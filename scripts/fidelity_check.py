#!/usr/bin/env python
"""Fidelity harness — the rebuild's analog of the reference's acceptance
test (a logged `run_train.sh` run on the 10-TFRecord sample,
/root/reference/README.md:44-124).

Generates a 10-record YT8M-shaped synthetic sample, runs the full
five-stage pipeline on it with the canonical flags (batch scaled to the
sample), and prints: the flag dump, both towers' parameter lists, the
per-step training metric lines, and the validation epoch summary — in
the reference's formats.

Besides running the five stages, the harness pins the few-step loss
TRAJECTORY against the reference's golden log
(/root/reference/README.md:116-122): the analytic step-2 init CE and
the step-4 decrease shape (teacher CE falls ~6 nats, L_REP grows as the
towers specialize, L_PRED stays ~0.01). Data ordering and init RNG
differ from the reference's run, so these are band checks, not
bit-equality; the step-2 value IS tight (it's analytic).

Usage: python scripts/fidelity_check.py [--workdir DIR]
"""

import argparse
import logging
import os
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from efficientvideoclassification_youtube8m_tpu.data import (  # noqa: E402
    write_synthetic_frame_shard,
)
from efficientvideoclassification_youtube8m_tpu.utils.fidelity import (  # noqa: E402
    StepCapture,
    check_trajectory,
)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--workdir", default=None)
    ap.add_argument("--num_videos", type=int, default=10)
    ap.add_argument("--platform", default=None, choices=["cpu", "gpu"],
                    help="pin the JAX backend ('cpu' runs the whole "
                    "pipeline on the host; ~20 min at flagship dims on "
                    "one core). Default: JAX's own choice.")
    args = ap.parse_args()
    if args.platform:
        import jax

        jax.config.update("jax_platforms",
                          "cuda" if args.platform == "gpu" else "cpu")
    workdir = args.workdir or tempfile.mkdtemp(prefix="yt8m_fidelity_")
    data_dir = os.path.join(workdir, "yt8m")
    os.makedirs(data_dir, exist_ok=True)
    write_synthetic_frame_shard(
        os.path.join(data_dir, "train-0000.tfrecord"),
        num_videos=args.num_videos, seed=0,
    )
    write_synthetic_frame_shard(
        os.path.join(data_dir, "validate-0000.tfrecord"),
        num_videos=args.num_videos, seed=1,
    )
    train_dir = os.path.join(workdir, "model_train") + "/"

    flags = [
        "--feature_names", "rgb, audio",
        "--feature_sizes", "1024, 128",
        "--model", "HierarchicalLstmModel",
        "--batch_size", "5",
        "--num_inputs_to_lstm", "20",
        "--lstm_layers", "2",
        "--every_n", "10",
        "--num_epochs", "2",
        "--num_readers", "2",
        # numerically identical; keeps the single-core CPU compile of the
        # flagship-dims graph tractable
        "--scan_unroll", "1",
    ]

    from efficientvideoclassification_youtube8m_tpu.cli import (
        convert as convert_cli,
        eval as eval_cli,
        finetune as finetune_cli,
        train as train_cli,
        validate as validate_cli,
    )

    print("=== train (teacher+student) ===")
    capture = StepCapture()
    logging.getLogger("train").addHandler(capture)
    train_cli.main(flags + [
        "--train_dir", train_dir,
        "--train_data_pattern", os.path.join(data_dir, "train*.tfrecord"),
        "--start_new_model", "true",
    ])
    logging.getLogger("train").removeHandler(capture)
    print("=== trajectory vs reference golden log (README.md:116-122) ===")
    trajectory_ok = check_trajectory(capture.steps)
    print("=== validate ===")
    validate_cli.main(flags + [
        "--train_dir", train_dir,
        "--eval_data_pattern", os.path.join(data_dir, "validate*.tfrecord"),
        "--run_once", "true",
    ])
    print("=== convert ===")
    convert_cli.main(flags + ["--train_dir", train_dir])
    finetune_dir = train_dir.replace("train", "") + "finetune/"
    print("=== finetune ===")
    finetune_cli.main(flags + [
        "--train_dir", finetune_dir,
        "--train_data_pattern", os.path.join(data_dir, "train*.tfrecord"),
        "--num_epochs", "1",
    ])
    print("=== eval ===")
    eval_cli.main(flags + [
        "--train_dir", finetune_dir,
        "--eval_data_pattern", os.path.join(data_dir, "validate*.tfrecord"),
        "--run_once", "true",
    ])
    print(f"fidelity pipeline completed under {workdir}")
    if not trajectory_ok:
        print("TRAJECTORY CHECK FAILED vs the reference golden log")
        sys.exit(1)
    print("trajectory check vs the reference golden log: OK")


if __name__ == "__main__":
    main()
