#!/usr/bin/env python
"""Acceptance harness — the flagship convergence run, with its bands
ASSERTED.

Recipe: learnable synthetic data (label->byte-pattern mapping,
data/yt8m.write_learnable_frame_shard) with vocab 256, 2048 train / 512
held-out videos, flagship dims (HierarchicalLstm 2x1024, 300 frames, 20
chunks, every_n 10), bf16, 30 epochs at batch 128 (16 batches/epoch ->
960 faithful global steps) through the REAL cli.train, then held-out
STUDENT validation through cli.validate.

Asserted bands (fail -> exit 1):
  * train GAP >= 0.995 by step <= 700
  * held-out student Hit@1 >= 0.95 and GAP >= 0.74

Intended for the GPU. On CPU pass --scan_unroll 1 and expect a
multi-hour run. With --deterministic_input true (the default) the batch
stream replays exactly (round-robin file dispatch + in-order drain; rngs
derive from the global step); the per-step loss trajectory digest is
printed so two runs can be compared. No digest is pinned: GPU reductions
need not be bit-reproducible across machines or autotuning choices.

Recorded on one NVIDIA H100 80GB HBM3, 700.00 W (defaults, two runs in
one machine, identical digests b1e91560e8f62913f461a08905ce6fa811a7db53):
train GAP 0.995 first at step 388; held-out Hit@1 0.971 / PERR 0.834 /
GAP 0.793 / mAP 0.851.

CONVERGENCE GATE — read before flipping any train-math default:
any flag that changes the training-step math (precision of residual /
cotangent streams, kernel fusion, optimizer math, loss terms) MUST pass
these bands on the card with the flag enabled BEFORE its default
changes: a throughput win that loses convergence is not a win.

Usage: python scripts/acceptance_run.py [--workdir DIR] [--scan_unroll N]
"""

import argparse
import logging
import os
import re
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from efficientvideoclassification_youtube8m_tpu.data.yt8m import (  # noqa: E402
    write_learnable_frame_shard,
)

_STEP_RE = re.compile(
    r"training step (\d+)\| Hit@1: ([\d.]+)\| PERR: ([\d.]+)\| GAP: ([\d.]+)"
)
_LOSS_RE = re.compile(
    r"training step (\d+)\|.*Teacher_Loss: ([\d.eE+-]+)\| "
    r"L_REP: ([\d.eE+-]+)\| L_PRED: ([\d.eE+-]+)\| L_CE: ([\d.eE+-]+)"
)

VOCAB = 256
TRAIN_VIDEOS = 2048
HELDOUT_VIDEOS = 512

class _GapCapture(logging.Handler):
    def __init__(self):
        super().__init__()
        self.first_converged_step = None
        self.last = None
        self.loss_lines = []  # per-step "(step,tl,lrep,lpred,lce)" strings

    def emit(self, record):
        msg = record.getMessage()
        m = _STEP_RE.search(msg)
        if m:
            step, gap = int(m.group(1)), float(m.group(4))
            self.last = (step, gap)
            if gap >= 0.995 and self.first_converged_step is None:
                self.first_converged_step = step
        ml = _LOSS_RE.search(msg)
        if ml:
            self.loss_lines.append(",".join(ml.groups()))

    def trajectory_sha1(self) -> str:
        import hashlib

        return hashlib.sha1(
            "\n".join(self.loss_lines).encode()).hexdigest()


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--workdir", default=None)
    ap.add_argument("--scan_unroll", type=int, default=None,
                    help="default: the CLI's own default")
    ap.add_argument("--num_epochs", type=int, default=30)
    ap.add_argument("--deterministic_input", default="true",
                    help="forwarded to cli.train/validate: replayable "
                    "batch order (round-robin file dispatch + in-order "
                    "drain). Pass false for work-stealing readers")
    args = ap.parse_args()
    workdir = args.workdir or tempfile.mkdtemp(prefix="yt8m_acceptance_")
    data_dir = os.path.join(workdir, "yt8m")
    os.makedirs(data_dir, exist_ok=True)
    per_shard = 512
    shards = [os.path.join(data_dir, f"train-{s:04d}.tfrecord")
              for s in range(TRAIN_VIDEOS // per_shard)]
    shards.append(os.path.join(data_dir, "validate-0000.tfrecord"))
    if all(os.path.exists(p) for p in shards):
        print(f"reusing existing shards under {data_dir}")
    else:
        print(f"writing learnable synthetic shards under {data_dir} ...")
        for s in range(TRAIN_VIDEOS // per_shard):
            write_learnable_frame_shard(
                os.path.join(data_dir, f"train-{s:04d}.tfrecord"),
                num_videos=per_shard, seed=s, vocab_size=VOCAB,
            )
        write_learnable_frame_shard(
            os.path.join(data_dir, "validate-0000.tfrecord"),
            num_videos=HELDOUT_VIDEOS, seed=9, vocab_size=VOCAB,
        )
    train_dir = os.path.join(workdir, "model_train") + "/"
    if os.path.isdir(train_dir):  # stale checkpoints would confuse validate
        import shutil

        shutil.rmtree(train_dir)

    flags = [
        "--feature_names", "rgb, audio",
        "--feature_sizes", "1024, 128",
        "--model", "HierarchicalLstmModel",
        "--num_classes", str(VOCAB),
        "--batch_size", "128",
        "--num_inputs_to_lstm", "20",
        "--lstm_cells", "1024",
        "--lstm_layers", "2",
        "--every_n", "10",
        "--num_readers", "4",
        "--deterministic_input", args.deterministic_input,
        "--compute_dtype", "bfloat16",
        "--save_model_secs", "100000",  # one final checkpoint
    ]
    if args.scan_unroll is not None:
        flags += ["--scan_unroll", str(args.scan_unroll)]

    from efficientvideoclassification_youtube8m_tpu.cli import (
        train as train_cli,
        validate as validate_cli,
    )
    from efficientvideoclassification_youtube8m_tpu.metrics import eval_util

    print("=== train (teacher+student, flagship dims) ===")
    capture = _GapCapture()
    logging.getLogger("train").addHandler(capture)
    train_cli.main(flags + [
        "--train_dir", train_dir,
        "--train_data_pattern", os.path.join(data_dir, "train-*.tfrecord"),
        "--num_epochs", str(args.num_epochs),
        "--start_new_model", "true",
    ])
    logging.getLogger("train").removeHandler(capture)

    print("=== held-out student validation ===")
    epoch = {}
    orig_get = eval_util.EvaluationMetrics.get

    def capture_get(self):
        data = orig_get(self)
        epoch.update(data)
        return data

    eval_util.EvaluationMetrics.get = capture_get
    try:
        validate_cli.main(flags + [
            "--train_dir", train_dir,
            "--eval_data_pattern", os.path.join(data_dir,
                                                "validate-*.tfrecord"),
            "--run_once", "true",
        ])
    finally:
        eval_util.EvaluationMetrics.get = orig_get

    aps = epoch.get("aps") or []
    mean_ap = sum(aps) / len(aps) if aps else 0.0
    hit = epoch.get("avg_hit_at_one", 0.0)
    perr = epoch.get("avg_perr", 0.0)
    gap = epoch.get("gap", 0.0)
    print("=== acceptance bands ===")
    if not epoch:
        print("  validation produced NO epoch data (empty eval stream?)")
    print(f"  train GAP >= 0.995 first at step: {capture.first_converged_step}"
          f"; last logged: {capture.last}")
    digest = capture.trajectory_sha1()
    print(f"  per-step loss trajectory sha1: {digest} "
          f"({len(capture.loss_lines)} steps)")
    print(f"  held-out Hit@1 {hit:.3f} | PERR {perr:.3f} | GAP {gap:.3f}"
          f" | mAP {mean_ap:.3f}")

    ok = True

    def expect(cond, msg):
        nonlocal ok
        print(f"  [{'ok' if cond else 'FAIL'}] {msg}")
        ok = ok and cond

    expect(capture.first_converged_step is not None
           and capture.first_converged_step <= 700,
           "train GAP reaches 0.995 by step 700")
    expect(epoch.get("avg_hit_at_one", 0.0) >= 0.95,
           "held-out student Hit@1 >= 0.95")
    expect(epoch.get("gap", 0.0) >= 0.74, "held-out student GAP >= 0.74")
    if not ok:
        print("ACCEPTANCE RUN FAILED")
        sys.exit(1)
    print("acceptance bands: OK")


if __name__ == "__main__":
    main()
