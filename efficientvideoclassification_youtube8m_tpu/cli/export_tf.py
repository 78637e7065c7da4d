"""Export a checkpoint as a reference TF-V2 bundle.

Interop in the OPPOSITE direction from `data/tf_checkpoint.py`'s
importer: a model trained HERE becomes a `model.ckpt-<step>` Saver-V2
bundle the reference's TF1 binaries (`validate.py:350-381` Saver maps,
`inspect_checkpoint_myfile.py`) consume directly, with the MoE layout
permuted back to the reference's class-interleaved columns and the Adam
moments + beta powers intact so reference training can resume from it.

Usage:
    python -m ...cli.export_tf --train_dir /x/model_train \
        --output_prefix /x/tf_export/model.ckpt \
        [--tower distill|student] <model dimension flags>
"""

from __future__ import annotations

import logging
import os
import sys

from efficientvideoclassification_youtube8m_tpu.cli import flags as flags_lib
from efficientvideoclassification_youtube8m_tpu.train import (
    init_distill_state,
    latest_checkpoint,
    make_optimizer,
    restore_checkpoint,
    student_state_from_distill,
)
from efficientvideoclassification_youtube8m_tpu.utils.compile_cache import (
    enable_compilation_cache,
)

logger = logging.getLogger("export_tf")


def export(args) -> str:
    from efficientvideoclassification_youtube8m_tpu.train.tf_export import (
        export_tf_checkpoint,
    )

    cfg = flags_lib.config_from_args(args)
    optimizer = make_optimizer(cfg.optimizer, cfg.clip_gradient_norm)
    template = init_distill_state(cfg, optimizer, host_optimizer_state=True)
    if args.tower == "student":
        template = student_state_from_distill(
            template, optimizer, host_optimizer_state=True)

    ckpt = args.checkpoint or latest_checkpoint(cfg.train_dir)
    if ckpt is None:
        raise IOError(f"no checkpoint found in {cfg.train_dir}")
    logger.info("Restoring %s", ckpt)
    state = restore_checkpoint(ckpt, template)

    import numpy as np

    step = int(np.asarray(state.global_step))
    prefix = args.output_prefix or os.path.join(
        cfg.train_dir, f"tf_export/model.ckpt-{step}")
    if not prefix.rsplit("-", 1)[-1].isdigit():
        prefix = f"{prefix}-{step}"
    os.makedirs(os.path.dirname(os.path.abspath(prefix)), exist_ok=True)
    out = export_tf_checkpoint(prefix, state)
    # a TF-style pointer file so the reference's
    # tf.train.latest_checkpoint finds it — but NEVER clobber an
    # existing pointer: if --output_prefix points inside a live
    # train_dir, overwriting its `checkpoint` file would silently
    # redirect the next resume/eval poll at the exported bundle
    pointer = os.path.join(os.path.dirname(out), "checkpoint")
    if os.path.exists(pointer):
        logger.warning(
            "%s already exists (a live checkpoint directory?) — leaving "
            "it untouched; point the reference tooling at the bundle "
            "prefix directly", pointer)
    else:
        with open(pointer, "w") as f:
            f.write(f'model_checkpoint_path: "{os.path.basename(out)}"\n')
            f.write(
                f'all_model_checkpoint_paths: "{os.path.basename(out)}"\n')
    logger.info("Exported TF-V2 bundle %s", out)
    return out


def main(argv=None):
    flags_lib.setup_logging()
    enable_compilation_cache()
    parser = flags_lib.base_parser(
        "Export a checkpoint as a reference TF-V2 Saver bundle")
    parser.add_argument("--checkpoint", default="",
                        help="explicit checkpoint path (msgpack file, "
                        "orbax dir); default: latest in --train_dir")
    parser.add_argument("--output_prefix", default="",
                        help="output bundle prefix (step is appended "
                        "when absent); default "
                        "<train_dir>/tf_export/model.ckpt-<step>")
    parser.add_argument("--tower", default="distill",
                        choices=["distill", "student"],
                        help="distill: both towers (train.py graphs); "
                        "student: student-only (finetune graphs)")
    args = parser.parse_args(argv)
    flags_lib.dump_flags(args, logger)
    export(args)


if __name__ == "__main__":
    main(sys.argv[1:])
