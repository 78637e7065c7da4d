"""Checkpoint converter: teacher-student -> standalone student.

Rebuild of `/root/reference/code_student_uniform/train_convert_model.py`
("meta-graph surgery", :360-401): loads the latest teacher-student
checkpoint, keeps the student parameter subtree, resets optimizer slots
and step, and saves a fresh checkpoint into the finetune directory
derived the same way: `train_dir.replace('train','') + 'finetune/'`.
"""

from __future__ import annotations

import logging
import os
import sys

import numpy as np

from efficientvideoclassification_youtube8m_tpu.cli import flags as flags_lib
from efficientvideoclassification_youtube8m_tpu.train import (
    init_distill_state,
    latest_checkpoint,
    make_optimizer,
    restore_checkpoint,
    save_checkpoint,
    student_state_from_distill,
)
from efficientvideoclassification_youtube8m_tpu.utils.compile_cache import (
    enable_compilation_cache,
)

logger = logging.getLogger("convert")


def convert(args) -> str:
    cfg = flags_lib.config_from_args(args)
    optimizer = make_optimizer(cfg.optimizer, cfg.clip_gradient_norm)
    template = init_distill_state(cfg, optimizer)

    ckpt = latest_checkpoint(cfg.train_dir)
    if ckpt is None:
        raise IOError(f"no checkpoint found in {cfg.train_dir}")
    logger.info("Restoring student variables from %s", ckpt)
    state = restore_checkpoint(ckpt, template)

    student_state = student_state_from_distill(state, optimizer)
    finetune_dir = cfg.train_dir.replace("train", "") + "finetune/"
    os.makedirs(finetune_dir, exist_ok=True)
    path = save_checkpoint(finetune_dir, student_state, 0,
                           backend=args.checkpoint_format)
    logger.info("Saved standalone student checkpoint to %s", path)

    # sanity: re-restore round-trip (the reference re-restores after save,
    # train_convert_model.py:398-401)
    import jax

    restored = restore_checkpoint(
        path, student_state_from_distill(template, optimizer)
    )
    jax.tree.map(
        lambda a, b: np.testing.assert_array_equal(np.asarray(a), np.asarray(b)),
        restored.params_student,
        jax.device_get(student_state.params_student),
    )
    logger.info("Round-trip restore verified.")
    return path


def main(argv=None):
    flags_lib.setup_logging()
    enable_compilation_cache()
    parser = flags_lib.base_parser(
        "Convert a teacher-student checkpoint to student-only"
    )
    args = parser.parse_args(argv)
    flags_lib.dump_flags(args, logger)
    convert(args)


if __name__ == "__main__":
    main(sys.argv[1:])
