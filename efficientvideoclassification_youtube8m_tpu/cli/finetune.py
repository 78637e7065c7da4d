"""Student-only finetuner.

Rebuild of `/root/reference/code_student_uniform/train_finetune.py`:
standard single-tower training of the student (CE + reg) resuming from
the converted checkpoint in `train_dir` (which for this binary is the
finetune directory, per run_finetune.sh).
"""

from __future__ import annotations

import logging
import sys
import time

from efficientvideoclassification_youtube8m_tpu.cli import flags as flags_lib
from efficientvideoclassification_youtube8m_tpu.data import (
    AggregatedDataLoader,
    FrameDataLoader,
)
from efficientvideoclassification_youtube8m_tpu.metrics import train_step_metrics
from efficientvideoclassification_youtube8m_tpu.train import (
    AsyncCheckpointSaver,
    init_distill_state,
    latest_checkpoint,
    make_optimizer,
    restore_checkpoint,
    student_state_from_distill,
)
from efficientvideoclassification_youtube8m_tpu.utils import summary as summary_lib
from efficientvideoclassification_youtube8m_tpu.utils.compile_cache import (
    enable_compilation_cache,
)

logger = logging.getLogger("finetune")


def finetune(args):
    from efficientvideoclassification_youtube8m_tpu.parallel import (
        build_sharded_finetune_step,
        build_shardmap_finetune_step,
        create_mesh,
        distributed,
        place_state,
    )

    distributed.initialize()  # no-op single-process; TF_CONFIG/JAX env else
    cfg = flags_lib.config_from_args(args)
    host = distributed.host_context(cfg.batch_size)
    if host.multi_host:
        logger.info(
            "Multi-host: process %d/%d, local batch %d of global %d",
            host.process_index, host.process_count,
            host.local_batch_size, cfg.batch_size,
        )
    optimizer = make_optimizer(cfg.optimizer, cfg.clip_gradient_norm)
    template = student_state_from_distill(
        init_distill_state(cfg, optimizer), optimizer
    )

    # master-elected resume checkpoint (hosts must restore the SAME one)
    ckpt = None if args.start_new_model else distributed.broadcast_str(
        latest_checkpoint(cfg.train_dir) if host.is_master else None
    )
    if args.start_new_model:
        # from-scratch training (the reference finetuner's fresh-model path,
        # train_finetune.py:377-379) — also how single-tower models like
        # DBoF are trained. Opt-in only: a missing checkpoint WITHOUT the
        # flag stays an error so a typo'd --train_dir in the distill ->
        # convert -> finetune chain can't silently train from random init.
        logger.info("Building new model.")
    elif ckpt is None:
        raise IOError(
            f"no converted checkpoint in {cfg.train_dir}; run convert "
            "first, or pass --start_new_model to train from scratch"
        )
    logger.info("Trainable Parameters of Student:")
    logger.info("%s", flags_lib.param_names(template.params_student,
                                            "model_student"))

    mesh = create_mesh(model=args.model_parallelism)
    # --frame_features=False: pre-aggregated Examples, video-level model
    # applied directly (train_finetune.py:514-518 reader selection);
    # frame path: frames are strided on the host below (1/every_n the
    # H2D bytes)
    aggregated = not args.frame_features
    if args.use_shardmap_train:
        step_fn = build_shardmap_finetune_step(
            cfg, optimizer, mesh, top_k=args.top_k,
            host_subsampled=not aggregated, aggregated=aggregated,
        )
    else:
        step_fn = build_sharded_finetune_step(
            cfg, optimizer, mesh, template, top_k=args.top_k,
            host_subsampled=not aggregated, aggregated=aggregated,
        )
    # place BEFORE restoring (see cli/train.py): orbax reads each shard
    # onto its device; the re-place no-ops for global arrays and places
    # msgpack's numpy leaves — no cross-host device transfers
    state = place_state(template, mesh)
    if ckpt:
        logger.info("Resuming student from %s", ckpt)
        state = place_state(restore_checkpoint(ckpt, state), mesh)

    loader_cls = AggregatedDataLoader if aggregated else FrameDataLoader
    loader = loader_cls(
        cfg.train_data_pattern,
        batch_size=host.local_batch_size,
        feature_names=cfg.feature_names_list,
        feature_sizes=cfg.feature_sizes_list,
        max_frames=cfg.max_num_frames,
        vocab_size=cfg.num_classes,
        num_readers=cfg.num_readers,
        deterministic=cfg.deterministic_input,
        num_epochs=cfg.num_epochs,
        shuffle=True,
        seed=cfg.seed,
        shard_index=host.process_index,
        num_shards=host.process_count,
        drop_remainder=True,  # static shapes, no fabricated rows
        use_native=cfg.use_native_io,
        bagging=args.bagging,
        # student-only frame training: parse/move only the kept
        # every_n-th frames (the step is built with host_subsampled=True)
        frame_stride=1 if aggregated else cfg.every_n,
    )
    writer = summary_lib.for_master(cfg.train_dir, host.is_master)
    start_time = time.time()
    logger.info("Entering training loop.")

    def write_graph_summaries(metrics, global_step_val, cur_state):
        """In-graph scalars (train_finetune.py:229,285,297,322) + one
        histogram per student variable, at save_summaries_secs cadence."""
        writer.scalar("learning_rate", float(metrics["learning_rate"]),
                      global_step_val)
        writer.scalar("student_label_loss",
                      float(metrics["student_label_loss"]), global_step_val)
        writer.scalar("student_reg_loss",
                      float(metrics["student_reg_loss"]), global_step_val)
        summary_lib.write_variable_histograms(
            writer, cur_state.params_student, "model_student",
            global_step_val)
        writer.flush()

    def log_step(metrics, labels, seconds_per_batch):
        global_step_val = int(metrics["global_step"])
        # multi-host: this process's rows only (per-worker logging).
        # PERR is the exact full-row device precision, like cli.train
        info = train_step_metrics(distributed.local_rows(metrics["topk_val"]),
                                  distributed.local_rows(metrics["topk_idx"]),
                                  labels,
                                  perr_precision=distributed.local_rows(
                                      metrics["perr_precision"]))
        logger.info(
            "training step %d| Hit@1: %.2f| PERR: %.2f| GAP: %.2f| L_CE: %s",
            global_step_val, info["hit_at_one"], info["perr"], info["gap"],
            round(float(metrics["student_label_loss"]), 2),
        )
        writer.scalar("model/Training_Hit@1", info["hit_at_one"], global_step_val)
        writer.scalar("model/Training_Perr", info["perr"], global_step_val)
        writer.scalar("model/Training_GAP", info["gap"], global_step_val)
        writer.scalar("global_step/Examples/Second",
                      labels.shape[0] * host.process_count / seconds_per_batch,
                      global_step_val)
        writer.flush()

    saver = AsyncCheckpointSaver(enabled=args.async_checkpoint)
    from efficientvideoclassification_youtube8m_tpu.cli.loop import (
        run_training_loop,
    )

    run_training_loop(
        loader=loader, mesh=mesh, state=state, step_fn=step_fn, saver=saver,
        writer=writer, cfg=cfg, args=args, log_step=log_step,
        write_graph_summaries=write_graph_summaries, logger=logger,
    )
    print("Total time taken is " + str(time.time() - start_time))


def main(argv=None):
    flags_lib.setup_logging()
    enable_compilation_cache()
    parser = flags_lib.base_parser("Finetune the student alone")
    args = parser.parse_args(argv)
    flags_lib.dump_flags(args, logger)
    finetune(args)


if __name__ == "__main__":
    main(sys.argv[1:])
