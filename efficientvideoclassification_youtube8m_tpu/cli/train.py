"""Parallel teacher+student distillation trainer.

The rebuild of `/root/reference/code_student_uniform/train.py`: same
flags, same log-line format, same summary tags
("model/Training_Hit@1|Perr|GAP", "global_step/Examples/Second",
train.py:528-545), same checkpoint cadence (save_model_secs=30min,
max_to_keep=1) and resume-from-latest behavior — on a JAX device mesh
instead of a TF1 Supervisor session.
"""

from __future__ import annotations

import logging
import sys
import time

from efficientvideoclassification_youtube8m_tpu.cli import flags as flags_lib
from efficientvideoclassification_youtube8m_tpu.data import FrameDataLoader
from efficientvideoclassification_youtube8m_tpu.metrics import train_step_metrics
from efficientvideoclassification_youtube8m_tpu.train import (
    AsyncCheckpointSaver,
    init_distill_state,
    latest_checkpoint,
    make_optimizer,
    restore_checkpoint,
)
from efficientvideoclassification_youtube8m_tpu.utils import summary as summary_lib
from efficientvideoclassification_youtube8m_tpu.utils.compile_cache import (
    enable_compilation_cache,
)

logger = logging.getLogger("train")


def train(args) -> None:
    from efficientvideoclassification_youtube8m_tpu.parallel import (
        build_sharded_distill_step,
        build_shardmap_distill_step,
        create_mesh,
        distributed,
        place_state,
    )

    # multi-host bring-up FIRST (before any backend/device use): no-op for
    # single-process runs, TF_CONFIG/JAX-env cluster spec otherwise
    # (reference worker dispatch, train.py:704-733)
    distributed.initialize()
    cfg = flags_lib.config_from_args(args)
    if not args.frame_features:
        # the reference's train.py accepts the flag (train.py:620-624
        # selects YT8MAggregatedFeatureReader) but its graph build then
        # fails on the rank-2 aggregated input (the student frame-subsample
        # transpose, train.py:268) — distillation structurally needs frame
        # features. Surface that clearly instead of a shape error.
        raise ValueError(
            "--frame_features=False: the teacher-student distillation "
            "trainer requires frame-level features. Train video-level "
            "models on aggregated Examples with "
            "cli.finetune --frame_features=False --start_new_model."
        )
    host = distributed.host_context(cfg.batch_size)
    if host.multi_host:
        logger.info(
            "Multi-host: process %d/%d, local batch %d of global %d",
            host.process_index, host.process_count,
            host.local_batch_size, cfg.batch_size,
        )
    # the reference's task prefix on training log lines
    # (train.py:528-533, task_as_string; golden log README.md:112-121)
    task_str = ("/job:master/task:0" if host.is_master
                else f"/job:worker/task:{host.process_index - 1}")
    optimizer = make_optimizer(cfg.optimizer, cfg.clip_gradient_norm)
    state = init_distill_state(cfg, optimizer)

    logger.info("Trainable Parameters of Teacher:")
    logger.info("%s", flags_lib.param_names(state.params_teacher, "model"))
    logger.info("Trainable Parameters of Student:")
    logger.info("%s", flags_lib.param_names(state.params_student, "model_student"))

    mesh = create_mesh(model=args.model_parallelism)
    logger.info("Device mesh: %s", dict(mesh.shape))
    if args.use_shardmap_train:
        step_fn = build_shardmap_distill_step(
            cfg, optimizer, mesh, top_k=args.top_k
        )
    else:
        step_fn = build_sharded_distill_step(
            cfg, optimizer, mesh, state, top_k=args.top_k
        )
    # place BEFORE restoring: orbax then reads every shard straight onto
    # its device (incl. other hosts' shards to their hosts), and the
    # re-place is a no-op for already-global arrays / the mesh placement
    # for msgpack's numpy leaves — no cross-host device transfers.
    state = place_state(state, mesh)
    # master-elected resume checkpoint: hosts racing their own directory
    # reads (NFS attribute caches) could restore different states
    ckpt = None if args.start_new_model else distributed.broadcast_str(
        latest_checkpoint(cfg.train_dir) if host.is_master else None
    )
    if ckpt:
        logger.info("Restoring from %s", ckpt)
        state = place_state(restore_checkpoint(ckpt, state), mesh)

    loader = FrameDataLoader(
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
    )

    writer = summary_lib.for_master(cfg.train_dir, host.is_master)
    saver = AsyncCheckpointSaver(enabled=args.async_checkpoint)
    start_time = time.time()
    logger.info("%s: Entering training loop.", task_str)

    def write_graph_summaries(metrics, global_step_val, cur_state):
        """The reference's in-graph summaries, emitted at the Supervisor's
        save_summaries_secs cadence (train.py:238-239,298,363,373,426-427):
        LR + loss scalars and one histogram per model variable."""
        writer.scalar("learning_rate", float(metrics["learning_rate"]),
                      global_step_val)
        writer.scalar("learning_rate_stud", float(metrics["learning_rate"]),
                      global_step_val)
        writer.scalar("label_loss", float(metrics["teacher_label_loss"]),
                      global_step_val)
        writer.scalar("reg_loss", float(metrics["teacher_reg_loss"]),
                      global_step_val)
        writer.scalar("State_student_loss",
                      float(metrics["student_loss_state"]), global_step_val)
        writer.scalar("student_label_loss",
                      float(metrics["student_label_loss"]), global_step_val)
        summary_lib.write_variable_histograms(
            writer, cur_state.params_teacher, "model", global_step_val)
        summary_lib.write_variable_histograms(
            writer, cur_state.params_student, "model_student",
            global_step_val)
        writer.flush()

    def log_step(metrics, labels, seconds_per_batch):
        """Host-side metrics from the device top-k; PERR is the EXACT
        full-row per-video precision computed inside the step
        (perr_precision_on_device), so the logged number matches the
        reference's full-matrix path for ANY label count. Multi-host:
        each process logs over ITS rows of the global batch (local_rows;
        zero cross-host traffic), like the reference's per-worker
        logging."""
        topk_val = distributed.local_rows(metrics["topk_val"])
        topk_idx = distributed.local_rows(metrics["topk_idx"])
        global_step_val = int(metrics["global_step"])
        examples_per_second = (
            labels.shape[0] * host.process_count / seconds_per_batch
        )
        info = train_step_metrics(
            topk_val, topk_idx, labels,
            perr_precision=distributed.local_rows(
                metrics["perr_precision"]),
        )
        logger.info(
            "%s: training step %d| Hit@1: %.2f| PERR: %.2f| GAP: %.2f| "
            "Teacher_Loss: %s| L_REP: %s| L_PRED: %s| L_CE: %s",
            task_str,
            global_step_val, info["hit_at_one"], info["perr"], info["gap"],
            round(float(metrics["teacher_label_loss"]), 2),
            round(float(metrics["student_loss_state"]), 2),
            round(float(metrics["pred_loss"]), 2),
            round(float(metrics["student_label_loss"]), 2),
        )
        writer.scalar("model/Training_Hit@1", info["hit_at_one"],
                      global_step_val)
        writer.scalar("model/Training_Perr", info["perr"], global_step_val)
        writer.scalar("model/Training_GAP", info["gap"], global_step_val)
        writer.scalar("global_step/Examples/Second", examples_per_second,
                      global_step_val)
        writer.flush()

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
    parser = flags_lib.base_parser("Train teacher+student on YT8M")
    args = parser.parse_args(argv)
    flags_lib.dump_flags(args, logger)
    train(args)


if __name__ == "__main__":
    main(sys.argv[1:])
