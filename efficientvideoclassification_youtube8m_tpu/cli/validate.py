"""Student validator (teacher tower present for L_REP).

Rebuild of `/root/reference/code_student_uniform/validate.py`: evaluates
the STUDENT on validation shards while also running the teacher to
report the representation loss; loops waiting for new checkpoints unless
--run_once.
"""

from __future__ import annotations

import logging
import os
import sys
import time
from collections import deque

import numpy as np

from efficientvideoclassification_youtube8m_tpu.cli import flags as flags_lib
from efficientvideoclassification_youtube8m_tpu.data import FrameDataLoader
from efficientvideoclassification_youtube8m_tpu.metrics import EvaluationMetrics
from efficientvideoclassification_youtube8m_tpu.train import (
    init_distill_state,
    latest_checkpoint,
    make_optimizer,
    restore_checkpoint,
)
from efficientvideoclassification_youtube8m_tpu.utils import summary as summary_lib
from efficientvideoclassification_youtube8m_tpu.utils.compile_cache import (
    enable_compilation_cache,
)

logger = logging.getLogger("validate")


def evaluation_loop(cfg, args, state, step_fn, mesh, writer, checkpoint_path,
                    host):
    from efficientvideoclassification_youtube8m_tpu.parallel import (
        device_prefetch,
        distributed,
    )

    evl_metrics = EvaluationMetrics(cfg.num_classes, args.top_k)
    global_step_val = int(np.asarray(state.global_step))
    loader = FrameDataLoader(
        args.eval_data_pattern,
        batch_size=host.local_batch_size,
        feature_names=cfg.feature_names_list,
        feature_sizes=cfg.feature_sizes_list,
        max_frames=cfg.max_num_frames,
        vocab_size=cfg.num_classes,
        num_readers=cfg.num_readers,
        deterministic=cfg.deterministic_input,
        num_epochs=1,
        shuffle=False,
        shard_index=host.process_index,
        num_shards=host.process_count,
        pad_final_batch=True,
        use_native=cfg.use_native_io,
    )
    examples_processed = 0
    start = time.time()

    def accumulate(rows, lrep: float):
        nonlocal examples_processed
        info = evl_metrics.accumulate_topk(
            rows["topk_val"], rows["topk_idx"], rows["labels"],
            rows["per_example_loss"], perr_precision=rows["perr_precision"],
        )
        examples_processed += rows["topk_val"].shape[0]
        info["examples_per_second"] = examples_processed / (time.time() - start)
        logger.info(
            "%s | L_REP: %.4f",
            summary_lib.add_global_step_summary(
                writer, global_step_val, info, summary_scope="Eval"
            ),
            lrep,
        )

    def drain(out, labels, pad):
        # this host's rows of the global outputs, gathered into the
        # global valid-row stream (passthrough single-process)
        accumulate(distributed.gather_step_outputs(out, labels, pad),
                   float(out["student_loss_state"]))

    # lag-N fetch ring: keep several dispatched batches in flight and
    # pull only the oldest one's packed outputs, so N launches' worth of
    # dispatch + D2H latency overlaps device compute. FIFO drain order
    # keeps epoch metrics bit-identical to the sequential loop.
    ring: deque = deque()
    depth = max(1, getattr(cfg, "fetch_depth", 4))
    steps = max(1, getattr(args, "steps_per_dispatch", 1))
    if steps > 1:
        # steps-per-dispatch: K batches scanned in one launch, one
        # packed fetch (shared stack_batches/stacked_ring helpers — same
        # loop as cli/eval.py, with the per-batch L_REP riding along).
        # Epoch metrics bit-identical.
        def launch(bufs):
            metas = [(b.labels, b.pad) for b in bufs]
            dev = distributed.stack_batches(mesh, bufs, steps)
            return (step_fn(state.params_teacher, state.params_student,
                            *dev), metas)

        for out, metas in distributed.stacked_ring(
                distributed.sync_host_streams(loader, "eval"),
                steps, depth, launch):
            lrep = np.asarray(out["student_loss_state"])
            for i, rows in enumerate(
                    distributed.gather_stacked_outputs(out["host_pack"],
                                                       metas)):
                accumulate(rows, float(lrep[i]))
    else:
        for (f, l, n), (labels, pad) in device_prefetch(
                distributed.sync_host_streams(loader, "eval"), mesh,
                host_keep=lambda b: (b.labels, b.pad)):
            ring.append(
                (step_fn(state.params_teacher, state.params_student, f, l, n),
                 labels, pad))
            if len(ring) > depth:
                drain(*ring.popleft())
        while ring:
            drain(*ring.popleft())
    epoch_data = evl_metrics.get()
    epoch_data["epoch_id"] = global_step_val
    logger.info(
        summary_lib.add_epoch_summary(
            writer, global_step_val, epoch_data, summary_scope="Eval"
        )
    )
    logger.info(
        "Average examples processed in one second %0.20f",
        examples_processed / (time.time() - start),
    )
    return epoch_data


def evaluate(args):
    from efficientvideoclassification_youtube8m_tpu.parallel import (
        build_sharded_validate_step,
        create_mesh,
        distributed,
    )

    distributed.initialize()  # no-op single-process
    cfg = flags_lib.config_from_args(args)
    if not args.frame_features:
        # like cli.train: the teacher+student validate graph structurally
        # needs frame features (the reference's validate.py has no
        # aggregated-reader branch at all); video-level models evaluate
        # through cli.eval --frame_features=False
        raise ValueError(
            "--frame_features=False: validation runs both distillation "
            "towers and requires frame-level features. Evaluate "
            "video-level models with cli.eval --frame_features=False."
        )
    host = distributed.host_context(cfg.batch_size)
    flags_lib.resolve_steps_per_dispatch(args, logger=logger)
    from efficientvideoclassification_youtube8m_tpu.parallel import place_fields

    optimizer = make_optimizer(cfg.optimizer, cfg.clip_gradient_norm)
    mesh = create_mesh(model=args.model_parallelism)
    # mesh-placed PARAMS template: restores read the params straight onto
    # the shardings; the optimizer moments this binary never touches are
    # host numpy (orbax restores them to host, msgpack ignores devices) —
    # no HBM, not even transiently, for 2x Adam state on an eval chip
    _PLACED = ("params_teacher", "params_student")
    template = place_fields(
        init_distill_state(cfg, optimizer, host_optimizer_state=True),
        mesh, _PLACED,
    )
    if max(1, getattr(args, "steps_per_dispatch", 1)) > 1:
        from efficientvideoclassification_youtube8m_tpu.parallel import (
            build_sharded_validate_step_stacked,
        )

        step_fn = build_sharded_validate_step_stacked(
            cfg, mesh, template.params_teacher, template.params_student,
            top_k=args.top_k,
        )
    else:
        step_fn = build_sharded_validate_step(
            cfg, mesh, template.params_teacher, template.params_student,
            top_k=args.top_k,
        )
    writer = summary_lib.for_master(
        os.path.join(cfg.train_dir, "eval"), host.is_master
    )

    last_checkpoint = None
    while True:
        # master-elected: every host evaluates the SAME checkpoint (the
        # per-batch collectives inside evaluation_loop would desync if
        # hosts raced their own latest_checkpoint polls)
        ckpt = distributed.broadcast_str(
            latest_checkpoint(cfg.train_dir) if host.is_master else None
        )
        if ckpt is None:
            logger.info("No checkpoint yet in %s; waiting.", cfg.train_dir)
        elif ckpt != last_checkpoint:
            logger.info("Loading checkpoint for eval: %s", ckpt)
            state = place_fields(restore_checkpoint(ckpt, template), mesh,
                                 _PLACED)
            evaluation_loop(cfg, args, state, step_fn, mesh, writer, ckpt,
                            host)
            last_checkpoint = ckpt
        if args.run_once:
            break
        time.sleep(30)
    writer.close()


def main(argv=None):
    flags_lib.setup_logging()
    enable_compilation_cache()
    parser = flags_lib.base_parser("Validate the student on YT8M")
    parser.add_argument("--steps_per_dispatch", type=int, default=0,
                        help="K>1: scan K batches per device launch (one "
                        "packed fetch) — amortizes per-launch dispatch "
                        "latency; epoch metrics are bit-identical. "
                        "Default 0 = auto: 1 (per-batch dispatch)")
    args = parser.parse_args(argv)
    flags_lib.dump_flags(args, logger)
    evaluate(args)


if __name__ == "__main__":
    main(sys.argv[1:])
