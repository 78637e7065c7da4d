"""Finetuned-student evaluator.

Rebuild of `/root/reference/code_student_uniform/eval_finetune.py`:
student-only eval (no teacher tower), epoch-level GAP/mAP/Hit@1/PERR,
looping on new checkpoints unless --run_once.
"""

from __future__ import annotations

import logging
import os
import sys
import time
from collections import deque

import numpy as np

from efficientvideoclassification_youtube8m_tpu.cli import flags as flags_lib
from efficientvideoclassification_youtube8m_tpu.data import (
    AggregatedDataLoader,
    FrameDataLoader,
)
from efficientvideoclassification_youtube8m_tpu.metrics import EvaluationMetrics
from efficientvideoclassification_youtube8m_tpu.train import (
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

logger = logging.getLogger("eval")


def evaluation_loop(cfg, args, params_student, global_step_val, step_fn, mesh,
                    writer, host):
    from efficientvideoclassification_youtube8m_tpu.parallel import (
        device_prefetch,
        distributed,
    )

    evl_metrics = EvaluationMetrics(cfg.num_classes, args.top_k)
    aggregated = not args.frame_features
    loader_cls = AggregatedDataLoader if aggregated else FrameDataLoader
    loader = loader_cls(
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
        # frame path: the student never reads the dropped frames — stride
        # at the PARSER (1/every_n the decode AND H2D bytes; the step is
        # built with host_subsampled=True)
        frame_stride=1 if aggregated else cfg.every_n,
    )

    examples_processed = 0
    start = time.time()

    def accumulate(rows):
        """Accumulate one batch's gathered valid rows + log."""
        nonlocal examples_processed
        info = evl_metrics.accumulate_topk(
            rows["topk_val"], rows["topk_idx"], rows["labels"],
            rows["per_example_loss"], perr_precision=rows["perr_precision"],
        )
        examples_processed += rows["topk_val"].shape[0]
        info["examples_per_second"] = examples_processed / (time.time() - start)
        logger.info(summary_lib.add_global_step_summary(
            writer, global_step_val, info, summary_scope="Eval"))

    def drain(out, labels, pad):
        """Fetch + accumulate one batch's outputs (one packed D2H
        transfer, gather_step_outputs)."""
        accumulate(distributed.gather_step_outputs(out, labels, pad))

    # lag-N fetch ring: keep several dispatched batches in flight and
    # only pull the OLDEST one's packed outputs, so the ~per-launch
    # dispatch + D2H latency of N batches overlaps device compute
    # (device_prefetch already overlaps the H2D side). Drain order is
    # FIFO, so epoch metrics are bit-identical to the sequential loop.
    ring: deque = deque()
    depth = max(1, getattr(cfg, "fetch_depth", 4))
    steps = max(1, getattr(args, "steps_per_dispatch", 1))
    if steps > 1:
        # steps-per-dispatch: stack K host batches, ONE launch scans
        # them (build_sharded_eval_step_stacked), one packed [K, B,
        # 2k+2] fetch — amortizes per-launch dispatch latency K-fold on
        # high-latency links; epoch metrics bit-identical (the shared
        # stack_batches/stacked_ring helpers pin the semantics).
        def launch(bufs):
            metas = [(b.labels, b.pad) for b in bufs]
            dev = distributed.stack_batches(mesh, bufs, steps)
            return step_fn(params_student, *dev), metas

        for packs, metas in distributed.stacked_ring(
                distributed.sync_host_streams(loader, "eval"),
                steps, depth, launch):
            for rows in distributed.gather_stacked_outputs(packs, metas):
                accumulate(rows)
    else:
        for (f, l, n), (labels, pad) in device_prefetch(
                distributed.sync_host_streams(loader, "eval"),
                mesh, host_keep=lambda b: (b.labels, b.pad)):
            ring.append((step_fn(params_student, f, l, n), labels, pad))
            if len(ring) > depth:
                drain(*ring.popleft())
        while ring:
            drain(*ring.popleft())
    epoch_data = evl_metrics.get()
    epoch_data["epoch_id"] = global_step_val
    logger.info(summary_lib.add_epoch_summary(
        writer, global_step_val, epoch_data, summary_scope="Eval"))
    logger.info("Average examples processed in one second %0.20f",
                examples_processed / (time.time() - start))
    return epoch_data


def evaluate(args):
    from efficientvideoclassification_youtube8m_tpu.parallel import (
        build_sharded_eval_step,
        build_sharded_quantized_eval_step,
        create_mesh,
        distributed,
    )

    distributed.initialize()  # no-op single-process
    cfg = flags_lib.config_from_args(args)
    host = distributed.host_context(cfg.batch_size)
    from efficientvideoclassification_youtube8m_tpu.parallel import place_fields

    optimizer = make_optimizer(cfg.optimizer, cfg.clip_gradient_norm)
    mesh = create_mesh(model=args.model_parallelism)
    # mesh-placed PARAMS template (opt moments stay host numpy — this
    # binary never reads them; see cli/validate.py)
    _PLACED = ("params_student",)
    template = place_fields(
        student_state_from_distill(
            init_distill_state(cfg, optimizer, host_optimizer_state=True),
            optimizer, host_optimizer_state=True,
        ),
        mesh, _PLACED,
    )
    aggregated = not args.frame_features
    quantize = getattr(args, "quantize", "none")
    stacked_steps = flags_lib.resolve_steps_per_dispatch(args, logger=logger)
    if quantize == "int8":
        # evaluate the int8 SERVING numerics at scale (the deploy-gate
        # workflow): quantize each restored checkpoint's student params
        # once, run the int8 forward through the same epoch machinery
        if aggregated:
            raise ValueError("--quantize int8 is the frame-level student path")
        if (cfg.model != "HierarchicalLstmModel"
                or cfg.video_level_classifier_model != "MoeModel"):
            # guard BEFORE touching params: quantize_hierarchical_params
            # would KeyError on a non-flagship tree
            raise ValueError(
                "--quantize int8 covers the flagship HierarchicalLstmModel "
                "+ MoeModel configuration"
            )
        import jax

        from efficientvideoclassification_youtube8m_tpu.ops.quantize import (
            quantize_hierarchical_params,
        )

        def prepare_params(params_student):
            return quantize_hierarchical_params(
                params_student, cfg.total_feature_size, cfg.lstm_cells,
                cfg.lstm_layers)

        # structure-only template: no device quantization of the
        # random init
        qtemplate = jax.eval_shape(prepare_params, template.params_student)
        if stacked_steps > 1:
            from efficientvideoclassification_youtube8m_tpu.parallel import (
                build_sharded_eval_step_stacked,
            )

            step_fn = build_sharded_eval_step_stacked(
                cfg, mesh, qtemplate, top_k=args.top_k,
                host_subsampled=True, quantized=True,
            )
        else:
            step_fn = build_sharded_quantized_eval_step(
                cfg, mesh, qtemplate, top_k=args.top_k, host_subsampled=True,
            )
    else:
        prepare_params = lambda p: p  # noqa: E731
        if stacked_steps > 1:
            from efficientvideoclassification_youtube8m_tpu.parallel import (
                build_sharded_eval_step_stacked,
            )

            step_fn = build_sharded_eval_step_stacked(
                cfg, mesh, template.params_student, top_k=args.top_k,
                host_subsampled=not aggregated, aggregated=aggregated,
            )
        else:
            step_fn = build_sharded_eval_step(
                cfg, mesh, template.params_student, top_k=args.top_k,
                # frame path: the loader strides frames at the parser
                host_subsampled=not aggregated, aggregated=aggregated,
            )
    writer = summary_lib.for_master(
        os.path.join(cfg.train_dir, "eval"), host.is_master
    )

    last_checkpoint = None
    while True:
        # master-elected so every host evaluates the SAME checkpoint
        ckpt = distributed.broadcast_str(
            latest_checkpoint(cfg.train_dir) if host.is_master else None
        )
        if ckpt is None:
            logger.info("No checkpoint yet in %s; waiting.", cfg.train_dir)
        elif ckpt != last_checkpoint:
            logger.info("Loading checkpoint for eval: %s", ckpt)
            state = place_fields(restore_checkpoint(ckpt, template), mesh,
                                 _PLACED)
            evaluation_loop(cfg, args, prepare_params(state.params_student),
                            int(np.asarray(state.global_step)), step_fn, mesh,
                            writer, host)
            last_checkpoint = ckpt
        if args.run_once:
            break
        time.sleep(30)
    writer.close()


def main(argv=None):
    flags_lib.setup_logging()
    enable_compilation_cache()
    parser = flags_lib.base_parser("Evaluate the finetuned student")
    parser.add_argument("--quantize", default="none",
                        choices=["none", "int8"],
                        help="int8: evaluate the quantized serving path "
                        "(ops/quantize.py) — the deploy-gate accuracy check")
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
