"""Inference: student checkpoint -> Kaggle CSV.

The core of the reference's inference binaries
(`inference_ensemble.py:113-204` minus the ensemble feed): stream test
shards, run the model, write `VideoId,LabelConfidencePairs` top-k rows.

--alpha_bias/--tensor_name reproduce `inference_bias.py:129,158-168`:
before running, the named bias parameter b is replaced by
`b/alpha + mean(b - b/alpha)`.
"""

from __future__ import annotations

import logging
import sys
import time

import numpy as np

from efficientvideoclassification_youtube8m_tpu.cli import flags as flags_lib
from efficientvideoclassification_youtube8m_tpu.data import (
    AggregatedDataLoader,
    FrameDataLoader,
)
from efficientvideoclassification_youtube8m_tpu.ensemble import (
    format_lines,
    format_ranked_lines,
    write_predictions_csv,
)
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

logger = logging.getLogger("infer")


def rescale_bias_param(params, tensor_path: str, alpha: float):
    """new = old/alpha + mean(old - old/alpha) (inference_bias.py:158-161),
    addressed by a '/'-joined path into the params pytree."""
    # params pytrees here are dicts and lists only (ops/lstm.py cell
    # lists of {"kernel","bias"} dicts; classifier dicts) — tuples would
    # not support the item assignment below anyway
    keys = [k for k in tensor_path.split("/") if k]
    node = params
    for k in keys[:-1]:
        node = node[int(k)] if isinstance(node, list) else node[k]
    leaf_key = keys[-1]
    old = np.asarray(node[int(leaf_key)] if isinstance(node, list)
                     else node[leaf_key])
    scaled = old / alpha
    new = scaled + np.mean(old - scaled)
    import jax.numpy as jnp

    if isinstance(node, list):
        node[int(leaf_key)] = jnp.asarray(new)
    else:
        node[leaf_key] = jnp.asarray(new)
    return params


def inference(args):
    from efficientvideoclassification_youtube8m_tpu.parallel import (
        build_sharded_eval_step,
        create_mesh,
        distributed,
        shard_batch,
    )

    cfg = flags_lib.config_from_args(args)
    optimizer = make_optimizer(cfg.optimizer, cfg.clip_gradient_norm)
    template = student_state_from_distill(
        init_distill_state(cfg, optimizer), optimizer
    )
    ckpt = latest_checkpoint(cfg.train_dir)
    if ckpt is None:
        raise IOError(f"unable to find a checkpoint at location: {cfg.train_dir}")
    logger.info("restoring variables from %s", ckpt)
    state = restore_checkpoint(ckpt, template)
    params = state.params_student
    if args.tensor_name:
        logger.info("rescaling bias %s by alpha=%s", args.tensor_name,
                    args.alpha_bias)
        params = rescale_bias_param(params, args.tensor_name, args.alpha_bias)

    mesh = create_mesh(model=args.model_parallelism)
    # --frame_features=False selects the aggregated reader like
    # inference_bias.py:195-199; frame path strides frames on the host
    # (1/every_n the H2D bytes)
    aggregated = not args.frame_features
    # ONE clamp shared by the builder choice and the rows() loop below.
    # Unlike cli.eval/validate there is NO auto mode here: the stacked
    # path emits rows from the DEVICE top-k, whose probability-tie
    # ordering can differ from the K=1 host top-k — changing the default
    # would change CSV outputs, so K>1 stays an explicit opt-in.
    if getattr(args, "steps_per_dispatch", 1) == 0:
        logger.info("steps_per_dispatch=0 (auto) is not applied to "
                    "inference (device-top-k tie order differs from the "
                    "host path); using 1 — pass an explicit K to opt in")
    steps = max(1, getattr(args, "steps_per_dispatch", 1))
    args.steps_per_dispatch = steps
    if getattr(args, "quantize", "none") == "int8":
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
        from efficientvideoclassification_youtube8m_tpu.ops.quantize import (
            quantize_hierarchical_params,
        )
        from efficientvideoclassification_youtube8m_tpu.parallel import (
            build_sharded_quantized_eval_step,
        )

        params = quantize_hierarchical_params(
            params, cfg.total_feature_size, cfg.lstm_cells, cfg.lstm_layers)
        if steps > 1:
            from efficientvideoclassification_youtube8m_tpu.parallel import (
                build_sharded_eval_step_stacked,
            )

            step_fn = build_sharded_eval_step_stacked(
                cfg, mesh, params, top_k=args.top_k, host_subsampled=True,
                quantized=True)
        else:
            step_fn = build_sharded_quantized_eval_step(
                cfg, mesh, params, top_k=args.top_k, host_subsampled=True)
    elif steps > 1:
        from efficientvideoclassification_youtube8m_tpu.parallel import (
            build_sharded_eval_step_stacked,
        )

        step_fn = build_sharded_eval_step_stacked(
            cfg, mesh, params, top_k=args.top_k,
            host_subsampled=not aggregated, aggregated=aggregated)
    else:
        step_fn = build_sharded_eval_step(cfg, mesh, params, top_k=args.top_k,
                                          host_subsampled=not aggregated,
                                          aggregated=aggregated)

    loader_cls = AggregatedDataLoader if aggregated else FrameDataLoader
    loader = loader_cls(
        args.input_data_pattern,
        batch_size=cfg.batch_size,
        feature_names=cfg.feature_names_list,
        feature_sizes=cfg.feature_sizes_list,
        max_frames=cfg.max_num_frames,
        vocab_size=cfg.num_classes,
        num_readers=cfg.num_readers,
        deterministic=cfg.deterministic_input,
        num_epochs=1,
        shuffle=False,
        pad_final_batch=True,
        use_native=cfg.use_native_io,
        # frame path: parse/move only the kept frames
        frame_stride=1 if aggregated else cfg.every_n,
    )

    def rows():
        from collections import deque

        num_examples_processed = 0
        start_time = time.time()
        dummy_labels = np.zeros((cfg.batch_size, cfg.num_classes), bool)
        # lag-N ring (like cli.eval): keep several launches in flight,
        # pull only the oldest result — dispatch + D2H latency overlaps
        # device compute; FIFO drain keeps CSV row order identical
        ring: deque = deque()
        depth = max(1, getattr(cfg, "fetch_depth", 4))

        def progress(valid):
            nonlocal num_examples_processed
            num_examples_processed += valid
            logger.info(
                "num examples processed: %d elapsed seconds: %.2f",
                num_examples_processed, time.time() - start_time,
            )

        if steps > 1:
            # K batches per launch; rows come from the packed buffer's
            # DEVICE top-k ((2k+2)*4 bytes/row fetched instead of the
            # full [B, vocab] predictions). lax.top_k breaks probability
            # ties by lowest class index; the K=1 path's np.argpartition
            # can order/select tied entries differently — lines are
            # identical wherever the top-k probabilities are distinct.
            def emit(packs, metas):
                pack = np.asarray(packs)
                for i, (vids, pad) in enumerate(metas):
                    valid = len(vids) - pad
                    fields = distributed.unpack_host_pack(
                        pack[i, :valid], None)
                    progress(valid)
                    # device lax.top_k rows arrive pre-sorted; the row
                    # format is owned by ensemble.format_ranked_lines
                    yield from format_ranked_lines(
                        vids[:valid], fields["topk_idx"],
                        fields["topk_val"])

            def launch(bufs):
                metas = [(b.video_ids, b.pad) for b in bufs]
                dev = distributed.stack_batches(
                    mesh, bufs, steps, dummy_labels=dummy_labels)
                return step_fn(params, *dev), metas

            for packs, metas in distributed.stacked_ring(
                    loader, steps, depth, launch):
                yield from emit(packs, metas)
        else:
            def emit(out, vids, pad):
                valid = len(vids) - pad
                preds = np.asarray(out["predictions"])[:valid]
                progress(valid)
                yield from format_lines(vids[:valid], preds, args.top_k)

            for batch in loader:
                f, l, n = shard_batch(mesh, batch.features, dummy_labels,
                                      batch.num_frames)
                ring.append(
                    (step_fn(params, f, l, n), batch.video_ids, batch.pad))
                if len(ring) > depth:
                    yield from emit(*ring.popleft())
            while ring:
                yield from emit(*ring.popleft())

    write_predictions_csv(args.output_file, rows())
    logger.info("Done with inference. The output file was written to %s",
                args.output_file)


def main(argv=None):
    flags_lib.setup_logging()
    enable_compilation_cache()
    parser = flags_lib.base_parser("Inference: checkpoint -> Kaggle CSV")
    parser.add_argument("--output_file", required=True)
    parser.add_argument("--tensor_name", default="",
                        help="params path for bias rescaling, e.g. "
                        "classifier/experts/b")
    parser.add_argument("--alpha_bias", type=float, default=1.0)
    parser.add_argument("--quantize", default="none",
                        choices=["none", "int8"],
                        help="int8: serve the quantized student path")
    parser.add_argument("--steps_per_dispatch", type=int, default=1,
                        help="K>1: scan K batches per device launch and "
                        "build rows from the DEVICE top-k (tiny packed "
                        "fetch instead of full [B, vocab] predictions) — "
                        "big win on high-latency/low-bandwidth links. "
                        "Probability ties may order differently than the "
                        "K=1 host top-k")
    args = parser.parse_args(argv)
    flags_lib.dump_flags(args, logger)
    inference(args)


if __name__ == "__main__":
    main(sys.argv[1:])
