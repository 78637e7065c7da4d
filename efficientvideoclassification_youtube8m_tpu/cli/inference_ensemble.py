"""Ensemble inference: learned ensemble head over K prior prediction CSVs.

Rebuild of `/root/reference/code_student_uniform/inference_ensemble.py`:
streams test videos, assembles `old_predictions` [B, K, 4716] from K
sorted prediction CSVs keyed by video id (:155-191), runs an ensemble
head (video_level.py ensemble classes) on video-level features +
old_predictions, writes the Kaggle CSV.

The head checkpoint is a msgpack {"model": name, "params": pytree,
"input_size": int} written by cli/train_ensemble.py.
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
    PredictionStore,
    write_predictions_csv,
)
from efficientvideoclassification_youtube8m_tpu.models import get_model
from efficientvideoclassification_youtube8m_tpu.train.step import preprocess_batch
from efficientvideoclassification_youtube8m_tpu.train import serialization
from efficientvideoclassification_youtube8m_tpu.utils.compile_cache import (
    enable_compilation_cache,
)

logger = logging.getLogger("inference_ensemble")


def load_head(path: str):
    with open(path, "rb") as f:
        raw = serialization.msgpack_restore(f.read())
    # num_models absent in pre-r5 head checkpoints -> no K validation
    k = raw.get("num_models")
    return (raw["model"], raw["params"], int(raw["input_size"]),
            None if k is None else int(k))


def inference(args):
    import jax
    import jax.numpy as jnp

    cfg = flags_lib.config_from_args(args)
    head_name, head_params, head_input, head_k = load_head(
        args.head_checkpoint)
    head = get_model(head_name)
    logger.info("ensemble head: %s (input %d)", head_name, head_input)
    if head_input != cfg.total_feature_size:
        # fail with a one-liner here instead of an opaque XLA dot
        # dimension error inside the jitted run_head
        raise ValueError(
            f"head checkpoint {args.head_checkpoint!r} was trained on "
            f"input_size {head_input}, but --feature_names/"
            f"--feature_sizes describe {cfg.total_feature_size} features"
        )

    @jax.jit
    def run_head(params, features, old_predictions, num_frames):
        if features.dtype == jnp.uint8:
            # frame-level input: mean-pool the TRUE frames into a
            # video-level vector (padding is zeroed by preprocess_batch;
            # divide by num_frames, not max_frames)
            x = preprocess_batch(cfg, features, num_frames)
            denom = jnp.maximum(num_frames.astype(jnp.float32), 1.0)
            model_input = jnp.sum(x, axis=1) / denom[:, None]
        else:
            model_input = features
        out = head.apply(
            params,
            model_input,
            vocab_size=params_vocab,
            old_predictions=old_predictions,
        )
        return out["predictions"]

    loader_cls = FrameDataLoader if args.frame_features else AggregatedDataLoader
    loader_kwargs = dict(
        batch_size=cfg.batch_size,
        feature_names=cfg.feature_names_list,
        feature_sizes=cfg.feature_sizes_list,
        vocab_size=cfg.num_classes,
        num_readers=cfg.num_readers,
        deterministic=cfg.deterministic_input,
        num_epochs=1,
        shuffle=False,
        pad_final_batch=True,
    )
    if args.frame_features:
        loader_kwargs.update(max_frames=cfg.max_num_frames,
                             use_native=cfg.use_native_io)
    loader = loader_cls(args.input_data_pattern, **loader_kwargs)

    # the head's "vocab_size" is K for the weight-over-models heads
    store = PredictionStore(args.preds_pattern, cfg.num_classes)
    params_vocab = store.num_models
    if head_k is not None and head_k != store.num_models:
        raise ValueError(
            f"head checkpoint {args.head_checkpoint!r} was trained over "
            f"{head_k} prediction files, but --preds_pattern matches "
            f"{store.num_models}")

    def rows():
        num_examples_processed = 0
        start_time = time.time()
        for batch in loader:
            valid = len(batch.video_ids) - batch.pad
            old = store.assemble(batch.video_ids[:valid])
            if batch.pad:
                old = np.concatenate(
                    [old, np.zeros((batch.pad,) + old.shape[1:], old.dtype)]
                )
            nf = (batch.num_frames if args.frame_features
                  else np.ones(len(batch.video_ids), np.int32))
            preds = np.asarray(
                run_head(head_params, jnp.asarray(batch.features),
                         jnp.asarray(old), jnp.asarray(nf))
            )[:valid]
            num_examples_processed += valid
            logger.info("num examples processed: %d elapsed seconds: %.2f",
                        num_examples_processed, time.time() - start_time)
            yield from format_lines(batch.video_ids[:valid], preds, args.top_k)

    write_predictions_csv(args.output_file, rows())
    logger.info("Done with inference. The output file was written to %s",
                args.output_file)


def main(argv=None):
    flags_lib.setup_logging()
    enable_compilation_cache()
    parser = flags_lib.base_parser("Ensemble inference over prior CSVs")
    parser.add_argument("--output_file", required=True)
    parser.add_argument("--preds_pattern", required=True)
    parser.add_argument("--head_checkpoint", required=True)
    args = parser.parse_args(argv)
    flags_lib.dump_flags(args, logger)
    inference(args)


if __name__ == "__main__":
    main(sys.argv[1:])
