"""Ensemble-head trainer.

The reference trains its ensemble heads (video_level_models.py:227-373)
through the same train graph with an `old_predictions` input alongside
video-level features. This binary is that capability as a standalone
tool: train any registered video-level head on pre-aggregated Example
shards + K prior-prediction CSVs, then save a head checkpoint consumable
by cli/inference_ensemble.py.
"""

from __future__ import annotations

import logging
import os
import sys

import numpy as np

from efficientvideoclassification_youtube8m_tpu.cli import flags as flags_lib
from efficientvideoclassification_youtube8m_tpu.data import AggregatedDataLoader
from efficientvideoclassification_youtube8m_tpu.ensemble import PredictionStore
from efficientvideoclassification_youtube8m_tpu import losses as losses_lib
from efficientvideoclassification_youtube8m_tpu.models import get_model
from efficientvideoclassification_youtube8m_tpu.train.optimizer import (
    exponential_decay,
    make_optimizer,
)
from efficientvideoclassification_youtube8m_tpu.train import serialization
from efficientvideoclassification_youtube8m_tpu.utils.compile_cache import (
    enable_compilation_cache,
)

logger = logging.getLogger("train_ensemble")

# heads whose init/apply contract is (input_size, K-models) +
# old_predictions — the five reference ensemble heads
# (video_level_models.py:227-373). Plain video-level heads size their
# OUTPUT by vocab_size; passing num_models there builds a K-class head
# against num_classes labels, so reject them with a clear message.
ENSEMBLE_HEADS = (
    "LinearRegressionEnsemble",
    "SingleHiddenLayerEnsemble",
    "LinearRegressionWeightedMeanEnsemble",
    "LinearRegressionWeightedMeanEnsembleDifferenceLoss",
    "IndependentClassEnsemble",
)


def train_ensemble(args):
    import jax
    import jax.numpy as jnp

    cfg = flags_lib.config_from_args(args)
    if args.model not in ENSEMBLE_HEADS:
        raise ValueError(
            f"--model {args.model} is not an ensemble head; this binary "
            f"trains weight-over-models heads only: {ENSEMBLE_HEADS}")
    store = PredictionStore(args.preds_pattern, cfg.num_classes)
    num_models = store.num_models
    head = get_model(args.model)
    # the weight-over-models heads size their output by K (SURVEY §2.2)
    head_params = head.init(
        jax.random.PRNGKey(cfg.seed), cfg.total_feature_size, num_models,
        num_classes=cfg.num_classes,
    )
    optimizer = make_optimizer(cfg.optimizer, cfg.clip_gradient_norm)
    opt_state = optimizer.init(head_params)
    schedule = exponential_decay(
        cfg.base_learning_rate, cfg.batch_size,
        cfg.learning_rate_decay_examples, cfg.learning_rate_decay,
    )
    label_loss_fn = losses_lib.get_loss(cfg.label_loss)

    @jax.jit
    def step(params, opt_state, gstep, features, old_predictions, labels):
        def loss_fn(p):
            out = head.apply(
                p, features, vocab_size=num_models,
                old_predictions=old_predictions, labels=labels,
            )
            loss = out.get("loss")
            if loss is None:
                loss = label_loss_fn(out["predictions"], labels)
            elif loss.ndim > 0:
                loss = jnp.sum(loss)  # matrix-valued model losses train on sum
            reg = out.get("regularization_loss", 0.0)
            return loss + cfg.regularization_penalty * reg, out["predictions"]

        (loss, preds), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
        lr = schedule(gstep)
        new_params, new_opt = optimizer.update(grads, opt_state, params, lr)
        return new_params, new_opt, loss, preds

    gstep = 0  # host counter: the schedule takes it as a traced scalar,
    # and keeping it on the host avoids a device fetch per step
    for epoch in range(cfg.num_epochs or 1):
        loader = AggregatedDataLoader(
            cfg.train_data_pattern,
            batch_size=cfg.batch_size,
            feature_names=cfg.feature_names_list,
            feature_sizes=cfg.feature_sizes_list,
            vocab_size=cfg.num_classes,
            num_readers=cfg.num_readers,
            deterministic=cfg.deterministic_input,
            num_epochs=1,
            shuffle=True,
            seed=cfg.seed + epoch,
        )
        for batch in loader:
            old = store.assemble(batch.video_ids)
            head_params, opt_state, loss, _ = step(
                head_params, opt_state, jnp.asarray(gstep, jnp.int32),
                jnp.asarray(batch.features), jnp.asarray(old),
                jnp.asarray(batch.labels),
            )
            gstep += 1
            # float(loss) is a device sync; at a log cadence the host
            # batch assembly (PredictionStore.assemble) overlaps the
            # dispatched steps instead of serializing with every one
            if gstep % args.log_every == 0:
                logger.info("epoch %d step %d loss %.4f", epoch, gstep,
                            float(loss))

    os.makedirs(os.path.dirname(args.head_checkpoint) or ".", exist_ok=True)
    with open(args.head_checkpoint, "wb") as f:
        f.write(serialization.to_bytes({
            "model": args.model,
            "params": jax.device_get(head_params),
            "input_size": cfg.total_feature_size,
            # lets inference_ensemble reject a prediction-CSV count
            # mismatch with a clear message instead of an XLA shape error
            "num_models": num_models,
        }))
    logger.info("saved ensemble head to %s", args.head_checkpoint)


def main(argv=None):
    flags_lib.setup_logging()
    enable_compilation_cache()
    parser = flags_lib.base_parser("Train an ensemble head over K CSVs")
    parser.add_argument("--preds_pattern", required=True)
    parser.add_argument("--head_checkpoint", required=True)
    parser.add_argument("--log_every", type=int, default=10,
                        help="log (and device-sync) the loss every N steps")
    # replace base_parser's frame-level default only — an EXPLICIT
    # --model is validated (rejected if not an ensemble head), never
    # silently rewritten
    parser.set_defaults(model="LinearRegressionEnsemble")
    args = parser.parse_args(argv)
    flags_lib.dump_flags(args, logger)
    train_ensemble(args)


if __name__ == "__main__":
    main(sys.argv[1:])
