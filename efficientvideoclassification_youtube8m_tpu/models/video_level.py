"""Video-level classifier heads.

Re-designs of every head in
`/root/reference/code_student_uniform/video_level_models.py` as pure
functions over explicit parameter pytrees. Each class carries
``init``/``apply`` staticmethods; `apply` returns a dict with
"predictions" [B, vocab] plus "regularization_loss" (the slim
weights/biases l2 regularizers the reference registers via
`slim.l2_regularizer`), and optionally "loss" when the head supplies its
own training loss.

All heads are one or two dense layers — single matrix products; the
MoE head's two [B, 4096] x [4096, ~14k] matmuls dominate
and are the natural tensor-parallel shard axis (see parallel/sharding).
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import jax
import jax.numpy as jnp

from efficientvideoclassification_youtube8m_tpu.models.base import (
    dense,
    dense_init,
    dropout,
    glorot_uniform,
    l2_loss,
    register_model,
)


@register_model("MoeModel")
class MoeModel:
    """Per-class softmax mixture of logistic experts (+ one dummy expert).

    Reference: video_level_models.py:394-448. gates = FC(input,
    vocab*(m+1), no bias); experts = FC(input, vocab*m). Softmax over the
    m+1 gates per (batch, class); sigmoid experts; prediction = sum of the
    first m gate*expert products.

    Layout note: the reference's weight columns interleave class-major
    (`reshape(-1, m+1)`), which would put the softmax/sigmoid on
    [B*vocab, m+1]-shaped tensors with a 3-wide minor axis. Weights
    here are stored [D, m(+1), vocab] so every elementwise op runs on
    [B, m, vocab] with the long class axis minor, and the math is
    exactly the reference's. A TF
    checkpoint column c*(m+1)+k maps to [:, k, c].
    """

    @staticmethod
    def init(key, input_size: int, vocab_size: int, num_mixtures: int = 2, **_):
        kg, ke = jax.random.split(key)
        # glorot fan-in/out matches the reference's 2-D [D, V*K] layout
        gates_w = glorot_uniform(
            kg, (input_size, vocab_size * (num_mixtures + 1))
        ).reshape(input_size, num_mixtures + 1, vocab_size)
        experts_w = glorot_uniform(
            ke, (input_size, vocab_size * num_mixtures)
        ).reshape(input_size, num_mixtures, vocab_size)
        return {
            "gates": {"w": gates_w},
            "experts": {
                "w": experts_w,
                "b": jnp.zeros((num_mixtures, vocab_size), jnp.float32),
            },
        }

    @staticmethod
    def apply(params, model_input, vocab_size: int, num_mixtures: int = 2,
              l2_penalty: float = 1e-8, compute_dtype=jnp.float32,
              **_) -> Dict[str, Any]:
        D = model_input.shape[-1]
        x = model_input.astype(compute_dtype)
        gate_act = jax.lax.dot_general(
            x, params["gates"]["w"].reshape(D, -1).astype(compute_dtype),
            dimension_numbers=(((1,), (0,)), ((), ())),
            preferred_element_type=jnp.float32,
        ).reshape(-1, num_mixtures + 1, vocab_size)
        expert_act = jax.lax.dot_general(
            x, params["experts"]["w"].reshape(D, -1).astype(compute_dtype),
            dimension_numbers=(((1,), (0,)), ((), ())),
            preferred_element_type=jnp.float32,
        ).reshape(-1, num_mixtures, vocab_size) + params["experts"]["b"]
        gating = jax.nn.softmax(gate_act, axis=1)  # [B, m+1, V]
        experts = jax.nn.sigmoid(expert_act)  # [B, m, V]
        predictions = jnp.sum(gating[:, :num_mixtures] * experts, axis=1)
        reg = l2_penalty * (l2_loss(params["gates"]["w"]) +
                            l2_loss(params["experts"]["w"]))
        return {"predictions": predictions, "regularization_loss": reg}


@register_model("LogisticModel")
class LogisticModel:
    """Sigmoid FC(vocab) with weight l2 (video_level_models.py:375-392)."""

    @staticmethod
    def init(key, input_size: int, vocab_size: int, **_):
        return {"fc": dense_init(key, input_size, vocab_size)}

    @staticmethod
    def apply(params, model_input, vocab_size: int, l2_penalty: float = 1e-8,
              **_) -> Dict[str, Any]:
        out = jax.nn.sigmoid(dense(params["fc"], model_input))
        reg = l2_penalty * l2_loss(params["fc"]["w"])
        return {"predictions": out, "regularization_loss": reg}


@register_model("SingleHiddenLayerModel")
class SingleHiddenLayerModel:
    """1024-sigmoid hidden -> sigmoid FC (video_level_models.py:21-45)."""

    @staticmethod
    def init(key, input_size: int, vocab_size: int, num_hidden_units: int = 1024, **_):
        k1, k2 = jax.random.split(key)
        return {
            "hidden": dense_init(k1, input_size, num_hidden_units),
            "out": dense_init(k2, num_hidden_units, vocab_size),
        }

    @staticmethod
    def apply(params, model_input, vocab_size: int, l2_penalty: float = 1e-7,
              **_) -> Dict[str, Any]:
        hidden = jax.nn.sigmoid(dense(params["hidden"], model_input))
        out = jax.nn.sigmoid(dense(params["out"], hidden))
        reg = (l2_penalty * (l2_loss(params["hidden"]["w"]) + l2_loss(params["out"]["w"]))
               + 1e-4 * l2_loss(params["hidden"]["b"])
               + 1e-3 * l2_loss(params["out"]["b"]))
        return {"predictions": out, "regularization_loss": reg}


@register_model("SingleHiddenLayerModelDropout")
class SingleHiddenLayerModelDropout:
    """Same, with keep-prob dropout between the layers
    (video_level_models.py:47-71)."""

    @staticmethod
    def init(key, input_size: int, vocab_size: int, num_hidden_units: int = 1024, **_):
        k1, k2 = jax.random.split(key)
        return {
            "hidden": dense_init(k1, input_size, num_hidden_units),
            "out": dense_init(k2, num_hidden_units, vocab_size),
        }

    @staticmethod
    def apply(params, model_input, vocab_size: int, l2_penalty: float = 1e-8,
              dropout_keep_prob=1.0, rng: Optional[jax.Array] = None,
              **_) -> Dict[str, Any]:
        hidden = jax.nn.sigmoid(dense(params["hidden"], model_input))
        if rng is not None:
            hidden = dropout(hidden, dropout_keep_prob, rng)
        out = jax.nn.sigmoid(dense(params["out"], hidden))
        reg = (l2_penalty * (l2_loss(params["hidden"]["w"]) + l2_loss(params["out"]["w"]))
               + 1e-4 * l2_loss(params["out"]["b"]))
        return {"predictions": out, "regularization_loss": reg}


@register_model("DoubleHiddenLayerModelDropout")
class DoubleHiddenLayerModelDropout:
    """2048-tanh -> dropout -> 1024-sigmoid -> sigmoid FC
    (video_level_models.py:73-96)."""

    @staticmethod
    def init(key, input_size: int, vocab_size: int, **_):
        k1, k2, k3 = jax.random.split(key, 3)
        return {
            "hidden1": dense_init(k1, input_size, 2048),
            "hidden2": dense_init(k2, 2048, 1024),
            "out": dense_init(k3, 1024, vocab_size),
        }

    @staticmethod
    def apply(params, model_input, vocab_size: int, l2_penalty: float = 1e-8,
              dropout_keep_prob=1.0, rng: Optional[jax.Array] = None,
              **_) -> Dict[str, Any]:
        hidden = jnp.tanh(dense(params["hidden1"], model_input))
        if rng is not None:
            hidden = dropout(hidden, dropout_keep_prob, rng)
        hidden = jax.nn.sigmoid(dense(params["hidden2"], hidden))
        out = jax.nn.sigmoid(dense(params["out"], hidden))
        reg = (l2_penalty * (l2_loss(params["hidden1"]["w"])
                             + l2_loss(params["hidden2"]["w"])
                             + l2_loss(params["out"]["w"]))
               + 1e-4 * l2_loss(params["out"]["b"]))
        return {"predictions": out, "regularization_loss": reg}


# Class-frequency bands of the 4716 YT8M classes and their per-band
# positive/negative CE weights (video_level_models.py:98-167).
_SPLIT_BANDS = (
    (0, 30, 1024, 1.0, 1.0),
    (30, 300, 512, 2.0, 0.25),
    (300, 1500, 256, 4.0, 0.1),
    (1500, 4716, 256, 10.0, 0.01),
)


@register_model("SplitSingleHiddenLayerModel")
class SplitSingleHiddenLayerModel:
    """Four per-frequency-band heads with a model-supplied weighted CE loss."""

    @staticmethod
    def init(key, input_size: int, vocab_size: int, **_):
        assert vocab_size == 4716, "band boundaries are defined for the 4716-class vocab"
        keys = jax.random.split(key, 2 * len(_SPLIT_BANDS))
        params = {}
        for bi, (lo, hi, hid, _, _) in enumerate(_SPLIT_BANDS):
            params[f"band{bi}"] = {
                "hidden": dense_init(keys[2 * bi], input_size, hid),
                "out": dense_init(keys[2 * bi + 1], hid, hi - lo),
            }
        return params

    @staticmethod
    def apply(params, model_input, vocab_size: int, labels=None,
              l2_penalty: float = 1e-7, **_) -> Dict[str, Any]:
        epsilon = 10e-6
        outputs, reg = [], 0.0
        loss = 0.0
        float_labels = None if labels is None else labels.astype(jnp.float32)
        for bi, (lo, hi, _, wpos, wneg) in enumerate(_SPLIT_BANDS):
            p = params[f"band{bi}"]
            hidden = jax.nn.sigmoid(dense(p["hidden"], model_input))
            out = jax.nn.sigmoid(dense(p["out"], hidden))
            outputs.append(out)
            reg += l2_penalty * (l2_loss(p["hidden"]["w"]) + l2_loss(p["out"]["w"]))
            if float_labels is not None:
                lab = float_labels[:, lo:hi]
                ce = wpos * lab * jnp.log(out + epsilon) + wneg * (1 - lab) * jnp.log(
                    1 - out + epsilon
                )
                loss = loss + jnp.sum(-ce, axis=1)
        result = {
            "predictions": jnp.concatenate(outputs, axis=1),
            "regularization_loss": reg,
        }
        if float_labels is not None:
            result["loss"] = jnp.mean(loss)
        return result


@register_model("ScaledSingleHiddenLayerModel")
class ScaledSingleHiddenLayerModel:
    """SingleHidden head whose outputs are min-max rescaled per row
    (video_level_models.py:169-197)."""

    @staticmethod
    def init(key, input_size: int, vocab_size: int, num_hidden_units: int = 1024, **_):
        return SingleHiddenLayerModel.init(
            key, input_size, vocab_size, num_hidden_units
        )

    @staticmethod
    def apply(params, model_input, vocab_size: int, l2_penalty: float = 1e-8,
              **_) -> Dict[str, Any]:
        hidden = jax.nn.sigmoid(dense(params["hidden"], model_input))
        out = jax.nn.sigmoid(dense(params["out"], hidden))
        o_max = jnp.max(out, axis=1, keepdims=True)
        o_min = jnp.min(out, axis=1, keepdims=True)
        out = (out - o_min) / (o_max - o_min)
        reg = (l2_penalty * (l2_loss(params["hidden"]["w"]) + l2_loss(params["out"]["w"]))
               + 1e-3 * l2_loss(params["out"]["b"]))
        return {"predictions": out, "regularization_loss": reg}


@register_model("SingleHiddenLayerResidualModel")
class SingleHiddenLayerResidualModel:
    """Splits the input at 6400 into features + logit-space old predictions,
    adds a tanh residual (video_level_models.py:199-225)."""

    SPLIT = 6400

    @staticmethod
    def init(key, input_size: int, vocab_size: int, num_hidden_units: int = 1024, **_):
        k1, k2 = jax.random.split(key)
        return {
            "hidden": dense_init(k1, SingleHiddenLayerResidualModel.SPLIT,
                                 num_hidden_units),
            "out": dense_init(k2, num_hidden_units, vocab_size),
        }

    @staticmethod
    def apply(params, model_input, vocab_size: int, l2_penalty: float = 1e-8,
              dropout_keep_prob=1.0, rng: Optional[jax.Array] = None,
              **_) -> Dict[str, Any]:
        split = SingleHiddenLayerResidualModel.SPLIT
        old_predictions = model_input[:, split:]
        features = model_input[:, :split]
        hidden = jax.nn.sigmoid(dense(params["hidden"], features))
        if rng is not None:
            hidden = dropout(hidden, dropout_keep_prob, rng)
        residual = jnp.tanh(dense(params["out"], hidden))
        out = jax.nn.sigmoid(residual + old_predictions)
        reg = (l2_penalty * (l2_loss(params["hidden"]["w"]) + l2_loss(params["out"]["w"]))
               + 1e-4 * l2_loss(params["out"]["b"]))
        return {"predictions": out, "regularization_loss": reg}


def _softmax_weighted_blend(weights_logits, old_predictions):
    """softmax over the K-model axis, then a weighted sum of old predictions.

    old_predictions: [B, K, vocab]; weights_logits: [B, K]."""
    weights = jax.nn.softmax(weights_logits, axis=-1)
    return jnp.sum(weights[:, :, None] * old_predictions, axis=1)


@register_model("LinearRegressionEnsemble")
class LinearRegressionEnsemble:
    """Learned per-video softmax weights over K stacked prior predictions
    (video_level_models.py:227-251). NOTE the reference sizes the weight
    layer by `vocab_size`, which the callers set to K (number of models)."""

    @staticmethod
    def init(key, input_size: int, vocab_size: int, **_):
        return {"weights": dense_init(key, input_size, vocab_size)}

    @staticmethod
    def apply(params, model_input, vocab_size: int, old_predictions=None,
              l2_penalty: float = 1e-8, **_) -> Dict[str, Any]:
        old_predictions = old_predictions[: model_input.shape[0]]
        logits = dense(params["weights"], model_input)
        out = _softmax_weighted_blend(logits, old_predictions)
        reg = l2_penalty * l2_loss(params["weights"]["w"])
        return {"predictions": out, "regularization_loss": reg}


@register_model("LinearRegressionWeightedMeanEnsemble")
class LinearRegressionWeightedMeanEnsemble:
    """Ensemble blend with a learned sigmoid-alpha mix toward the plain
    mean (video_level_models.py:253-281)."""

    @staticmethod
    def init(key, input_size: int, vocab_size: int, **_):
        return {
            "weights": dense_init(key, input_size, vocab_size),
            "alpha_logit": jnp.asarray(2.0, jnp.float32),
        }

    @staticmethod
    def apply(params, model_input, vocab_size: int, old_predictions=None,
              l2_penalty: float = 1e-8, **_) -> Dict[str, Any]:
        old_predictions = old_predictions[: model_input.shape[0]]
        logits = dense(params["weights"], model_input)
        out = _softmax_weighted_blend(logits, old_predictions)
        alpha = jax.nn.sigmoid(params["alpha_logit"])
        mean_pred = jnp.mean(old_predictions, axis=1)
        out = out * (1 - alpha) + mean_pred * alpha
        reg = l2_penalty * l2_loss(params["weights"]["w"])
        return {"predictions": out, "regularization_loss": reg}


@register_model("LinearRegressionWeightedMeanEnsembleDifferenceLoss")
class LinearRegressionWeightedMeanEnsembleDifferenceLoss:
    """WeightedMean ensemble plus a top-20-masked margin loss
    (video_level_models.py:283-317)."""

    @staticmethod
    def init(key, input_size: int, vocab_size: int, **_):
        return LinearRegressionWeightedMeanEnsemble.init(key, input_size, vocab_size)

    @staticmethod
    def apply(params, model_input, vocab_size: int, old_predictions=None,
              labels=None, l2_penalty: float = 1e-8, **_) -> Dict[str, Any]:
        # the blend is EXACTLY the WeightedMean head's; only the margin
        # loss below is added (video_level_models.py:283-317)
        result = LinearRegressionWeightedMeanEnsemble.apply(
            params, model_input, vocab_size,
            old_predictions=old_predictions, l2_penalty=l2_penalty)
        out = result["predictions"]
        mean_pred = jnp.mean(
            old_predictions[: model_input.shape[0]], axis=1)
        # the in-graph margin loss needs labels; inference
        # (cli/inference_ensemble.run_head) calls without them and only
        # reads the predictions — the reference always feeds labels
        # because its graph is train-only (video_level_models.py:283-317)
        if labels is not None:
            fl = labels.astype(jnp.float32)
            loss = -(out - mean_pred) * fl + (out - mean_pred) * (1 - fl)
            values = jax.lax.top_k(out, 20)[0][:, 19]
            mask = (out >= values[:, None]).astype(jnp.float32)
            result["loss"] = loss * mask
        return result


@register_model("IndependentClassEnsemble")
class IndependentClassEnsemble:
    """Per-(model, class) softmax weight table over the K-model axis
    (video_level_models.py:319-344)."""

    @staticmethod
    def init(key, input_size: int, vocab_size: int, num_classes: int = 4716, **_):
        return {"weights": jnp.ones((vocab_size, num_classes), jnp.float32)}

    @staticmethod
    def apply(params, model_input, vocab_size: int, old_predictions=None,
              **_) -> Dict[str, Any]:
        old_predictions = old_predictions[: model_input.shape[0]]
        mask = (old_predictions > 0).astype(jnp.float32)
        weights = mask * params["weights"][None, :, :]
        weights = jax.nn.softmax(weights, axis=1)
        out = jnp.sum(weights * old_predictions, axis=1)
        return {"predictions": out, "regularization_loss": jnp.asarray(0.0)}


@register_model("SingleHiddenLayerEnsemble")
class SingleHiddenLayerEnsemble:
    """512-sigmoid hidden -> softmax weights over K old predictions
    (video_level_models.py:346-373)."""

    @staticmethod
    def init(key, input_size: int, vocab_size: int, **_):
        k1, k2 = jax.random.split(key)
        return {
            "hidden": dense_init(k1, input_size, 512),
            "weights": dense_init(k2, 512, vocab_size),
        }

    @staticmethod
    def apply(params, model_input, vocab_size: int, old_predictions=None,
              l2_penalty: float = 1e-8, **_) -> Dict[str, Any]:
        old_predictions = old_predictions[: model_input.shape[0]]
        hidden = jax.nn.sigmoid(dense(params["hidden"], model_input))
        logits = dense(params["weights"], hidden)
        out = _softmax_weighted_blend(logits, old_predictions)
        reg = l2_penalty * (l2_loss(params["hidden"]["w"])
                            + l2_loss(params["weights"]["w"]))
        return {"predictions": out, "regularization_loss": reg}
