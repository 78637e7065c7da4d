"""Frame-level models.

Re-designs of `/root/reference/code_student_uniform/frame_level_models.py`
in JAX. The flagship is `HierarchicalLstmModel`: the reference runs 20
separate `dynamic_rnn` calls (one per 15-frame chunk) sharing one 2-layer
LSTM, stacks the 20 final states, and runs a second 2-layer LSTM over
them (frame_level_models.py:237-257).

Mapping: the 20 chunks are *folded into the batch axis* —
[B, 300, D] -> [B*20, 15, D] — so L1 is ONE 15-step scan whose per-step
recurrent matmul has batch B*20 (large matrix-unit tiles, and an
embarrassingly parallel axis that sequence-parallel sharding can split
across devices).
L2 is a single 20-step scan over the stacked chunk states.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional

import jax
import jax.numpy as jnp

from efficientvideoclassification_youtube8m_tpu.models.base import (
    dense,
    dense_init,
    get_model,
    l2_loss,
    register_model,
)
from efficientvideoclassification_youtube8m_tpu.ops.lstm import (
    init_multi_lstm,
    multi_lstm_scan,
)


@register_model("HierarchicalLstmModel")
class HierarchicalLstmModel:
    """Two-level hierarchical LSTM + a configurable video-level classifier.

    `apply` covers both the reference's `create_model` (teacher: 300
    frames, 20 chunks) and `create_model_inference` (student: 300//every_n
    frames, `num_inputs_l1` chunks) — same math, different static shapes.
    Returns {"state": [B, layers*2*cells], "predictions": [B, vocab], ...};
    "state" is the distillation target (train.py:359).
    """

    @staticmethod
    def init(
        key: jax.Array,
        input_size: int,
        vocab_size: int,
        lstm_cells: int = 1024,
        lstm_layers: int = 2,
        classifier: str = "MoeModel",
        classifier_kwargs: Optional[dict] = None,
        **_,
    ) -> Dict[str, Any]:
        k1, k2, k3 = jax.random.split(key, 3)
        state_dim = lstm_layers * 2 * lstm_cells
        cls = get_model(classifier)
        return {
            "rnn_l1": init_multi_lstm(k1, input_size, lstm_cells, lstm_layers),
            "rnn_l2": init_multi_lstm(k2, state_dim, lstm_cells, lstm_layers),
            "classifier": cls.init(
                k3, state_dim, vocab_size, **(classifier_kwargs or {})
            ),
        }

    @staticmethod
    def apply(
        params,
        model_input: jax.Array,  # [B, T, D]
        vocab_size: int,
        num_frames: jax.Array,  # [B] (already rescaled for the student)
        num_chunks: int = 20,
        classifier: str = "MoeModel",
        compute_dtype: Any = jnp.float32,
        labels: Optional[jax.Array] = None,
        dropout_keep_prob=1.0,
        rng: Optional[jax.Array] = None,
        scan_unroll: int = 1,
        **classifier_kwargs,
    ) -> Dict[str, Any]:
        B, T, D = model_input.shape
        assert T % num_chunks == 0, (T, num_chunks)
        chunk_len = T // num_chunks

        def scan_fn(p, xs, seq):
            return multi_lstm_scan(
                p, xs, seq, compute_dtype=compute_dtype, unroll=scan_unroll,
            )

        # L1: fold chunks into the batch axis -> one shared-weight scan.
        x_chunks = model_input.reshape(B * num_chunks, chunk_len, D)
        chunk_starts = chunk_len * jnp.arange(num_chunks, dtype=jnp.int32)
        seq_l1 = jnp.clip(
            num_frames.astype(jnp.int32)[:, None] - chunk_starts[None, :],
            0,
            chunk_len,
        ).reshape(B * num_chunks)
        l1_state = scan_fn(params["rnn_l1"], x_chunks, seq_l1)
        # [B*num_chunks, layers*2*cells]

        # L2: scan over the per-chunk final states.
        l2_input = l1_state.reshape(B, num_chunks, -1).astype(jnp.float32)
        seq_l2 = jnp.ceil(
            num_frames.astype(jnp.float32) / float(chunk_len)
        ).astype(jnp.int32)
        state = scan_fn(params["rnn_l2"], l2_input, seq_l2)
        # [B, layers*2*cells]

        cls = get_model(classifier)
        result = cls.apply(
            params["classifier"],
            state,
            vocab_size=vocab_size,
            labels=labels,
            dropout_keep_prob=dropout_keep_prob,
            rng=rng,
            compute_dtype=compute_dtype,
            **classifier_kwargs,
        )
        result["state"] = state
        return result


@register_model("FrameLevelLogisticModel")
class FrameLevelLogisticModel:
    """Mean-pool over true frames -> sigmoid FC
    (frame_level_models.py:50-83)."""

    @staticmethod
    def init(key, input_size: int, vocab_size: int, **_):
        return {"fc": dense_init(key, input_size, vocab_size)}

    @staticmethod
    def apply(params, model_input, vocab_size: int, num_frames=None,
              l2_penalty: float = 1e-8, **_) -> Dict[str, Any]:
        denom = num_frames.astype(jnp.float32)[:, None]
        avg_pooled = jnp.sum(model_input, axis=1) / denom
        out = jax.nn.sigmoid(dense(params["fc"], avg_pooled))
        reg = l2_penalty * l2_loss(params["fc"]["w"])
        return {"predictions": out, "regularization_loss": reg}


def sample_random_frames(model_input, num_frames, num_samples: int, rng):
    """Uniform random frame indices below num_frames
    (model_utils.py:39-58)."""
    B = model_input.shape[0]
    u = jax.random.uniform(rng, (B, num_samples))
    frame_index = (u * num_frames.astype(jnp.float32)[:, None]).astype(jnp.int32)
    return jnp.take_along_axis(model_input, frame_index[:, :, None], axis=1)


def sample_random_sequence(model_input, num_frames, num_samples: int, rng):
    """Random contiguous window of num_samples frames
    (model_utils.py:11-36)."""
    B = model_input.shape[0]
    offsets = jnp.arange(num_samples, dtype=jnp.int32)[None, :]
    max_start = jnp.maximum(num_frames.astype(jnp.int32) - num_samples, 0)
    u = jax.random.uniform(rng, (B, 1))
    start = (u * (max_start + 1).astype(jnp.float32)[:, None]).astype(jnp.int32)
    frame_index = jnp.minimum(
        start + offsets, num_frames.astype(jnp.int32)[:, None] - 1
    )
    return jnp.take_along_axis(model_input, frame_index[:, :, None], axis=1)


def sample_even_frames(model_input, num_frames, num_samples: int):
    """Deterministic evenly-spaced frame indices strictly below num_frames —
    the eval-time counterpart of sample_random_frames (the reference samples
    randomly at eval too, model_utils.py:39-58; here eval is deterministic).
    Crucially the indices never reach padding rows, which matters for models
    that pool over all sampled frames (DBoF): padded rows stop being zero
    after batch norm and would contaminate max/average pooling."""
    u = (jnp.arange(num_samples, dtype=jnp.float32) + 0.5) / num_samples
    frame_index = (
        u[None, :] * num_frames.astype(jnp.float32)[:, None]
    ).astype(jnp.int32)
    return jnp.take_along_axis(model_input, frame_index[:, :, None], axis=1)


def frame_pooling(frames, method: str):
    """average/max/none pooling over the frame axis (model_utils.py:60-83)."""
    if method == "average":
        return jnp.mean(frames, axis=1)
    if method == "max":
        return jnp.max(frames, axis=1)
    if method == "none":
        return frames.reshape(-1, frames.shape[2])
    raise ValueError(f"Unrecognized pooling method: {method}")


def _bn_init(dim: int):
    return {
        "scale": jnp.ones((dim,), jnp.float32),
        "offset": jnp.zeros((dim,), jnp.float32),
        "moving_mean": jnp.zeros((dim,), jnp.float32),
        "moving_var": jnp.ones((dim,), jnp.float32),
    }


def _bn_apply(p, x, is_training: bool, momentum: float = 0.999,
              eps: float = 1e-3, axis_name=None):
    """slim.batch_norm semantics: batch stats in training (moving averages
    updated with `momentum` decay), moving stats at inference. Returns
    (normalized, updated_bn_params).

    With `axis_name` (synced cross-shard BN under shard_map), the batch
    moments are pmean'd over the data axis so normalization — and hence
    gradients and moving averages — match a single program over the
    global batch exactly (equal shard sizes hold by construction)."""
    if is_training:
        if axis_name is not None:
            mean = jax.lax.pmean(jnp.mean(x, axis=0), axis_name)
            mean_sq = jax.lax.pmean(jnp.mean(jnp.square(x), axis=0), axis_name)
            var = mean_sq - jnp.square(mean)
        else:
            mean = jnp.mean(x, axis=0)
            var = jnp.var(x, axis=0)
        new_p = dict(
            p,
            moving_mean=momentum * p["moving_mean"] + (1 - momentum) * mean,
            moving_var=momentum * p["moving_var"] + (1 - momentum) * var,
        )
    else:
        mean, var = p["moving_mean"], p["moving_var"]
        new_p = p
    inv = jax.lax.rsqrt(var + eps)
    return (x - mean) * inv * p["scale"] + p["offset"], new_p


@register_model("DbofModel")
class DbofModel:
    """Deep Bag-of-Frames (frame_level_models.py:85-195): sample frames,
    BN -> cluster FC -> relu6 -> frame pooling -> hidden FC -> relu6 ->
    video-level classifier. BN moving averages ride along in the params
    pytree; `apply` returns the updated copy under "updated_params"."""

    @staticmethod
    def init(key, input_size: int, vocab_size: int, cluster_size: int = 8192,
             hidden_size: int = 1024, classifier: str = "MoeModel",
             add_batch_norm: bool = True,
             classifier_kwargs: Optional[dict] = None, **_):
        k1, k2, k3, k4, k5 = jax.random.split(key, 5)
        cls = get_model(classifier)
        params = {
            "cluster": {
                "w": (1.0 / math.sqrt(input_size))
                * jax.random.normal(k1, (input_size, cluster_size))
            },
            "hidden1": {
                "w": (1.0 / math.sqrt(cluster_size))
                * jax.random.normal(k2, (cluster_size, hidden_size))
            },
            "classifier": cls.init(
                k3, hidden_size, vocab_size, **(classifier_kwargs or {})
            ),
        }
        if add_batch_norm:
            params["input_bn"] = _bn_init(input_size)
            params["cluster_bn"] = _bn_init(cluster_size)
            params["hidden1_bn"] = _bn_init(hidden_size)
        else:
            # no-BN variant (frame_level_models.py:150-162,175-187):
            # biases replace the norms; reference stddevs kept.
            params["cluster"]["b"] = (1.0 / math.sqrt(input_size)) * (
                jax.random.normal(k4, (cluster_size,))
            )
            params["hidden1"]["b"] = 0.01 * jax.random.normal(
                k5, (hidden_size,)
            )
        return params

    @staticmethod
    def apply(params, model_input, vocab_size: int, num_frames=None,
              iterations: int = 30, sample_random: bool = True,
              pooling_method: str = "max", classifier: str = "MoeModel",
              add_batch_norm: bool = True,
              is_training: bool = True, rng: Optional[jax.Array] = None,
              bn_axis_name=None,
              **classifier_kwargs) -> Dict[str, Any]:
        # the classifier head gets its own dropout key (the reference
        # plumbs `dropout` into every head, frame_level_models.py:192-196
        # via **unused_params); fold_in keeps the SAMPLING stream on the
        # original key so recorded sampling behavior is unchanged
        cls_rng = None if rng is None else jax.random.fold_in(rng, 1)
        if rng is not None:
            sampler = sample_random_frames if sample_random else sample_random_sequence
            model_input = sampler(model_input, num_frames, iterations, rng)
        elif num_frames is not None:
            # eval/inference: deterministic sampling, still strictly below
            # num_frames so the pooled window never includes padding rows
            model_input = sample_even_frames(model_input, num_frames, iterations)
        max_frames = model_input.shape[1]
        feature_size = model_input.shape[2]
        x = model_input.reshape(-1, feature_size)

        updated = dict(params)
        if add_batch_norm:
            x, updated["input_bn"] = _bn_apply(params["input_bn"], x, is_training,
                                               axis_name=bn_axis_name)
        act = dense(params["cluster"], x)
        if add_batch_norm:
            act, updated["cluster_bn"] = _bn_apply(params["cluster_bn"], act,
                                                   is_training,
                                                   axis_name=bn_axis_name)
        act = jnp.clip(act, 0.0, 6.0)  # relu6
        act = act.reshape(-1, max_frames, act.shape[-1])
        act = frame_pooling(act, pooling_method)
        act = dense(params["hidden1"], act)
        if add_batch_norm:
            act, updated["hidden1_bn"] = _bn_apply(params["hidden1_bn"], act,
                                                   is_training,
                                                   axis_name=bn_axis_name)
        act = jnp.clip(act, 0.0, 6.0)

        cls = get_model(classifier)
        result = cls.apply(
            params["classifier"], act, vocab_size=vocab_size, rng=cls_rng,
            **classifier_kwargs
        )
        result["updated_params"] = updated
        return result


def _frame_mask(num_frames, T: int):
    """[B, T, 1] float mask of true frames."""
    t = jnp.arange(T, dtype=jnp.int32)[None, :]
    return (t < num_frames.astype(jnp.int32)[:, None]).astype(jnp.float32)[
        :, :, None
    ]


@register_model("NetVLADModel")
class NetVLADModel:
    """NetVLAD aggregation (the reference declares this "Upcoming" and
    stubs it, frame_level_models.py:341-347 — implemented here for real).

    Soft-assign each frame to K learned clusters, aggregate assignment-
    weighted residuals against the cluster centers, intra-normalize per
    cluster, flatten + l2-normalize, hidden FC, video-level classifier.
    Frames past num_frames are masked out of the assignment. Everything
    is batched matmuls/einsums.
    """

    @staticmethod
    def init(key, input_size: int, vocab_size: int, vlad_clusters: int = 64,
             hidden_size: int = 1024, classifier: str = "MoeModel",
             classifier_kwargs: Optional[dict] = None, **_):
        k1, k2, k3, k4 = jax.random.split(key, 4)
        cls = get_model(classifier)
        return {
            "assign": dense_init(k1, input_size, vlad_clusters),
            "centers": (1.0 / math.sqrt(input_size))
            * jax.random.normal(k2, (vlad_clusters, input_size)),
            "hidden": dense_init(k3, vlad_clusters * input_size, hidden_size),
            "classifier": cls.init(
                k4, hidden_size, vocab_size, **(classifier_kwargs or {})
            ),
        }

    @staticmethod
    def apply(params, model_input, vocab_size: int, num_frames=None,
              classifier: str = "MoeModel", l2_penalty: float = 1e-8,
              **classifier_kwargs) -> Dict[str, Any]:
        B, T, D = model_input.shape
        K = params["centers"].shape[0]
        mask = _frame_mask(num_frames, T)  # [B, T, 1]
        assign = jax.nn.softmax(dense(params["assign"], model_input), axis=-1)
        assign = assign * mask  # [B, T, K]

        # vlad[b,k,d] = sum_t a[b,t,k] x[b,t,d] - (sum_t a[b,t,k]) c[k,d]
        weighted = jnp.einsum("btk,btd->bkd", assign, model_input)
        a_sum = jnp.sum(assign, axis=1)  # [B, K]
        vlad = weighted - a_sum[:, :, None] * params["centers"][None]
        # intra-normalization per cluster, then global l2 over the flat code
        vlad = vlad * jax.lax.rsqrt(
            jnp.maximum(jnp.sum(vlad * vlad, axis=2, keepdims=True), 1e-12)
        )
        flat = vlad.reshape(B, K * D)
        flat = flat * jax.lax.rsqrt(
            jnp.maximum(jnp.sum(flat * flat, axis=1, keepdims=True), 1e-12)
        )
        act = jax.nn.relu(dense(params["hidden"], flat))

        cls = get_model(classifier)
        result = cls.apply(params["classifier"], act, vocab_size=vocab_size,
                           **classifier_kwargs)
        reg = result.get("regularization_loss", 0.0) + l2_penalty * (
            l2_loss(params["assign"]["w"]) + l2_loss(params["hidden"]["w"])
        )
        result["regularization_loss"] = reg
        return result


@register_model("NeXtVLADModel")
class NeXtVLADModel:
    """NeXtVLAD (Lin et al. 2018) — grouped, attention-gated NetVLAD
    (the reference stubs it, frame_level_models.py:349-355).

    Expand D -> lambda*D, split into G groups, per-(frame,group) sigmoid
    attention, shared soft-assignment over K clusters, aggregate grouped
    residuals -> [K, lambda*D/G] code, intra-norm, flatten, hidden FC.
    """

    @staticmethod
    def init(key, input_size: int, vocab_size: int, vlad_clusters: int = 64,
             expansion: int = 2, groups: int = 8, hidden_size: int = 1024,
             classifier: str = "MoeModel",
             classifier_kwargs: Optional[dict] = None, **_):
        assert (expansion * input_size) % groups == 0
        k1, k2, k3, k4, k5, k6 = jax.random.split(key, 6)
        expanded = expansion * input_size
        group_dim = expanded // groups
        cls = get_model(classifier)
        return {
            "expand": dense_init(k1, input_size, expanded),
            "attention": dense_init(k2, expanded, groups),
            "assign": dense_init(k3, expanded, groups * vlad_clusters),
            "centers": (1.0 / math.sqrt(group_dim))
            * jax.random.normal(k4, (vlad_clusters, group_dim)),
            "hidden": dense_init(k5, vlad_clusters * group_dim, hidden_size),
            "classifier": cls.init(
                k6, hidden_size, vocab_size, **(classifier_kwargs or {})
            ),
        }

    @staticmethod
    def apply(params, model_input, vocab_size: int, num_frames=None,
              groups: int = 8, classifier: str = "MoeModel",
              l2_penalty: float = 1e-8, **classifier_kwargs) -> Dict[str, Any]:
        B, T, D = model_input.shape
        K = params["centers"].shape[0]
        mask = _frame_mask(num_frames, T)  # [B, T, 1]

        x = dense(params["expand"], model_input)  # [B, T, E]
        E = x.shape[-1]
        G = groups
        gd = E // G
        attn = jax.nn.sigmoid(dense(params["attention"], x)) * mask  # [B,T,G]
        assign = jax.nn.softmax(
            dense(params["assign"], x).reshape(B, T, G, K), axis=-1
        )
        a = assign * attn[:, :, :, None]  # [B, T, G, K]

        xg = x.reshape(B, T, G, gd)
        weighted = jnp.einsum("btgk,btgd->bkd", a, xg)
        a_sum = jnp.sum(a, axis=(1, 2))  # [B, K]
        vlad = weighted - a_sum[:, :, None] * params["centers"][None]
        vlad = vlad * jax.lax.rsqrt(
            jnp.maximum(jnp.sum(vlad * vlad, axis=2, keepdims=True), 1e-12)
        )
        flat = vlad.reshape(B, K * gd)
        flat = flat * jax.lax.rsqrt(
            jnp.maximum(jnp.sum(flat * flat, axis=1, keepdims=True), 1e-12)
        )
        act = jax.nn.relu(dense(params["hidden"], flat))

        cls = get_model(classifier)
        result = cls.apply(params["classifier"], act, vocab_size=vocab_size,
                           **classifier_kwargs)
        reg = result.get("regularization_loss", 0.0) + l2_penalty * (
            l2_loss(params["expand"]["w"]) + l2_loss(params["assign"]["w"])
            + l2_loss(params["hidden"]["w"])
        )
        result["regularization_loss"] = reg
        return result
