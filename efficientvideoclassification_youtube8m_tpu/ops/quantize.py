"""int8 quantized student inference path.

Serving is the paper's deliverable (`create_model_inference`,
/root/reference/code_student_uniform/frame_level_models.py:269-338), and
int8 x int8 -> int32 matmuls halve the weight bytes of the bf16 path.
This module provides a weight+activation int8 forward for the flagship
HierarchicalLstm student (and teacher):

  * weights: per-output-channel symmetric int8 (separate scales for the
    LSTM kernels' x-rows and h-rows — the two matmul sites see different
    input ranges — and per column of the MoE gates/experts);
  * activations: dynamic per-row symmetric int8 (the l2-normalized
    inputs and tanh-bounded h are well-conditioned for it);
  * accumulation: int32, rescaled to f32; all gate/softmax/
    sigmoid math stays f32 — the "keep gate math f32" recipe.

Exposed through `serving.Predictor(..., quantize="int8")`; accuracy is
pinned by tests/test_quantize.py (epoch Hit@1/GAP within +/-2e-3 of the
bf16 path on the learnable-synthetic eval).
"""

from __future__ import annotations

from typing import Any, Dict, List

import jax
import jax.numpy as jnp


def _weight_scale(w: jax.Array, axis: int = 0) -> jax.Array:
    """Symmetric per-output-channel scale: amax over the reduction axis."""
    s = jnp.max(jnp.abs(w), axis=axis) / 127.0
    return jnp.maximum(s, 1e-12).astype(jnp.float32)


def quantize_weight(w: jax.Array, axis: int = 0):
    scale = _weight_scale(w, axis)
    q = jnp.clip(jnp.round(w / jnp.expand_dims(scale, axis)), -127, 127)
    return q.astype(jnp.int8), scale


def _row_quant(x: jax.Array):
    """Dynamic per-row (last-axis) int8 activation quantization."""
    scale = jnp.maximum(
        jnp.max(jnp.abs(x), axis=-1, keepdims=True) / 127.0, 1e-12
    )
    q = jnp.clip(jnp.round(x / scale), -127, 127).astype(jnp.int8)
    return q, scale.astype(jnp.float32)


def int8_dot(x: jax.Array, w_q: jax.Array, w_scale: jax.Array) -> jax.Array:
    """f32 activations [..., D] x int8 weights [D, N] -> f32 [..., N]
    through an int8 x int8 -> int32 matmul."""
    x_q, x_scale = _row_quant(x)
    y = jax.lax.dot_general(
        x_q, w_q,
        dimension_numbers=(((x.ndim - 1,), (0,)), ((), ())),
        preferred_element_type=jnp.int32,
    )
    return y.astype(jnp.float32) * x_scale * w_scale


# --- LSTM ----------------------------------------------------------------

def quantize_lstm_cell(cell: Dict[str, jax.Array], input_size: int):
    """Split the TF-layout kernel [D+H, 4H] at the x/h row boundary and
    quantize each block per column — the two matmuls run separately
    (ops/lstm.py hoists the x projection) with different input ranges."""
    kernel = cell["kernel"]
    wx_q, wx_s = quantize_weight(kernel[:input_size])
    wh_q, wh_s = quantize_weight(kernel[input_size:])
    return {
        "wx_q": wx_q, "wx_scale": wx_s,
        "wh_q": wh_q, "wh_scale": wh_s,
        "bias": cell["bias"].astype(jnp.float32),
    }


def _quantized_lstm_layer_scan(qp, xs, seq_len, forget_bias: float = 1.0,
                               unroll: int = 1):
    """_lstm_layer_scan (ops/lstm.py:95-165) with both matmul sites on
    the int8 matmul path; gate math and carries stay f32."""
    B, T, D = xs.shape
    H = qp["wx_q"].shape[-1] // 4
    bias = qp["bias"]

    x_proj = int8_dot(xs.astype(jnp.float32), qp["wx_q"], qp["wx_scale"])
    # [B, T, 4H] f32; stored bf16 between the hoisted matmul and the
    # scan, like the bf16 path — it is the largest HBM tensor here
    x_proj = x_proj.astype(jnp.bfloat16)

    seq_len = seq_len.astype(jnp.int32)
    c0 = jnp.zeros((B, H), jnp.float32)
    h0 = jnp.zeros((B, H), jnp.float32)
    ts = jnp.arange(T, dtype=jnp.int32)

    def step(carry, inp):
        c, h = carry
        xp, t = inp
        gates = int8_dot(h, qp["wh_q"], qp["wh_scale"])
        gates = gates + xp.astype(jnp.float32) + bias
        i, j, f, o = jnp.split(gates, 4, axis=-1)
        new_c = (c * jax.nn.sigmoid(f + forget_bias)
                 + jax.nn.sigmoid(i) * jnp.tanh(j))
        new_h = jnp.tanh(new_c) * jax.nn.sigmoid(o)
        valid = (t < seq_len)[:, None]
        c = jnp.where(valid, new_c, c)
        h = jnp.where(valid, new_h, h)
        out = jnp.where(valid, new_h, 0.0)
        return (c, h), out

    (c_fin, h_fin), outs = jax.lax.scan(
        step, (c0, h0), (jnp.swapaxes(x_proj, 0, 1), ts), unroll=unroll
    )
    return jnp.swapaxes(outs, 0, 1), c_fin, h_fin


def quantized_multi_lstm_scan(qparams: List[dict], xs, seq_len,
                              forget_bias: float = 1.0, unroll: int = 1):
    """Stacked dynamic_rnn (ops/lstm.py:multi_lstm_scan) on the int8
    path; returns the [c0, h0, c1, h1] state layout."""
    state_parts = []
    layer_in = xs
    for qp in qparams:
        outs, c_fin, h_fin = _quantized_lstm_layer_scan(
            qp, layer_in, seq_len, forget_bias, unroll
        )
        state_parts.extend([c_fin, h_fin])
        layer_in = outs
    return jnp.concatenate(state_parts, axis=-1)


# --- MoE classifier ------------------------------------------------------

def quantize_moe(params: Dict[str, Any]):
    """[D, K, V]-layout MoE head (models/video_level.py:34-91): quantize
    the flattened [D, K*V] kernels per column."""
    D = params["gates"]["w"].shape[0]
    gq, gs = quantize_weight(params["gates"]["w"].reshape(D, -1))
    eq, es = quantize_weight(params["experts"]["w"].reshape(D, -1))
    return {
        "gates_q": gq, "gates_scale": gs,
        "experts_q": eq, "experts_scale": es,
        "experts_b": params["experts"]["b"].astype(jnp.float32),
    }


def quantized_moe_apply(qp, state, vocab_size: int, num_mixtures: int):
    gate_act = int8_dot(state, qp["gates_q"], qp["gates_scale"]).reshape(
        -1, num_mixtures + 1, vocab_size
    )
    expert_act = int8_dot(state, qp["experts_q"], qp["experts_scale"]).reshape(
        -1, num_mixtures, vocab_size
    ) + qp["experts_b"]
    gating = jax.nn.softmax(gate_act, axis=1)
    experts = jax.nn.sigmoid(expert_act)
    return jnp.sum(gating[:, :num_mixtures] * experts, axis=1)


# --- full student/teacher forward ----------------------------------------

def quantize_hierarchical_params(params: Dict[str, Any], input_size: int,
                                 lstm_cells: int, lstm_layers: int):
    """DistillState params subtree -> int8 param tree. Layer 0 of each
    level consumes the level input; deeper layers consume h [cells]."""
    state_dim = lstm_layers * 2 * lstm_cells
    def level(cells, in_size):
        sizes = [in_size] + [lstm_cells] * (len(cells) - 1)
        return [quantize_lstm_cell(c, s) for c, s in zip(cells, sizes)]

    return {
        "rnn_l1": level(params["rnn_l1"], input_size),
        "rnn_l2": level(params["rnn_l2"], state_dim),
        "classifier": quantize_moe(params["classifier"]),
    }


def quantized_hierarchical_forward(
    qparams, model_input: jax.Array, num_frames: jax.Array,
    num_chunks: int, vocab_size: int, num_mixtures: int,
    scan_unroll: int = 1,
):
    """HierarchicalLstmModel.apply (models/frame_level.py:70-151) with
    every matmul on the int8 path. Inference only (no dropout, no
    losses); returns predictions [B, vocab]."""
    B, T, D = model_input.shape
    assert T % num_chunks == 0, (T, num_chunks)
    chunk_len = T // num_chunks

    def scan(qp, xs, seq):
        return quantized_multi_lstm_scan(qp, xs, seq, unroll=scan_unroll)

    x_chunks = model_input.reshape(B * num_chunks, chunk_len, D)
    chunk_starts = chunk_len * jnp.arange(num_chunks, dtype=jnp.int32)
    seq_l1 = jnp.clip(
        num_frames.astype(jnp.int32)[:, None] - chunk_starts[None, :],
        0, chunk_len,
    ).reshape(B * num_chunks)
    l1_state = scan(qparams["rnn_l1"], x_chunks, seq_l1)

    l2_input = l1_state.reshape(B, num_chunks, -1)
    seq_l2 = jnp.ceil(
        num_frames.astype(jnp.float32) / float(chunk_len)
    ).astype(jnp.int32)
    state = scan(qparams["rnn_l2"], l2_input, seq_l2)
    return quantized_moe_apply(
        qparams["classifier"], state, vocab_size, num_mixtures
    )
