"""TF1-semantics LSTM as a `lax.scan`.

Reproduces the exact math of the reference's recurrent stack
(`/root/reference/code_student_uniform/frame_level_models.py:221-257`):
`tf.contrib.rnn.BasicLSTMCell(num_units, forget_bias=1.0, state_is_tuple=False)`
wrapped in `MultiRNNCell(state_is_tuple=False)` and driven by
`tf.nn.dynamic_rnn(..., sequence_length=...)`.

Semantics that must hold for parity (and are covered by tests):

  * Cell state is the concatenation ``[c, h]`` along the feature axis;
    the multi-layer state is the per-layer concatenation
    ``[c0, h0, c1, h1, ...]``.
  * Gate pre-activations are ``[x, h] @ W + b`` split in order
    ``i, j, f, o`` (input, new-input, forget, output).
  * ``new_c = c * sigmoid(f + forget_bias) + sigmoid(i) * tanh(j)``,
    ``new_h = tanh(new_c) * sigmoid(o)``.
  * `dynamic_rnn` sequence-length handling: for steps ``t >= seq_len`` the
    cell is skipped entirely — emitted output is zero and the carried state
    is frozen; a zero-length sequence yields the zero state.

Design notes:

  * The input projection ``x_t @ Wx`` for all timesteps is hoisted out of
    the scan into ONE large ``[B*T, D] @ [D, 4H]`` matmul; the scan body
    only performs the unavoidable recurrent ``h @ Wh`` matmul plus the
    elementwise gate math.
  * Layers run sequentially over the full sequence (exact for stacked
    LSTMs — no intra-step feedback), so each layer is again one hoisted
    matmul + one scan, instead of an interleaved per-step multi-layer cell.
  * Everything is static-shaped; sequence lengths enter only as masks.
"""

from __future__ import annotations

import math
from typing import Any, List, Sequence, Tuple

import jax
import jax.numpy as jnp

# A single cell's parameters mirror the TF variable layout so checkpoints
# line up one-to-one with the reference's
# `RNN_L*/multi_rnn_cell/cell_*/basic_lstm_cell/{kernel,bias}`:
#   kernel: [input_size + num_units, 4 * num_units]
#   bias:   [4 * num_units] (zero-initialized)
BasicLSTMCellParams = dict  # {"kernel": Array, "bias": Array}


def init_basic_lstm_cell(
    key: jax.Array, input_size: int, num_units: int, dtype: Any = jnp.float32
) -> BasicLSTMCellParams:
    """Glorot-uniform kernel (TF1.3 `_linear` default) + zero bias."""
    fan_in = input_size + num_units
    fan_out = 4 * num_units
    limit = math.sqrt(6.0 / (fan_in + fan_out))
    kernel = jax.random.uniform(
        key, (fan_in, fan_out), dtype=jnp.float32, minval=-limit, maxval=limit
    ).astype(dtype)
    bias = jnp.zeros((fan_out,), dtype=dtype)
    return {"kernel": kernel, "bias": bias}


def init_multi_lstm(
    key: jax.Array,
    input_size: int,
    num_units: int,
    num_layers: int,
    dtype: Any = jnp.float32,
) -> List[BasicLSTMCellParams]:
    """Stack of cells; layer 0 consumes the input, deeper layers consume h."""
    keys = jax.random.split(key, num_layers)
    sizes = [input_size] + [num_units] * (num_layers - 1)
    return [
        init_basic_lstm_cell(k, s, num_units, dtype) for k, s in zip(keys, sizes)
    ]


def lstm_cell_step(
    params: BasicLSTMCellParams,
    x: jax.Array,
    c: jax.Array,
    h: jax.Array,
    forget_bias: float = 1.0,
) -> Tuple[jax.Array, jax.Array]:
    """One unmasked BasicLSTMCell step. Used by parity tests; the scan path
    below inlines the same math with the input projection hoisted."""
    gates = jnp.concatenate([x, h], axis=-1) @ params["kernel"] + params["bias"]
    i, j, f, o = jnp.split(gates, 4, axis=-1)
    new_c = c * jax.nn.sigmoid(f + forget_bias) + jax.nn.sigmoid(i) * jnp.tanh(j)
    new_h = jnp.tanh(new_c) * jax.nn.sigmoid(o)
    return new_c, new_h


def _lstm_layer_scan(
    params: BasicLSTMCellParams,
    xs: jax.Array,  # [B, T, D]
    seq_len: jax.Array,  # [B] int
    forget_bias: float,
    compute_dtype: Any,
    unroll: int = 1,
) -> Tuple[jax.Array, jax.Array, jax.Array]:
    """Run one LSTM layer over a full sequence with dynamic_rnn masking.

    Returns (outputs [B, T, H], final_c [B, H], final_h [B, H]).
    """
    B, T, D = xs.shape
    H = params["kernel"].shape[-1] // 4
    # Accumulate in f32 unless running a float64 parity check.
    acc_dtype = jnp.float64 if compute_dtype == jnp.float64 else jnp.float32
    low_precision = compute_dtype == jnp.bfloat16
    w_x = params["kernel"][:D].astype(compute_dtype)
    w_h = params["kernel"][D:].astype(compute_dtype)
    bias = params["bias"].astype(acc_dtype)

    # Hoisted input projection: one large matmul for every timestep.
    # In bf16 mode the [B, T, 4H] intermediate is stored in bf16 — it is
    # the largest HBM tensor in the model (e.g. 1.26 GB/layer f32 for the
    # teacher L1) and its round-trip bounds the scan's bandwidth; the
    # bias is re-added in f32 inside the step.
    x_proj = jax.lax.dot_general(
        xs.astype(compute_dtype),
        w_x,
        dimension_numbers=(((2,), (0,)), ((), ())),
        preferred_element_type=compute_dtype if low_precision else acc_dtype,
    )
    if not low_precision:
        x_proj = x_proj + bias

    seq_len = seq_len.astype(jnp.int32)
    c0 = jnp.zeros((B, H), acc_dtype)
    h0 = jnp.zeros((B, H), acc_dtype)
    ts = jnp.arange(T, dtype=jnp.int32)

    def step(carry, inp):
        c, h = carry
        xp, t = inp
        gates = jax.lax.dot_general(
            h.astype(compute_dtype),
            w_h,
            dimension_numbers=(((1,), (0,)), ((), ())),
            preferred_element_type=acc_dtype,
        )
        if low_precision:
            gates = gates + xp.astype(acc_dtype) + bias
        else:
            gates = gates + xp
        i, j, f, o = jnp.split(gates, 4, axis=-1)
        new_c = c * jax.nn.sigmoid(f + forget_bias) + jax.nn.sigmoid(i) * jnp.tanh(j)
        new_h = jnp.tanh(new_c) * jax.nn.sigmoid(o)
        valid = (t < seq_len)[:, None]
        c = jnp.where(valid, new_c, c)
        h = jnp.where(valid, new_h, h)
        # per-step outputs only feed the next layer's (bf16) matmul, so
        # stack them in compute precision — halves the largest stacked
        # tensor's HBM traffic in bf16 mode ([T, B, H] per layer)
        out = jnp.where(valid, new_h, 0.0).astype(
            compute_dtype if low_precision else acc_dtype
        )
        return (c, h), out

    (c_fin, h_fin), outs = jax.lax.scan(
        step, (c0, h0), (jnp.swapaxes(x_proj, 0, 1), ts), unroll=unroll
    )
    return jnp.swapaxes(outs, 0, 1), c_fin, h_fin


def multi_lstm_scan(
    params: Sequence[BasicLSTMCellParams],
    xs: jax.Array,  # [B, T, D]
    seq_len: jax.Array,  # [B]
    forget_bias: float = 1.0,
    compute_dtype: Any = jnp.float32,
    return_outputs: bool = False,
    unroll: int = 1,
):
    """Stacked-LSTM `dynamic_rnn` over a full sequence.

    Returns the final state in the reference's `state_is_tuple=False` layout
    ``[c0, h0, c1, h1, ...]`` of shape [B, num_layers * 2H] — the tensor the
    reference uses as the distillation target
    (`/root/reference/code_student_uniform/train.py:359`). Optionally also
    returns the top layer's per-step outputs.
    """
    state_parts = []
    layer_in = xs
    outs = None
    for layer_params in params:
        outs, c_fin, h_fin = _lstm_layer_scan(
            layer_params, layer_in, seq_len, forget_bias, compute_dtype,
            unroll=unroll,
        )
        state_parts.extend([c_fin, h_fin])
        layer_in = outs
    final_state = jnp.concatenate(state_parts, axis=-1)
    if return_outputs:
        return final_state, outs
    return final_state
