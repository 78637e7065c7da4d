"""Parity tests for the TF1-semantics LSTM scan.

The oracle is a straight-line NumPy transcription of TF 1.3's
`BasicLSTMCell.__call__` (gate order i, j, f, o; forget_bias added inside
the sigmoid), `MultiRNNCell` with `state_is_tuple=False` (per-layer
[c, h] concat), and `dynamic_rnn` sequence_length handling (cell skipped
past seq_len: zero output, frozen state). See
/root/reference/code_student_uniform/frame_level_models.py:221-257 for
how the reference instantiates them.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from efficientvideoclassification_youtube8m_tpu.ops.lstm import (
    init_multi_lstm,
    lstm_cell_step,
    multi_lstm_scan,
)


def _sigmoid(x):
    return 1.0 / (1.0 + np.exp(-x))


def ref_basic_lstm_step(kernel, bias, x, c, h, forget_bias=1.0):
    gates = np.concatenate([x, h], axis=-1) @ kernel + bias
    i, j, f, o = np.split(gates, 4, axis=-1)
    new_c = c * _sigmoid(f + forget_bias) + _sigmoid(i) * np.tanh(j)
    new_h = np.tanh(new_c) * _sigmoid(o)
    return new_c, new_h


def ref_multi_dynamic_rnn(params, xs, seq_len, forget_bias=1.0):
    """Per-timestep multi-layer cell with dynamic_rnn masking — the
    literal TF execution order (layer l at time t sees layer l-1 at t)."""
    B, T, _ = xs.shape
    L = len(params)
    H = params[0]["kernel"].shape[-1] // 4
    cs = [np.zeros((B, H)) for _ in range(L)]
    hs = [np.zeros((B, H)) for _ in range(L)]
    for t in range(T):
        new_cs, new_hs = [], []
        inp = xs[:, t]
        for l in range(L):
            nc, nh = ref_basic_lstm_step(
                np.asarray(params[l]["kernel"]), np.asarray(params[l]["bias"]),
                inp, cs[l], hs[l], forget_bias,
            )
            new_cs.append(nc)
            new_hs.append(nh)
            inp = nh
        valid = (t < seq_len)[:, None]
        for l in range(L):
            cs[l] = np.where(valid, new_cs[l], cs[l])
            hs[l] = np.where(valid, new_hs[l], hs[l])
    parts = []
    for l in range(L):
        parts.extend([cs[l], hs[l]])
    return np.concatenate(parts, axis=-1)


@pytest.mark.parametrize("num_layers", [1, 2])
def test_multi_lstm_scan_matches_reference_semantics(num_layers):
    """Exact-math parity vs the per-timestep oracle, run in float64 so
    f32 summation-order noise doesn't mask real semantic differences."""
    rng = np.random.default_rng(0)
    B, T, D, H = 4, 15, 12, 8
    with jax.enable_x64(True):
        params = [
            {k: jnp.asarray(np.asarray(v), jnp.float64) for k, v in p.items()}
            for p in init_multi_lstm(jax.random.PRNGKey(0), D, H, num_layers)
        ]
        xs = rng.normal(size=(B, T, D))
        # include edge cases: zero-length, full-length, mid
        seq_len = np.array([0, 1, 7, 15], dtype=np.int32)

        got = np.asarray(
            multi_lstm_scan(
                params, jnp.asarray(xs), jnp.asarray(seq_len),
                compute_dtype=jnp.float64,
            )
        )
        want = ref_multi_dynamic_rnn(params, xs, seq_len)
    np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-9)


def test_zero_length_sequence_gives_zero_state():
    params = init_multi_lstm(jax.random.PRNGKey(1), 6, 5, 2)
    xs = jnp.ones((2, 7, 6))
    state = multi_lstm_scan(params, xs, jnp.array([0, 0]))
    assert state.shape == (2, 2 * 2 * 5)
    np.testing.assert_array_equal(np.asarray(state), 0.0)


def test_state_layout_is_c_then_h_per_layer():
    """state = [c0, h0, c1, h1]; h = tanh(c)*sigmoid(o) relation holds for
    a 1-step sequence."""
    D, H = 3, 4
    params = init_multi_lstm(jax.random.PRNGKey(2), D, H, 1)
    x = jnp.array([[0.5, -0.3, 1.0]])
    state = multi_lstm_scan(params, x[:, None, :], jnp.array([1]))
    c, h = np.split(np.asarray(state), 2, axis=-1)
    ec, eh = lstm_cell_step(params[0], x, jnp.zeros((1, H)), jnp.zeros((1, H)))
    np.testing.assert_allclose(c, np.asarray(ec), rtol=1e-6)
    np.testing.assert_allclose(h, np.asarray(eh), rtol=1e-6)


def test_bf16_path_tracks_f32():
    """The bf16 compute path (bf16 x_proj storage + deferred bias) must
    track the f32 path within bf16 rounding tolerance."""
    params = init_multi_lstm(jax.random.PRNGKey(5), 12, 8, 2)
    xs = jnp.asarray(np.random.default_rng(4).normal(size=(4, 15, 12)),
                     jnp.float32)
    seq_len = jnp.array([0, 3, 9, 15])
    f32 = np.asarray(multi_lstm_scan(params, xs, seq_len))
    bf16 = np.asarray(multi_lstm_scan(params, xs, seq_len,
                                      compute_dtype=jnp.bfloat16))
    np.testing.assert_allclose(bf16, f32, rtol=0.05, atol=0.05)


@pytest.mark.parametrize("unroll", [2, 5])
def test_unroll_is_exact(unroll):
    params = init_multi_lstm(jax.random.PRNGKey(6), 6, 5, 2)
    xs = jnp.asarray(np.random.default_rng(5).normal(size=(3, 15, 6)),
                     jnp.float32)
    seq_len = jnp.array([2, 9, 15])
    base = np.asarray(multi_lstm_scan(params, xs, seq_len))
    got = np.asarray(multi_lstm_scan(params, xs, seq_len, unroll=unroll))
    np.testing.assert_allclose(got, base, rtol=1e-6, atol=1e-7)


def test_outputs_zeroed_past_seq_len():
    params = init_multi_lstm(jax.random.PRNGKey(3), 4, 3, 1)
    xs = jnp.asarray(np.random.default_rng(1).normal(size=(2, 6, 4)), jnp.float32)
    _, outs = multi_lstm_scan(
        params, xs, jnp.array([2, 6]), return_outputs=True
    )
    outs = np.asarray(outs)
    assert np.all(outs[0, 2:] == 0.0)
    assert np.all(outs[0, :2] != 0.0)
    assert np.all(outs[1] != 0.0)


# The flagship's four recurrences (HierarchicalLstmModel, 2 layers x 1024
# cells): (time steps, input width) of the teacher's 15-frame L1 chunks
# and 20-chunk L2, and the student's 6-frame L1 chunks (30 frames / 5)
# and 5-chunk L2.
FLAGSHIP_SCANS = {
    "teacher_l1": (15, 1152),
    "student_l1": (6, 1152),
    "teacher_l2": (20, 4096),
    "student_l2": (5, 4096),
}


@pytest.mark.parametrize("name", sorted(FLAGSHIP_SCANS))
def test_bf16_scan_at_flagship_widths_tracks_float64_oracle(name):
    """The production bf16 scan at the real widths against the float64
    per-timestep oracle. Tolerance: bf16 keeps 8 mantissa bits (~4e-3
    relative rounding of each step's matmul operands); measured on CPU
    the state's max error is 0.3-0.4% of its largest entry at every
    shape, so 1.5% leaves a 4x margin while a semantic error (a wrong
    gate, mask or layout) moves the state by far more."""
    T, D = FLAGSHIP_SCANS[name]
    H, B = 1024, 4
    rng = np.random.default_rng(7)
    params = init_multi_lstm(jax.random.PRNGKey(8), D, H, 2)
    # L1 inputs are l2-normalized frames; L2 inputs are O(1) [c, h] states
    scale = 1.0 / np.sqrt(D) if D == 1152 else 0.5
    xs = (rng.normal(size=(B, T, D)) * scale).astype(np.float32)
    seq_len = np.array([0, 1, T // 2, T], dtype=np.int32)
    got = np.asarray(multi_lstm_scan(
        params, jnp.asarray(xs), jnp.asarray(seq_len),
        compute_dtype=jnp.bfloat16), np.float64)
    want = ref_multi_dynamic_rnn(
        [{k: np.asarray(v, np.float64) for k, v in p.items()} for p in params],
        xs.astype(np.float64), seq_len)
    assert got.shape == (B, 4 * H)
    np.testing.assert_array_equal(got[0], 0.0)  # zero-length: zero state
    err = np.max(np.abs(got - want))
    assert err <= 1.5e-2 * np.max(np.abs(want)), (err, np.max(np.abs(want)))
    # and the error is bf16-sized: the scan really computed in bf16
    assert err > 1e-7 * np.max(np.abs(want))
