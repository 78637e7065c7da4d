"""int8 quantized serving path (ops/quantize.py + Predictor(quantize=)).

Covers: per-channel weight quantization round-trip, the quantized
hierarchical forward tracking the f32 forward closely, and the
acceptance bar — epoch Hit@1/GAP within +/-2e-3 of the float path on a
learnable synthetic eval with a genuinely trained student.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from efficientvideoclassification_youtube8m_tpu.metrics import EvaluationMetrics
from efficientvideoclassification_youtube8m_tpu.ops import quantize as qz
from efficientvideoclassification_youtube8m_tpu.serving import Predictor
from efficientvideoclassification_youtube8m_tpu.train import (
    init_distill_state,
    make_optimizer,
)
from efficientvideoclassification_youtube8m_tpu.utils.config import TrainConfig

TINY = TrainConfig(
    num_classes=24,
    batch_size=8,
    lstm_cells=16,
    lstm_layers=2,
    max_num_frames=40,
    num_inputs_to_lstm=4,
    num_inputs_L1=2,
    every_n=2,
    feature_names="rgb, audio",
    feature_sizes="6, 2",
    compute_dtype="float32",
    scan_unroll=1,
)


def test_weight_quantize_roundtrip():
    rng = np.random.default_rng(0)
    w = rng.normal(size=(32, 64)).astype(np.float32) * np.exp(
        rng.normal(size=(1, 64)))  # per-column ranges vary 10x+
    q, s = qz.quantize_weight(jnp.asarray(w))
    deq = np.asarray(q, np.float32) * np.asarray(s)
    # per-column max error bounded by half a quantization step
    col_amax = np.abs(w).max(axis=0)
    assert np.all(np.abs(deq - w) <= col_amax / 127.0 * 0.5 + 1e-7)


def test_int8_dot_close():
    rng = np.random.default_rng(1)
    x = rng.normal(size=(16, 32)).astype(np.float32)
    w = rng.normal(size=(32, 48)).astype(np.float32)
    q, s = qz.quantize_weight(jnp.asarray(w))
    got = np.asarray(qz.int8_dot(jnp.asarray(x), q, s))
    want = x @ w
    # relative error of an int8 x int8 product with per-row/col scales
    assert np.max(np.abs(got - want)) / np.max(np.abs(want)) < 0.02


def test_quantized_forward_tracks_float():
    cfg = TINY
    opt = make_optimizer(cfg.optimizer, cfg.clip_gradient_norm)
    state = init_distill_state(cfg, opt)
    from efficientvideoclassification_youtube8m_tpu.train.step import (
        forward_student,
        preprocess_batch,
    )
    from efficientvideoclassification_youtube8m_tpu.ops.preprocess import (
        student_num_frames,
        uniform_subsample,
    )

    rng = np.random.default_rng(2)
    feats = rng.integers(0, 256, size=(8, cfg.max_num_frames,
                                       cfg.total_feature_size), dtype=np.uint8)
    nf = rng.integers(5, cfg.max_num_frames + 1, size=8).astype(np.int32)
    x = preprocess_batch(cfg, jnp.asarray(feats))
    xs = uniform_subsample(x, cfg.every_n)
    nfs = student_num_frames(jnp.asarray(nf), cfg.every_n, cfg.max_num_frames)
    want = np.asarray(forward_student(cfg, state.params_student, xs, nfs,
                                      inference=True)["predictions"])

    qparams = qz.quantize_hierarchical_params(
        state.params_student, cfg.total_feature_size, cfg.lstm_cells,
        cfg.lstm_layers)
    got = np.asarray(qz.quantized_hierarchical_forward(
        qparams, xs, nfs, cfg.num_inputs_L1, cfg.num_classes,
        cfg.moe_num_mixtures))
    assert got.shape == want.shape
    assert np.max(np.abs(got - want)) < 0.02  # probabilities in [0, 1]


def _train_tiny_student(cfg, steps=220, lr=0.02, seed=0):
    """Train a student (single tower) on a learnable synthetic mapping so
    the accuracy comparison runs on a model that actually predicts."""
    from efficientvideoclassification_youtube8m_tpu.train.step import (
        build_finetune_step,
    )
    from efficientvideoclassification_youtube8m_tpu.train import (
        student_state_from_distill,
    )

    rng = np.random.default_rng(seed)
    protos = rng.normal(size=(cfg.num_classes, cfg.total_feature_size))
    protos = (protos / np.linalg.norm(protos, axis=1, keepdims=True) * 80
              + 128)

    def batch(n, bseed):
        brng = np.random.default_rng(bseed)
        cls = brng.integers(cfg.num_classes, size=n)
        feats = np.clip(
            protos[cls][:, None, :]
            + brng.normal(scale=6.0, size=(n, cfg.max_num_frames,
                                           cfg.total_feature_size)),
            0, 255).astype(np.uint8)
        labels = np.zeros((n, cfg.num_classes), bool)
        labels[np.arange(n), cls] = True
        nf = np.full(n, cfg.max_num_frames, np.int32)
        return feats, labels, nf

    opt = make_optimizer(cfg.optimizer, cfg.clip_gradient_norm)
    cfg_t = cfg.replace(base_learning_rate=lr)
    state = student_state_from_distill(init_distill_state(cfg_t, opt), opt)
    step = jax.jit(build_finetune_step(cfg_t, opt, top_k=5))
    for i in range(steps):
        f, l, n = batch(cfg.batch_size, 1000 + i)
        state, _ = step(state, jnp.asarray(f), jnp.asarray(l), jnp.asarray(n))
    return state.params_student, batch


def test_int8_epoch_metrics_within_2e3_of_float():
    """The acceptance bar: Hit@1 and GAP of the int8 Predictor
    within +/-0.002 of the float path on a held-out synthetic eval."""
    cfg = TINY.replace(batch_size=32)
    params, batch = _train_tiny_student(cfg)

    def epoch_metrics(quantize):
        p = Predictor(cfg, params, serve_batch=32, quantize=quantize)
        evl = EvaluationMetrics(cfg.num_classes, 5)
        for s in range(6):
            feats, labels, nf = batch(32, 9000 + s)
            probs = p.predict(feats, nf)
            idx = np.argsort(-probs, axis=1, kind="stable")[:, :5]
            vals = np.take_along_axis(probs, idx, axis=1)
            evl.accumulate_topk(vals, idx, labels, loss=np.zeros(32))
        return evl.get()

    base = epoch_metrics("none")
    q = epoch_metrics("int8")
    assert base["avg_hit_at_one"] > 0.9  # the comparison is meaningful
    assert abs(q["avg_hit_at_one"] - base["avg_hit_at_one"]) <= 2e-3
    assert abs(q["gap"] - base["gap"]) <= 2e-3


def test_int8_teacher_tower():
    """quantize='int8' also serves the TEACHER tower (20 chunks)."""
    cfg = TINY
    opt = make_optimizer(cfg.optimizer, cfg.clip_gradient_norm)
    state = init_distill_state(cfg, opt)
    p = Predictor(cfg, state.params_teacher, tower="teacher", serve_batch=8,
                  quantize="int8")
    rng = np.random.default_rng(5)
    feats = rng.integers(0, 256, size=(8, cfg.max_num_frames,
                                       cfg.total_feature_size), dtype=np.uint8)
    nf = rng.integers(5, cfg.max_num_frames + 1, size=8).astype(np.int32)
    probs = p.predict(feats, nf)
    base = Predictor(cfg, state.params_teacher, tower="teacher",
                     serve_batch=8).predict(feats, nf)
    assert probs.shape == (8, cfg.num_classes)
    assert np.max(np.abs(probs - base)) < 0.02


def test_int8_predictor_guards():
    cfg = TINY.replace(model="DbofModel")
    opt = make_optimizer(cfg.optimizer, cfg.clip_gradient_norm)
    with pytest.raises(ValueError, match="int8"):
        Predictor(TINY, {}, quantize="int4")
    with pytest.raises(ValueError, match="flagship"):
        state = init_distill_state(TINY, opt)
        Predictor(cfg, state.params_student, quantize="int8")
