"""Serving API tests: checkpoint loading (both layouts), batch padding,
parity with the eval step."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from efficientvideoclassification_youtube8m_tpu.serving import Predictor
from efficientvideoclassification_youtube8m_tpu.train import (
    build_eval_step,
    init_distill_state,
    make_optimizer,
    save_checkpoint,
    student_state_from_distill,
)
from efficientvideoclassification_youtube8m_tpu.utils.config import TrainConfig

CFG = TrainConfig(
    num_classes=30,
    batch_size=4,
    lstm_cells=8,
    lstm_layers=2,
    max_num_frames=40,
    num_inputs_to_lstm=4,
    num_inputs_L1=2,
    every_n=2,
    feature_names="rgb, audio",
    feature_sizes="6, 2",
    scan_unroll=1,
    compute_dtype="float32",
)


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    root = tmp_path_factory.mktemp("serving")
    opt = make_optimizer(CFG.optimizer, CFG.clip_gradient_norm)
    dstate = init_distill_state(CFG, opt)
    sstate = student_state_from_distill(dstate, opt)
    distill_dir = str(root / "train")
    finetune_dir = str(root / "finetune")
    save_checkpoint(distill_dir, dstate, 10)
    save_checkpoint(finetune_dir, sstate, 3)
    return distill_dir, finetune_dir, dstate, sstate


def _batch(n, seed=0):
    rng = np.random.default_rng(seed)
    feats = rng.integers(0, 256, size=(n, CFG.max_num_frames,
                                       CFG.total_feature_size), dtype=np.uint8)
    nf = rng.integers(5, CFG.max_num_frames + 1, size=n).astype(np.int32)
    return feats, nf


def test_predict_matches_eval_step(dirs):
    _, finetune_dir, _, sstate = dirs
    p = Predictor.from_checkpoint(finetune_dir, CFG, serve_batch=4)
    feats, nf = _batch(4)
    probs = p.predict(feats, nf)

    estep = jax.jit(build_eval_step(CFG, top_k=5))
    out = estep(sstate.params_student, jnp.asarray(feats),
                jnp.zeros((4, CFG.num_classes), bool), jnp.asarray(nf))
    np.testing.assert_allclose(probs, np.asarray(out["predictions"]),
                               rtol=1e-5, atol=1e-6)


def test_predict_pads_odd_batches(dirs):
    _, finetune_dir, _, _ = dirs
    p = Predictor.from_checkpoint(finetune_dir, CFG, serve_batch=4)
    feats, nf = _batch(7, seed=1)
    probs = p.predict(feats, nf)
    assert probs.shape == (7, CFG.num_classes)
    # per-example results are independent of batch grouping
    probs_single = p.predict(feats[3:4], nf[3:4])
    np.testing.assert_allclose(probs[3:4], probs_single, rtol=1e-5, atol=1e-6)


def test_predict_ring_depths_keep_chunk_order(dirs):
    """Multi-chunk requests drain through a lag-N ring; FIFO order (and
    the padded final chunk's truncation) must hold at every depth,
    including depth=1 (one launch in flight) and depth > #chunks
    (everything drains in the tail loop)."""
    _, finetune_dir, _, sstate = dirs
    feats, nf = _batch(10, seed=4)
    expected = None
    for depth in (1, 2, 8):
        p = Predictor.from_checkpoint(finetune_dir, CFG, serve_batch=4)
        p.fetch_depth = depth
        probs = p.predict(feats, nf)
        assert probs.shape == (10, CFG.num_classes)
        if expected is None:
            expected = probs
        else:
            np.testing.assert_array_equal(probs, expected)


def test_teacher_tower_from_distill_checkpoint(dirs):
    distill_dir, finetune_dir, dstate, _ = dirs
    p = Predictor.from_checkpoint(distill_dir, CFG, tower="teacher",
                                  serve_batch=4)
    feats, nf = _batch(4, seed=2)
    probs = p.predict(feats, nf)
    assert probs.shape == (4, CFG.num_classes)
    with pytest.raises(ValueError):
        Predictor.from_checkpoint(finetune_dir, CFG, tower="teacher")


def test_topk(dirs):
    _, finetune_dir, _, _ = dirs
    p = Predictor.from_checkpoint(finetune_dir, CFG, serve_batch=4)
    feats, nf = _batch(4, seed=3)
    vals, idx = p.predict_topk(feats, nf, k=5)
    assert vals.shape == (4, 5) and idx.shape == (4, 5)
    assert np.all(np.diff(vals, axis=1) <= 0)  # sorted desc
    probs = p.predict(feats, nf)
    np.testing.assert_allclose(vals[:, 0], probs.max(axis=1), rtol=1e-6)


def test_sequence_parallel_predict_parity(dirs):
    """The Predictor's sequence-parallel path (chunk axis
    sharded over the mesh, parallel/sequence_parallel.py) returns the
    same predictions as the single-device forward."""
    from efficientvideoclassification_youtube8m_tpu.parallel import create_mesh

    _, finetune_dir, _, _ = dirs
    base = Predictor.from_checkpoint(finetune_dir, CFG, serve_batch=4)

    # student has num_inputs_L1=2 chunks -> a 2-device data axis
    mesh = create_mesh(data=2, devices=jax.devices()[:2])
    sp = Predictor.from_checkpoint(finetune_dir, CFG, serve_batch=4,
                                   mesh=mesh, sequence_parallel=True)
    feats, nf = _batch(4, seed=5)
    np.testing.assert_allclose(sp.predict(feats, nf),
                               base.predict(feats, nf),
                               rtol=1e-5, atol=1e-6)

    # teacher tower: 4 chunks over a 4-device axis
    distill_dir = dirs[0]
    base_t = Predictor.from_checkpoint(distill_dir, CFG, tower="teacher",
                                       serve_batch=4)
    mesh4 = create_mesh(data=4, devices=jax.devices()[:4])
    sp_t = Predictor.from_checkpoint(distill_dir, CFG, tower="teacher",
                                     serve_batch=4, mesh=mesh4,
                                     sequence_parallel=True)
    np.testing.assert_allclose(sp_t.predict(feats, nf),
                               base_t.predict(feats, nf),
                               rtol=1e-5, atol=1e-6)

    # chunk count must divide the data axis
    with pytest.raises(ValueError):
        Predictor.from_checkpoint(finetune_dir, CFG, mesh=create_mesh(),
                                  sequence_parallel=True)  # 2 % 8 != 0


def test_mesh_data_parallel_predict_parity(dirs):
    """Predictor(mesh=...) without sequence_parallel: batch rows sharded
    over the 8-device data axis, same predictions as single-device."""
    from efficientvideoclassification_youtube8m_tpu.parallel import create_mesh

    _, finetune_dir, _, _ = dirs
    base = Predictor.from_checkpoint(finetune_dir, CFG, serve_batch=8)
    dp = Predictor.from_checkpoint(finetune_dir, CFG, serve_batch=8,
                                   mesh=create_mesh())
    feats, nf = _batch(8, seed=6)
    np.testing.assert_allclose(dp.predict(feats, nf),
                               base.predict(feats, nf),
                               rtol=1e-5, atol=1e-6)


def test_mesh_data_parallel_int8_predict_parity(dirs):
    """int8 serving under a data-parallel mesh (shard_map per-device
    programs): same predictions as the single-device int8 path."""
    from efficientvideoclassification_youtube8m_tpu.parallel import create_mesh

    _, finetune_dir, _, _ = dirs
    base = Predictor.from_checkpoint(finetune_dir, CFG, serve_batch=8,
                                     quantize="int8")
    dp = Predictor.from_checkpoint(finetune_dir, CFG, serve_batch=8,
                                   mesh=create_mesh(), quantize="int8")
    feats, nf = _batch(8, seed=7)
    np.testing.assert_allclose(dp.predict(feats, nf),
                               base.predict(feats, nf),
                               rtol=1e-5, atol=1e-6)
