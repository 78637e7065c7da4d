"""Sharding tests on the 8-device virtual CPU mesh: DP-only, DP x TP, and
parity of sharded vs single-device results."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
from jax.sharding import PartitionSpec as P

from efficientvideoclassification_youtube8m_tpu.parallel import (
    build_sharded_distill_step,
    build_sharded_eval_step,
    create_mesh,
    place_state,
    shard_batch,
    shard_state_specs,
)
from efficientvideoclassification_youtube8m_tpu.train import (
    build_distill_train_step,
    init_distill_state,
    make_optimizer,
    student_state_from_distill,
)
from efficientvideoclassification_youtube8m_tpu.utils.config import TrainConfig

CFG = TrainConfig(
    num_classes=32,
    batch_size=8,
    lstm_cells=8,
    lstm_layers=2,
    max_num_frames=40,
    num_inputs_to_lstm=4,
    num_inputs_L1=2,
    every_n=2,
    feature_names="rgb, audio",
    feature_sizes="6, 2",
    scan_unroll=1,
)


def _batch(cfg, seed=0):
    rng = np.random.default_rng(seed)
    B = cfg.batch_size
    feats = rng.integers(0, 256, size=(B, cfg.max_num_frames,
                                       cfg.total_feature_size), dtype=np.uint8)
    labels = np.zeros((B, cfg.num_classes), bool)
    for i in range(B):
        labels[i, rng.choice(cfg.num_classes, 3, replace=False)] = True
    nf = rng.integers(5, cfg.max_num_frames + 1, size=B).astype(np.int32)
    return feats, labels, nf


def test_mesh_construction():
    assert len(jax.devices()) == 8, "conftest must provide 8 virtual devices"
    mesh = create_mesh()
    assert mesh.shape == {"data": 8, "model": 1}
    mesh = create_mesh(model=2)
    assert mesh.shape == {"data": 4, "model": 2}
    with pytest.raises(ValueError):
        create_mesh(data=3, model=2)


def test_tp_spec_rule():
    """Wide last-dim arrays shard over model; small ones replicate."""
    params = {
        "moe_gates": jnp.zeros((16, 4096)),
        "lstm_kernel": jnp.zeros((24, 32)),
        "bias": jnp.zeros((4096,)),
        "scalar": jnp.zeros(()),
    }
    specs = shard_state_specs(params, model_size=2, min_dim=4096)
    assert specs["moe_gates"] == P(None, "model")
    assert specs["lstm_kernel"] == P()
    assert specs["bias"] == P("model")
    assert specs["scalar"] == P()
    # model_size=1 -> fully replicated
    specs1 = shard_state_specs(params, model_size=1)
    assert all(s == P() for s in jax.tree.leaves(specs1,
                                                 is_leaf=lambda x: isinstance(x, P)))


@pytest.mark.parametrize("mesh_shape", [(8, 1), (4, 2)])
def test_sharded_distill_step_matches_single_device(mesh_shape):
    """The sharded step must produce the same losses and state as the
    unsharded single-device step."""
    data, model = mesh_shape
    cfg = CFG
    opt = make_optimizer(cfg.optimizer, cfg.clip_gradient_norm)
    state_host = init_distill_state(cfg, opt)
    feats, labels, nf = _batch(cfg)

    # single-device baseline
    base_step = jax.jit(build_distill_train_step(cfg, opt, top_k=5))
    base_state, base_metrics = base_step(
        state_host, jnp.asarray(feats), jnp.asarray(labels), jnp.asarray(nf))

    mesh = create_mesh(data=data, model=model)
    # min_dim tiny so the 32-class MoE head actually gets TP-sharded
    min_dim = 32 if model > 1 else 4096
    state = place_state(state_host, mesh, min_dim=min_dim)
    step = build_sharded_distill_step(cfg, opt, mesh, state_host, top_k=5,
                                      min_dim=min_dim)
    f, l, n = shard_batch(mesh, feats, labels, nf)
    new_state, metrics = step(state, f, l, n)

    for k in ["teacher_label_loss", "student_loss_state", "pred_loss",
              "student_label_loss", "total_student_loss"]:
        np.testing.assert_allclose(float(metrics[k]), float(base_metrics[k]),
                                   rtol=2e-4, err_msg=k)
    np.testing.assert_allclose(
        np.asarray(jax.device_get(new_state.params_teacher["rnn_l1"][0]["kernel"])),
        np.asarray(base_state.params_teacher["rnn_l1"][0]["kernel"]),
        rtol=1e-4, atol=1e-6)
    assert int(new_state.global_step) == 2


def test_tp_actually_shards_moe(capsys):
    cfg = CFG
    opt = make_optimizer(cfg.optimizer, cfg.clip_gradient_norm)
    state_host = init_distill_state(cfg, opt)
    mesh = create_mesh(data=4, model=2)
    state = place_state(state_host, mesh, min_dim=32)
    w = state.params_teacher["classifier"]["gates"]["w"]  # [D, m+1, V]
    # the class axis splits over the 2 model shards -> V/2 each
    shard_shapes = {s.data.shape for s in w.addressable_shards}
    assert shard_shapes == {(w.shape[0], w.shape[1], w.shape[2] // 2)}


def test_sharded_eval_step():
    cfg = CFG
    opt = make_optimizer(cfg.optimizer, cfg.clip_gradient_norm)
    dstate = init_distill_state(cfg, opt)
    sstate = student_state_from_distill(dstate, opt)
    mesh = create_mesh()
    feats, labels, nf = _batch(cfg, seed=1)
    step = build_sharded_eval_step(cfg, mesh, sstate.params_student, top_k=5)
    params = jax.device_put(sstate.params_student)
    f, l, n = shard_batch(mesh, feats, labels, nf)
    out = step(params, f, l, n)
    assert out["predictions"].shape == (cfg.batch_size, cfg.num_classes)
    assert np.all(np.isfinite(np.asarray(out["per_example_loss"])))


def test_tf_config_parsing():
    from efficientvideoclassification_youtube8m_tpu.parallel import distributed

    cfg = distributed.parse_tf_config(
        {"TF_CONFIG": '{"cluster": {"worker": ["h0:1234", "h1:1234"]}, '
                      '"task": {"type": "worker", "index": 1}}'})
    assert cfg == {"coordinator": "h0:1234", "num_processes": 2,
                   "process_id": 1, "task_type": "worker"}
    assert distributed.parse_tf_config({}) is None


def test_host_shard_single_process():
    from efficientvideoclassification_youtube8m_tpu.parallel import distributed

    assert distributed.host_shard() == (0, 1)
    assert distributed.is_master()
    distributed.initialize()  # no-op single process


def test_shardmap_eval_matches_jit_eval():
    """The explicit shard_map DP eval path must match the GSPMD jit
    path."""
    from efficientvideoclassification_youtube8m_tpu.parallel import (
        build_shardmap_eval_step,
    )

    cfg = CFG
    opt = make_optimizer(cfg.optimizer, cfg.clip_gradient_norm)
    sstate = student_state_from_distill(init_distill_state(cfg, opt), opt)
    mesh = create_mesh()
    feats, labels, nf = _batch(cfg, seed=2)
    params = jax.device_put(sstate.params_student)
    f, l, n = shard_batch(mesh, feats, labels, nf)

    jit_step = build_sharded_eval_step(cfg, mesh, sstate.params_student, top_k=5)
    sm_step = build_shardmap_eval_step(cfg, mesh, top_k=5)
    out_a = jit_step(params, f, l, n)
    out_b = sm_step(params, f, l, n)
    np.testing.assert_allclose(
        np.asarray(out_a["predictions"]), np.asarray(out_b["predictions"]),
        rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(
        np.asarray(out_a["per_example_loss"]),
        np.asarray(out_b["per_example_loss"]), rtol=1e-4)


def test_sequence_parallel_matches_folded_dp():
    """Sharding the chunk axis (true sequence parallelism, one all_gather
    before L2) must reproduce the single-device hierarchical state."""
    from efficientvideoclassification_youtube8m_tpu.models import get_model
    from efficientvideoclassification_youtube8m_tpu.parallel import (
        build_sequence_parallel_state_fn,
    )

    cfg = CFG.replace(num_inputs_to_lstm=8, max_num_frames=40)
    opt = make_optimizer(cfg.optimizer, cfg.clip_gradient_norm)
    state = init_distill_state(cfg, opt)
    mesh = create_mesh()  # 8 devices = 8 chunks, one block per device

    rng = np.random.default_rng(3)
    B = 4
    x = jnp.asarray(rng.normal(size=(B, 40, cfg.total_feature_size)),
                    jnp.float32)
    nf = jnp.array([40, 23, 7, 1], jnp.int32)

    sp_fn = build_sequence_parallel_state_fn(cfg, mesh)
    got = np.asarray(sp_fn(state.params_teacher["rnn_l1"],
                           state.params_teacher["rnn_l2"], x, nf))

    model = get_model(cfg.model)
    want = np.asarray(model.apply(
        state.params_teacher, x, vocab_size=cfg.num_classes, num_frames=nf,
        num_chunks=8, scan_unroll=1)["state"])
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_shardmap_distill_step_matches_single_device():
    """The shard_map TRAIN path (explicit per-device grads + one psum over
    the data axis, mean/sum loss-term bookkeeping in build_distill_train_step)
    must reproduce the single-program step: same losses, same updated params."""
    from efficientvideoclassification_youtube8m_tpu.parallel import (
        build_shardmap_distill_step,
    )

    cfg = CFG
    opt = make_optimizer(cfg.optimizer, cfg.clip_gradient_norm)
    state_host = init_distill_state(cfg, opt)
    feats, labels, nf = _batch(cfg, seed=3)

    base_step = jax.jit(build_distill_train_step(cfg, opt, top_k=5))
    base_state, base_metrics = base_step(
        state_host, jnp.asarray(feats), jnp.asarray(labels), jnp.asarray(nf))

    mesh = create_mesh()  # 8-way data parallel
    state = place_state(state_host, mesh)
    step = build_shardmap_distill_step(cfg, opt, mesh, top_k=5)
    f, l, n = shard_batch(mesh, feats, labels, nf)
    new_state, metrics = step(state, f, l, n)

    for k in ["teacher_label_loss", "teacher_final_loss", "student_loss_state",
              "pred_loss", "student_label_loss", "total_student_loss"]:
        np.testing.assert_allclose(float(metrics[k]), float(base_metrics[k]),
                                   rtol=2e-4, err_msg=k)
    for name in ["params_teacher", "params_student"]:
        jax.tree.map(
            lambda a, b: np.testing.assert_allclose(
                np.asarray(jax.device_get(a)), np.asarray(b),
                rtol=1e-4, atol=1e-6),
            getattr(new_state, name), jax.device_get(getattr(base_state, name)))
    assert int(new_state.global_step) == 2
    # topk concatenates back to the full batch
    assert metrics["topk_val"].shape == (cfg.batch_size, 5)
    with pytest.raises(ValueError):
        build_shardmap_distill_step(cfg, opt, create_mesh(model=2), top_k=5)


def test_shardmap_finetune_step_matches_single_device():
    from efficientvideoclassification_youtube8m_tpu.parallel import (
        build_shardmap_finetune_step,
    )
    from efficientvideoclassification_youtube8m_tpu.train import (
        build_finetune_step,
    )

    cfg = CFG
    opt = make_optimizer(cfg.optimizer, cfg.clip_gradient_norm)
    state_host = student_state_from_distill(init_distill_state(cfg, opt), opt)
    feats, labels, nf = _batch(cfg, seed=5)

    base_step = jax.jit(build_finetune_step(cfg, opt, top_k=5))
    base_state, base_metrics = base_step(
        state_host, jnp.asarray(feats), jnp.asarray(labels), jnp.asarray(nf))

    mesh = create_mesh()
    state = place_state(state_host, mesh)
    step = build_shardmap_finetune_step(cfg, opt, mesh, top_k=5)
    f, l, n = shard_batch(mesh, feats, labels, nf)
    new_state, metrics = step(state, f, l, n)

    np.testing.assert_allclose(float(metrics["student_label_loss"]),
                               float(base_metrics["student_label_loss"]),
                               rtol=2e-4)
    jax.tree.map(
        lambda a, b: np.testing.assert_allclose(
            np.asarray(jax.device_get(a)), np.asarray(b),
            rtol=1e-4, atol=1e-6),
        new_state.params_student, jax.device_get(base_state.params_student))


def test_synced_bn_shardmap_matches_gspmd_global_stats(monkeypatch):
    """--sync_batch_norm: DBoF under shard_map pmean's the batch-norm
    moments, so its gradients/params match the GSPMD path's global-batch
    statistics. Frame sampling is pinned
    to a deterministic sampler for the comparison — per-shard sampling
    rngs are deliberately decorrelated and would differ from the GSPMD
    path's single stream regardless of BN."""
    import dataclasses

    from efficientvideoclassification_youtube8m_tpu.models import frame_level
    from efficientvideoclassification_youtube8m_tpu.parallel import (
        build_shardmap_finetune_step,
    )
    from efficientvideoclassification_youtube8m_tpu.train import (
        build_finetune_step,
    )

    monkeypatch.setattr(
        frame_level, "sample_random_frames",
        lambda x, nf, k, rng: frame_level.sample_even_frames(x, nf, k),
    )

    # SGD so the post-step param diff IS the gradient diff — Adam's
    # g/(|g|+eps) near-zero normalization would amplify fp reassociation
    # noise on the tiny BN-offset grads into the comparison.
    cfg = dataclasses.replace(
        CFG, model="DbofModel", dbof_cluster_size=16, dbof_hidden_size=8,
        iterations=5, sync_batch_norm=True,
        optimizer="GradientDescentOptimizer",
    )
    opt = make_optimizer(cfg.optimizer, cfg.clip_gradient_norm)
    state_host = student_state_from_distill(init_distill_state(cfg, opt), opt)
    feats, labels, nf = _batch(cfg, seed=9)

    base_step = jax.jit(build_finetune_step(cfg, opt, top_k=5))
    base_state, base_metrics = base_step(
        state_host, jnp.asarray(feats), jnp.asarray(labels), jnp.asarray(nf))

    mesh = create_mesh()
    state = place_state(state_host, mesh)
    step = build_shardmap_finetune_step(cfg, opt, mesh, top_k=5)
    f, l, n = shard_batch(mesh, feats, labels, nf)
    synced_state, synced_metrics = step(state, f, l, n)

    np.testing.assert_allclose(float(synced_metrics["student_label_loss"]),
                               float(base_metrics["student_label_loss"]),
                               rtol=2e-4)
    # grads (hence params after one Adam step) AND the folded-back BN
    # moving stats match the global-batch-statistics program
    jax.tree.map(
        lambda a, b: np.testing.assert_allclose(
            np.asarray(jax.device_get(a)), np.asarray(b),
            rtol=1e-4, atol=1e-6),
        synced_state.params_student,
        jax.device_get(base_state.params_student))

    # ... and WITHOUT the flag, per-shard statistics diverge from the
    # global-batch program (the documented unsynced-BN default).
    # Fresh state: the shard_map steps donate their state argument.
    cfg_u = dataclasses.replace(cfg, sync_batch_norm=False)
    step_u = build_shardmap_finetune_step(cfg_u, opt, mesh, top_k=5)
    fresh = student_state_from_distill(init_distill_state(cfg, opt), opt)
    unsynced_state, _ = step_u(place_state(fresh, mesh), f, l, n)
    diffs = jax.tree.map(
        lambda a, b: float(np.max(np.abs(np.asarray(jax.device_get(a))
                                         - np.asarray(b)))),
        unsynced_state.params_student,
        jax.device_get(base_state.params_student))
    assert max(jax.tree.leaves(diffs)) > 1e-6


def test_device_prefetch_order_and_values():
    """device_prefetch yields every batch exactly once, in order, with the
    sharded device arrays equal to a direct shard_batch of the same host
    batch — only the transfer timing differs."""
    from collections import namedtuple

    from efficientvideoclassification_youtube8m_tpu.parallel import (
        device_prefetch,
    )

    Batch = namedtuple("Batch", "features labels num_frames")
    cfg = CFG
    host = [Batch(*_batch(cfg, seed=s)) for s in range(5)]
    mesh = create_mesh()

    out = list(device_prefetch(iter(host), mesh, depth=2))
    assert len(out) == len(host)
    for i, ((f, l, n), host_labels) in enumerate(out):
        np.testing.assert_array_equal(np.asarray(f), host[i].features)
        np.testing.assert_array_equal(np.asarray(l), host[i].labels)
        np.testing.assert_array_equal(np.asarray(n), host[i].num_frames)
        # only the labels stay resident on the host
        assert host_labels is host[i].labels
        # really sharded over the data axis
        assert f.sharding.spec == P("data", None, None)
