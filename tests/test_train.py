"""Train-layer tests: optimizer parity, the distillation step end-to-end
on tiny shapes, checkpoint round-trips and conversion surgery."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from efficientvideoclassification_youtube8m_tpu.train import (
    DistillState,
    build_distill_train_step,
    build_eval_step,
    build_finetune_step,
    build_validate_step,
    clip_grads_per_variable,
    exponential_decay,
    init_distill_state,
    latest_checkpoint,
    make_optimizer,
    restore_checkpoint,
    save_checkpoint,
    student_state_from_distill,
)
from efficientvideoclassification_youtube8m_tpu.train.checkpoint import (
    checkpoint_step,
)
from efficientvideoclassification_youtube8m_tpu.utils.config import TrainConfig

TINY = TrainConfig(
    num_classes=30,
    batch_size=4,
    lstm_cells=8,
    lstm_layers=2,
    max_num_frames=40,
    num_inputs_to_lstm=4,
    num_inputs_L1=2,
    every_n=2,
    base_learning_rate=0.01,
    learning_rate_decay_examples=1000,
    feature_names="rgb, audio",
    feature_sizes="6, 2",
    scan_unroll=1,
)


def _tiny_batch(cfg, seed=0):
    rng = np.random.default_rng(seed)
    B = cfg.batch_size
    feats = rng.integers(0, 256, size=(B, cfg.max_num_frames,
                                       cfg.total_feature_size), dtype=np.uint8)
    labels = np.zeros((B, cfg.num_classes), bool)
    for i in range(B):
        labels[i, rng.choice(cfg.num_classes, 3, replace=False)] = True
    nf = rng.integers(5, cfg.max_num_frames + 1, size=B).astype(np.int32)
    return jnp.asarray(feats), jnp.asarray(labels), jnp.asarray(nf)


# ---------------------------------------------------------------------------
# optimizer semantics
# ---------------------------------------------------------------------------

def test_exponential_decay_staircase():
    sched = exponential_decay(0.01, 256, 1000000, 0.95)
    # step*batch < decay_examples -> no decay yet
    np.testing.assert_allclose(float(sched(jnp.asarray(0))), 0.01)
    np.testing.assert_allclose(float(sched(jnp.asarray(3906))), 0.01)
    # crosses one decay boundary
    np.testing.assert_allclose(float(sched(jnp.asarray(3907))), 0.0095)
    np.testing.assert_allclose(float(sched(jnp.asarray(2 * 3907))), 0.01 * 0.95**2)


def test_per_variable_clip():
    grads = {"a": jnp.asarray([3.0, 4.0]), "b": jnp.asarray([0.3, 0.4])}
    clipped = clip_grads_per_variable(grads, 1.0)
    np.testing.assert_allclose(np.asarray(clipped["a"]), [0.6, 0.8], rtol=1e-6)
    np.testing.assert_allclose(np.asarray(clipped["b"]), [0.3, 0.4], rtol=1e-6)


def test_tf_adam_matches_hand_math():
    """One Adam step on a scalar: TF formula
    lr*sqrt(1-b2)/(1-b1) * m/(sqrt(v)+eps)."""
    opt = make_optimizer("AdamOptimizer", clip_gradient_norm=0.0)
    params = {"w": jnp.asarray(1.0)}
    state = opt.init(params)
    g = 0.5
    new_params, state = opt.update({"w": jnp.asarray(g)}, state, params, 0.01)
    b1, b2, eps = 0.9, 0.999, 1e-8
    m, v = (1 - b1) * g, (1 - b2) * g * g
    lr_t = 0.01 * np.sqrt(1 - b2) / (1 - b1)
    want = 1.0 - lr_t * m / (np.sqrt(v) + eps)
    np.testing.assert_allclose(float(new_params["w"]), want, rtol=1e-6)
    # second step
    g2 = -0.25
    new_params2, state = opt.update({"w": jnp.asarray(g2)}, state,
                                    new_params, 0.01)
    m = b1 * m + (1 - b1) * g2
    v = b2 * v + (1 - b2) * g2 * g2
    lr_t = 0.01 * np.sqrt(1 - b2**2) / (1 - b1**2)
    want2 = want - lr_t * m / (np.sqrt(v) + eps)
    np.testing.assert_allclose(float(new_params2["w"]), want2, rtol=1e-6)


@pytest.mark.parametrize("name", [
    "GradientDescentOptimizer", "MomentumOptimizer", "RMSPropOptimizer",
    "AdagradOptimizer"])
def test_other_optimizers_step(name):
    opt = make_optimizer(name, clip_gradient_norm=1.0)
    params = {"w": jnp.ones((3,))}
    state = opt.init(params)
    new_params, _ = opt.update({"w": jnp.full((3,), 0.1)}, state, params, 0.1)
    assert np.all(np.asarray(new_params["w"]) < 1.0)


def test_unknown_optimizer():
    with pytest.raises(ValueError):
        make_optimizer("BogusOptimizer")


# ---------------------------------------------------------------------------
# distillation train step
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def distill_setup():
    cfg = TINY
    opt = make_optimizer(cfg.optimizer, cfg.clip_gradient_norm)
    state = init_distill_state(cfg, opt)
    step = jax.jit(build_distill_train_step(cfg, opt, top_k=5))
    return cfg, opt, state, step


def test_distill_step_runs_and_counts(distill_setup):
    cfg, opt, state, step = distill_setup
    feats, labels, nf = _tiny_batch(cfg)
    new_state, metrics = step(state, feats, labels, nf)
    # faithful quirk: shared global_step advances by 2
    assert int(new_state.global_step) == 2
    for k in ["teacher_label_loss", "student_loss_state", "pred_loss",
              "student_label_loss", "total_student_loss"]:
        assert np.isfinite(float(metrics[k])), k
    assert metrics["topk_val"].shape == (cfg.batch_size, 5)
    assert metrics["perr_precision"].shape == (cfg.batch_size,)
    # both towers actually updated
    assert not np.allclose(
        np.asarray(new_state.params_teacher["classifier"]["experts"]["w"]),
        np.asarray(state.params_teacher["classifier"]["experts"]["w"]))
    assert not np.allclose(
        np.asarray(new_state.params_student["classifier"]["experts"]["w"]),
        np.asarray(state.params_student["classifier"]["experts"]["w"]))


def test_distill_step_perr_exact_for_many_label_videos(distill_setup):
    """The train-step metrics carry an EXACT full-row PERR precision
    (perr_precision_on_device on the teacher predictions); with more
    labels than top_k the top-k approximation visibly deviates, and the
    exact one agrees with re-deriving PERR from a teacher forward."""
    from efficientvideoclassification_youtube8m_tpu.metrics import (
        eval_util,
        train_step_metrics,
    )

    cfg, opt, state, step = distill_setup
    feats, labels, nf = _tiny_batch(cfg, seed=11)
    labels = np.array(labels)  # writable copy
    labels[0, :] = False
    labels[0, :12] = True  # 12 labels > top_k=5
    _, metrics = step(state, feats, labels, jnp.asarray(nf))
    perr_rows = np.asarray(metrics["perr_precision"])
    assert perr_rows.shape == (cfg.batch_size,)
    exact = train_step_metrics(metrics["topk_val"], metrics["topk_idx"],
                               labels, perr_precision=perr_rows)["perr"]
    approx = train_step_metrics(metrics["topk_val"], metrics["topk_idx"],
                                labels)["perr"]
    # top-k PERR can only see 5 of the 12 labels: caps row 0 at 5/5-of-12
    assert exact != approx
    # cross-check row 0 against the definition: precision within the
    # top-12 of the teacher's full score row
    assert 0.0 <= perr_rows[0] <= 1.0
    np.testing.assert_allclose(
        exact,
        float(np.sum(perr_rows)) / cfg.batch_size,
    )


def test_distill_losses_decrease(distill_setup):
    cfg, opt, state, step = distill_setup
    feats, labels, nf = _tiny_batch(cfg, seed=1)
    first, last = None, None
    for i in range(12):
        state, metrics = step(state, feats, labels, nf)
        if i == 0:
            first = {k: float(metrics[k]) for k in
                     ["teacher_label_loss", "student_label_loss"]}
        last = {k: float(metrics[k]) for k in
                ["teacher_label_loss", "student_label_loss"]}
    # both towers' CE must fall; L_REP/L_PRED may grow early while the
    # teacher's representation runs ahead of the student
    assert last["teacher_label_loss"] < first["teacher_label_loss"]
    assert last["student_label_loss"] < first["student_label_loss"]


def test_teacher_not_updated_by_student_loss():
    """The teacher must be unaffected by the distillation terms: training
    with and without the student tower gives identical teacher params
    (stop-gradient by variable partition, train.py:408-418)."""
    cfg = TINY
    opt = make_optimizer(cfg.optimizer, cfg.clip_gradient_norm)
    state = init_distill_state(cfg, opt)
    feats, labels, nf = _tiny_batch(cfg, seed=2)

    step = jax.jit(build_distill_train_step(cfg, opt, top_k=5))
    new_state, _ = step(state, feats, labels, nf)

    # teacher-only reference: same step with the representation/KL terms
    # detached is what the math should reduce to for the teacher subtree
    from efficientvideoclassification_youtube8m_tpu import losses as L
    from efficientvideoclassification_youtube8m_tpu.train.step import (
        forward_teacher, preprocess_batch)

    def teacher_loss(params_t):
        model_input = preprocess_batch(cfg, feats)
        out = forward_teacher(cfg, params_t, model_input, nf, labels)
        ll = L.get_loss(cfg.label_loss)(out["predictions"], labels)
        return ll + cfg.regularization_penalty * out["regularization_loss"]

    g_t = jax.grad(teacher_loss)(state.params_teacher)
    lr = exponential_decay(cfg.base_learning_rate, cfg.batch_size,
                           cfg.learning_rate_decay_examples,
                           cfg.learning_rate_decay)(state.global_step)
    want_pt, _ = opt.update(g_t, state.opt_teacher, state.params_teacher, lr)
    got = np.asarray(
        new_state.params_teacher["rnn_l1"][0]["kernel"])
    want = np.asarray(want_pt["rnn_l1"][0]["kernel"])
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_quirk_toggle_changes_rep_weight():
    cfg_f = TINY.replace(faithful_quirks=True)
    cfg_c = TINY.replace(faithful_quirks=False)
    opt = make_optimizer(TINY.optimizer, TINY.clip_gradient_norm)
    state = init_distill_state(TINY, opt)
    feats, labels, nf = _tiny_batch(TINY, seed=3)
    _, m_f = jax.jit(build_distill_train_step(cfg_f, opt))(state, feats, labels, nf)
    st_c, m_c = jax.jit(build_distill_train_step(cfg_c, opt))(state, feats, labels, nf)
    lrep = float(m_f["student_loss_state"])
    np.testing.assert_allclose(
        float(m_f["total_student_loss"]) - float(m_c["total_student_loss"]),
        lrep, rtol=1e-4)
    assert int(st_c.global_step) == 1  # corrected mode counts batches


# ---------------------------------------------------------------------------
# finetune / validate / eval steps
# ---------------------------------------------------------------------------

def test_finetune_and_eval_steps():
    cfg = TINY
    opt = make_optimizer(cfg.optimizer, cfg.clip_gradient_norm)
    dstate = init_distill_state(cfg, opt)
    sstate = student_state_from_distill(dstate, opt)
    feats, labels, nf = _tiny_batch(cfg, seed=4)

    fstep = jax.jit(build_finetune_step(cfg, opt, top_k=5))
    new_sstate, metrics = fstep(sstate, feats, labels, nf)
    assert int(new_sstate.global_step) == 1
    assert np.isfinite(float(metrics["student_label_loss"]))

    vstep = jax.jit(build_validate_step(cfg, top_k=5))
    vout = vstep(dstate.params_teacher, dstate.params_student, feats, labels, nf)
    assert np.isfinite(float(vout["student_loss_state"]))
    assert vout["per_example_loss"].shape == (cfg.batch_size,)

    estep = jax.jit(build_eval_step(cfg, top_k=5))
    eout = estep(sstate.params_student, feats, labels, nf)
    assert eout["predictions"].shape == (cfg.batch_size, cfg.num_classes)
    # eval step on the SAME params as validate must give the same student
    # predictions
    np.testing.assert_allclose(np.asarray(eout["predictions"]),
                               np.asarray(vout["predictions"]), rtol=1e-5)


# ---------------------------------------------------------------------------
# checkpointing
# ---------------------------------------------------------------------------

def test_checkpoint_roundtrip_and_surgery(tmp_path):
    cfg = TINY
    opt = make_optimizer(cfg.optimizer, cfg.clip_gradient_norm)
    state = init_distill_state(cfg, opt)
    feats, labels, nf = _tiny_batch(cfg, seed=5)
    step = jax.jit(build_distill_train_step(cfg, opt))
    state, _ = step(state, feats, labels, nf)

    train_dir = str(tmp_path / "train")
    p1 = save_checkpoint(train_dir, state, int(state.global_step))
    assert latest_checkpoint(train_dir) == p1
    assert checkpoint_step(p1) == 2

    state2, _ = step(state, feats, labels, nf)
    p2 = save_checkpoint(train_dir, state2, int(state2.global_step))
    assert latest_checkpoint(train_dir) == p2
    import os
    assert not os.path.exists(p1)  # max_to_keep=1

    template = init_distill_state(cfg, opt)
    restored = restore_checkpoint(p2, template)
    jax.tree.map(
        lambda a, b: np.testing.assert_array_equal(np.asarray(a), np.asarray(b)),
        restored.params_student, state2.params_student)
    assert int(restored.global_step) == int(state2.global_step)

    # conversion surgery: student subtree carries over, optimizer resets
    sstate = student_state_from_distill(restored, opt)
    jax.tree.map(
        lambda a, b: np.testing.assert_array_equal(np.asarray(a), np.asarray(b)),
        sstate.params_student, state2.params_student)
    assert int(sstate.global_step) == 0
    finetune_dir = str(tmp_path / "finetune")
    fp = save_checkpoint(finetune_dir, sstate, 0)
    template_s = student_state_from_distill(template, opt)
    restored_s = restore_checkpoint(fp, template_s)
    jax.tree.map(
        lambda a, b: np.testing.assert_array_equal(np.asarray(a), np.asarray(b)),
        restored_s.params_student, state2.params_student)


def test_async_saver_matches_sync_and_survives_donation(tmp_path):
    """AsyncCheckpointSaver writes the same bytes as the synchronous
    save, and its on-device snapshot survives the train step's buffer
    DONATION (sharded_step.py donate_argnums=(0,)): steps dispatched
    after save() invalidate the original state buffers while the writer
    thread is still fetching."""
    from efficientvideoclassification_youtube8m_tpu.train import (
        AsyncCheckpointSaver,
    )

    cfg = TINY
    opt = make_optimizer(cfg.optimizer, cfg.clip_gradient_norm)
    state = init_distill_state(cfg, opt)
    feats, labels, nf = _tiny_batch(cfg, seed=7)
    # donated like the CLIs' sharded step builders
    step = jax.jit(build_distill_train_step(cfg, opt), donate_argnums=(0,))
    state, _ = step(state, feats, labels, nf)

    sync_dir, async_dir = str(tmp_path / "sync"), str(tmp_path / "async")
    step_val = int(jax.device_get(state.global_step))
    save_checkpoint(sync_dir, state, step_val)

    saver = AsyncCheckpointSaver()
    saver.save(async_dir, state, step_val)
    # donate the saved state's buffers immediately: the snapshot (not
    # the invalidated originals) must back the in-flight write
    for _ in range(3):
        state, _ = step(state, feats, labels, nf)
    saver.wait()

    sync_path = latest_checkpoint(sync_dir)
    async_path = latest_checkpoint(async_dir)
    assert checkpoint_step(async_path) == step_val
    with open(sync_path, "rb") as f1, open(async_path, "rb") as f2:
        assert f1.read() == f2.read()

    # a second async save supersedes the first (pointer + max_to_keep)
    step_val2 = int(jax.device_get(state.global_step))
    saver.save(async_dir, state, step_val2)
    saver.wait()
    assert checkpoint_step(latest_checkpoint(async_dir)) == step_val2
    import os
    assert not os.path.exists(async_path)  # max_to_keep=1


def test_async_saver_snapshot_mode_fallback(tmp_path):
    """The snapshot prefers pinned_host memory (flat device-memory
    high-water). XLA:CPU lists pinned_host but cannot execute the
    placement, so the saver must settle on the in-device copy and still
    produce a byte-identical checkpoint."""
    from efficientvideoclassification_youtube8m_tpu.train import (
        AsyncCheckpointSaver,
    )

    state = {"x": jax.numpy.arange(8.0), "step": 3}
    sync_dir, async_dir = str(tmp_path / "sync"), str(tmp_path / "async")
    save_checkpoint(sync_dir, state, 3)

    saver = AsyncCheckpointSaver()
    saver.save(async_dir, state, 3)
    saver.wait()
    assert saver._mode in ("host", "hbm")  # settled, cached for next saves
    with open(latest_checkpoint(sync_dir), "rb") as f1, \
            open(latest_checkpoint(async_dir), "rb") as f2:
        assert f1.read() == f2.read()

    # the settled mode is reused (no re-probe): snapshot fn stays built
    fn = saver._snapshot_fn
    saver.save(async_dir, state, 4)
    saver.wait()
    assert saver._snapshot_fn is fn


def test_async_saver_sync_fallback_when_snapshot_impossible(
        tmp_path, monkeypatch):
    """If no snapshot can be taken at all, the save must still happen —
    synchronously, with a one-time warning — rather than dropping the
    checkpoint or crashing the loop."""
    from efficientvideoclassification_youtube8m_tpu.train import (
        AsyncCheckpointSaver,
    )

    saver = AsyncCheckpointSaver()

    def boom(mode, arrays):
        raise RuntimeError("RESOURCE_EXHAUSTED: synthetic")

    monkeypatch.setattr(saver, "_run_snapshot", boom)
    state = {"x": jax.numpy.arange(4.0)}
    saver.save(str(tmp_path), state, 7)
    assert saver._thread is None  # ran inline, nothing in flight
    path = latest_checkpoint(str(tmp_path))
    assert path and checkpoint_step(path) == 7
    restored = restore_checkpoint(path, {"x": jax.numpy.zeros(4)})
    np.testing.assert_array_equal(np.asarray(restored["x"]),
                                  np.arange(4.0))


def test_async_saver_gspmd_sharded_state(tmp_path):
    """Async saves of a GSPMD-sharded state (DP×TP over the 8-device
    mesh) snapshot per-shard (`with_memory_kind` on NamedSharding) and
    round-trip identically to a synchronous orbax save — the sharding
    equivalent of the single-device donation test."""
    from efficientvideoclassification_youtube8m_tpu.parallel import (
        create_mesh,
        place_state,
    )
    from efficientvideoclassification_youtube8m_tpu.train import (
        AsyncCheckpointSaver,
    )

    cfg = TINY
    opt = make_optimizer(cfg.optimizer, cfg.clip_gradient_norm)
    mesh = create_mesh(model=2)
    state = place_state(init_distill_state(cfg, opt), mesh, min_dim=16)

    sync_dir, async_dir = str(tmp_path / "sync"), str(tmp_path / "async")
    save_checkpoint(sync_dir, state, 0, backend="orbax")
    saver = AsyncCheckpointSaver()
    saver.save(async_dir, state, 0, backend="orbax")
    saver.wait()
    assert saver._mode in ("host", "hbm")

    template = place_state(init_distill_state(cfg, opt), mesh, min_dim=16)
    a = restore_checkpoint(latest_checkpoint(sync_dir), template)
    b = restore_checkpoint(latest_checkpoint(async_dir), template)
    jax.tree.map(
        lambda x, y: np.testing.assert_array_equal(
            np.asarray(x), np.asarray(y)), a, b)


def test_async_saver_propagates_write_errors(tmp_path):
    from efficientvideoclassification_youtube8m_tpu.train import (
        AsyncCheckpointSaver,
    )

    blocker = tmp_path / "not_a_dir"
    blocker.write_text("file where the train_dir should be")
    saver = AsyncCheckpointSaver()
    saver.save(str(blocker), {"x": jax.numpy.ones((2,))}, 1)
    with pytest.raises(OSError):
        saver.wait()
    # the saver is reusable after the failure
    saver.save(str(tmp_path / "ok"), {"x": jax.numpy.ones((2,))}, 1)
    saver.wait()
    assert latest_checkpoint(str(tmp_path / "ok"))


def test_async_saver_orbax_single_process(tmp_path):
    """Single-process orbax saves run through the async snapshot+writer
    path too (no collective to reorder): the async checkpoint restores
    identically to a synchronous orbax save, including after the saved
    state's buffers are donated away."""
    from efficientvideoclassification_youtube8m_tpu.train import (
        AsyncCheckpointSaver,
    )

    cfg = TINY
    opt = make_optimizer(cfg.optimizer, cfg.clip_gradient_norm)
    state = init_distill_state(cfg, opt)
    feats, labels, nf = _tiny_batch(cfg, seed=7)
    step = jax.jit(build_distill_train_step(cfg, opt), donate_argnums=(0,))
    state, _ = step(state, feats, labels, nf)

    sync_dir, async_dir = str(tmp_path / "sync"), str(tmp_path / "async")
    step_val = int(jax.device_get(state.global_step))
    save_checkpoint(sync_dir, state, step_val, backend="orbax")

    saver = AsyncCheckpointSaver()
    saver.save(async_dir, state, step_val, backend="orbax")
    for _ in range(3):  # donate the saved buffers while the write drains
        state, _ = step(state, feats, labels, nf)
    saver.wait()

    template = init_distill_state(cfg, opt)
    a = restore_checkpoint(latest_checkpoint(sync_dir), template)
    b = restore_checkpoint(latest_checkpoint(async_dir), template)
    jax.tree.map(
        lambda x, y: np.testing.assert_array_equal(
            np.asarray(x), np.asarray(y)), a, b)


def test_async_saver_orbax_multihost_sync_fallback(tmp_path, monkeypatch):
    """Multi-host orbax saves fall back to the SYNCHRONOUS path only
    when the coordination-service barrier routing is unavailable
    (jax.distributed uninitialized here, so orbax's commit barrier would
    run device collectives off the main thread). The real async
    multi-host behavior — both backends saving from writer threads while
    stepping, raise-together on writer failure — is covered by the
    2-process run (tests/_multihost_worker.py)."""
    import threading

    import numpy as np
    from jax.experimental import multihost_utils

    from efficientvideoclassification_youtube8m_tpu.train import (
        AsyncCheckpointSaver,
    )
    from efficientvideoclassification_youtube8m_tpu.train import (
        checkpoint as checkpoint_mod,
    )

    calls = []
    monkeypatch.setattr(
        checkpoint_mod, "save_checkpoint",
        lambda *a, **kw: calls.append((threading.get_ident(), a, kw)))
    monkeypatch.setattr(checkpoint_mod.jax, "process_count", lambda: 2)
    # the single-process mock can't run a real cross-process all-gather;
    # stand in for "every peer reports ok"
    monkeypatch.setattr(multihost_utils, "process_allgather",
                        lambda x, **kw: np.asarray([x, x]))

    saver = AsyncCheckpointSaver()
    saver.save(str(tmp_path), {"x": jax.numpy.ones((2,))}, 1,
               backend="orbax")
    assert calls and calls[0][0] == threading.get_ident()  # ran inline
    assert calls[0][2]["backend"] == "orbax"
    assert saver._warned_sync  # fell back WITH the logged reason


def test_distill_overfits_one_batch():
    """Learning sanity: both towers memorize a fixed batch (teacher
    Hit@1 -> 1.0) — end-to-end signal through preprocess, both scans,
    MoE, losses, clipping, Adam, and the LR schedule."""
    cfg = TINY.replace(base_learning_rate=0.02)
    opt = make_optimizer(cfg.optimizer, cfg.clip_gradient_norm)
    state = init_distill_state(cfg, opt)
    step = jax.jit(build_distill_train_step(cfg, opt, top_k=5))
    feats, labels, nf = _tiny_batch(cfg, seed=11)
    for _ in range(80):
        state, metrics = step(state, feats, labels, nf)
    topk_idx = np.asarray(metrics["topk_idx"])
    lab = np.asarray(labels)
    hits = [lab[i, topk_idx[i, 0]] for i in range(cfg.batch_size)]
    assert np.mean(hits) >= 0.75, np.mean(hits)


def test_class_imbalance_loss_via_counts_file(tmp_path):
    cfg = TINY.replace(label_loss="CrossEntropyLossClassImbalance",
                       class_counts_file=str(tmp_path / "counts_tv"))
    with open(cfg.class_counts_file, "w") as f:
        f.write("\n".join(str(1000 + i) for i in range(cfg.num_classes)))
    opt = make_optimizer(cfg.optimizer, cfg.clip_gradient_norm)
    state = init_distill_state(cfg, opt)
    step = jax.jit(build_distill_train_step(cfg, opt, top_k=5))
    feats, labels, nf = _tiny_batch(cfg, seed=12)
    _, metrics = step(state, feats, labels, nf)
    assert np.isfinite(float(metrics["teacher_label_loss"]))


def test_counts_file_read_at_build_time(tmp_path):
    """The class-counts file is read ONCE when the step is built — never
    under trace. Deleting it after build must not break the step."""
    import os

    cfg = TINY.replace(label_loss="CrossEntropyLossClassImbalance",
                       class_counts_file=str(tmp_path / "counts_tv"))
    with open(cfg.class_counts_file, "w") as f:
        f.write("\n".join(str(1000 + i) for i in range(cfg.num_classes)))
    opt = make_optimizer(cfg.optimizer, cfg.clip_gradient_norm)
    state = init_distill_state(cfg, opt)
    step = jax.jit(build_distill_train_step(cfg, opt, top_k=5))
    os.remove(cfg.class_counts_file)  # no file I/O may happen after build
    feats, labels, nf = _tiny_batch(cfg, seed=12)
    _, metrics = step(state, feats, labels, nf)
    assert np.isfinite(float(metrics["teacher_label_loss"]))


def test_periodic_save_names_match_state_step(tmp_path, monkeypatch):
    """Every periodic checkpoint is named with the step stored IN the
    saved state (no one-step lag from the lagged metric logging)."""
    from efficientvideoclassification_youtube8m_tpu.cli import train as train_cli
    from efficientvideoclassification_youtube8m_tpu.data import (
        write_synthetic_frame_shard,
    )

    data = tmp_path / "shard.tfrecord"
    write_synthetic_frame_shard(str(data), num_videos=12, seed=3,
                                feature_names=("rgb", "audio"),
                                feature_sizes=(6, 2), max_frames=40,
                                vocab_size=30)
    from efficientvideoclassification_youtube8m_tpu.train import (
        checkpoint as checkpoint_mod,
    )

    recorded = []
    real_save = checkpoint_mod.save_checkpoint

    def recording_save(train_dir, state, step, **kw):
        # runs inside the AsyncCheckpointSaver's writer thread on the
        # donation-safe snapshot — its stored step must still match
        recorded.append((step, int(jax.device_get(state.global_step))))
        return real_save(train_dir, state, step, **kw)

    monkeypatch.setattr(checkpoint_mod, "save_checkpoint", recording_save)
    train_cli.main([
        "--num_classes", "30", "--batch_size", "8", "--lstm_cells", "8",
        "--lstm_layers", "2", "--max_num_frames", "40",
        "--num_inputs_to_lstm", "4", "--num_inputs_L1", "2",
        "--every_n", "2", "--feature_names", "rgb, audio",
        "--feature_sizes", "6, 2", "--compute_dtype", "float32",
        "--scan_unroll", "1", "--top_k", "5", "--num_epochs", "2",
        "--train_dir", str(tmp_path / "model") + "/",
        "--train_data_pattern", str(data),
        "--start_new_model", "true",
        "--save_model_secs", "0",  # save after every step
    ])
    assert len(recorded) >= 3  # 3 mid-loop saves + the final save
    for named_step, state_step in recorded:
        assert named_step == state_step, recorded


def test_preprocess_zeroes_padding_frames():
    """The loader pads uint8 with 0, which dequantizes to -1.992 — rows
    past num_frames must come out exactly 0.0 like the reference's
    dequantize-then-pad order (readers.py:170-173)."""
    from efficientvideoclassification_youtube8m_tpu.train.step import (
        preprocess_batch,
    )

    cfg = TINY
    feats = np.zeros((2, 6, cfg.total_feature_size), np.uint8)
    feats[0, :3] = 200
    feats[1, :6] = 100
    nf = jnp.array([3, 6])
    out = np.asarray(preprocess_batch(cfg, jnp.asarray(feats), nf))
    assert np.all(out[0, 3:] == 0.0)
    assert np.all(out[0, :3] != 0.0)
    assert np.all(out[1] != 0.0)
    # without num_frames (legacy path) padding rows are NOT zeroed
    out2 = np.asarray(preprocess_batch(cfg, jnp.asarray(feats)))
    assert np.all(out2[0, 3:] != 0.0)


def test_orbax_checkpoint_backend(tmp_path):
    """Orbax directory checkpoints interoperate with the pointer-file /
    max_to_keep / restore machinery (auto-detected by restore)."""
    cfg = TINY
    opt = make_optimizer(cfg.optimizer, cfg.clip_gradient_norm)
    state = init_distill_state(cfg, opt)
    train_dir = str(tmp_path / "train")
    import os

    p1 = save_checkpoint(train_dir, state, 2, backend="orbax")
    assert os.path.isdir(p1)
    assert latest_checkpoint(train_dir) == p1

    feats, labels, nf = _tiny_batch(cfg, seed=13)
    step = jax.jit(build_distill_train_step(cfg, opt))
    state2, _ = step(state, feats, labels, nf)
    p2 = save_checkpoint(train_dir, state2, 4, backend="orbax")
    assert latest_checkpoint(train_dir) == p2
    assert not os.path.exists(p1)  # max_to_keep=1
    assert checkpoint_step(p2) == 4

    template = init_distill_state(cfg, opt)
    restored = restore_checkpoint(p2, template)
    jax.tree.map(
        lambda a, b: np.testing.assert_array_equal(np.asarray(a), np.asarray(b)),
        restored.params_student, jax.device_get(state2.params_student))
    assert int(restored.global_step) == int(state2.global_step)

    # restoring onto a SHARDED target places shards directly (no host
    # round-trip): restored leaves carry the target's shardings
    from efficientvideoclassification_youtube8m_tpu.parallel import (
        create_mesh,
        place_state,
    )

    mesh = create_mesh(model=2)
    sharded_template = place_state(init_distill_state(cfg, opt), mesh,
                                   min_dim=16)
    restored_sharded = restore_checkpoint(p2, sharded_template)
    jax.tree.map(
        lambda a, b: np.testing.assert_array_equal(
            np.asarray(a), np.asarray(b)),
        restored_sharded.params_student,
        jax.device_get(state2.params_student))

    def assert_same_sharding(a, t):
        assert a.sharding.is_equivalent_to(t.sharding, a.ndim), (
            a.sharding, t.sharding)

    jax.tree.map(assert_same_sharding, restored_sharded, sharded_template)

    # ... and SAVING a sharded state writes shard-by-shard (no host
    # gather) and round-trips through the sharded restore
    sharded_state = restore_checkpoint(p2, sharded_template)
    p3 = save_checkpoint(train_dir, sharded_state, 6, backend="orbax")
    back = restore_checkpoint(p3, sharded_template)
    jax.tree.map(
        lambda a, b: np.testing.assert_array_equal(
            np.asarray(a), np.asarray(b)),
        back.params_teacher, jax.device_get(state2.params_teacher))
    jax.tree.map(assert_same_sharding, back, sharded_template)


def test_dbof_finetune_updates_bn_moving_stats():
    """The finetune step consumes DBoF's `updated_params`: batch-norm
    moving averages advance with every step — the UPDATE_OPS control
    dependency of the reference (train.py:312-318) — while trainables
    take the gradient update."""
    import dataclasses

    cfg = dataclasses.replace(
        TINY, model="DbofModel", dbof_cluster_size=16, dbof_hidden_size=8,
        iterations=5,
    )
    opt = make_optimizer(cfg.optimizer, cfg.clip_gradient_norm)
    state = student_state_from_distill(init_distill_state(cfg, opt), opt)
    p0 = jax.device_get(state.params_student)
    np.testing.assert_array_equal(p0["input_bn"]["moving_mean"], 0.0)
    np.testing.assert_array_equal(p0["input_bn"]["moving_var"], 1.0)

    step = jax.jit(build_finetune_step(cfg, opt))
    feats, labels, nf = _tiny_batch(cfg, seed=7)
    state, m1 = step(state, feats, labels, nf)
    p1 = jax.device_get(state.params_student)
    for bn in ("input_bn", "cluster_bn", "hidden1_bn"):
        assert np.any(p1[bn]["moving_mean"] != 0.0), bn
        assert np.any(p1[bn]["moving_var"] != 1.0), bn
    # trainables moved too (gradient update, not just the stat fold-back)
    assert np.any(p1["cluster"]["w"] != p0["cluster"]["w"])

    # stats keep advancing (decay 0.999 toward the batch stats)
    state, _ = step(state, feats, labels, nf)
    p2 = jax.device_get(state.params_student)
    assert np.any(p2["input_bn"]["moving_mean"] != p1["input_bn"]["moving_mean"])

    # eval consumes the moving stats without mutating state
    eval_step = jax.jit(build_eval_step(cfg))
    out = eval_step(state.params_student, feats, labels, nf)
    assert out["predictions"].shape == (cfg.batch_size, cfg.num_classes)
    assert np.all(np.isfinite(np.asarray(out["predictions"])))


def test_dbof_faithful_eval_sampling_flag():
    """Reference DBoF samples frames RANDOMLY at eval too
    (model_utils.py:39-58 via frame_level_models.py:126-131). Faithful
    mode reproduces that; the corrected default (faithful_quirks=False)
    evaluates on deterministic even samples."""
    import dataclasses

    base = dataclasses.replace(
        TINY, model="DbofModel", dbof_cluster_size=16, dbof_hidden_size=8,
        iterations=5,
    )
    opt = make_optimizer(base.optimizer, base.clip_gradient_norm)
    state = student_state_from_distill(init_distill_state(base, opt), opt)
    feats, labels, nf = _tiny_batch(base, seed=3)

    cfg_f = dataclasses.replace(base, faithful_quirks=True)
    cfg_c = dataclasses.replace(base, faithful_quirks=False)
    out_f = jax.jit(build_eval_step(cfg_f))(state.params_student, feats,
                                            labels, nf)
    out_f2 = jax.jit(build_eval_step(cfg_f))(state.params_student, feats,
                                             labels, nf)
    out_c = jax.jit(build_eval_step(cfg_c))(state.params_student, feats,
                                            labels, nf)

    # faithful: random sampling -> different frames than even sampling
    assert np.any(np.asarray(out_f["predictions"])
                  != np.asarray(out_c["predictions"]))
    # but reproducible under one jitted program on the same batch
    np.testing.assert_array_equal(np.asarray(out_f["predictions"]),
                                  np.asarray(out_f2["predictions"]))

    # the LSTM flagship is unaffected by the flag at eval
    opt_l = make_optimizer(TINY.optimizer, TINY.clip_gradient_norm)
    st_l = student_state_from_distill(init_distill_state(TINY, opt_l), opt_l)
    f2, l2, n2 = _tiny_batch(TINY, seed=4)
    for cfg_l in (dataclasses.replace(TINY, faithful_quirks=True),
                  dataclasses.replace(TINY, faithful_quirks=False)):
        out_l = jax.jit(build_eval_step(cfg_l))(st_l.params_student, f2, l2, n2)
        assert np.all(np.isfinite(np.asarray(out_l["predictions"])))


def test_dbof_no_batch_norm_variant():
    """`--dbof_add_batch_norm False` swaps the norms for biases
    (frame_level_models.py:150-162,175-187) and still trains."""
    import dataclasses

    cfg = dataclasses.replace(
        TINY, model="DbofModel", dbof_cluster_size=16, dbof_hidden_size=8,
        iterations=5, dbof_add_batch_norm=False,
    )
    opt = make_optimizer(cfg.optimizer, cfg.clip_gradient_norm)
    state = student_state_from_distill(init_distill_state(cfg, opt), opt)
    params = jax.device_get(state.params_student)
    assert "input_bn" not in params
    assert "b" in params["cluster"] and "b" in params["hidden1"]

    step = jax.jit(build_finetune_step(cfg, opt))
    feats, labels, nf = _tiny_batch(cfg, seed=11)
    state, metrics = step(state, feats, labels, nf)
    assert np.isfinite(float(metrics["student_label_loss"]))


def test_host_subsampled_eval_step_parity():
    """build_eval_step(host_subsampled=True) on host-strided uint8 equals
    the in-graph-subsampled step on the full frames — the H2D-saving
    layout used by cli/eval, cli/infer, and the serving Predictor."""
    from efficientvideoclassification_youtube8m_tpu.ops.preprocess import (
        host_subsample,
    )

    cfg = TINY
    opt = make_optimizer(cfg.optimizer, cfg.clip_gradient_norm)
    state = student_state_from_distill(init_distill_state(cfg, opt), opt)
    feats, labels, nf = _tiny_batch(cfg, seed=21)

    full = jax.jit(build_eval_step(cfg, top_k=5))(
        state.params_student, feats, labels, nf)
    sub = jax.jit(build_eval_step(cfg, top_k=5, host_subsampled=True))(
        state.params_student,
        jnp.asarray(host_subsample(np.asarray(feats), cfg.every_n)),
        labels, nf)
    assert sub["predictions"].shape == full["predictions"].shape
    for k in ("predictions", "per_example_loss", "perr_precision",
              "topk_val", "topk_idx"):
        np.testing.assert_array_equal(np.asarray(full[k]),
                                      np.asarray(sub[k]))
