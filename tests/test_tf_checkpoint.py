"""TF Saver-V2 checkpoint import.

Fixtures are written by REAL TensorFlow (tf.compat.v1.train.Saver, the
same writer the reference uses); the reader/importer under test is the
package's pure-Python implementation (`data/tf_checkpoint.py`,
`train/tf_import.py`) — no TF inside the framework.
"""

import os

import numpy as np
import pytest

tf = pytest.importorskip("tensorflow.compat.v1")

from efficientvideoclassification_youtube8m_tpu.data.tf_checkpoint import (
    TFCheckpointReader,
    _snappy_decompress,
    is_tf_checkpoint,
    latest_tf_checkpoint,
)
from efficientvideoclassification_youtube8m_tpu.train import (
    init_distill_state,
    latest_checkpoint,
    make_optimizer,
    restore_checkpoint,
    student_state_from_distill,
)
from efficientvideoclassification_youtube8m_tpu.train.tf_import import (
    moe_bias_from_tf,
    moe_bias_to_tf,
    moe_weights_from_tf,
    moe_weights_to_tf,
)
from efficientvideoclassification_youtube8m_tpu.utils.config import TrainConfig

tf.disable_eager_execution()


def _tiny_cfg():
    return TrainConfig(
        num_classes=12,
        lstm_cells=6,
        lstm_layers=2,
        max_num_frames=20,
        num_inputs_to_lstm=4,
        num_inputs_L1=2,
        feature_sizes="5, 3",
        scan_unroll=1,
        compute_dtype="float32",
    )


def _save_tf_fixture(tmp_path, state, global_step=84, with_adam=True):
    """Write a reference-shaped TF checkpoint holding `state`'s params:
    reference var names (validate.py:350-381), reference MoE column
    layout, optional Adam slots + beta powers."""
    import jax

    def tf_vars_for(scope, params, adam_t):
        out = {}
        for lk, ln in (("rnn_l1", 1), ("rnn_l2", 2)):
            for i, cell in enumerate(params[lk]):
                base = (f"{scope}/RNN_L{ln}/rnn/multi_rnn_cell/cell_{i}"
                        "/basic_lstm_cell")
                out[f"{base}/kernel"] = np.asarray(cell["kernel"])
                out[f"{base}/bias"] = np.asarray(cell["bias"])
        clf = params["classifier"]
        out[f"{scope}/classifier/gates/weights"] = moe_weights_to_tf(
            np.asarray(clf["gates"]["w"]))
        out[f"{scope}/classifier/experts/weights"] = moe_weights_to_tf(
            np.asarray(clf["experts"]["w"]))
        out[f"{scope}/classifier/experts/biases"] = moe_bias_to_tf(
            np.asarray(clf["experts"]["b"]))
        return out

    rng = np.random.default_rng(7)
    tensors = {"global_step": np.int64(global_step)}
    tensors.update(tf_vars_for("model", state.params_teacher, 5))
    tensors.update(tf_vars_for("model_student", state.params_student, 9))
    if with_adam:
        for name in [n for n in list(tensors) if n != "global_step"]:
            tensors[name + "/Adam"] = rng.normal(
                size=tensors[name].shape).astype(np.float32)
            tensors[name + "/Adam_1"] = np.abs(rng.normal(
                size=tensors[name].shape)).astype(np.float32)
        # TF1 Adam stores b^(t+1) after t updates (init b, multiplied
        # after each apply — verified against a live AdamOptimizer)
        tensors["beta1_power"] = np.float32(0.9 ** 6)     # teacher: t=5
        tensors["beta1_power_1"] = np.float32(0.9 ** 10)  # student: t=9
        tensors["beta2_power"] = np.float32(0.999 ** 6)
        tensors["beta2_power_1"] = np.float32(0.999 ** 10)

    g = tf.Graph()
    with g.as_default():
        tf_vars = {
            name: tf.get_variable(name, initializer=val)
            for name, val in tensors.items()
        }
        saver = tf.train.Saver(tf_vars)
        with tf.Session() as sess:
            sess.run(tf.global_variables_initializer())
            prefix = saver.save(
                sess, os.path.join(str(tmp_path), "model.ckpt"),
                global_step=global_step, write_meta_graph=False,
            )
    return prefix, tensors


def test_moe_layout_round_trip_and_semantics():
    rng = np.random.default_rng(0)
    d, m, v = 5, 3, 7
    w_tf = rng.normal(size=(d, v * m)).astype(np.float32)
    w = moe_weights_from_tf(w_tf, m)
    assert w.shape == (d, m, v)
    for c in range(v):
        for k in range(m):
            np.testing.assert_array_equal(w[:, k, c], w_tf[:, c * m + k])
    np.testing.assert_array_equal(moe_weights_to_tf(w), w_tf)

    b_tf = rng.normal(size=(v * m,)).astype(np.float32)
    b = moe_bias_from_tf(b_tf, m)
    for c in range(v):
        for k in range(m):
            assert b[k, c] == b_tf[c * m + k]
    np.testing.assert_array_equal(moe_bias_to_tf(b), b_tf)


def test_reader_round_trips_tf_written_bundle(tmp_path):
    rng = np.random.default_rng(1)
    tensors = {
        "a/kernel": rng.normal(size=(9, 33)).astype(np.float32),
        "a/bias": rng.normal(size=(33,)).astype(np.float32),
        "counts": rng.integers(0, 100, size=(4, 5)).astype(np.int64),
        "flags": np.array([True, False, True]),
        "scalar": np.float64(3.25),
    }
    g = tf.Graph()
    with g.as_default():
        tf_vars = {n: tf.get_variable(n, initializer=v)
                   for n, v in tensors.items()}
        saver = tf.train.Saver(tf_vars)
        with tf.Session() as sess:
            sess.run(tf.global_variables_initializer())
            prefix = saver.save(sess, os.path.join(str(tmp_path), "m.ckpt"),
                                write_meta_graph=False)

    assert is_tf_checkpoint(prefix)
    assert is_tf_checkpoint(prefix + ".index")
    reader = TFCheckpointReader(prefix)
    assert reader.variable_names() == sorted(tensors)
    listed = {n: (s, d) for n, s, d in reader.list_variables()}
    assert listed["a/kernel"] == ((9, 33), "float32")
    assert listed["scalar"] == ((), "float64")
    for name, val in tensors.items():
        got = reader.get_tensor(name)
        assert got.dtype == val.dtype
        np.testing.assert_array_equal(got, val)


def test_import_distill_state_full(tmp_path):
    import jax

    cfg = _tiny_cfg()
    opt = make_optimizer(cfg.optimizer, cfg.clip_gradient_norm)
    golden = init_distill_state(cfg, opt)
    prefix, tensors = _save_tf_fixture(tmp_path, golden, global_step=84)

    template = init_distill_state(cfg, opt, rng=jax.random.PRNGKey(99))
    restored = restore_checkpoint(prefix, template)

    # params: exact round trip through the reference layout
    for got, want in zip(
        jax.tree_util.tree_leaves(
            (restored.params_teacher, restored.params_student)),
        jax.tree_util.tree_leaves(
            (golden.params_teacher, golden.params_student)),
    ):
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
    assert int(restored.global_step) == 84

    # Adam moments imported (teacher slot count from beta1_power=0.9^5)
    assert int(restored.opt_teacher.count) == 5
    assert int(restored.opt_student.count) == 9
    np.testing.assert_array_equal(
        np.asarray(restored.opt_teacher.mu["rnn_l1"][0]["kernel"]),
        tensors["model/RNN_L1/rnn/multi_rnn_cell/cell_0/basic_lstm_cell"
                "/kernel/Adam"],
    )
    np.testing.assert_array_equal(
        np.asarray(restored.opt_student.nu["classifier"]["experts"]["b"]),
        moe_bias_from_tf(
            tensors["model_student/classifier/experts/biases/Adam_1"],
            golden.params_student["classifier"]["experts"]["b"].shape[0],
        ),
    )

    # forward parity: imported teacher == golden teacher on a real batch
    from efficientvideoclassification_youtube8m_tpu.train.step import (
        forward_teacher,
        preprocess_batch,
    )

    rng = np.random.default_rng(3)
    feats = rng.integers(
        0, 256, size=(4, cfg.max_num_frames, cfg.total_feature_size),
        dtype=np.uint8)
    nf = np.asarray([20, 7, 13, 4], np.int32)
    x = preprocess_batch(cfg, feats)
    out_golden = forward_teacher(cfg, golden.params_teacher, x, nf)
    out_imported = forward_teacher(cfg, restored.params_teacher, x, nf)
    np.testing.assert_array_equal(
        np.asarray(out_golden["predictions"]),
        np.asarray(out_imported["predictions"]),
    )


def test_import_student_state_from_distill_bundle_adam_count(tmp_path):
    """Restoring a DISTILL bundle straight into a StudentState (e.g.
    cli.finetune resuming from a reference distill train_dir) must pair
    the student's Adam slots with `beta1_power_1` (t=9 in the fixture),
    not the teacher's `beta1_power` (t=5)."""
    import jax

    cfg = _tiny_cfg()
    opt = make_optimizer(cfg.optimizer, cfg.clip_gradient_norm)
    golden = init_distill_state(cfg, opt)
    prefix, _ = _save_tf_fixture(tmp_path, golden, global_step=84)

    template = student_state_from_distill(
        init_distill_state(cfg, opt, rng=jax.random.PRNGKey(5)), opt
    )
    restored = restore_checkpoint(prefix, template)
    assert int(restored.opt_student.count) == 9


def test_import_student_state_without_adam(tmp_path):
    import jax

    cfg = _tiny_cfg()
    opt = make_optimizer(cfg.optimizer, cfg.clip_gradient_norm)
    golden = init_distill_state(cfg, opt)
    prefix, _ = _save_tf_fixture(tmp_path, golden, global_step=12,
                                 with_adam=False)

    template = student_state_from_distill(
        init_distill_state(cfg, opt, rng=jax.random.PRNGKey(5)), opt
    )
    restored = restore_checkpoint(prefix, template)
    for got, want in zip(
        jax.tree_util.tree_leaves(restored.params_student),
        jax.tree_util.tree_leaves(golden.params_student),
    ):
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
    assert int(restored.global_step) == 12
    assert int(restored.opt_student.count) == 0  # no slots -> fresh Adam


@pytest.mark.parametrize("add_bn", [True, False])
def test_import_dbof_student_state(tmp_path, add_bn):
    """DBoF TF-V2 bundles import with the reference's UNNAMED-Variable
    ordering (cluster_weights -> [cluster_biases] -> hidden1_weights ->
    [hidden1_biases], frame_level_models.py:145-187), slim batch_norm
    moving stats mapped, and the MoE head at the bare scope (DBoF calls
    the video-level model without a 'classifier' variable_scope)."""
    import jax

    cfg = _tiny_cfg().replace(model="DbofModel", dbof_cluster_size=10,
                              dbof_hidden_size=6, dbof_add_batch_norm=add_bn)
    opt = make_optimizer(cfg.optimizer, cfg.clip_gradient_norm)
    golden = student_state_from_distill(init_distill_state(cfg, opt), opt)
    params = jax.device_get(golden.params_student)
    # make BN stats distinctive so the mapping is actually exercised
    if add_bn:
        rng = np.random.default_rng(3)
        for bn in ("input_bn", "cluster_bn", "hidden1_bn"):
            for k in params[bn]:
                params[bn][k] = rng.normal(
                    size=params[bn][k].shape).astype(np.float32)

    scope = "model_student"
    tensors = {"global_step": np.int64(7)}
    k = [0]

    def unnamed(val):
        name = (f"{scope}/Variable" if k[0] == 0
                else f"{scope}/Variable_{k[0]}")
        k[0] += 1
        tensors[name] = np.asarray(val)

    unnamed(params["cluster"]["w"])
    if not add_bn:
        unnamed(params["cluster"]["b"])
    unnamed(params["hidden1"]["w"])
    if not add_bn:
        unnamed(params["hidden1"]["b"])
    if add_bn:
        for bn in ("input_bn", "cluster_bn", "hidden1_bn"):
            tensors[f"{scope}/{bn}/gamma"] = np.asarray(params[bn]["scale"])
            tensors[f"{scope}/{bn}/beta"] = np.asarray(params[bn]["offset"])
            tensors[f"{scope}/{bn}/moving_mean"] = np.asarray(
                params[bn]["moving_mean"])
            tensors[f"{scope}/{bn}/moving_variance"] = np.asarray(
                params[bn]["moving_var"])
    tensors[f"{scope}/gates/weights"] = moe_weights_to_tf(
        np.asarray(params["classifier"]["gates"]["w"]))
    tensors[f"{scope}/experts/weights"] = moe_weights_to_tf(
        np.asarray(params["classifier"]["experts"]["w"]))
    tensors[f"{scope}/experts/biases"] = moe_bias_to_tf(
        np.asarray(params["classifier"]["experts"]["b"]))

    g = tf.Graph()
    with g.as_default():
        tf_vars = {n: tf.get_variable(n, initializer=v)
                   for n, v in tensors.items()}
        saver = tf.train.Saver(tf_vars)
        with tf.Session() as sess:
            sess.run(tf.global_variables_initializer())
            prefix = saver.save(sess, os.path.join(str(tmp_path), "model.ckpt"),
                                global_step=7, write_meta_graph=False)

    template = student_state_from_distill(
        init_distill_state(cfg, opt, rng=__import__("jax").random.PRNGKey(9)),
        opt)
    restored = restore_checkpoint(prefix, template)
    flat_got = jax.tree_util.tree_flatten_with_path(restored.params_student)[0]
    flat_want = jax.tree_util.tree_flatten_with_path(params)[0]
    for (pg, got), (pw, want) in zip(flat_got, flat_want):
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want),
                                      err_msg=str(pg))
    assert int(restored.global_step) == 7


def test_latest_checkpoint_reads_reference_pointer_file(tmp_path):
    cfg = _tiny_cfg()
    opt = make_optimizer(cfg.optimizer, cfg.clip_gradient_norm)
    state = init_distill_state(cfg, opt)
    prefix, _ = _save_tf_fixture(tmp_path, state, global_step=84)
    # tf.train.Saver wrote the reference-format pointer file itself
    assert os.path.exists(os.path.join(str(tmp_path), "checkpoint"))
    assert latest_checkpoint(str(tmp_path)) == prefix
    assert latest_tf_checkpoint(str(tmp_path)) == prefix


def test_inspect_checkpoint_prints_tf(tmp_path, capsys):
    from efficientvideoclassification_youtube8m_tpu.cli import (
        inspect_checkpoint,
    )

    cfg = _tiny_cfg()
    opt = make_optimizer(cfg.optimizer, cfg.clip_gradient_norm)
    state = init_distill_state(cfg, opt)
    prefix, _ = _save_tf_fixture(tmp_path, state, with_adam=False)
    inspect_checkpoint.main(["--file_name", prefix])
    out = capsys.readouterr().out
    assert ("tensor_name: model/RNN_L1/rnn/multi_rnn_cell/cell_0/"
            "basic_lstm_cell/kernel") in out
    assert "tensor_name: global_step  shape: []  dtype: int64" in out


def test_snappy_decoder():
    # literal "hello " + copy(offset=6, len=6) + literal "!" = "hello hello !"?
    # Build: uncompressed length varint, literal tag, data, 1-byte-offset copy
    payload = b"hello "
    lit_tag = bytes([(len(payload) - 1) << 2])
    copy_tag = bytes([((6 - 4) & 0x7) << 2 | 1 | (0 << 5), 6])  # len 6, off 6
    raw = bytes([13]) + lit_tag + payload + copy_tag + bytes([0 << 2]) + b"!"
    out = _snappy_decompress(memoryview(raw))
    assert out == b"hello hello !"


def test_serving_predictor_from_tf_checkpoint_dir(tmp_path):
    """The switch-over story end-to-end: a reference-trained TF
    checkpoint directory serves BOTH towers through the Predictor with
    no conversion step."""
    import jax

    from efficientvideoclassification_youtube8m_tpu.serving import Predictor
    from efficientvideoclassification_youtube8m_tpu.train.step import (
        forward_teacher,
        preprocess_batch,
    )

    cfg = _tiny_cfg()
    opt = make_optimizer(cfg.optimizer, cfg.clip_gradient_norm)
    golden = init_distill_state(cfg, opt)
    _save_tf_fixture(tmp_path, golden, global_step=84, with_adam=False)

    rng = np.random.default_rng(11)
    feats = rng.integers(
        0, 256, size=(4, cfg.max_num_frames, cfg.total_feature_size),
        dtype=np.uint8)
    nf = np.asarray([20, 7, 13, 4], np.int32)

    # teacher tower from the TF bundle == the golden params' forward
    p_t = Predictor.from_checkpoint(str(tmp_path), cfg, tower="teacher",
                                    serve_batch=4)
    x = preprocess_batch(cfg, feats)
    want = forward_teacher(cfg, golden.params_teacher, x,
                           nf, inference=True)["predictions"]
    np.testing.assert_allclose(p_t.predict(feats, nf), np.asarray(want),
                               rtol=1e-5, atol=1e-6)

    # student tower also loads (both towers live in one bundle)
    p_s = Predictor.from_checkpoint(str(tmp_path), cfg, serve_batch=4)
    probs = p_s.predict(feats, nf)
    assert probs.shape == (4, cfg.num_classes)
    assert np.all(np.isfinite(probs))


def test_validate_cli_over_tf_checkpoint_dir(tmp_path):
    """cli.validate pointed at a reference TF train_dir evaluates it
    directly (pointer file + importer)."""
    from efficientvideoclassification_youtube8m_tpu.cli import validate
    from efficientvideoclassification_youtube8m_tpu.data.yt8m import (
        write_synthetic_frame_shard,
    )

    cfg = _tiny_cfg()
    opt = make_optimizer(cfg.optimizer, cfg.clip_gradient_norm)
    state = init_distill_state(cfg, opt)
    _save_tf_fixture(tmp_path, state, global_step=84, with_adam=False)
    write_synthetic_frame_shard(
        str(tmp_path / "validate-0000.tfrecord"), num_videos=6, seed=3,
        max_frames=cfg.max_num_frames, min_frames=3,
        vocab_size=cfg.num_classes, feature_sizes=(5, 3),
    )
    validate.main([
        "--train_dir", str(tmp_path),
        "--eval_data_pattern", str(tmp_path / "validate-*.tfrecord"),
        "--num_classes", str(cfg.num_classes),
        "--feature_sizes", "5, 3",
        "--max_num_frames", str(cfg.max_num_frames),
        "--lstm_cells", str(cfg.lstm_cells),
        "--num_inputs_to_lstm", str(cfg.num_inputs_to_lstm),
        "--num_inputs_L1", str(cfg.num_inputs_L1),
        "--every_n", "2",
        "--batch_size", "8",  # divisible by the 8-device test mesh
        "--top_k", "5",
        "--compute_dtype", "float32",
        "--scan_unroll", "1",
        "--num_readers", "1",
        "--run_once", "true",
    ])


# ---------------------------------------------------------------------------
# TF-V2 EXPORT: the inverse direction — checkpoints this
# framework WRITES must be consumable by the reference's TF tooling.
# ---------------------------------------------------------------------------


def _stateful_distill_state(cfg, opt, t_teacher=5, t_student=9, step=84):
    """A distill state with non-trivial Adam moments and step counts."""
    import jax
    import jax.numpy as jnp

    state = init_distill_state(cfg, opt)
    rng = np.random.default_rng(3)

    def fill(tree):
        return jax.tree.map(
            lambda x: jnp.asarray(
                rng.normal(size=x.shape).astype(np.float32)), tree)

    state = state.replace(
        opt_teacher=state.opt_teacher._replace(
            count=jnp.asarray(t_teacher, state.opt_teacher.count.dtype),
            mu=fill(state.opt_teacher.mu), nu=fill(state.opt_teacher.nu)),
        opt_student=state.opt_student._replace(
            count=jnp.asarray(t_student, state.opt_student.count.dtype),
            mu=fill(state.opt_student.mu), nu=fill(state.opt_student.nu)),
        global_step=jnp.asarray(step, state.global_step.dtype),
    )
    return state


def test_export_import_roundtrip_distill(tmp_path):
    """import(export(state)) == state bit-for-bit: params, both towers'
    Adam moments + step counts, global_step."""
    import jax

    from efficientvideoclassification_youtube8m_tpu.train.tf_export import (
        export_tf_checkpoint,
    )

    cfg = _tiny_cfg()
    opt = make_optimizer(cfg.optimizer, cfg.clip_gradient_norm)
    state = _stateful_distill_state(cfg, opt)
    prefix = export_tf_checkpoint(str(tmp_path / "model.ckpt-84"), state)
    assert is_tf_checkpoint(prefix)

    template = init_distill_state(cfg, opt, rng=__import__("jax").random.PRNGKey(99))
    restored = restore_checkpoint(prefix, template)
    for field in ("params_teacher", "params_student"):
        jax.tree.map(
            lambda a, b: np.testing.assert_array_equal(
                np.asarray(a), np.asarray(b)),
            getattr(restored, field), getattr(state, field))
    for field in ("opt_teacher", "opt_student"):
        got, want = getattr(restored, field), getattr(state, field)
        assert int(got.count) == int(want.count), field
        jax.tree.map(
            lambda a, b: np.testing.assert_array_equal(
                np.asarray(a), np.asarray(b)), got.mu, want.mu)
        jax.tree.map(
            lambda a, b: np.testing.assert_array_equal(
                np.asarray(a), np.asarray(b)), got.nu, want.nu)
    assert int(restored.global_step) == 84


def test_export_student_roundtrip(tmp_path):
    import jax

    from efficientvideoclassification_youtube8m_tpu.train.tf_export import (
        export_tf_checkpoint,
    )

    cfg = _tiny_cfg()
    opt = make_optimizer(cfg.optimizer, cfg.clip_gradient_norm)
    state = student_state_from_distill(
        _stateful_distill_state(cfg, opt), opt)
    prefix = export_tf_checkpoint(str(tmp_path / "model.ckpt-84"), state)
    # a single-optimizer (finetune-shaped) bundle: unsuffixed powers
    r = TFCheckpointReader(prefix)
    assert r.has_tensor("beta1_power") and not r.has_tensor("beta1_power_1")
    template = student_state_from_distill(
        init_distill_state(cfg, opt, rng=jax.random.PRNGKey(42)), opt)
    restored = restore_checkpoint(prefix, template)
    jax.tree.map(
        lambda a, b: np.testing.assert_array_equal(
            np.asarray(a), np.asarray(b)),
        restored.params_student, state.params_student)
    assert int(restored.opt_student.count) == int(state.opt_student.count)


def test_exported_bundle_consumed_by_real_tf(tmp_path):
    """The reference's own consumption paths accept an exported bundle:
    NewCheckpointReader lists/reads it (inspect_checkpoint_myfile.py:34)
    and tf.train.Saver RESTORES it into reference-named graph variables
    (validate.py:350-381) with the reference's column layout."""
    from efficientvideoclassification_youtube8m_tpu.train.tf_export import (
        export_tf_checkpoint,
    )

    cfg = _tiny_cfg()
    opt = make_optimizer(cfg.optimizer, cfg.clip_gradient_norm)
    state = _stateful_distill_state(cfg, opt)
    prefix = export_tf_checkpoint(str(tmp_path / "model.ckpt-84"), state)

    reader = tf.train.NewCheckpointReader(prefix)
    names = sorted(reader.get_variable_to_shape_map())
    # the reference distill graph's variable inventory, per tower
    for scope in ("model", "model_student"):
        for want in (
            f"{scope}/RNN_L1/rnn/multi_rnn_cell/cell_0/basic_lstm_cell/kernel",
            f"{scope}/RNN_L1/rnn/multi_rnn_cell/cell_1/basic_lstm_cell/bias",
            f"{scope}/RNN_L2/rnn/multi_rnn_cell/cell_0/basic_lstm_cell/kernel",
            f"{scope}/classifier/gates/weights",
            f"{scope}/classifier/experts/weights",
            f"{scope}/classifier/experts/biases",
            f"{scope}/classifier/experts/weights/Adam",
            f"{scope}/classifier/experts/weights/Adam_1",
        ):
            assert want in names, want
    for want in ("global_step", "beta1_power", "beta1_power_1",
                 "beta2_power", "beta2_power_1"):
        assert want in names, want
    assert reader.get_tensor("global_step") == 84
    # t=5 updates -> TF stores b1^6 (what its next apply uses)
    np.testing.assert_allclose(
        reader.get_tensor("beta1_power"), 0.9 ** 6, rtol=1e-6)
    # values arrive in the REFERENCE layout (class-interleaved columns)
    np.testing.assert_array_equal(
        reader.get_tensor("model/classifier/experts/weights"),
        moe_weights_to_tf(np.asarray(state.params_teacher["classifier"]
                                     ["experts"]["w"])))

    # the real consumption path: Saver.restore into a reference graph
    kname = "model/RNN_L1/rnn/multi_rnn_cell/cell_0/basic_lstm_cell/kernel"
    want_k = np.asarray(state.params_teacher["rnn_l1"][0]["kernel"])
    g = tf.Graph()
    with g.as_default():
        v = tf.get_variable(kname, shape=want_k.shape, dtype=tf.float32)
        saver = tf.train.Saver({kname: v})
        with tf.Session() as sess:
            saver.restore(sess, prefix)
            np.testing.assert_array_equal(sess.run(v), want_k)


def test_export_tf_cli_end_to_end(tmp_path):
    """cli.export_tf: msgpack train_dir -> TF bundle + TF-style pointer
    file; the exported bundle re-imports bit-identically."""
    import jax

    from efficientvideoclassification_youtube8m_tpu.cli import export_tf
    from efficientvideoclassification_youtube8m_tpu.train import (
        save_checkpoint,
    )

    cfg = _tiny_cfg()
    opt = make_optimizer(cfg.optimizer, cfg.clip_gradient_norm)
    state = _stateful_distill_state(cfg, opt, step=12)
    train_dir = str(tmp_path / "model_train")
    save_checkpoint(train_dir, state, 12)

    export_tf.main([
        "--train_dir", train_dir,
        "--num_classes", str(cfg.num_classes),
        "--lstm_cells", str(cfg.lstm_cells),
        "--num_inputs_to_lstm", str(cfg.num_inputs_to_lstm),
        "--num_inputs_L1", str(cfg.num_inputs_L1),
        "--max_num_frames", str(cfg.max_num_frames),
        "--feature_sizes", cfg.feature_sizes,
        "--scan_unroll", "1",
    ])
    export_dir = os.path.join(train_dir, "tf_export")
    prefix = os.path.join(export_dir, "model.ckpt-12")
    assert is_tf_checkpoint(prefix)
    # the reference-format pointer file resolves through BOTH lookup
    # paths (ours reads TF-format pointers; latest_tf_checkpoint globs)
    assert latest_checkpoint(export_dir) == prefix
    assert latest_tf_checkpoint(export_dir) == prefix
    restored = restore_checkpoint(
        prefix, init_distill_state(cfg, opt, rng=jax.random.PRNGKey(1)))
    jax.tree.map(
        lambda a, b: np.testing.assert_array_equal(
            np.asarray(a), np.asarray(b)),
        restored.params_teacher, state.params_teacher)
    assert int(restored.global_step) == 12


def test_adam_count_matches_live_tf_optimizer(tmp_path):
    """The beta1_power <-> count conversion pinned against a REAL
    tf.train.AdamOptimizer (not a synthetic fixture): TF stores b1^(t+1)
    after t updates, so import must recover t and export must write
    b1^(t+1) — b1^t would hand a fresh state power 1.0 and NaN TF's
    1/(1-beta1_power) bias correction."""
    import math

    from efficientvideoclassification_youtube8m_tpu.train.tf_import import (
        _adam_count,
    )

    g = tf.Graph()
    with g.as_default():
        v = tf.get_variable("model/v", initializer=np.float32([1.0, 2.0]))
        opt = tf.train.AdamOptimizer(learning_rate=0.1)
        train_op = opt.minimize(tf.reduce_sum(v * v))
        saver = tf.train.Saver()
        with tf.Session() as sess:
            sess.run(tf.global_variables_initializer())
            for _ in range(3):
                sess.run(train_op)
            prefix = saver.save(sess, str(tmp_path / "model.ckpt"),
                                write_meta_graph=False)
    reader = TFCheckpointReader(prefix)
    b1p = float(reader.get_tensor("beta1_power"))
    np.testing.assert_allclose(b1p, 0.9 ** 4, rtol=1e-6)
    assert _adam_count(reader, 0) == 3
    # a NEVER-trained graph stores b1^1 -> count 0 (fresh)
    g2 = tf.Graph()
    with g2.as_default():
        v = tf.get_variable("model/v", initializer=np.float32([1.0]))
        opt = tf.train.AdamOptimizer(learning_rate=0.1)
        opt.minimize(tf.reduce_sum(v * v))
        saver = tf.train.Saver()
        with tf.Session() as sess:
            sess.run(tf.global_variables_initializer())
            prefix2 = saver.save(sess, str(tmp_path / "fresh.ckpt"),
                                 write_meta_graph=False)
    assert _adam_count(TFCheckpointReader(prefix2), 0) == 0
    # export side: a fresh state (count=0) must store TF's fresh-init
    # power, never 1.0
    from efficientvideoclassification_youtube8m_tpu.train.tf_export import (
        export_tf_checkpoint,
    )

    cfg = _tiny_cfg()
    o = make_optimizer(cfg.optimizer, cfg.clip_gradient_norm)
    state = init_distill_state(cfg, o)
    p3 = export_tf_checkpoint(str(tmp_path / "ours.ckpt-0"), state)
    b1p = float(TFCheckpointReader(p3).get_tensor("beta1_power"))
    assert math.isclose(b1p, 0.9, rel_tol=1e-6)
