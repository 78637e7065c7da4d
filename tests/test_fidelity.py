"""Fidelity tests against the reference's golden log
(/root/reference/README.md:88-106): the flagship teacher/student towers
must have exactly the reference's trainable-variable set — same count,
same total parameters, same per-variable shapes (modulo the documented
MoE [D, K, V] re-layout)."""

import jax
import numpy as np

from efficientvideoclassification_youtube8m_tpu.train import (
    init_distill_state,
    make_optimizer,
)
from efficientvideoclassification_youtube8m_tpu.utils.config import TrainConfig


# The reference's printed variable list for the canonical run
# (README.md:98,105): name -> TF shape.
REF_TEACHER_VARS = {
    "RNN_L1/cell_0/kernel": (1152 + 1024, 4096),
    "RNN_L1/cell_0/bias": (4096,),
    "RNN_L1/cell_1/kernel": (1024 + 1024, 4096),
    "RNN_L1/cell_1/bias": (4096,),
    "RNN_L2/cell_0/kernel": (4096 + 1024, 4096),
    "RNN_L2/cell_0/bias": (4096,),
    "RNN_L2/cell_1/kernel": (1024 + 1024, 4096),
    "RNN_L2/cell_1/bias": (4096,),
    "classifier/gates/weights": (4096, 4716 * 3),
    "classifier/experts/weights": (4096, 4716 * 2),
    "classifier/experts/biases": (4716 * 2,),
}


def _flagship_params():
    cfg = TrainConfig()
    opt = make_optimizer(cfg.optimizer, cfg.clip_gradient_norm)
    return cfg, init_distill_state(cfg, opt)


def test_flagship_variable_shapes_match_reference():
    _, state = _flagship_params()
    for tower in [state.params_teacher, state.params_student]:
        got = {}
        for li, layer in enumerate(tower["rnn_l1"]):
            got[f"RNN_L1/cell_{li}/kernel"] = tuple(layer["kernel"].shape)
            got[f"RNN_L1/cell_{li}/bias"] = tuple(layer["bias"].shape)
        for li, layer in enumerate(tower["rnn_l2"]):
            got[f"RNN_L2/cell_{li}/kernel"] = tuple(layer["kernel"].shape)
            got[f"RNN_L2/cell_{li}/bias"] = tuple(layer["bias"].shape)
        # MoE stored [D, K, V]; the reference layout is the 2-D flatten
        gw = tower["classifier"]["gates"]["w"]
        ew = tower["classifier"]["experts"]["w"]
        eb = tower["classifier"]["experts"]["b"]
        got["classifier/gates/weights"] = (gw.shape[0], gw.shape[1] * gw.shape[2])
        got["classifier/experts/weights"] = (ew.shape[0], ew.shape[1] * ew.shape[2])
        got["classifier/experts/biases"] = (eb.shape[0] * eb.shape[1],)

        assert got == REF_TEACHER_VARS
        # exactly 11 trainable variables per tower, like the README list
        assert len(got) == 11


def test_flagship_param_count():
    _, state = _flagship_params()
    n = sum(int(np.prod(x.shape)) for x in jax.tree.leaves(state.params_teacher))
    want = sum(int(np.prod(s)) for s in REF_TEACHER_VARS.values())
    assert n == want


def test_flagship_forward_shapes():
    """README.md:93-96,100-103: teacher input (?,300,1152) student
    (?,30,1152); both towers emit (?,4716) predictions and a 4096-d
    state."""
    import jax.numpy as jnp

    from efficientvideoclassification_youtube8m_tpu.ops.preprocess import (
        student_num_frames,
        uniform_subsample,
    )
    from efficientvideoclassification_youtube8m_tpu.train.step import (
        forward_student,
        forward_teacher,
    )

    cfg, state = _flagship_params()
    B = 2
    x = jnp.zeros((B, 300, 1152), jnp.float32)
    nf = jnp.array([300, 40])
    out_t = jax.eval_shape(
        lambda p, x, nf: forward_teacher(cfg, p, x, nf),
        state.params_teacher, x, nf,
    )
    assert tuple(out_t["predictions"].shape) == (B, 4716)
    assert tuple(out_t["state"].shape) == (B, 4096)

    xs = uniform_subsample(x, cfg.every_n)
    assert xs.shape == (B, 30, 1152)
    out_s = jax.eval_shape(
        lambda p, x, nf: forward_student(cfg, p, x, nf),
        state.params_student, xs, student_num_frames(nf, cfg.every_n),
    )
    assert tuple(out_s["predictions"].shape) == (B, 4716)
    assert tuple(out_s["state"].shape) == (B, 4096)


def test_init_teacher_loss_matches_golden_log():
    """The reference's golden log shows Teacher_Loss ~1914 at step 2
    (README.md:116) — the analytic CE of the freshly-initialized MoE head
    (gates ~uniform 1/3, experts sigmoid(0)=0.5 -> p~=1/3 per class:
    4716 * -log(2/3) ~= 1912). Our init must land there too."""
    import jax.numpy as jnp

    from efficientvideoclassification_youtube8m_tpu import losses as L
    from efficientvideoclassification_youtube8m_tpu.train.step import (
        forward_teacher,
    )

    cfg, state = _flagship_params()
    B = 4
    x = jnp.asarray(
        np.random.default_rng(0).normal(size=(B, 300, 1152)).astype(np.float32))
    nf = jnp.full((B,), 300, jnp.int32)
    labels = np.zeros((B, 4716), bool)
    labels[:, :4] = True
    out = forward_teacher(cfg, state.params_teacher, x, nf)
    ce = float(L.get_loss("CrossEntropyLoss")(out["predictions"],
                                              jnp.asarray(labels)))
    assert 1880 < ce < 1950, ce


def test_trajectory_harness_bands():
    """utils/fidelity.py (used by scripts/fidelity_check.py and
    chip_smoke.py) pins the few-step loss trajectory against the
    reference golden log (README.md:116-122). The capture regex parses
    the trainer's log-line format, and the band checks accept a
    golden-shaped trajectory while rejecting non-decreasing / diverging
    ones."""
    import logging

    from efficientvideoclassification_youtube8m_tpu.utils import fidelity as fc

    cap = fc.StepCapture()
    fmt = ("training step %d| Hit@1: %.2f| PERR: %.2f| GAP: %.2f| "
           "Teacher_Loss: %s| L_REP: %s| L_PRED: %s| L_CE: %s")
    for step, t, r, p, c in [(2, 1914.13, 1.16, 0.01, 1914.1),
                             (4, 1908.5, 1.49, 0.01, 1913.3)]:
        cap.emit(logging.LogRecord(
            "train", 20, "", 0, fmt,
            (step, 0.0, 0.0, 0.0, t, r, p, c), None))
    assert set(cap.steps) == {2, 4}
    assert cap.steps[2]["teacher"] == 1914.13
    assert fc.check_trajectory(cap.steps)

    # a diverging trajectory fails the shape check
    bad = dict(cap.steps)
    bad[4] = {"teacher": 1920.0, "l_rep": 0.9, "l_pred": 0.4,
              "l_ce": 1916.0}
    assert not fc.check_trajectory(bad)
