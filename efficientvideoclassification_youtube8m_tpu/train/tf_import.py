"""Import reference TF-V2 checkpoints into the rebuild's pytrees.

A model trained with `/root/reference/code_student_uniform/train.py` can
be served, evaluated, or finetuned here: this module maps the
reference's variable names (the hardcoded Saver maps,
`validate.py:350-381`) onto the rebuild's state pytrees, permuting the
MoE weight layout from the reference's class-interleaved columns to the
`[D, K, V]` storage (`models/video_level.py:43-49`).

Name map (teacher scope "model", student scope "model_student"):

  {scope}/RNN_L{1,2}/rnn/multi_rnn_cell/cell_{i}/basic_lstm_cell/kernel
      -> params["rnn_l{1,2}"][i]["kernel"]          (identity; same
         [in+cells, 4*cells] layout, same i,j,f,o gate order)
  {scope}/classifier/gates/weights   [D, V*(m+1)]
      -> params["classifier"]["gates"]["w"]  [D, m+1, V]
  {scope}/classifier/experts/weights [D, V*m]
      -> params["classifier"]["experts"]["w"] [D, m, V]
  {scope}/classifier/experts/biases  [V*m]
      -> params["classifier"]["experts"]["b"] [m, V]
  global_step -> state.global_step

Adam slot variables (`<var>/Adam`, `<var>/Adam_1`) are imported when
present so training can RESUME from a reference checkpoint with the
optimizer moments intact; the TF update count t is recovered from
`beta1_power` = b1^(t+1) — TF1 Adam initializes the power to b1 and
multiplies AFTER each apply, so a checkpoint saved after t updates
stores the factor its NEXT apply will use (see _adam_count).
"""

from __future__ import annotations

import logging
import math
from typing import Any, Callable, Dict, Optional

import jax.numpy as jnp
import numpy as np

from efficientvideoclassification_youtube8m_tpu.data.tf_checkpoint import (
    TFCheckpointReader,
)

logger = logging.getLogger("tf_import")

_ADAM_B1 = 0.9


def moe_weights_from_tf(w_tf: np.ndarray, groups: int) -> np.ndarray:
    """[D, V*groups] class-interleaved columns -> [D, groups, V].
    TF column c*groups+k lands at [:, k, c] (video_level.py:43-49)."""
    d, cols = w_tf.shape
    vocab = cols // groups
    return np.ascontiguousarray(w_tf.reshape(d, vocab, groups).transpose(0, 2, 1))


def moe_bias_from_tf(b_tf: np.ndarray, groups: int) -> np.ndarray:
    """[V*groups] -> [groups, V] with the same column mapping."""
    vocab = b_tf.shape[0] // groups
    return np.ascontiguousarray(b_tf.reshape(vocab, groups).T)


def moe_weights_to_tf(w: np.ndarray) -> np.ndarray:
    """[D, groups, V] -> the reference's [D, V*groups] (inverse map)."""
    d = w.shape[0]
    return np.ascontiguousarray(w.transpose(0, 2, 1).reshape(d, -1))


def moe_bias_to_tf(b: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(b.T.reshape(-1))


Converter = Callable[[np.ndarray], np.ndarray]


def _is_name_leaf(x) -> bool:
    """Name-tree leaves are (tf_name, from_tf, to_tf) triples."""
    return (isinstance(x, tuple) and len(x) == 3
            and isinstance(x[0], str))


def _hierarchical_name_tree(scope: str, template: Any) -> Any:
    """A pytree shaped like the params template whose leaves are
    (tf_variable_name, from_tf, to_tf) triples (the third member is
    what train/tf_export.py uses to write the inverse direction).
    Template-driven so cell counts and mixture counts come from the
    actual state, not flags."""
    ident: Converter = lambda x: x  # noqa: E731
    tree: Dict[str, Any] = {}
    for level_key, level_num in (("rnn_l1", 1), ("rnn_l2", 2)):
        cells = template[level_key]
        tree[level_key] = [
            {
                "kernel": (
                    f"{scope}/RNN_L{level_num}/rnn/multi_rnn_cell/"
                    f"cell_{i}/basic_lstm_cell/kernel",
                    ident, ident,
                ),
                "bias": (
                    f"{scope}/RNN_L{level_num}/rnn/multi_rnn_cell/"
                    f"cell_{i}/basic_lstm_cell/bias",
                    ident, ident,
                ),
            }
            for i in range(len(cells))
        ]
    tree["classifier"] = _moe_classifier_name_tree(
        f"{scope}/classifier", template["classifier"]
    )
    return tree


def _moe_classifier_name_tree(prefix: str, clf_template: Any) -> Any:
    """Name/converter tree for a MoE head living at `prefix` (the
    hierarchical model's `{scope}/classifier`, DBoF's bare `{scope}` —
    DBoF calls the video-level model without a variable_scope,
    frame_level_models.py:192-196)."""
    if set(clf_template) != {"gates", "experts"}:
        raise NotImplementedError(
            "TF import supports the MoE classifier (the reference "
            f"flagship); template has {sorted(clf_template)}"
        )
    m_plus_1 = clf_template["gates"]["w"].shape[1]
    m = clf_template["experts"]["w"].shape[1]
    return {
        "gates": {
            "w": (
                f"{prefix}/gates/weights",
                lambda x: moe_weights_from_tf(x, m_plus_1),
                moe_weights_to_tf,
            )
        },
        "experts": {
            "w": (
                f"{prefix}/experts/weights",
                lambda x: moe_weights_from_tf(x, m),
                moe_weights_to_tf,
            ),
            "b": (
                f"{prefix}/experts/biases",
                lambda x: moe_bias_from_tf(x, m),
                moe_bias_to_tf,
            ),
        },
    }


def _dbof_name_tree(scope: str, template: Any) -> Any:
    """DBoF variable map (frame_level_models.py:104-196): the FC kernels
    are UNNAMED tf.Variables, so TF names them `{scope}/Variable[_k]` in
    creation order — cluster_weights first, then (no-BN only)
    cluster_biases, then hidden1_weights, then hidden1_biases. slim
    batch_norm scopes input_bn/cluster_bn/hidden1_bn carry
    gamma/beta/moving_mean/moving_variance (center=True, scale=True)."""
    ident: Converter = lambda x: x  # noqa: E731
    add_bn = "input_bn" in template
    ordinal = iter(range(16))

    def unnamed():
        k = next(ordinal)
        return f"{scope}/Variable" if k == 0 else f"{scope}/Variable_{k}"

    def bn(name):
        return {
            "scale": (f"{scope}/{name}/gamma", ident, ident),
            "offset": (f"{scope}/{name}/beta", ident, ident),
            "moving_mean": (f"{scope}/{name}/moving_mean", ident, ident),
            "moving_var": (f"{scope}/{name}/moving_variance", ident, ident),
        }

    tree: Dict[str, Any] = {"cluster": {"w": (unnamed(), ident, ident)}}
    if not add_bn:
        tree["cluster"]["b"] = (unnamed(), ident, ident)
    tree["hidden1"] = {"w": (unnamed(), ident, ident)}
    if not add_bn:
        tree["hidden1"]["b"] = (unnamed(), ident, ident)
    if add_bn:
        tree["input_bn"] = bn("input_bn")
        tree["cluster_bn"] = bn("cluster_bn")
        tree["hidden1_bn"] = bn("hidden1_bn")
    tree["classifier"] = _moe_classifier_name_tree(scope, template["classifier"])
    return tree


def _name_tree(scope: str, template: Any) -> Any:
    """Dispatch on the params-template shape: hierarchical LSTM vs DBoF."""
    if "rnn_l1" in template:
        return _hierarchical_name_tree(scope, template)
    if "cluster" in template:
        return _dbof_name_tree(scope, template)
    raise NotImplementedError(
        "TF import supports HierarchicalLstmModel and DbofModel "
        f"templates; got keys {sorted(template)}"
    )


def _load_tree(reader: TFCheckpointReader, name_tree: Any, template: Any,
               suffix: str = "") -> Optional[Any]:
    """Materialize a params-shaped pytree from the checkpoint. With a
    suffix ("/Adam", "/Adam_1") loads the optimizer slot variables;
    returns None if any slot is absent (e.g. an inference checkpoint)."""
    import jax

    leaves_spec, treedef = jax.tree_util.tree_flatten(
        name_tree, is_leaf=_is_name_leaf
    )
    tmpl_leaves = treedef.flatten_up_to(template)
    out = []
    for (tf_name, convert, _), tmpl in zip(leaves_spec, tmpl_leaves):
        if not reader.has_tensor(tf_name + suffix):
            if suffix:
                return None
            raise KeyError(
                f"checkpoint {reader.prefix} lacks {tf_name!r}; not a "
                "reference checkpoint for this model?"
            )
        arr = convert(reader.get_tensor(tf_name + suffix))
        if tuple(arr.shape) != tuple(tmpl.shape):
            raise ValueError(
                f"{tf_name}{suffix}: checkpoint shape {arr.shape} != "
                f"template {tuple(tmpl.shape)} (flag mismatch?)"
            )
        out.append(jnp.asarray(arr, dtype=tmpl.dtype))
    return jax.tree_util.tree_unflatten(treedef, out)


def _adam_count(reader: TFCheckpointReader, ordinal: int) -> int:
    """Recover TF Adam's update count from beta1_power.

    TF1 Adam initializes beta1_power to b1 and multiplies AFTER each
    apply (adam.py _finish), so a checkpoint saved after t updates
    stores b1^(t+1) — the correction factor its NEXT apply will use.
    Our optimizer's next update uses b1^(count+1), so count = t =
    log(b1p)/log(b1) - 1 (verified against a live tf.train.AdamOptimizer:
    fresh graph stores 0.9, after 3 updates 0.9^4).

    The teacher optimizer is built before the student's
    (train.py:332,416), so its power variable is `beta1_power` and the
    student's `beta1_power_1`."""
    name = "beta1_power" if ordinal == 0 else f"beta1_power_{ordinal}"
    for candidate in (name, f"model/{name}", f"model_student/{name}"):
        if reader.has_tensor(candidate):
            b1p = float(reader.get_tensor(candidate))
            if 0.0 < b1p < 1.0:
                return max(
                    0,
                    int(round(math.log(b1p) / math.log(_ADAM_B1))) - 1,
                )
    return 0


def _import_optimizer_slots(reader, name_tree, template_opt, ordinal: int):
    """TfAdamState(count, mu, nu) from `<var>/Adam(,_1)`, or None."""
    mu = _load_tree(reader, name_tree, template_opt.mu, "/Adam")
    nu = _load_tree(reader, name_tree, template_opt.nu, "/Adam_1")
    if mu is None or nu is None:
        return None
    count = _adam_count(reader, ordinal)
    return template_opt._replace(
        count=jnp.asarray(count, template_opt.count.dtype), mu=mu, nu=nu
    )


def _global_step(reader: TFCheckpointReader, template) -> Any:
    if reader.has_tensor("global_step"):
        return jnp.asarray(
            int(reader.get_tensor("global_step")), template.dtype
        )
    return template


def import_distill_state(prefix: str, template: Any) -> Any:
    """Reference distillation checkpoint -> DistillState (params for both
    towers, global_step, Adam moments when present)."""
    reader = TFCheckpointReader(prefix)
    t_tree = _name_tree("model", template.params_teacher)
    s_tree = _name_tree("model_student", template.params_student)
    params_teacher = _load_tree(reader, t_tree, template.params_teacher)
    params_student = _load_tree(reader, s_tree, template.params_student)
    opt_teacher = _import_optimizer_slots(
        reader, t_tree, template.opt_teacher, 0
    )
    opt_student = _import_optimizer_slots(
        reader, s_tree, template.opt_student, 1
    )
    if opt_teacher is None or opt_student is None:
        logger.info("TF checkpoint has no Adam slots; optimizer state reset")
    return template.replace(
        params_teacher=params_teacher,
        params_student=params_student,
        opt_teacher=opt_teacher or template.opt_teacher,
        opt_student=opt_student or template.opt_student,
        global_step=_global_step(reader, template.global_step),
    )


def _student_power_ordinal(reader: TFCheckpointReader) -> int:
    """Which beta1_power variable pairs with the student's Adam slots.

    A finetune graph builds ONE optimizer (train_finetune.py:231), so the
    student's power is `beta1_power` (ordinal 0). A DISTILL graph builds
    the teacher's optimizer first (train.py:332,416), so there the
    student's lives in `beta1_power_1` — restoring a distill bundle into
    a StudentState with ordinal 0 would recover the TEACHER's step count
    and skew the student's Adam bias correction."""
    for name in ("beta1_power_1", "model/beta1_power_1",
                 "model_student/beta1_power_1"):
        if reader.has_tensor(name):
            return 1
    return 0


def import_student_state(prefix: str, template: Any) -> Any:
    """Reference finetune/inference checkpoint -> StudentState."""
    reader = TFCheckpointReader(prefix)
    s_tree = _name_tree("model_student", template.params_student)
    params_student = _load_tree(reader, s_tree, template.params_student)
    opt_student = _import_optimizer_slots(
        reader, s_tree, template.opt_student, _student_power_ordinal(reader)
    )
    return template.replace(
        params_student=params_student,
        opt_student=opt_student or template.opt_student,
        global_step=_global_step(reader, template.global_step),
    )


def import_tf_checkpoint(prefix: str, template: Any) -> Any:
    """Dispatch on the template state type (DistillState vs StudentState)."""
    if hasattr(template, "params_teacher"):
        return import_distill_state(prefix, template)
    return import_student_state(prefix, template)
