"""Export the rebuild's state pytrees as reference TF-V2 checkpoints.

The inverse of `train/tf_import.py`: a model trained HERE becomes a
`model.ckpt-<step>` Saver-V2 bundle the reference's TF1 binaries consume
directly — `tf.train.Saver` restore maps by the exact variable names the
reference graphs create (`validate.py:350-381`,
`train_convert_model.py:501-513`), and `inspect_checkpoint_myfile.py`
lists the same tensors. The MoE weights are permuted back from the
`[D, K, V]` storage to the reference's class-interleaved
`[D, V*K]` columns (`moe_weights_to_tf`), and the Adam moments export as
`<var>/Adam` / `<var>/Adam_1` with `beta{1,2}_power` recovered from the
optimizer step count (= b^t) so reference training can RESUME from an
exported bundle. Verified against TensorFlow's own
`NewCheckpointReader`, not just this repo's reader."""

from __future__ import annotations

from typing import Any, Dict

import numpy as np

from efficientvideoclassification_youtube8m_tpu.data.tf_checkpoint import (
    write_tf_checkpoint,
)
from efficientvideoclassification_youtube8m_tpu.train.tf_import import (
    _ADAM_B1,
    _is_name_leaf,
    _name_tree,
)

_ADAM_B2 = 0.999


def _dump_tree(name_tree: Any, params: Any, out: Dict[str, np.ndarray],
               suffix: str = "") -> None:
    import jax

    leaves_spec, treedef = jax.tree_util.tree_flatten(
        name_tree, is_leaf=_is_name_leaf
    )
    param_leaves = treedef.flatten_up_to(params)
    for (tf_name, _, to_tf), leaf in zip(leaves_spec, param_leaves):
        # the reference graphs are float32 throughout
        out[tf_name + suffix] = np.asarray(
            to_tf(np.asarray(leaf, np.float32)))


def _dump_optimizer(name_tree: Any, opt: Any, ordinal: int,
                    out: Dict[str, np.ndarray]) -> None:
    """Adam slots + power variables for one tower's optimizer. `ordinal`
    mirrors the reference's optimizer creation order: the distill graph
    builds the teacher's first (`beta1_power`), the student's second
    (`beta1_power_1`); a finetune graph has one optimizer (ordinal 0)."""
    if not (hasattr(opt, "mu") and hasattr(opt, "nu")):
        return
    _dump_tree(name_tree, opt.mu, out, "/Adam")
    _dump_tree(name_tree, opt.nu, out, "/Adam_1")
    # TF1 Adam stores b^(t+1) after t updates (initialized to b,
    # multiplied after each apply) — the factor its NEXT apply uses.
    # b^count would hand a fresh state power 1.0 and NaN TF's bias
    # correction (division by 1 - beta1_power).
    t = int(np.asarray(opt.count))
    sfx = "" if ordinal == 0 else f"_{ordinal}"
    out[f"beta1_power{sfx}"] = np.float32(_ADAM_B1 ** (t + 1))
    out[f"beta2_power{sfx}"] = np.float32(_ADAM_B2 ** (t + 1))


def export_distill_state(prefix: str, state: Any) -> str:
    """DistillState -> reference distillation checkpoint (both towers'
    params under scopes `model` / `model_student`, Adam slots, int32
    global_step — train.py:222)."""
    import jax

    state = jax.device_get(state)
    tensors: Dict[str, np.ndarray] = {}
    t_tree = _name_tree("model", state.params_teacher)
    s_tree = _name_tree("model_student", state.params_student)
    _dump_tree(t_tree, state.params_teacher, tensors)
    _dump_tree(s_tree, state.params_student, tensors)
    _dump_optimizer(t_tree, state.opt_teacher, 0, tensors)
    _dump_optimizer(s_tree, state.opt_student, 1, tensors)
    tensors["global_step"] = np.asarray(
        int(np.asarray(state.global_step)), np.int32)
    return write_tf_checkpoint(prefix, tensors)


def export_student_state(prefix: str, state: Any) -> str:
    """StudentState -> reference finetune checkpoint (student scope only,
    single optimizer so its power variables are unsuffixed)."""
    import jax

    state = jax.device_get(state)
    tensors: Dict[str, np.ndarray] = {}
    s_tree = _name_tree("model_student", state.params_student)
    _dump_tree(s_tree, state.params_student, tensors)
    _dump_optimizer(s_tree, state.opt_student, 0, tensors)
    tensors["global_step"] = np.asarray(
        int(np.asarray(state.global_step)), np.int32)
    return write_tf_checkpoint(prefix, tensors)


def export_tf_checkpoint(prefix: str, state: Any) -> str:
    """Dispatch on the state type (DistillState vs StudentState)."""
    if hasattr(state, "params_teacher"):
        return export_distill_state(prefix, state)
    return export_student_state(prefix, state)
