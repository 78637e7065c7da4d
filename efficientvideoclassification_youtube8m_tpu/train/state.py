"""Training state pytrees.

The reference's graph state (two variable scopes `model/*` and
`model_student/*`, two Adam slots sets, one shared `global_step`,
train.py:222-242,281,349) becomes one explicit pytree. Checkpoint
"surgery" (train_convert_model.py) is plain subtree selection on it.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import jax
import jax.numpy as jnp

from efficientvideoclassification_youtube8m_tpu.models import get_model
from efficientvideoclassification_youtube8m_tpu.train.optimizer import Optimizer
from efficientvideoclassification_youtube8m_tpu.utils.config import TrainConfig


def _state_dataclass(cls):
    """Frozen dataclass registered as a pytree (every field a child),
    with `replace(**fields)` returning an updated copy."""
    cls = dataclasses.dataclass(frozen=True)(cls)
    cls.replace = dataclasses.replace
    return jax.tree_util.register_dataclass(
        cls, data_fields=[f.name for f in dataclasses.fields(cls)],
        meta_fields=[])


@_state_dataclass
class DistillState:
    """Teacher + student joint training state (cli train.py)."""

    params_teacher: Any
    params_student: Any
    opt_teacher: Any
    opt_student: Any
    global_step: jax.Array  # shared, advances 2/batch in faithful mode
    dropout_keep_prob: jax.Array  # the reference's dropout_var


@_state_dataclass
class StudentState:
    """Student-only state (finetune / eval / inference)."""

    params_student: Any
    opt_student: Any
    global_step: jax.Array
    dropout_keep_prob: jax.Array


def init_distill_state(
    cfg: TrainConfig, optimizer: Optimizer, rng: Optional[jax.Array] = None,
    host_optimizer_state: bool = False,
) -> DistillState:
    """`host_optimizer_state`: keep the optimizer slots as numpy
    zeros on the host — for eval-only templates that never read them
    (no transient device allocation of 2x-params Adam moments)."""
    rng = jax.random.PRNGKey(cfg.seed) if rng is None else rng
    kt, ks = jax.random.split(rng)
    model = get_model(cfg.model)
    classifier_kwargs = (
        {"num_mixtures": cfg.moe_num_mixtures}
        if cfg.video_level_classifier_model == "MoeModel"
        else {"num_hidden_units": cfg.num_hidden_units}
    )
    kwargs = dict(
        lstm_cells=cfg.lstm_cells,
        lstm_layers=cfg.lstm_layers,
        classifier=cfg.video_level_classifier_model,
        classifier_kwargs=classifier_kwargs,
        # flattened for when cfg.model IS a video-level head (the
        # --frame_features=False aggregated path): its init reads these
        # directly; frame models swallow them via **_
        num_mixtures=cfg.moe_num_mixtures,
        num_hidden_units=cfg.num_hidden_units,
    )
    if cfg.model == "DbofModel":
        # DBoF sizing flags (frame_level_models.py:119-124); every init
        # takes **_ so the union of kwargs is safe to pass.
        kwargs.update(
            cluster_size=cfg.dbof_cluster_size,
            hidden_size=cfg.dbof_hidden_size,
            add_batch_norm=cfg.dbof_add_batch_norm,
        )
    params_teacher = model.init(
        kt, cfg.total_feature_size, cfg.num_classes, **kwargs
    )
    params_student = model.init(
        ks, cfg.total_feature_size, cfg.num_classes, **kwargs
    )
    return DistillState(
        params_teacher=params_teacher,
        params_student=params_student,
        opt_teacher=(optimizer.init_host if host_optimizer_state
                     else optimizer.init)(params_teacher),
        opt_student=(optimizer.init_host if host_optimizer_state
                     else optimizer.init)(params_student),
        global_step=jnp.zeros([], jnp.int32),
        dropout_keep_prob=jnp.asarray(cfg.dropout, jnp.float32),
    )


def student_state_from_distill(
    state: DistillState, optimizer: Optimizer,
    host_optimizer_state: bool = False,
) -> StudentState:
    """The convert step (train_convert_model.py:360-401): keep the student
    subtree, drop the teacher, reset optimizer slots + global step for the
    finetune phase (the reference re-saves a fresh graph whose Adam slots
    initialize from scratch)."""
    return StudentState(
        params_student=state.params_student,
        opt_student=(optimizer.init_host if host_optimizer_state
                     else optimizer.init)(state.params_student),
        global_step=jnp.zeros([], jnp.int32),
        dropout_keep_prob=state.dropout_keep_prob,
    )
