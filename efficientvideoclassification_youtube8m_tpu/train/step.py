"""Jitted train/eval steps.

One XLA program per step replaces the reference's
`sess.run([train_op, train_student_op, ...])` hot loop
(`/root/reference/code_student_uniform/train.py:516-517`): both towers'
forward+backward, both optimizer updates, and the on-device top-k for
host metrics, fused and scheduled by XLA — the teacher and student
towers have no data dependence (beyond the stop-gradiented distillation
targets) so XLA overlaps them, mirroring the reference's intra-op
two-tower concurrency.

Input contract (from data/loader.py): raw uint8 features — dequantize +
l2-normalize happen HERE, on device.

Faithful quirks (cfg.faithful_quirks=True, SURVEY.md §2.5):
  * L_REP enters the student loss twice (train.py:406);
  * the shared global_step advances 2 per batch and drives both LR
    schedules (train.py:230,329,413);
  * L_PRED sums (not means) over the batch (train.py:402).
Set faithful_quirks=False for the corrected versions.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import jax
import jax.numpy as jnp

from efficientvideoclassification_youtube8m_tpu import losses as losses_lib
from efficientvideoclassification_youtube8m_tpu.metrics.eval_util import (
    topk_and_perr_on_device,
)
from efficientvideoclassification_youtube8m_tpu.models import get_model
from efficientvideoclassification_youtube8m_tpu.ops.preprocess import (
    dequantize,
    l2_normalize,
    student_num_frames,
    uniform_subsample,
)
from efficientvideoclassification_youtube8m_tpu.train.optimizer import (
    Optimizer,
    exponential_decay,
)
from efficientvideoclassification_youtube8m_tpu.train.state import (
    DistillState,
    StudentState,
)
from efficientvideoclassification_youtube8m_tpu.utils.config import TrainConfig


def resolve_label_loss(cfg: TrainConfig):
    """Loss fn from the registry, with file-backed extras bound ONCE at
    step-build time (never file I/O under trace).

    `CrossEntropyLossClassImbalance` reads per-class counts from a
    `counts_tv` file in the reference (losses.py:107); here the path
    comes from cfg.class_counts_file (one integer per line).
    """
    fn = losses_lib.get_loss(cfg.label_loss)
    if cfg.label_loss == "PWELoss" and cfg.faithful_quirks:
        # the literal graph's hardcoded batch-128 reshape (losses.py
        # docstring); the corrected default accepts any batch

        def bound_pwe(predictions, labels, **kw):
            return fn(predictions, labels, faithful_quirks=True, **kw)

        return bound_pwe
    if cfg.label_loss == "CrossEntropyLossClassImbalance":
        path = getattr(cfg, "class_counts_file", "") or "counts_tv"
        with open(path) as f:
            counts = [int(line) for line in f if line.strip()]

        def bound(predictions, labels, **kw):
            return fn(predictions, labels, class_counts=counts, **kw)

        return bound
    return fn


def _model_apply_kwargs(cfg: TrainConfig, inference: bool = False) -> Dict[str, Any]:
    kw: Dict[str, Any] = {
        "classifier": cfg.video_level_classifier_model,
        "compute_dtype": jnp.bfloat16
        if cfg.compute_dtype == "bfloat16"
        else jnp.float32,
        "scan_unroll": cfg.scan_unroll,
    }
    kw["is_training"] = not inference
    if cfg.model == "DbofModel":
        # DBoF's flag block (frame_level_models.py:119-124); sampling uses
        # the step-derived rng the towers already receive, so eval (rng
        # None) sees the full deterministic frame sequence instead.
        kw.update(
            iterations=cfg.iterations,
            sample_random=cfg.sample_random_frames,
            pooling_method=cfg.dbof_pooling_method,
            add_batch_norm=cfg.dbof_add_batch_norm,
        )
    if cfg.video_level_classifier_model == "MoeModel":
        kw["num_mixtures"] = cfg.moe_num_mixtures
    else:
        kw["num_hidden_units"] = cfg.num_hidden_units
    return kw


def preprocess_batch(
    cfg: TrainConfig,
    features_u8: jax.Array,
    num_frames: Optional[jax.Array] = None,
) -> jax.Array:
    """uint8 [B, T, D] -> l2-normalized f32 (train.py:256 + readers.py
    Dequantize), fused on device: XLA fuses the chain into one pass.

    Padding frames must end up EXACTLY 0.0 like the reference's
    dequantize-then-zero-pad order (readers.py:170-173) — the loader pads
    the uint8 tensor, and dequantize maps byte 0 to -1.992, so rows past
    num_frames are re-zeroed here. (The hierarchical model's seq-len
    masking never reads them, but FrameLevelLogistic/DBoF/mean-pool
    consumers do.)"""
    x = l2_normalize(dequantize(features_u8), axis=2)
    if num_frames is not None:
        T = x.shape[1]
        mask = (
            jnp.arange(T, dtype=jnp.int32)[None, :]
            < num_frames.astype(jnp.int32)[:, None]
        )
        x = x * mask[:, :, None]
    return x


def forward_teacher(cfg: TrainConfig, params, model_input, num_frames, labels=None,
                    inference: bool = False, dropout_keep_prob=1.0, rng=None,
                    bn_axis_name: Optional[str] = None):
    model = get_model(cfg.model)
    return model.apply(
        params,
        model_input,
        vocab_size=cfg.num_classes,
        num_frames=num_frames,
        num_chunks=cfg.num_inputs_to_lstm,
        labels=labels,
        dropout_keep_prob=dropout_keep_prob,
        rng=rng,
        bn_axis_name=bn_axis_name,
        **_model_apply_kwargs(cfg, inference=inference),
    )


def forward_student(cfg: TrainConfig, params, model_input_student, num_frames_stud,
                    labels=None, inference: bool = False,
                    dropout_keep_prob=1.0, rng=None,
                    bn_axis_name: Optional[str] = None):
    """`create_model_inference` (frame_level_models.py:269-338): same
    architecture on the subsampled frames with num_inputs_L1 chunks."""
    model = get_model(cfg.model)
    return model.apply(
        params,
        model_input_student,
        vocab_size=cfg.num_classes,
        num_frames=num_frames_stud,
        num_chunks=cfg.num_inputs_L1,
        labels=labels,
        dropout_keep_prob=dropout_keep_prob,
        rng=rng,
        bn_axis_name=bn_axis_name,
        **_model_apply_kwargs(cfg, inference=inference),
    )


# models whose apply contract is [B, T, D] frame input (models/frame_level.py)
_FRAME_LEVEL_MODELS = frozenset({
    "HierarchicalLstmModel", "FrameLevelLogisticModel", "DbofModel",
    "NetVLADModel", "NeXtVLADModel",
})


def forward_video_level(cfg: TrainConfig, params, model_input, labels=None,
                        inference: bool = False, dropout_keep_prob=1.0,
                        rng=None):
    """Aggregated-feature forward: the reference's `--frame_features=False`
    branch applies the flag-selected model DIRECTLY to the [B, D]
    pre-aggregated Example features (train_finetune.py:514-518 selecting
    `YT8MAggregatedFeatureReader`, readers.py:53-112) — video-level heads
    (LogisticModel, MoeModel, ...) resolve through the same registry the
    frame models use."""
    if cfg.model in _FRAME_LEVEL_MODELS:
        raise ValueError(
            f"--frame_features=False feeds [batch, {model_input.shape[-1]}] "
            f"aggregated features, but --model={cfg.model} is a frame-level "
            "model; pick a video-level head (LogisticModel, MoeModel, ...) "
            "or use frame-feature shards"
        )
    model = get_model(cfg.model)
    kw: Dict[str, Any] = {
        "compute_dtype": jnp.bfloat16
        if cfg.compute_dtype == "bfloat16"
        else jnp.float32,
        "is_training": not inference,
    }
    if cfg.video_level_classifier_model == "MoeModel" or cfg.model == "MoeModel":
        kw["num_mixtures"] = cfg.moe_num_mixtures
    else:
        kw["num_hidden_units"] = cfg.num_hidden_units
    return model.apply(
        params,
        model_input,
        vocab_size=cfg.num_classes,
        labels=labels,
        dropout_keep_prob=dropout_keep_prob,
        rng=rng,
        **kw,
    )


def preprocess_aggregated(features) -> jax.Array:
    """[B, D] float32 aggregated features -> l2-normalized model input.

    The reference graph l2-normalizes `model_input_raw` along its LAST
    axis regardless of reader (`feature_dim = len(shape) - 1`,
    train_finetune.py:242-244, eval_finetune.py:134-137) — for the
    aggregated reader's rank-2 output that is axis 1. The features are
    already float averages of dequantized values (readers.py:56-59), so
    there is no dequantize stage."""
    return l2_normalize(jnp.asarray(features, jnp.float32), axis=1)


def _video_level_label_loss(out, labels, label_loss_fn):
    """Model-supplied loss if present (e.g. SplitSingleHiddenLayerModel),
    else the flag loss; matrix-valued model losses train on their sum
    (what slim's create_train_op effectively reduces)."""
    loss = out.get("loss")
    if loss is None:
        return label_loss_fn(out["predictions"], labels)
    if getattr(loss, "ndim", 0) > 0:
        loss = jnp.sum(loss)
    return loss


_NON_TRAINABLE_STATS = ("moving_mean", "moving_var")


def _merge_updated_stats(new_params, updated):
    """Fold non-trainable statistics computed during the forward pass
    (DBoF batch-norm moving averages, models/frame_level.py:_bn_apply)
    back into the optimizer-updated params.

    This is the functional equivalent of the reference's UPDATE_OPS
    control dependency around the train op (train.py:312-318): slim's
    batch_norm registers moving-average assign ops there, and
    create_train_op runs them with every step. Here the forward pass
    returns the updated stats as an aux output and the step merges just
    those leaves; the trainable leaves keep their gradient update (the
    stats receive zero gradient, so Adam leaves them untouched)."""
    if updated is None:
        return new_params

    def merge(path, new_leaf, upd_leaf):
        key = getattr(path[-1], "key", None) if path else None
        return upd_leaf if key in _NON_TRAINABLE_STATS else new_leaf

    return jax.tree_util.tree_map_with_path(merge, new_params, updated)


def _distill_losses(cfg: TrainConfig, out_t, out_s, labels, label_loss_fn):
    """All six scalars of the reference's train graph (train.py:294-406).

    `label_loss_fn` is resolved once by the step builder (file-backed
    losses read their counts file there, not inside the traced fn)."""
    teacher_label_loss = out_t.get("loss")
    if teacher_label_loss is None:
        teacher_label_loss = label_loss_fn(out_t["predictions"], labels)
    teacher_reg = out_t.get("regularization_loss", 0.0)
    teacher_final = cfg.regularization_penalty * teacher_reg + teacher_label_loss

    if "state" not in out_t or "state" not in out_s:
        # same constraint as the reference, surfaced clearly: its train.py
        # unpacks `state, result = model.create_model(...)` (train.py:281-288),
        # which only HierarchicalLstmModel provides.
        raise ValueError(
            f"model '{cfg.model}' does not return a distillation 'state'; "
            "teacher-student training requires HierarchicalLstmModel. "
            "Train single-tower models with cli.finetune --start_new_model."
        )
    l_rep = losses_lib.representation_loss(out_t["state"], out_s["state"])
    l_pred = losses_lib.prediction_kl_loss(
        out_t["predictions"], out_s["predictions"]
    )
    student_label_loss = out_s.get("loss")
    if student_label_loss is None:
        student_label_loss = label_loss_fn(out_s["predictions"], labels)
    student_reg = out_s.get("regularization_loss", 0.0)
    rep_weight = 2.0 if cfg.faithful_quirks else 1.0
    student_total = (
        rep_weight * l_rep
        + l_pred
        + student_label_loss
        + cfg.regularization_penalty * student_reg
    )
    return {
        "teacher_label_loss": teacher_label_loss,
        "teacher_final_loss": teacher_final,
        "teacher_reg_loss": teacher_reg,
        "student_loss_state": l_rep,  # L_REP
        "pred_loss": l_pred,  # L_PRED
        "student_label_loss": student_label_loss,  # L_CE
        "student_reg_loss": student_reg,
        "total_student_loss": student_total,
    }


def build_distill_train_step(cfg: TrainConfig, optimizer: Optimizer, top_k: int = 20,
                             axis_name: Optional[str] = None):
    """Returns step(state, features_u8, labels, num_frames) ->
    (state, metrics). Jit-compatible; sharding is applied by the caller
    (parallel/).

    With `axis_name`, the step is a PER-DEVICE program for shard_map over
    a data axis: the batch-MEAN loss terms (CE, L_REP) and the
    batch-independent l2 reg are scaled by 1/n_devices locally and the
    batch-SUM term (L_PRED, losses.py:prediction_kl_loss) is left
    unscaled, so ONE explicit `psum` of the local gradients reproduces
    the global-batch gradient exactly; the replicated optimizer update
    then applies identically on every device (per-variable clipping acts
    on the summed grads, same as the single-program path). Reported
    scalars are pmean'd (psum for L_PRED) back to their global values.

    Batch-norm models (DBoF): by default shard_map normalizes with
    PER-SHARD batch statistics — standard unsynced data-parallel BN —
    so gradients are not bit-equal to the GSPMD path's global-batch
    statistics (the moving stats are pmean'd so state stays replicated).
    With cfg.sync_batch_norm the batch moments are pmean'd inside the
    forward (models/frame_level.py:_bn_apply) and the two paths' BN
    math matches exactly. The flagship LSTM models have no BN and the
    paths match either way (tested)."""
    schedule = exponential_decay(
        cfg.base_learning_rate,
        cfg.batch_size,
        cfg.learning_rate_decay_examples,
        cfg.learning_rate_decay,
    )
    step_increment = 2 if cfg.faithful_quirks else 1
    label_loss_fn = resolve_label_loss(cfg)

    # synced cross-shard BN (optional): DBoF normalizes with pmean'd
    # global-batch moments so shard_map grads == GSPMD global-stat grads
    bn_axis = axis_name if cfg.sync_batch_norm else None

    def loss_fn(params_t, params_s, model_input, model_input_s, num_frames,
                nf_student, labels, keep_prob, rng_t, rng_s):
        out_t = forward_teacher(cfg, params_t, model_input, num_frames, labels,
                                dropout_keep_prob=keep_prob, rng=rng_t,
                                bn_axis_name=bn_axis)
        out_s = forward_student(cfg, params_s, model_input_s, nf_student, labels,
                                dropout_keep_prob=keep_prob, rng=rng_s,
                                bn_axis_name=bn_axis)
        ls = _distill_losses(cfg, out_t, out_s, labels, label_loss_fn)
        total = ls["teacher_final_loss"] + ls["total_student_loss"]
        if axis_name is not None:
            n = jax.lax.psum(1, axis_name)
            # mean/reg terms /n so psum(grads) == global-batch grad;
            # the batch-SUM L_PRED stays unscaled.
            total = (total - ls["pred_loss"]) / n + ls["pred_loss"]
        return total, (ls, out_t["predictions"], out_s["predictions"],
                       out_t.get("updated_params"), out_s.get("updated_params"))

    # the reference plumbs a dropout keep-prob variable into every tower
    # (train.py:278-288); heads/models that ignore it (quirk 5) cost
    # nothing under jit. rngs derive from the global step (also drives
    # DBoF's frame sampling).
    def step(state: DistillState, features_u8, labels, num_frames):
        model_input = preprocess_batch(cfg, features_u8, num_frames)
        model_input_s = uniform_subsample(model_input, cfg.every_n)
        nf_student = student_num_frames(num_frames, cfg.every_n, cfg.max_num_frames)
        base = jax.random.fold_in(jax.random.PRNGKey(cfg.seed),
                                  state.global_step)
        if axis_name is not None:
            # decorrelate dropout / frame sampling across batch shards
            base = jax.random.fold_in(base, jax.lax.axis_index(axis_name))
        rng_t, rng_s = jax.random.split(base)

        grad_fn = jax.grad(loss_fn, argnums=(0, 1), has_aux=True)
        (g_t, g_s), (ls, preds_t, preds_s, upd_t, upd_s) = grad_fn(
            state.params_teacher, state.params_student, model_input,
            model_input_s, num_frames, nf_student, labels,
            state.dropout_keep_prob, rng_t, rng_s,
        )
        if axis_name is not None:
            g_t = jax.lax.psum(g_t, axis_name)
            g_s = jax.lax.psum(g_s, axis_name)
            pred_local = ls["pred_loss"]
            stud_minus_pred = ls["total_student_loss"] - pred_local
            ls = jax.tree.map(lambda v: jax.lax.pmean(v, axis_name), ls)
            ls["pred_loss"] = jax.lax.psum(pred_local, axis_name)
            ls["total_student_loss"] = (
                jax.lax.pmean(stud_minus_pred, axis_name) + ls["pred_loss"]
            )
            # BN batch stats are per-shard under shard_map; average them so
            # every device folds back the same (global-batch) moving stats
            upd_t = None if upd_t is None else jax.tree.map(
                lambda v: jax.lax.pmean(v, axis_name), upd_t)
            upd_s = None if upd_s is None else jax.tree.map(
                lambda v: jax.lax.pmean(v, axis_name), upd_s)
        # Both towers' schedules read the SAME pre-update global step
        # (deterministic resolution of the reference's read/increment race).
        lr = schedule(state.global_step)
        new_pt, new_ot = optimizer.update(
            g_t, state.opt_teacher, state.params_teacher, lr
        )
        new_ps, new_os = optimizer.update(
            g_s, state.opt_student, state.params_student, lr
        )
        new_pt = _merge_updated_stats(new_pt, upd_t)
        new_ps = _merge_updated_stats(new_ps, upd_s)
        new_state = state.replace(
            params_teacher=new_pt,
            params_student=new_ps,
            opt_teacher=new_ot,
            opt_student=new_os,
            global_step=state.global_step + step_increment,
        )
        # the reference's per-step log covers TEACHER metrics only
        # (train.py:522-526); the student's come from validate.py
        topk_val_t, topk_idx_t, perr_t = topk_and_perr_on_device(
            preds_t, labels, top_k)
        metrics = dict(
            ls,
            learning_rate=lr,
            global_step=new_state.global_step,
            topk_val=topk_val_t,
            topk_idx=topk_idx_t,
            perr_precision=perr_t,
        )
        return new_state, metrics

    return step


def build_finetune_step(cfg: TrainConfig, optimizer: Optimizer, top_k: int = 20,
                        axis_name: Optional[str] = None,
                        host_subsampled: bool = False,
                        aggregated: bool = False):
    """Student-only training: CE + reg (train_finetune.py:263-331).

    With `axis_name`, a per-device shard_map program: both loss terms are
    batch-mean / batch-independent, so the local loss is scaled by
    1/n_devices and the local grads psum'd (see build_distill_train_step).

    `host_subsampled`: frames were strided to every_n on the HOST
    (1/every_n the H2D bytes); `num_frames` stays the ORIGINAL count.

    `aggregated`: the `--frame_features=False` branch — features arrive
    [B, D] float32 from pre-aggregated Examples and the (video-level)
    model is applied directly: no dequantize, no frame subsampling
    (train_finetune.py:514-518 + readers.py:53-112); `num_frames` is the
    reader's all-ones placeholder (readers.py:112) and is ignored."""
    schedule = exponential_decay(
        cfg.base_learning_rate,
        cfg.batch_size,
        cfg.learning_rate_decay_examples,
        cfg.learning_rate_decay,
    )

    label_loss_fn = resolve_label_loss(cfg)

    def loss_fn(params_s, model_input_s, nf_student, labels, keep_prob, rng):
        if aggregated:
            out_s = forward_video_level(
                cfg, params_s, model_input_s, labels,
                dropout_keep_prob=keep_prob, rng=rng,
            )
            label_loss = _video_level_label_loss(out_s, labels, label_loss_fn)
        else:
            out_s = forward_student(
                cfg, params_s, model_input_s, nf_student, labels,
                dropout_keep_prob=keep_prob, rng=rng,
                bn_axis_name=axis_name if cfg.sync_batch_norm else None,
            )
            label_loss = out_s.get("loss")
            if label_loss is None:
                label_loss = label_loss_fn(out_s["predictions"], labels)
        reg = out_s.get("regularization_loss", 0.0)
        total = cfg.regularization_penalty * reg + label_loss
        if axis_name is not None:
            total = total / jax.lax.psum(1, axis_name)
        return total, (label_loss, reg, out_s["predictions"],
                       out_s.get("updated_params"))

    def step(state: StudentState, features_u8, labels, num_frames):
        if aggregated:
            nf_student = None
            model_input_s = preprocess_aggregated(features_u8)
        else:
            # student-only path: subsample the uint8 frames FIRST, then
            # dequantize/l2-normalize only the kept 1/every_n — identical
            # results (the ops are per-frame and the LSTM freezes past
            # nf_student), ~10x less preprocess work
            nf_student = student_num_frames(num_frames, cfg.every_n,
                                            cfg.max_num_frames)
            sub = (features_u8 if host_subsampled
                   else uniform_subsample(features_u8, cfg.every_n))
            model_input_s = preprocess_batch(cfg, sub, nf_student)

        rng = jax.random.fold_in(jax.random.PRNGKey(cfg.seed), state.global_step)
        if axis_name is not None:
            rng = jax.random.fold_in(rng, jax.lax.axis_index(axis_name))
        grad_fn = jax.grad(loss_fn, has_aux=True)
        g_s, (label_loss, reg, preds, upd_s) = grad_fn(
            state.params_student, model_input_s, nf_student, labels,
            state.dropout_keep_prob, rng,
        )
        if axis_name is not None:
            g_s = jax.lax.psum(g_s, axis_name)
            label_loss = jax.lax.pmean(label_loss, axis_name)
            reg = jax.lax.pmean(reg, axis_name)
            upd_s = None if upd_s is None else jax.tree.map(
                lambda v: jax.lax.pmean(v, axis_name), upd_s)
        lr = schedule(state.global_step)
        new_ps, new_os = optimizer.update(
            g_s, state.opt_student, state.params_student, lr
        )
        new_ps = _merge_updated_stats(new_ps, upd_s)
        new_state = state.replace(
            params_student=new_ps,
            opt_student=new_os,
            global_step=state.global_step + 1,
        )
        topk_val, topk_idx, perr = topk_and_perr_on_device(
            preds, labels, top_k)
        metrics = {
            "student_label_loss": label_loss,
            "student_reg_loss": reg,
            "learning_rate": lr,
            "global_step": new_state.global_step,
            "topk_val": topk_val,
            "topk_idx": topk_idx,
            "perr_precision": perr,
        }
        return new_state, metrics

    return step


# Paired-index host pack: two top-k indices per f32 lane. Bits 0-15 hold
# the even index, 16-29 the odd one, and bits 31+30 are ALWAYS set: the
# sign bit is the layout discriminator (a wide pack's index lanes are
# non-negative floats, so bit 31 is 0 there), and with bit 30 set the
# exponent field is 0x80..0xFE — a NEGATIVE NORMAL f32, never
# subnormal/NaN (nothing between the pack and the host fetch may flush
# or canonicalize it). Keeping the exponent below 0xFF is what caps the
# packable class id at 0x3F7F = 16255 (YT8M: 4715).
PACKED_IDX_MAX = 0x3F7F
_PAIR_MARKER = (1 << 31) | (1 << 30)


def _pack_host_outputs(topk_val, topk_idx, per_example_loss, perr,
                       num_classes=None):
    """One f32 host bundle per batch: topk values | topk indices |
    per-example CE | PERR. The eval CLIs fetch this ONE buffer
    (parallel/distributed.gather_step_outputs unpacks it).

    When every class id fits (num_classes - 1 <= PACKED_IDX_MAX) the
    indices travel as int16 PAIRS bitcast into f32 lanes — [B, k + ceil(k/2) + 2], 24% fewer
    D2H bytes at k=20, bit-exact (indices are integers; value lanes are
    untouched). Otherwise the wide [B, 2k+2] one-index-per-lane layout
    (exact for class ids < 2^24)."""
    parts = [topk_val.astype(jnp.float32)]
    if num_classes is not None and num_classes - 1 <= PACKED_IDX_MAX:
        idx = topk_idx.astype(jnp.int32)
        if idx.shape[1] % 2:
            idx = jnp.pad(idx, ((0, 0), (0, 1)))
        # _PAIR_MARKER as an int32 literal is -(1 << 30) (two's complement
        # for bits 31+30); `| marker` sets exactly those bits
        words = idx[:, 0::2] | (idx[:, 1::2] << 16) | jnp.int32(-(1 << 30))
        parts.append(jax.lax.bitcast_convert_type(words, jnp.float32))
    else:
        parts.append(topk_idx.astype(jnp.float32))
    parts.append(per_example_loss.astype(jnp.float32)[:, None])
    parts.append(perr.astype(jnp.float32)[:, None])
    return jnp.concatenate(parts, axis=1)


def _faithful_eval_rngs(cfg: TrainConfig, num_frames):
    """Eval-time frame-sampling rngs for DBoF under faithful mode.

    The reference samples frames RANDOMLY at eval too (model_utils.py:
    39-58 called unconditionally from frame_level_models.py:126-131);
    the corrected default here is deterministic even sampling
    (models/frame_level.py:sample_even_frames). With faithful_quirks,
    eval gets a sampling rng — derived from the batch contents so every
    batch draws differently under one jitted program (the reference's
    stream is fresh per session and unreproducible either way).
    """
    if not (cfg.faithful_quirks and cfg.model == "DbofModel"):
        return None, None
    base = jax.random.fold_in(
        jax.random.PRNGKey(cfg.seed), jnp.sum(num_frames)
    )
    return tuple(jax.random.split(base))


def build_validate_step(cfg: TrainConfig, top_k: int = 20):
    """Student eval with the teacher present for L_REP
    (validate.py:109-189): both towers forward-only."""
    label_loss_fn = resolve_label_loss(cfg)

    def step(params_teacher, params_student, features_u8, labels, num_frames):
        model_input = preprocess_batch(cfg, features_u8, num_frames)
        model_input_s = uniform_subsample(model_input, cfg.every_n)
        nf_student = student_num_frames(num_frames, cfg.every_n, cfg.max_num_frames)
        rng_t, rng_s = _faithful_eval_rngs(cfg, num_frames)
        out_t = forward_teacher(cfg, params_teacher, model_input, num_frames,
                                labels, inference=True, rng=rng_t)
        out_s = forward_student(cfg, params_student, model_input_s, nf_student,
                                labels, inference=True, rng=rng_s)
        ls = _distill_losses(cfg, out_t, out_s, labels, label_loss_fn)
        # per-example CE + device top-k + exact PERR + the packed
        # single-transfer host bundle (validate.py:255-268)
        return {**ls, **_eval_outputs(out_s["predictions"], labels, top_k)}

    return step


def _eval_outputs(predictions, labels, top_k: int) -> Dict[str, Any]:
    """The eval binaries' shared per-batch outputs: per-example CE,
    device top-k, exact PERR, and the packed host bundle."""
    eps = 10e-6
    fl = labels.astype(jnp.float32)
    per_example_loss = -jnp.sum(
        fl * jnp.log(predictions + eps)
        + (1 - fl) * jnp.log(1 - predictions + eps),
        axis=1,
    )
    # device top-k + the exact full-row PERR (the reference's
    # eval_util.py:34-59 definition) from ONE sort: bit-identical to
    # lax.top_k + perr_precision_on_device (tests/test_metrics_fast.py)
    # and faster on the GPU (0.97 vs 1.29 ms at 1024x4716 on one NVIDIA
    # H100 80GB HBM3 at 700 W)
    topk_val, topk_idx, perr = topk_and_perr_on_device(
        predictions, labels, top_k)
    return {
        "predictions": predictions,
        "per_example_loss": per_example_loss,
        "topk_val": topk_val,
        "topk_idx": topk_idx,
        "perr_precision": perr,
        "host_pack": _pack_host_outputs(topk_val, topk_idx,
                                        per_example_loss, perr,
                                        num_classes=predictions.shape[-1]),
    }


def build_eval_step(cfg: TrainConfig, top_k: int = 20,
                    host_subsampled: bool = False,
                    aggregated: bool = False):
    """Student-only eval (eval_finetune.py:108-176).

    `host_subsampled`: the caller already strided the uint8 frames to
    every_n on the HOST (1/every_n the host->device bytes — the student
    never reads the dropped frames); features arrive [B, T//every_n, D]
    and `num_frames` stays the ORIGINAL count.

    `aggregated`: the `--frame_features=False` branch — [B, D] float32
    pre-aggregated features straight into the video-level model
    (eval_finetune.py:298-302 + readers.py:53-112)."""

    def step(params_student, features_u8, labels, num_frames):
        if aggregated:
            model_input_s = preprocess_aggregated(features_u8)
            out_s = forward_video_level(cfg, params_student, model_input_s,
                                        labels, inference=True)
        else:
            # subsample uint8 first: only the kept frames are preprocessed
            nf_student = student_num_frames(num_frames, cfg.every_n,
                                            cfg.max_num_frames)
            sub = (features_u8 if host_subsampled
                   else uniform_subsample(features_u8, cfg.every_n))
            model_input_s = preprocess_batch(cfg, sub, nf_student)
            _, rng_s = _faithful_eval_rngs(cfg, num_frames)
            out_s = forward_student(cfg, params_student, model_input_s,
                                    nf_student, labels, inference=True,
                                    rng=rng_s)
        return _eval_outputs(out_s["predictions"], labels, top_k)

    return step


def build_quantized_eval_step(cfg: TrainConfig, top_k: int = 20,
                              host_subsampled: bool = False):
    """build_eval_step with the int8 forward (ops/quantize.py): takes
    QUANTIZED params (quantize_hierarchical_params); same outputs, so
    the eval CLIs' epoch machinery is unchanged. Flagship
    HierarchicalLstm + MoE only."""
    from efficientvideoclassification_youtube8m_tpu.ops.quantize import (
        quantized_hierarchical_forward,
    )

    if (cfg.model != "HierarchicalLstmModel"
            or cfg.video_level_classifier_model != "MoeModel"):
        raise ValueError(
            "--quantize int8 covers the flagship HierarchicalLstmModel "
            "+ MoeModel configuration"
        )

    def step(qparams, features_u8, labels, num_frames):
        nf_student = student_num_frames(num_frames, cfg.every_n,
                                        cfg.max_num_frames)
        sub = (features_u8 if host_subsampled
               else uniform_subsample(features_u8, cfg.every_n))
        model_input_s = preprocess_batch(cfg, sub, nf_student)
        predictions = quantized_hierarchical_forward(
            qparams, model_input_s, nf_student, cfg.num_inputs_L1,
            cfg.num_classes, cfg.moe_num_mixtures,
            scan_unroll=cfg.scan_unroll,
        )
        return _eval_outputs(predictions, labels, top_k)

    return step
