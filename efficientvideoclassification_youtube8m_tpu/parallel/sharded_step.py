"""Sharded (pjit) wrappers around the train/eval steps.

One `jit` with explicit in/out shardings over the ("data", "model") mesh:
GSPMD partitions the program — batch math over "data", the MoE head's
wide matmuls over "model" — and inserts the gradient all-reduces.
State buffers are donated so optimizer updates are in-place.
"""

from __future__ import annotations

from typing import Any

import jax
from jax.sharding import NamedSharding, PartitionSpec as P

from efficientvideoclassification_youtube8m_tpu.parallel.mesh import (
    DATA_AXIS,
    Mesh,
    shard_state_specs,
    to_named,
)
from efficientvideoclassification_youtube8m_tpu.train.optimizer import Optimizer
from efficientvideoclassification_youtube8m_tpu.train.step import (
    build_distill_train_step,
    build_eval_step,
    build_finetune_step,
    build_quantized_eval_step,
    build_validate_step,
)
from efficientvideoclassification_youtube8m_tpu.utils.config import TrainConfig


def _batch_shardings(mesh: Mesh, feature_ndim: int = 3):
    """feature_ndim=3 for frame batches [B, T, D]; 2 for aggregated
    video-level batches [B, D]."""
    fs = NamedSharding(mesh, P(DATA_AXIS, *([None] * (feature_ndim - 1))))
    ls = NamedSharding(mesh, P(DATA_AXIS, None))
    ns = NamedSharding(mesh, P(DATA_AXIS))
    return fs, ls, ns


_DISTILL_SCALARS = (
    "teacher_label_loss", "teacher_final_loss", "teacher_reg_loss",
    "student_loss_state", "pred_loss", "student_label_loss",
    "student_reg_loss", "total_student_loss",
)

_FINETUNE_SCALARS = ("student_label_loss", "student_reg_loss")


def _train_metric_shardings(mesh: Mesh, scalar_keys,
                            with_perr: bool = False):
    """Pin the metric outputs: scalars replicated, top-k row-sharded over
    the data axis. Without this GSPMD may choose layouts where a host's
    addressable shards are COLUMN slices — `distributed.local_rows`
    depends on outputs being row-sharded under multi-host."""
    rep = NamedSharding(mesh, P())
    rows = NamedSharding(mesh, P(DATA_AXIS, None))
    out = {k: rep for k in scalar_keys}
    out.update(learning_rate=rep, global_step=rep,
               topk_val=rows, topk_idx=rows)
    if with_perr:
        out["perr_precision"] = NamedSharding(mesh, P(DATA_AXIS))
    return out


def _eval_metric_shardings(mesh: Mesh, with_losses: bool = False):
    rep = NamedSharding(mesh, P())
    rows2 = NamedSharding(mesh, P(DATA_AXIS, None))
    rows1 = NamedSharding(mesh, P(DATA_AXIS))
    out = {
        "predictions": rows2,
        "per_example_loss": rows1,
        "topk_val": rows2,
        "topk_idx": rows2,
        "perr_precision": rows1,
        "host_pack": rows2,
    }
    if with_losses:
        out.update({k: rep for k in _DISTILL_SCALARS})
    return out


def state_sharding(state: Any, mesh: Mesh, min_dim: int = 4200):
    model_size = mesh.shape.get("model", 1)
    return to_named(shard_state_specs(state, model_size, min_dim), mesh)


def place_state(state: Any, mesh: Mesh, min_dim: int = 4200):
    """Device-put a host state pytree with its sharding."""
    return jax.device_put(state, state_sharding(state, mesh, min_dim))


def place_fields(state: Any, mesh: Mesh, fields, min_dim: int = 4200):
    """Place only the NAMED subtrees of a state dataclass on the mesh;
    every other leaf stays where it is. The eval binaries use this so
    params restore straight onto their shardings while the optimizer
    moments they never read remain host arrays."""
    return state.replace(**{
        f: place_state(getattr(state, f), mesh, min_dim) for f in fields
    })


def build_sharded_distill_step(
    cfg: TrainConfig,
    optimizer: Optimizer,
    mesh: Mesh,
    state_template: Any,
    top_k: int = 20,
    min_dim: int = 4200,
):
    """jit-compiled distillation step with explicit shardings + donation."""
    step = build_distill_train_step(cfg, optimizer, top_k)
    st_shard = state_sharding(state_template, mesh, min_dim)
    fs, ls, ns = _batch_shardings(mesh)
    return jax.jit(
        step,
        in_shardings=(st_shard, fs, ls, ns),
        out_shardings=(st_shard, _train_metric_shardings(
            mesh, _DISTILL_SCALARS, with_perr=True)),
        donate_argnums=(0,),
    )


def build_sharded_finetune_step(
    cfg: TrainConfig,
    optimizer: Optimizer,
    mesh: Mesh,
    state_template: Any,
    top_k: int = 20,
    min_dim: int = 4200,
    host_subsampled: bool = False,
    aggregated: bool = False,
):
    step = build_finetune_step(cfg, optimizer, top_k,
                               host_subsampled=host_subsampled,
                               aggregated=aggregated)
    st_shard = state_sharding(state_template, mesh, min_dim)
    fs, ls, ns = _batch_shardings(mesh, feature_ndim=2 if aggregated else 3)
    return jax.jit(
        step,
        in_shardings=(st_shard, fs, ls, ns),
        out_shardings=(st_shard, _train_metric_shardings(
            mesh, _FINETUNE_SCALARS, with_perr=True)),
        donate_argnums=(0,),
    )


def build_sharded_validate_step(
    cfg: TrainConfig,
    mesh: Mesh,
    params_teacher_template: Any,
    params_student_template: Any,
    top_k: int = 20,
    min_dim: int = 4200,
):
    step = build_validate_step(cfg, top_k)
    model_size = mesh.shape.get("model", 1)
    pt_shard = to_named(
        shard_state_specs(params_teacher_template, model_size, min_dim), mesh
    )
    ps_shard = to_named(
        shard_state_specs(params_student_template, model_size, min_dim), mesh
    )
    fs, ls, ns = _batch_shardings(mesh)
    return jax.jit(step, in_shardings=(pt_shard, ps_shard, fs, ls, ns),
                   out_shardings=_eval_metric_shardings(mesh, with_losses=True))


def build_sharded_eval_step(
    cfg: TrainConfig,
    mesh: Mesh,
    params_student_template: Any,
    top_k: int = 20,
    min_dim: int = 4200,
    host_subsampled: bool = False,
    aggregated: bool = False,
):
    step = build_eval_step(cfg, top_k, host_subsampled=host_subsampled,
                           aggregated=aggregated)
    model_size = mesh.shape.get("model", 1)
    ps_shard = to_named(
        shard_state_specs(params_student_template, model_size, min_dim), mesh
    )
    fs, ls, ns = _batch_shardings(mesh, feature_ndim=2 if aggregated else 3)
    return jax.jit(step, in_shardings=(ps_shard, fs, ls, ns),
                   out_shardings=_eval_metric_shardings(mesh))


def build_sharded_validate_step_stacked(
    cfg: TrainConfig,
    mesh: Mesh,
    params_teacher_template: Any,
    params_student_template: Any,
    top_k: int = 20,
    min_dim: int = 4200,
):
    """build_sharded_validate_step's steps-per-dispatch variant: K
    stacked batches scanned in ONE launch, returning the packed host
    buffer [K, B, 2k+2] plus the per-batch L_REP ([K]) that
    cli.validate logs. Same amortization story as
    build_sharded_eval_step_stacked (below)."""
    step = build_validate_step(cfg, top_k)
    model_size = mesh.shape.get("model", 1)
    pt_shard = to_named(
        shard_state_specs(params_teacher_template, model_size, min_dim), mesh
    )
    ps_shard = to_named(
        shard_state_specs(params_student_template, model_size, min_dim), mesh
    )

    def stacked(pt, ps, features, labels, num_frames):
        def body(carry, batch):
            f, l, n = batch
            out = step(pt, ps, f, l, n)
            return carry, (out["host_pack"], out["student_loss_state"])

        _, (packs, lrep) = jax.lax.scan(
            body, None, (features, labels, num_frames))
        return {"host_pack": packs, "student_loss_state": lrep}

    fs = NamedSharding(mesh, P(None, DATA_AXIS, None, None))
    ls = NamedSharding(mesh, P(None, DATA_AXIS, None))
    ns = NamedSharding(mesh, P(None, DATA_AXIS))
    out_shard = {
        "host_pack": NamedSharding(mesh, P(None, DATA_AXIS, None)),
        "student_loss_state": NamedSharding(mesh, P()),
    }
    return jax.jit(stacked, in_shardings=(pt_shard, ps_shard, fs, ls, ns),
                   out_shardings=out_shard)


def build_sharded_eval_step_stacked(
    cfg: TrainConfig,
    mesh: Mesh,
    params_student_template: Any,
    top_k: int = 20,
    min_dim: int = 4200,
    host_subsampled: bool = False,
    aggregated: bool = False,
    quantized: bool = False,
):
    """K eval batches per LAUNCH: `lax.scan` of the per-batch eval step
    over stacked [K, B, ...] inputs, returning only the packed host
    buffer [K, B, 2k+2].

    On high-launch-latency links, per-launch dispatch is the eval
    loop's floor (the reference paid the same per-`session.run` round
    trip, eval_finetune.py:147-156); scanning K batches inside one
    program amortizes it K-fold and the whole stack's outputs cross the
    device->host edge in one transfer. The scan body IS
    build_eval_step's math on each [B, ...] slice, so epoch metrics are
    bit-identical to the per-batch program (tests/test_stacked_eval.py).
    Caveat: bitwise equality is up to the COMPILER — XLA:CPU can vectorize the CE
    reduction differently inside a scan body than standalone, shifting
    per-example loss by an f32 ulp for some weights (rank metrics stay
    exact; the CLI identity tests pin loss to ulp tolerance).
    K is baked at trace time — one compiled program per distinct K; the
    CLI pads the epoch's final partial stack with dummy batches whose
    output slices are never read.

    `quantized=True` scans the int8 step instead (pass the quantized
    params template); data-parallel meshes only, like
    build_sharded_quantized_eval_step."""
    if quantized:
        if mesh.shape.get("model", 1) != 1:
            raise ValueError("--quantize int8 eval is data-parallel only")
        step = build_quantized_eval_step(cfg, top_k,
                                         host_subsampled=host_subsampled)
        ps_shard = to_named(
            jax.tree.map(lambda _: P(), params_student_template), mesh
        )
    else:
        step = build_eval_step(cfg, top_k, host_subsampled=host_subsampled,
                               aggregated=aggregated)
        ps_shard = to_named(
            shard_state_specs(params_student_template,
                              mesh.shape.get("model", 1), min_dim),
            mesh,
        )

    def stacked(params, features, labels, num_frames):
        def body(carry, batch):
            f, l, n = batch
            return carry, step(params, f, l, n)["host_pack"]

        _, packs = jax.lax.scan(body, None, (features, labels, num_frames))
        return packs

    fnd = 2 if aggregated else 3
    fs = NamedSharding(mesh, P(None, DATA_AXIS, *([None] * (fnd - 1))))
    ls = NamedSharding(mesh, P(None, DATA_AXIS, None))
    ns = NamedSharding(mesh, P(None, DATA_AXIS))
    out = NamedSharding(mesh, P(None, DATA_AXIS, None))
    return jax.jit(stacked, in_shardings=(ps_shard, fs, ls, ns),
                   out_shardings=out)


def build_sharded_quantized_eval_step(
    cfg: TrainConfig,
    mesh: Mesh,
    qparams_template: Any,
    top_k: int = 20,
    host_subsampled: bool = False,
):
    """int8 eval step (train/step.py:build_quantized_eval_step) under
    the same DP batch shardings; the int8 params replicate (no TP —
    per-column scales would need the same split as the kernels)."""
    if mesh.shape.get("model", 1) != 1:
        raise ValueError("--quantize int8 eval is data-parallel only")
    step = build_quantized_eval_step(cfg, top_k,
                                     host_subsampled=host_subsampled)
    qp_shard = to_named(jax.tree.map(lambda _: P(), qparams_template), mesh)
    fs, ls, ns = _batch_shardings(mesh)
    return jax.jit(step, in_shardings=(qp_shard, fs, ls, ns),
                   out_shardings=_eval_metric_shardings(mesh))


def _shardmap_train(step, mesh, metric_scalars, feature_ndim: int = 3,
                    with_perr: bool = False):
    """shard_map a per-device train step (built with axis_name=DATA_AXIS):
    replicated state in/out, batch sharded over "data", topk concatenated.

    Unlike the GSPMD jit path (where the partitioner chooses the
    collectives), the per-device program and its single gradient psum
    are explicit — the scaling-book recipe written by hand. Gradients
    are psum'd inside the step, so the replicated optimizer update is
    identical on every device and the out-spec P() state replication
    holds by construction."""
    from jax.sharding import PartitionSpec as P

    in_specs = (
        P(),  # state: replicated
        P(DATA_AXIS, *([None] * (feature_ndim - 1))),  # features
        P(DATA_AXIS, None),  # labels
        P(DATA_AXIS),  # num_frames
    )
    metric_specs = {k: P() for k in metric_scalars}
    metric_specs.update(
        learning_rate=P(), global_step=P(),
        topk_val=P(DATA_AXIS, None), topk_idx=P(DATA_AXIS, None),
    )
    if with_perr:
        metric_specs["perr_precision"] = P(DATA_AXIS)
    mapped = jax.shard_map(
        step, mesh=mesh, in_specs=in_specs,
        out_specs=(P(), metric_specs), check_vma=False,
    )
    return jax.jit(mapped, donate_argnums=(0,))


def build_shardmap_distill_step(
    cfg: TrainConfig, optimizer: Optimizer, mesh: Mesh, top_k: int = 20,
):
    """Data-parallel distillation TRAIN step via shard_map (explicit
    per-device grads + one psum). Requires model_parallelism == 1;
    use build_sharded_distill_step (GSPMD) for tensor-parallel meshes."""
    if mesh.shape.get("model", 1) != 1:
        raise ValueError("shard_map train path is data-parallel only")
    step = build_distill_train_step(cfg, optimizer, top_k,
                                    axis_name=DATA_AXIS)
    return _shardmap_train(step, mesh, _DISTILL_SCALARS, with_perr=True)


def build_shardmap_finetune_step(
    cfg: TrainConfig, optimizer: Optimizer, mesh: Mesh, top_k: int = 20,
    host_subsampled: bool = False, aggregated: bool = False,
):
    """Data-parallel student-only TRAIN step via shard_map."""
    if mesh.shape.get("model", 1) != 1:
        raise ValueError("shard_map train path is data-parallel only")
    step = build_finetune_step(cfg, optimizer, top_k, axis_name=DATA_AXIS,
                               host_subsampled=host_subsampled,
                               aggregated=aggregated)
    return _shardmap_train(
        step, mesh, ("student_label_loss", "student_reg_loss"),
        feature_ndim=2 if aggregated else 3, with_perr=True,
    )


def build_shardmap_eval_step(
    cfg: TrainConfig,
    mesh: Mesh,
    top_k: int = 20,
):
    """DP eval step via shard_map: each device runs the per-shard program
    on its local batch slice with replicated params. Metrics concatenate
    along the batch axis; requires model_parallelism == 1.
    """
    if mesh.shape.get("model", 1) != 1:
        raise ValueError("shard_map eval path is data-parallel only")
    from jax.sharding import PartitionSpec as P

    step = build_eval_step(cfg, top_k)

    batch_specs = (
        P(),  # params: replicated
        P(DATA_AXIS, None, None),  # features
        P(DATA_AXIS, None),  # labels
        P(DATA_AXIS),  # num_frames
    )
    out_specs = {
        "predictions": P(DATA_AXIS, None),
        "per_example_loss": P(DATA_AXIS),
        "topk_val": P(DATA_AXIS, None),
        "topk_idx": P(DATA_AXIS, None),
        "perr_precision": P(DATA_AXIS),
        "host_pack": P(DATA_AXIS, None),
    }
    mapped = jax.shard_map(
        step, mesh=mesh, in_specs=batch_specs, out_specs=out_specs,
        check_vma=False,
    )
    return jax.jit(mapped)
