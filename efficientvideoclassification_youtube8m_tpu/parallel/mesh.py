"""Device mesh + sharding rules.

Replaces the reference's vestigial TF1 ps/worker scaffolding
(`/root/reference/code_student_uniform/train.py:654-699`, bypassed by
its own authors at train.py:477-479) with first-class SPMD:

  * mesh axes ("data", "model") over the devices (cards joined all to
    all, so the mesh shape follows the algorithm alone);
  * batch sharded over "data" (pure DP is the workload's natural
    parallelism — and because the hierarchical model folds its 20 L1
    chunks into the batch axis, DP over batch IS sequence-block
    parallelism for L1);
  * the MoE classifier's wide matmuls ([state, vocab*(m+1)] ~ 58M params)
    column-sharded over "model" (Megatron-style tensor parallelism);
    XLA/GSPMD inserts the collectives;
  * optimizer state shards like its parameters; everything else
    replicates.

No parameter server: optimizer state is replicated/sharded with the
params and gradients are reduced by XLA's all-reduce (NCCL on GPUs).
"""

from __future__ import annotations

from typing import Any, Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

DATA_AXIS = "data"
MODEL_AXIS = "model"


def create_mesh(
    data: Optional[int] = None,
    model: int = 1,
    devices: Optional[Sequence[jax.Device]] = None,
) -> Mesh:
    """Build a ("data", "model") mesh. With `data=None`, all remaining
    devices go to the data axis."""
    devices = list(devices if devices is not None else jax.devices())
    n = len(devices)
    if data is None:
        if n % model:
            raise ValueError(f"{n} devices not divisible by model={model}")
        data = n // model
    if data * model != n:
        raise ValueError(f"mesh {data}x{model} != {n} devices")
    arr = np.asarray(devices).reshape(data, model)
    return Mesh(arr, (DATA_AXIS, MODEL_AXIS))


def _is_tp_shardable(x, model_size: int, min_dim: int) -> bool:
    if not hasattr(x, "ndim"):
        return False
    if x.ndim == 0:
        return False
    d = x.shape[-1]
    return d >= min_dim and d % model_size == 0


def _tp_spec(x, model_size: int, min_dim: int):
    """The column-sharding rule, in ONE place: wide, model-divisible
    last dims shard over "model"; everything else replicates."""
    if model_size > 1 and _is_tp_shardable(x, model_size, min_dim):
        if x.ndim == 1:
            return P(MODEL_AXIS)
        return P(*([None] * (x.ndim - 1)), MODEL_AXIS)
    return P()


def make_params_specs(params: Any, model_size: int, min_dim: int = 4200) -> Any:
    """PartitionSpec tree for a params pytree.

    Rule: kernels and their biases whose LAST dim is wide (>= min_dim)
    and divisible by the model axis are column-sharded over "model"
    (covers the MoE gates/experts, last dim = vocab 4716); everything
    else — LSTM kernels (last dim 4*1024 = 4096, hence the default
    min_dim of 4200 sits between them), hidden layers — replicates.
    With model_size == 1 everything replicates.
    """

    return jax.tree.map(lambda x: _tp_spec(x, model_size, min_dim), params)


def shard_state_specs(state: Any, model_size: int, min_dim: int = 4200) -> Any:
    """Specs for a DistillState/StudentState: params + matching optimizer
    slots sharded, counters replicated — the same column rule as
    make_params_specs (optimizer moments mirror their parameters)."""
    return jax.tree.map(lambda x: _tp_spec(x, model_size, min_dim), state)


def to_named(tree_of_specs: Any, mesh: Mesh) -> Any:
    return jax.tree.map(
        lambda s: NamedSharding(mesh, s),
        tree_of_specs,
        is_leaf=lambda x: isinstance(x, P),
    )


def shard_batch(mesh: Mesh, features, labels, num_frames):
    """Place host batch arrays sharded over the data axis.

    Single process: an async `device_put` (the H2D double-buffering in
    `device_prefetch` relies on it). Multi-host: each process holds only
    its `1/process_count` slice of the global batch, so the global array
    is assembled with `jax.make_array_from_process_local_data` — the
    local rows stay on the local devices and only metadata crosses DCN.
    """
    # frame batches are [B, T, D]; aggregated video-level batches [B, D]
    fs = NamedSharding(mesh, P(DATA_AXIS, *([None] * (features.ndim - 1))))
    ls = NamedSharding(mesh, P(DATA_AXIS, None))
    ns = NamedSharding(mesh, P(DATA_AXIS))
    if jax.process_count() > 1:
        count = jax.process_count()

        def assemble(x, sharding):
            global_shape = (x.shape[0] * count,) + tuple(x.shape[1:])
            return jax.make_array_from_process_local_data(
                sharding, np.ascontiguousarray(x), global_shape
            )

        return (
            assemble(features, fs),
            assemble(labels, ls),
            assemble(num_frames, ns),
        )
    return (
        jax.device_put(features, fs),
        jax.device_put(labels, ls),
        jax.device_put(num_frames, ns),
    )


def shard_stacked_batch(mesh: Mesh, features, labels, num_frames):
    """`shard_batch` for a STACK of K batches ([K, B, ...] arrays): the
    batch rows (axis 1) shard over the data axis; the stack axis stays
    whole on every device. Feeds the steps-per-dispatch eval program
    (parallel.build_sharded_eval_step_stacked), which scans the K
    batches inside one launch."""
    fs = NamedSharding(
        mesh, P(None, DATA_AXIS, *([None] * (features.ndim - 2)))
    )
    ls = NamedSharding(mesh, P(None, DATA_AXIS, None))
    ns = NamedSharding(mesh, P(None, DATA_AXIS))
    if jax.process_count() > 1:
        count = jax.process_count()

        def assemble(x, sharding):
            global_shape = (
                (x.shape[0], x.shape[1] * count) + tuple(x.shape[2:])
            )
            return jax.make_array_from_process_local_data(
                sharding, np.ascontiguousarray(x), global_shape
            )

        return (
            assemble(features, fs),
            assemble(labels, ls),
            assemble(num_frames, ns),
        )
    return (
        jax.device_put(features, fs),
        jax.device_put(labels, ls),
        jax.device_put(num_frames, ns),
    )


def device_prefetch(loader, mesh: Mesh, depth: int = 1, host_keep=None):
    """Yield `(sharded_device_arrays, host_kept)` pairs with the H2D
    transfer running `depth` batches ahead.

    `jax.device_put` is asynchronous, so issuing batch k+1's transfer
    before batch k's step is dispatched overlaps PCIe copy time with
    device compute — the double-buffering the reference gets from its
    queue runners feeding the device (train.py:170-176). Costs `depth`
    extra batches of HBM. Only `host_keep(batch)` rides along on the
    host (default: the labels, which the train loops' metric logging
    needs); the big uint8 features buffer is dropped as soon as its
    transfer is issued."""
    from collections import deque

    if host_keep is None:
        host_keep = lambda b: b.labels  # noqa: E731
    pending = deque()
    for batch in loader:
        pending.append(
            (shard_batch(mesh, batch.features, batch.labels,
                         batch.num_frames), host_keep(batch))
        )
        if len(pending) > depth:
            yield pending.popleft()
    while pending:
        yield pending.popleft()
