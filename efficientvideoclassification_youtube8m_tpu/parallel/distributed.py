"""Multi-host (multi-process) runtime helpers.

The reference's distribution story is a TF1 grpc parameter-server
scaffold keyed off TF_CONFIG (`train.py:654-733`) that its own authors
bypassed. The replacement here is single-controller-per-host SPMD:

  * `initialize()` — `jax.distributed.initialize` (coordinator address /
    process id from the environment, honoring the same TF_CONFIG shape
    for drop-in cluster specs);
  * `host_shard()` — which slice of the input shards this host reads
    (feeds FrameDataLoader's shard_index/num_shards);
  * global-batch assembly happens through `jax.make_array_from_
    process_local_data` on the data axis.

Fault tolerance follows the reference's model (SURVEY.md §5): periodic
checkpoints + relaunch-and-resume (`latest_checkpoint` ->
`restore_checkpoint`); there is no in-band elastic recovery to port.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Dict, Optional, Tuple

import jax
import numpy as np


def parse_tf_config(env: Optional[dict] = None) -> Optional[dict]:
    """Accept the reference's TF_CONFIG cluster spec (train.py:710-718)."""
    env = os.environ if env is None else env
    raw = env.get("TF_CONFIG")
    if not raw:
        return None
    cfg = json.loads(raw)
    cluster = cfg.get("cluster", {})
    task = cfg.get("task", {"type": "master", "index": 0})
    # master(s) first, then workers — process ids must be globally unique
    # across both job types (the reference's cluster spec has both,
    # train.py:710-718)
    masters = cluster.get("master", [])
    workers = cluster.get("worker", [])
    hosts = masters + workers
    index = int(task.get("index", 0))
    task_type = task.get("type", "master")
    process_id = index if task_type == "master" else len(masters) + index
    return {
        "coordinator": hosts[0] if hosts else None,
        "num_processes": len(hosts) or 1,
        "process_id": process_id,
        "task_type": task_type,
    }


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> None:
    """Bring up the multi-host runtime. No-ops for single-process runs.

    Falls back to TF_CONFIG (reference cluster-spec shape) and then to
    JAX's own env-based autodetection.
    """
    if coordinator_address is None:
        tfc = parse_tf_config()
        if tfc and tfc["num_processes"] > 1:
            coordinator_address = tfc["coordinator"]
            num_processes = tfc["num_processes"]
            process_id = tfc["process_id"]
    if coordinator_address is None and "JAX_COORDINATOR_ADDRESS" not in os.environ:
        return  # single process
    if jax.distributed.is_initialized():
        return  # already initialized (e.g. a scripted multi-stage pipeline
        # calling several CLI mains in one process)
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )


def host_shard() -> Tuple[int, int]:
    """(shard_index, num_shards) for this host's input pipeline."""
    return jax.process_index(), jax.process_count()


def is_master() -> bool:
    """The reference's master election (`train.py:444`)."""
    return jax.process_index() == 0


@dataclasses.dataclass(frozen=True)
class HostContext:
    """What one host needs to know about its place in the cluster.

    The per-host counterpart of the reference's worker bookkeeping
    (task index / is_chief, `train.py:704-733`): which input shards this
    process reads, how many rows of the GLOBAL batch it contributes, and
    whether it owns the side effects (summaries, checkpoints).
    """

    process_index: int
    process_count: int
    local_batch_size: int
    is_master: bool

    @property
    def multi_host(self) -> bool:
        return self.process_count > 1


def host_context(global_batch_size: int) -> HostContext:
    """Resolve this process's role after `initialize()`.

    `--batch_size` keeps its single-process meaning — the GLOBAL batch —
    and each host loads and transfers only its `1/process_count` slice
    (the SPMD replacement for the reference's per-worker batches).
    """
    index, count = host_shard()
    if global_batch_size % count:
        raise ValueError(
            f"--batch_size {global_batch_size} not divisible by "
            f"{count} processes"
        )
    return HostContext(
        process_index=index,
        process_count=count,
        local_batch_size=global_batch_size // count,
        is_master=index == 0,
    )


def local_rows(x) -> np.ndarray:
    """This host's rows of a batch-axis-sharded global array, in global
    row order.

    Under `make_array_from_process_local_data` each process's batch rows
    live on its own devices, so the addressable shards of a step OUTPUT
    that is sharded the same way are exactly the rows this host fed in —
    the per-step train logging can stay host-local (the reference logs
    per-worker metrics too) with zero cross-host traffic.
    """
    return _local_shards_along(x, axis=0)


def _local_shards_along(x, axis: int) -> np.ndarray:
    """Shared addressable-shard assembly for batch axes 0 (per-batch
    outputs) and 1 (stacked [K, B, ...] packs)."""
    if getattr(x, "is_fully_addressable", True):
        return np.asarray(x)
    parts: Dict[int, np.ndarray] = {}
    for shard in x.addressable_shards:
        start = shard.index[axis].start or 0
        if start not in parts:  # replicas on other axes carry the same rows
            parts[start] = np.asarray(shard.data)
    return np.concatenate([parts[k] for k in sorted(parts)], axis=axis)


def sync_host_streams(loader, mode: str = "train"):
    """Keep every host's step count identical under multi-host SPMD.

    Per-host input shards are never perfectly balanced, but every
    process must join every collective — one host running out of
    batches while the others keep stepping deadlocks the program (the
    TF1 analogue is a worker parking on an empty queue,
    `train.py:170-176`). Each iteration allgathers a 1-bit
    "I have a batch" flag:

      * mode="train": stop ALL hosts as soon as ANY host is exhausted
        (the cross-host drop_remainder);
      * mode="eval": run until EVERY host is exhausted — dry hosts feed
        fully-padded dummy batches (pad == batch rows) that the metric
        accumulation strips, so no real example is dropped.

    Single-process: a passthrough with zero overhead.
    """
    if jax.process_count() == 1:
        yield from loader
        return

    from jax.experimental import multihost_utils

    from efficientvideoclassification_youtube8m_tpu.data.loader import FrameBatch

    def dummy_batch():
        rows = getattr(loader, "feature_rows", loader.max_frames)
        return FrameBatch(
            video_ids=[""] * loader.batch_size,
            features=np.zeros(
                (loader.batch_size, rows, loader.total_size), np.uint8
            ),
            labels=np.zeros((loader.batch_size, loader.vocab_size), bool),
            num_frames=np.ones((loader.batch_size,), np.int32),
            pad=loader.batch_size,
        )

    it = iter(loader)
    while True:
        try:
            batch = next(it)
            have = 1
        except StopIteration:
            batch = None
            have = 0
        flags = np.asarray(
            multihost_utils.process_allgather(np.asarray([have], np.int32))
        ).reshape(-1)
        if mode == "train":
            if not flags.all():
                return
        else:
            if not flags.any():
                return
            if batch is None:
                batch = dummy_batch()
        yield batch


def broadcast_flag(value: bool) -> bool:
    """Broadcast the MASTER's boolean decision to every host.

    Wall-clock triggers (save_model_secs / save_summaries_secs) must
    fire on every host in the same step: the orbax save is a collective
    and the on-device histogram reductions run global programs — a host
    entering alone deadlocks. Single-process: a passthrough.
    """
    if jax.process_count() == 1:
        return value

    from jax.experimental import multihost_utils

    out = multihost_utils.broadcast_one_to_all(
        np.asarray([1 if value else 0], np.int32)
    )
    return bool(np.asarray(out)[0])


def broadcast_str(value: Optional[str], max_len: int = 1024) -> Optional[str]:
    """Broadcast a (possibly None) string from the master to every host.

    The eval/validate watch loops poll `latest_checkpoint` — under
    multi-host each host could see a DIFFERENT newest checkpoint (or a
    different number of them), desyncing the per-batch collectives that
    follow. The master's answer is authoritative; everyone else takes it.
    Single-process: a passthrough.
    """
    if jax.process_count() == 1:
        return value

    from jax.experimental import multihost_utils

    _TOO_LONG = b"\x01TOO_LONG"
    buf = np.zeros((max_len,), np.uint8)
    if jax.process_index() == 0 and value:
        raw = value.encode("utf-8")
        if len(raw) > max_len:
            # raising before the collective would strand the workers
            # inside broadcast_one_to_all — broadcast a sentinel so
            # EVERY host raises the same error deterministically
            raw = _TOO_LONG
        buf[: len(raw)] = np.frombuffer(raw, np.uint8)
    out = np.asarray(multihost_utils.broadcast_one_to_all(buf))
    raw = bytes(out[out != 0])
    if raw == _TOO_LONG:
        raise ValueError(f"broadcast string longer than {max_len} bytes")
    return raw.decode("utf-8") if raw else None


def gather_eval_rows(arrays: Dict[str, Any], pad: int) -> Tuple[Dict[str, np.ndarray], int]:
    """Assemble the GLOBAL (all-host) eval rows for metric accumulation.

    Each host passes its local `[local_B, ...]` arrays plus how many of
    its trailing rows are padding (eval tail batches pad per host). The
    result concatenates every host's VALID rows in process order, so the
    epoch metrics — GAP's global top-k heap in particular — see the same
    stream a single-process run would. Single-process: a passthrough.
    One collective per batch: the pad count rides in the same allgather
    pytree as the row arrays.
    """
    if jax.process_count() == 1:
        arrays = {k: np.asarray(v) for k, v in arrays.items()}
        if pad:
            arrays = {k: v[: v.shape[0] - pad] for k, v in arrays.items()}
        return arrays, pad

    from jax.experimental import multihost_utils

    local = {k: np.asarray(v) for k, v in arrays.items()}
    gathered = multihost_utils.process_allgather(
        dict(local, __pad__=np.asarray([pad], np.int32)), tiled=True
    )
    pads = np.asarray(gathered.pop("__pad__")).reshape(-1)
    gathered = {k: np.asarray(v) for k, v in gathered.items()}
    block = next(iter(local.values())).shape[0]
    keep = np.concatenate(
        [
            np.arange(p * block, (p + 1) * block - int(pads[p]))
            for p in range(len(pads))
        ]
    )
    return {k: v[keep] for k, v in gathered.items()}, int(pads.sum())


def _paired_k(m: int):
    """The k with k + ceil(k/2) == m (the paired-index pack's index+value
    lane count), or None. At most one k matches: the map is strictly
    increasing."""
    k = (2 * m) // 3
    for cand in (k, k + 1):
        if cand > 0 and cand + (cand + 1) // 2 == m:
            return cand
    return None


def unpack_host_pack(pack: np.ndarray, labels) -> Dict[str, Any]:
    """Split one packed eval buffer (train/step.py:_pack_host_outputs)
    back into its fields. Self-describing across the two layouts:
      * paired — [B, k + ceil(k/2) + 2], two indices per f32 lane, SIGN
        BIT SET (the _PAIR_MARKER; a wide pack's index lanes are
        non-negative floats, so a negative word proves paired even when
        the lane counts alias, e.g. wide k=3 vs paired k=4);
      * wide   — [B, 2k + 2], one float-encoded index per lane."""
    m = pack.shape[1] - 2
    k = _paired_k(m)
    if k is not None:
        h = (k + 1) // 2
        words = np.ascontiguousarray(pack[:, k:k + h]).view(np.int32)
        if words.size and words[0, 0] >= 0:
            k = None  # wide pack whose lane count aliases a paired one
        else:
            words = words & np.int32(0x3FFFFFFF)  # drop the marker bits
            idx = np.empty((pack.shape[0], 2 * h), np.int32)
            idx[:, 0::2] = words & 0xFFFF
            idx[:, 1::2] = words >> 16
            idx = idx[:, :k]
    if k is None:
        k = m // 2
        idx = pack[:, k:2 * k].astype(np.int32)
    return {
        "topk_val": pack[:, :k],
        "topk_idx": idx,
        "per_example_loss": pack[:, m],
        "perr_precision": pack[:, m + 1],
        "labels": labels,
    }


def _local_rows_axis1(x) -> np.ndarray:
    """This host's rows of a [K, B, ...] stack whose BATCH axis (1) is
    sharded over the data axis — `local_rows`' contract shifted one
    axis right (the stacked eval program's output layout)."""
    return _local_shards_along(x, axis=1)


def gather_stacked_outputs(packs, metas):
    """Per-batch row streams of ONE stacked eval launch
    (parallel.build_sharded_eval_step_stacked).

    `packs` is the [K, B, 2k+2] program output (axis 1 row-sharded);
    `metas` lists `(labels, pad)` for the REAL leading batches —
    shorter than K when the epoch tail padded the stack with dummy
    batches, whose slices are simply never read. The whole stack
    crosses the device->host edge in ONE transfer; yields
    `gather_step_outputs`-shaped row dicts in batch order, so epoch
    metrics are bit-identical to the per-batch loop."""
    pack = _local_rows_axis1(packs)
    for i, (labels, pad) in enumerate(metas):
        rows, _ = gather_eval_rows(unpack_host_pack(pack[i], labels), pad)
        yield rows


def stack_batches(mesh, bufs, steps: int, dummy_labels=None):
    """Stack `bufs` host batches into the [K, ...] arrays of ONE stacked
    launch, padding the epoch's final partial stack with fully-padded
    dummy batches (their output slices are simply never read — see
    gather_stacked_outputs). Shared by the cli.eval / cli.validate /
    cli.infer --steps_per_dispatch loops.

    `dummy_labels`: a fixed [B, V] array to use for EVERY position
    (cli.infer has no labels); None stacks each batch's own labels."""
    from efficientvideoclassification_youtube8m_tpu.parallel import (
        shard_stacked_batch,
    )

    feats = [b.features for b in bufs]
    nfs = [b.num_frames for b in bufs]
    for _ in range(steps - len(bufs)):
        feats.append(np.zeros_like(feats[0]))
        nfs.append(np.zeros_like(nfs[0]))
    if dummy_labels is None:
        labs = [b.labels for b in bufs]
        labs += [np.zeros_like(labs[0])] * (steps - len(bufs))
        labs = np.stack(labs)
    else:
        labs = np.ascontiguousarray(np.broadcast_to(
            dummy_labels, (steps,) + dummy_labels.shape))
    return shard_stacked_batch(mesh, np.stack(feats), labs, np.stack(nfs))


def stacked_ring(batches, steps: int, depth: int, launch):
    """The --steps_per_dispatch dispatch loop shared by the eval-side
    CLIs: group the host `batches` stream into stacks of `steps`,
    `launch(bufs)` each (returning the in-flight handle), and yield
    completed handles from a FIFO lag-`depth` ring — so `depth` launches'
    dispatch + D2H latency overlaps device compute while downstream
    consumption order stays identical to the sequential per-batch loop
    (epoch metrics / CSV rows bit-identical)."""
    from collections import deque

    ring: deque = deque()
    buf = []
    for batch in batches:
        buf.append(batch)
        if len(buf) == steps:
            ring.append(launch(buf))
            buf = []
            # pop only when MORE than `depth` are in flight: `>=` kept
            # depth-1 launches outstanding (depth=1 degenerated to a
            # fully synchronous loop) — device_prefetch's convention
            if len(ring) > depth:
                yield ring.popleft()
    if buf:
        ring.append(launch(buf))
    while ring:
        yield ring.popleft()


def gather_step_outputs(out: Dict[str, Any], labels, pad: int) -> Dict[str, np.ndarray]:
    """The eval CLIs' shared per-batch assembly: this host's rows of the
    step outputs + its labels, gathered into the global valid-row stream
    (cli/validate.py and cli/eval.py accumulate from the result).

    When the step supplies "host_pack" ([B, 2k+2], train/step.py:
    _pack_host_outputs), everything crosses the device->host edge in ONE
    transfer and is unpacked here — fetch round trips are the eval
    loop's critical path on high-latency links."""
    if "host_pack" in out:
        fields = unpack_host_pack(
            np.asarray(local_rows(out["host_pack"])), labels
        )
    else:
        fields = {
            "topk_val": local_rows(out["topk_val"]),
            "topk_idx": local_rows(out["topk_idx"]),
            "per_example_loss": local_rows(out["per_example_loss"]),
            "perr_precision": local_rows(out["perr_precision"]),
            "labels": labels,
        }
    rows, _ = gather_eval_rows(fields, pad)
    return rows
