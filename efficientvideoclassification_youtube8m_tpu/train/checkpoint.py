"""Checkpointing: pytree snapshots with TF-Saver-style semantics.

Replaces the reference's `tf.train.Saver` V2 checkpoints + `.meta` graph
files (`train.py:496-504,651`): `model.ckpt-<step>` snapshots, a
`checkpoint` pointer file (latest first), and `max_to_keep`. "Meta-graph
surgery" (train_convert_model.py:360-401) becomes subtree selection on
the state pytree (`train/state.py:student_state_from_distill`).

Two interchangeable backends:
  * "msgpack" (default) — one file in flax's msgpack layout, written and
    read by `train/serialization.py`; simple, fast, single-host;
  * "orbax" — `orbax.checkpoint.StandardCheckpointer` directories, for
    sharded/multi-host state (each host writes its shards; restore
    places onto the mesh). Optional: orbax is imported only when this
    backend is used, and a clear error says so when it is missing.
`latest_checkpoint`/`restore_checkpoint` auto-detect either format.
"""

from __future__ import annotations

import logging
import os
import re
import shutil
import threading
from typing import Any, List, Optional

import jax
import numpy as np

from efficientvideoclassification_youtube8m_tpu.train import serialization

_POINTER = "checkpoint"
_PREFIX = "model.ckpt"


def _orbax_checkpointer():
    try:
        import orbax.checkpoint as ocp
    except ImportError as e:
        raise ImportError(
            "--checkpoint_format orbax needs the orbax-checkpoint package, "
            "which is not installed; use --checkpoint_format msgpack"
        ) from e
    return ocp.StandardCheckpointer()


def _thread_safe_orbax_barriers() -> bool:
    """Route orbax's cross-process barriers through the JAX coordination
    service (pure RPC between processes — safe to run from a writer
    thread) instead of its default `sync_global_devices` DEVICE
    collective, which would interleave with the main thread's training
    collectives and can deadlock a pod. Returns False when the routing
    can't be enabled (orbax without the flag, or no distributed client
    to carry the RPC barrier)."""
    try:
        if not jax.distributed.is_initialized():
            return False
        from absl import flags as absl_flags

        import orbax.checkpoint._src.multihost.multihost as mh

        holder = mh.EXPERIMENTAL_ORBAX_USE_DISTRIBUTED_BARRIER
        absl_flags.FLAGS[holder.name].parse("true")
        return bool(holder.value)
    except Exception as e:  # missing flag / renamed module on old orbax
        logging.warning("orbax distributed barrier unavailable: %s", e)
        return False


def save_checkpoint(
    train_dir: str,
    state: Any,
    step: int,
    max_to_keep: int = 1,
    backend: str = "msgpack",
) -> str:
    """Write `model.ckpt-<step>[.msgpack]` and update the pointer file.
    The reference keeps only the latest (`Saver(max_to_keep=1)`,
    train.py:651).

    Multi-host contract: EVERY process calls this. The orbax backend's
    save is a collective (each host writes its own shards and joins the
    commit barrier); the msgpack backend writes from the master only
    (state must be host-replicated — DP — or use orbax). Pointer-file
    update and max_to_keep cleanup run on the master only.
    """
    is_master = jax.process_index() == 0
    os.makedirs(train_dir, exist_ok=True)
    if backend == "orbax":
        path = os.path.abspath(os.path.join(train_dir, f"{_PREFIX}-{step}"))
        if is_master and os.path.exists(path):
            shutil.rmtree(path)
        if jax.process_count() > 1:
            from jax.experimental import multihost_utils

            multihost_utils.sync_global_devices(f"ckpt_dir_ready_{step}")
        ckptr = _orbax_checkpointer()
        # hand orbax the device arrays as-is: sharded jax.Arrays are
        # written shard-by-shard (each host its own shards under
        # multi-host) with no host gather of the full state
        ckptr.save(path, state)
        ckptr.wait_until_finished()  # StandardCheckpointer saves async
    elif backend == "msgpack":
        path = os.path.join(train_dir, f"{_PREFIX}-{step}.msgpack")
        # Run the shardedness check on EVERY process (before the master's
        # early non-master return) so an unsupported state raises on all
        # hosts together — a master-only raise would leave the other
        # processes stepping into the next collective and deadlock the
        # cluster. `device_get` works for fully-REPLICATED global arrays
        # (the multi-host DP case: every host holds a full copy) even
        # though they are not fully addressable on a multi-process mesh.
        not_fetchable = [
            x for x in jax.tree.leaves(state)
            if isinstance(x, jax.Array)
            and not (x.is_fully_addressable or x.is_fully_replicated)
        ]
        if not_fetchable:
            raise ValueError(
                "msgpack checkpoints need the full state on this host; "
                f"{len(not_fetchable)} leaves are sharded across "
                "hosts — use --checkpoint_format orbax for multi-host "
                "sharded state"
            )
        if is_master:
            state = jax.device_get(state)
            tmp = path + ".tmp"
            with open(tmp, "wb") as f:
                f.write(serialization.to_bytes(state))
            os.replace(tmp, path)
    else:
        raise ValueError(f"unknown checkpoint backend {backend!r}")

    if not is_master:
        return path
    _update_pointer(train_dir, path, max_to_keep)
    return path


def _update_pointer(train_dir: str, path: str, max_to_keep: int) -> None:
    """Master-only tail of a save: pointer file + max_to_keep cleanup."""
    existing = _list_checkpoints(train_dir)
    ordered = [path] + [p for p in existing if p != path]
    with open(os.path.join(train_dir, _POINTER), "w") as f:
        for p in ordered:
            f.write(os.path.basename(p) + "\n")
    if max_to_keep and len(ordered) > max_to_keep:
        for p in ordered[max_to_keep:]:
            try:
                if os.path.isdir(p):
                    shutil.rmtree(p)
                else:
                    os.remove(p)
            except OSError:
                pass


class AsyncCheckpointSaver:
    """Checkpoint writes overlapped with training.

    The training loop's periodic `save_checkpoint` stalls it for the full
    device->host fetch plus the file write (the reference's `tf.train.Saver`
    blocks the Supervisor loop the same way, train.py:496-504). `save()`
    instead snapshots the state with one jitted identity copy — REQUIRED
    because the train step donates its state buffers
    (parallel/sharded_step.py donate_argnums=(0,)), so the next dispatched
    step invalidates the original arrays while a save is in flight — and
    hands the snapshot to a background thread that fetches it and runs the
    ordinary `save_checkpoint` (device_get releases the GIL during the
    transfer, so it overlaps subsequently dispatched steps).

    The snapshot lands in the device's **pinned_host memory** where the
    backend supports it: the copy streams device->host inside the jitted
    program, so the device-memory high-water stays flat instead of
    holding a second copy of the train state (3.2 GiB at the flagship)
    beside the step's activations. On the GPU this is the mode the saver
    settles on (chip_smoke.py's snapshot phase checks it). Backends whose
    pinned_host path doesn't execute (XLA:CPU lacks the placement) fall
    back to an in-device copy, and if no snapshot can be taken at all
    the save runs synchronously with a one-time warning.

    Multi-host: also async, with the collective-ordering hazard designed
    out rather than avoided. The jitted snapshot runs on the MAIN thread
    (every process dispatches it at the same program point; the identity
    program is collective-free). What runs on the writer thread never
    touches device collectives:
      * msgpack (replicated DP state): the master's thread device_gets
        its LOCAL copy and writes the file — non-masters have nothing to
        write (the shardedness validation runs on the main thread on
        every process, preserving the raise-together contract);
      * orbax (sharded state): every process's thread writes its OWN
        shards via orbax, with orbax's commit barriers routed through
        the JAX coordination service (`jax_distributed_barrier` — pure
        RPC between the writer threads, independent of the main threads'
        device-collective stream) instead of its default
        `sync_global_devices` DEVICE collective. If that routing is
        unavailable (orbax too old to have the flag, or
        jax.distributed uninitialized) the save falls back to the
        synchronous collective path with a one-time logged reason.
    If any process fails to snapshot (e.g. transient HBM pressure), all
    processes agree to save synchronously (one main-thread all-gather)
    so no host runs a collective save against a host that went async.

    One save in flight at a time: a second `save()` joins the first
    (pointer-file updates stay ordered). `wait()` joins and re-raises any
    background failure; call it before restoring from or handing off the
    train_dir, and at loop exit.
    """

    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        self._thread: Optional[threading.Thread] = None
        self._exc: Optional[BaseException] = None
        self._mode: Optional[str] = None  # "host" | "hbm", fixed on 1st win
        self._snapshot_fn = None  # jitted donation-safe copy, built lazily
        self._warned_sync = False

    @property
    def snapshot_mode(self) -> Optional[str]:
        """"host" (pinned_host), "hbm" (device copy), or None before the
        first snapshot (or when none could be taken)."""
        return self._mode

    def _run_snapshot(self, mode: str, arrays: List[jax.Array]):
        if self._snapshot_fn is None:
            if mode == "host":
                out_shardings = [
                    x.sharding.with_memory_kind("pinned_host")
                    for x in arrays
                ]
                # identity with outputs in a different memory space is a
                # real streamed D2H copy (no aliasing across memories)
                self._snapshot_fn = jax.jit(
                    lambda xs: xs, out_shardings=out_shardings)
            else:  # "hbm" — per-leaf device copy (the original scheme)
                self._snapshot_fn = jax.jit(
                    lambda xs: [x.copy() for x in xs])
        return self._snapshot_fn(arrays)

    def _snapshot(self, state: Any) -> Optional[Any]:
        """Donation-safe copy of `state`, or None if none could be taken
        (the caller then saves synchronously)."""
        leaves, treedef = jax.tree.flatten(state)
        arr_idx = [i for i, x in enumerate(leaves)
                   if isinstance(x, jax.Array)]
        arrays = [leaves[i] for i in arr_idx]
        probing = self._mode is None
        for mode in (("host", "hbm") if probing else (self._mode,)):
            try:
                copies = self._run_snapshot(mode, arrays)
                if probing:
                    # surface compile/placement/OOM failures while a
                    # fallback is still possible. Once the mode is
                    # established, skip the block: the copy executes
                    # serially with the step stream either way, but the
                    # host keeps dispatching (errors then surface at the
                    # writer's device_get -> wait()).
                    jax.block_until_ready(copies)
            except Exception:
                self._snapshot_fn = None
                if not probing:
                    return None  # established mode failed for this save
                continue
            self._mode = mode
            out = list(leaves)
            for i, c in zip(arr_idx, copies):
                out[i] = c
            return jax.tree.unflatten(treedef, out)
        return None

    def _sync_save(self, train_dir, state, step, max_to_keep, backend,
                   reason: str) -> None:
        if not self._warned_sync:
            self._warned_sync = True
            logging.warning("async checkpoint: saving synchronously (%s)",
                            reason)
        save_checkpoint(train_dir, state, step,
                        max_to_keep=max_to_keep, backend=backend)

    def _spawn(self, fn) -> None:
        def _run():
            try:
                fn()
            except BaseException as e:  # surfaced at the next wait()/save()
                self._exc = e

        self._thread = threading.Thread(
            target=_run, name="ckpt-writer", daemon=True
        )
        self._thread.start()

    def _join_quietly(self) -> Optional[BaseException]:
        """Join the in-flight writer WITHOUT raising; return its failure
        (if any) for the caller to surface at a safe point."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        exc, self._exc = self._exc, None
        return exc

    def save(self, train_dir: str, state: Any, step: int,
             max_to_keep: int = 1, backend: str = "msgpack") -> None:
        if jax.process_count() > 1 and self.enabled:
            # multi-host: the previous writer's failure must surface on
            # EVERY process at the same program point — a local raise at
            # wait() would leave the peers blocking in this save's first
            # collective (dir-prep barrier / snapshot allgather) until
            # the coordination timeout instead of failing cleanly
            self._save_multihost(train_dir, state, step, max_to_keep,
                                 backend)
            return
        self.wait()
        if not self.enabled:
            save_checkpoint(train_dir, state, step,
                            max_to_keep=max_to_keep, backend=backend)
            return
        snap = self._snapshot(state)
        if snap is None:
            self._sync_save(train_dir, state, step, max_to_keep, backend,
                            "no snapshot could be taken: neither the "
                            "pinned_host copy nor the in-device copy ran")
            return

        def _write():
            # fetch in the writer thread (GIL released during the
            # transfer) so both backends write plain host arrays
            save_checkpoint(train_dir, jax.device_get(snap), step,
                            max_to_keep=max_to_keep, backend=backend)

        self._spawn(_write)

    def _save_multihost(self, train_dir: str, state: Any, step: int,
                        max_to_keep: int, backend: str) -> None:
        """Async save from every process; see the class docstring for why
        each piece runs on the thread it does."""
        from jax.experimental import multihost_utils

        # join the previous writer quietly and agree on its outcome
        # BEFORE any of this save's collectives: if any process's writer
        # failed, every process raises HERE, together (the raise-together
        # contract the msgpack validation below also honors)
        exc = self._join_quietly()
        peers_ok = bool(np.min(multihost_utils.process_allgather(
            np.asarray(exc is None, np.int32))))
        if exc is not None:
            raise exc
        if not peers_ok:
            raise RuntimeError(
                "a peer process's checkpoint writer failed (its raise "
                "carries the underlying error)")

        if backend == "msgpack":
            # raise-together shardedness validation on the MAIN thread of
            # every process (save_checkpoint would do it, but only the
            # master's writer thread gets that far here)
            not_fetchable = [
                x for x in jax.tree.leaves(state)
                if isinstance(x, jax.Array)
                and not (x.is_fully_addressable or x.is_fully_replicated)
            ]
            if not_fetchable:
                raise ValueError(
                    "msgpack checkpoints need the full state on this "
                    f"host; {len(not_fetchable)} leaves are sharded "
                    "across hosts — use --checkpoint_format orbax for "
                    "multi-host sharded state"
                )
        elif backend == "orbax":
            if not _thread_safe_orbax_barriers():
                self._sync_save(
                    train_dir, state, step, max_to_keep, backend,
                    "orbax's coordination-service barrier is unavailable "
                    "(flag missing or jax.distributed uninitialized), so "
                    "its commit barrier would run device collectives off "
                    "the main thread")
                return
            # directory prep stays on the MAIN thread (same collective,
            # same program point on every process, as the sync path)
            path = os.path.abspath(
                os.path.join(train_dir, f"{_PREFIX}-{step}"))
            os.makedirs(train_dir, exist_ok=True)
            if jax.process_index() == 0 and os.path.exists(path):
                shutil.rmtree(path)
            multihost_utils.sync_global_devices(f"ckpt_dir_ready_{step}")
        else:
            raise ValueError(f"unknown checkpoint backend {backend!r}")

        # msgpack writes the replicated state from the MASTER only, so
        # non-masters skip the snapshot entirely (at flagship scale it
        # is a ~3.4GB device->host DMA whose result they would discard,
        # and a failure on a host that writes nothing must not drag the
        # cluster into the synchronous fallback)
        need_snapshot = backend != "msgpack" or jax.process_index() == 0
        snap = self._snapshot(state) if need_snapshot else None
        # every process must take the same sync-vs-async branch: a host
        # running the collective orbax save against hosts that went
        # async would deadlock — one main-thread all-gather settles it
        ok = bool(np.min(multihost_utils.process_allgather(np.asarray(
            snap is not None or not need_snapshot, np.int32))))
        if not ok:
            self._sync_save(train_dir, state, step, max_to_keep, backend,
                            "a process failed to snapshot")
            return

        if backend == "msgpack":
            if jax.process_index() != 0:
                return  # nothing to write on non-masters
            # device_get of fully-replicated/addressable leaves reads
            # only local shards — no collective on the writer thread
            self._spawn(lambda: save_checkpoint(
                train_dir, jax.device_get(snap), step,
                max_to_keep=max_to_keep, backend="msgpack"))
            return

        def _write_orbax():
            # per-process shard writes; commit barriers between the
            # writer threads ride the coordination service (the flag
            # _thread_safe_orbax_barriers just set)
            ckptr = _orbax_checkpointer()
            ckptr.save(path, snap)
            ckptr.wait_until_finished()
            if jax.process_index() == 0:
                _update_pointer(train_dir, path, max_to_keep)

        self._spawn(_write_orbax)

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._exc is not None:
            exc, self._exc = self._exc, None
            raise exc


def _list_checkpoints(train_dir: str) -> List[str]:
    if not os.path.isdir(train_dir):
        return []
    paths = []
    for name in os.listdir(train_dir):
        m = re.fullmatch(rf"{re.escape(_PREFIX)}-(\d+)(\.msgpack)?", name)
        if m:
            paths.append((int(m.group(1)), os.path.join(train_dir, name)))
    return [p for _, p in sorted(paths, reverse=True)]


def latest_checkpoint(train_dir: str) -> Optional[str]:
    """`tf.train.latest_checkpoint` equivalent: pointer file first, then
    a directory scan fallback. Reads BOTH this framework's pointer files
    and the reference's TF-format ones (`model_checkpoint_path: "..."`),
    so --train_dir can point straight at a reference train directory."""
    pointer = os.path.join(train_dir, _POINTER)
    if os.path.exists(pointer):
        with open(pointer) as f:
            for line in f:
                line = line.strip()
                if line.startswith(("model_checkpoint_path:",
                                    "all_model_checkpoint_paths:")):
                    line = line.split(":", 1)[1].strip().strip('"')
                    if not os.path.isabs(line):
                        line = os.path.join(train_dir, line)
                    if os.path.exists(line + ".index"):
                        return line
                    continue
                candidate = os.path.join(train_dir, line)
                if os.path.exists(candidate):
                    return candidate
    existing = _list_checkpoints(train_dir)
    if existing:
        return existing[0]
    from efficientvideoclassification_youtube8m_tpu.data.tf_checkpoint import (
        latest_tf_checkpoint,
    )

    return latest_tf_checkpoint(train_dir)


def checkpoint_step(path: str) -> int:
    m = re.search(rf"{re.escape(_PREFIX)}-(\d+)(\.msgpack)?$", path)
    return int(m.group(1)) if m else 0


def restore_checkpoint(path: str, target: Any) -> Any:
    """Restore into a template pytree (shapes/dtypes from `target`).
    Backend auto-detected: orbax checkpoints are directories; reference
    TF-V2 bundles (`<path>.index` exists) route through the importer, so
    models trained with the reference code load transparently."""
    from efficientvideoclassification_youtube8m_tpu.data.tf_checkpoint import (
        is_tf_checkpoint,
    )

    if is_tf_checkpoint(path):
        from efficientvideoclassification_youtube8m_tpu.train.tf_import import (
            import_tf_checkpoint,
        )

        if path.endswith(".index"):
            path = path[: -len(".index")]
        return import_tf_checkpoint(path, target)
    if os.path.isdir(path):
        # Restore straight onto the target's shardings: each leaf becomes
        # a ShapeDtypeStruct carrying its sharding, so orbax reads every
        # shard onto its own device (each host its own shards under
        # multi-host) — no host round-trip of the full state.
        def abstract(x):
            if isinstance(x, jax.Array):
                return jax.ShapeDtypeStruct(x.shape, x.dtype,
                                            sharding=x.sharding)
            return x

        return _orbax_checkpointer().restore(
            os.path.abspath(path), jax.tree.map(abstract, target)
        )
    with open(path, "rb") as f:
        return serialization.from_bytes(target, f.read())


def restore_subtree(path: str, target: Any, keys: List[str]) -> Any:
    """Partial restore by top-level field names — the explicit
    name->variable maps of validate.py:350-381 become field selection."""
    with open(path, "rb") as f:
        raw = serialization.msgpack_restore(f.read())
    state_dict = serialization.to_state_dict(target)
    for k in keys:
        if k not in raw:
            raise KeyError(f"checkpoint {path} has no field {k!r}")
        state_dict[k] = raw[k]
    return serialization.from_state_dict(target, state_dict)
