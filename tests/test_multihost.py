"""Multi-host execution.

Two layers:

  * in-process unit tests over the host-context math, per-host loader
    shard coverage, and the single-process passthroughs of the
    multi-host helpers;
  * a REAL 2-process distributed run on CPU (subprocess workers, each
    with 2 virtual devices) driving the same code paths the CLIs use —
    TF_CONFIG bring-up, `make_array_from_process_local_data` batch
    assembly, SPMD step, per-host row extraction, eval-row gathering,
    and host-stream synchronization.

Reference counterpart: the TF_CONFIG ps/worker dispatch at
`/root/reference/code_student_uniform/train.py:704-733`.
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest

import jax
from jax.sharding import NamedSharding, PartitionSpec as P

from efficientvideoclassification_youtube8m_tpu.data import FrameDataLoader
from efficientvideoclassification_youtube8m_tpu.data.yt8m import (
    write_synthetic_frame_shard,
)
from efficientvideoclassification_youtube8m_tpu.parallel import (
    create_mesh,
    distributed,
    shard_batch,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_host_context_math(monkeypatch):
    monkeypatch.setattr(distributed, "host_shard", lambda: (1, 4))
    hc = distributed.host_context(256)
    assert hc.local_batch_size == 64
    assert hc.process_index == 1 and hc.process_count == 4
    assert hc.multi_host and not hc.is_master

    with pytest.raises(ValueError):
        distributed.host_context(255)  # not divisible by 4


def test_host_context_single_process():
    hc = distributed.host_context(32)
    assert hc.local_batch_size == 32
    assert hc.is_master and not hc.multi_host


def test_per_host_loaders_cover_disjoint_shards(tmp_path):
    files = []
    for s in range(4):
        p = str(tmp_path / f"train-{s:04d}.tfrecord")
        write_synthetic_frame_shard(p, num_videos=3, seed=s, max_frames=6,
                                    min_frames=2, vocab_size=11,
                                    feature_sizes=(4, 2))
        files.append(p)
    pattern = str(tmp_path / "train-*.tfrecord")

    def ids(shard_index, num_shards):
        loader = FrameDataLoader(
            pattern, batch_size=2, feature_sizes=(4, 2), max_frames=6,
            vocab_size=11, num_epochs=1, shuffle=False, use_native=False,
            shard_index=shard_index, num_shards=num_shards,
        )
        out = []
        for b in loader:
            out.extend(v for v in b.video_ids if v)
        return set(out)

    host0, host1 = ids(0, 2), ids(1, 2)
    assert host0 and host1
    assert host0.isdisjoint(host1)
    assert host0 | host1 == ids(0, 1)  # union covers the full dataset


def test_make_array_assembly_matches_device_put():
    """Single-process: the global array `make_array_from_process_local_data`
    builds for our batch shardings equals the device_put one."""
    mesh = create_mesh()
    features = np.arange(8 * 3 * 5, dtype=np.uint8).reshape(8, 3, 5)
    labels = np.zeros((8, 7), bool)
    labels[::2, 1] = True
    num_frames = np.arange(8, dtype=np.int32)

    via_put = shard_batch(mesh, features, labels, num_frames)
    shardings = (
        NamedSharding(mesh, P("data", None, None)),
        NamedSharding(mesh, P("data", None)),
        NamedSharding(mesh, P("data")),
    )
    via_assembly = tuple(
        jax.make_array_from_process_local_data(s, x)
        for s, x in zip(shardings, (features, labels, num_frames))
    )
    for a, b in zip(via_put, via_assembly):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        assert a.sharding.is_equivalent_to(b.sharding, a.ndim)


def test_local_rows_single_process():
    mesh = create_mesh()
    x = np.arange(16, dtype=np.float32).reshape(8, 2)
    arr = jax.device_put(x, NamedSharding(mesh, P("data", None)))
    np.testing.assert_array_equal(distributed.local_rows(arr), x)


def test_gather_eval_rows_passthrough_strips_pad():
    rows, pad = distributed.gather_eval_rows(
        {"a": np.arange(6), "b": np.arange(12).reshape(6, 2)}, 2
    )
    np.testing.assert_array_equal(rows["a"], np.arange(4))
    assert rows["b"].shape == (4, 2)
    assert pad == 2


def test_sync_host_streams_passthrough():
    assert list(distributed.sync_host_streams(iter([1, 2, 3]), "train")) == [1, 2, 3]
    assert list(distributed.sync_host_streams(iter([4]), "eval")) == [4]


def test_two_process_distributed_run(tmp_path):
    """Launch 2 real JAX processes (2 virtual CPU devices each) and run
    the full multi-host path end-to-end. See tests/_multihost_worker.py."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]

    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env["MULTIHOST_CKPT_DIR"] = str(tmp_path / "ckpt")

    worker = os.path.join(REPO, "tests", "_multihost_worker.py")
    procs = [
        subprocess.Popen(
            [sys.executable, worker, str(port), str(pid)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True, env=env, cwd=REPO,
        )
        for pid in (0, 1)
    ]
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=540)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            pytest.fail("multi-host worker timed out (possible deadlock)")
        outs.append(out)
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"worker {pid} failed:\n{out}"
        assert "MULTIHOST_OK" in out, f"worker {pid} output:\n{out}"
