"""Worker for the REAL 2-process multi-host test (tests/test_multihost.py).

Each of the two processes owns 2 virtual CPU devices (4 global). It
exercises the full multi-host path the CLIs use: TF_CONFIG-driven
`distributed.initialize()`, `host_context`, global-batch assembly via
`shard_batch` / `jax.make_array_from_process_local_data`, a jitted SPMD
step over the global mesh, `local_rows`, `gather_eval_rows`, and
`sync_host_streams` on uneven per-host streams.

Usage: python tests/_multihost_worker.py <coordinator_port> <process_id>
"""

import json
import os
import sys

PORT = sys.argv[1]
PID = int(sys.argv[2])

# The reference's cluster-spec shape (train.py:710-718): one master, one
# worker; the master's address doubles as the JAX coordinator.
os.environ["TF_CONFIG"] = json.dumps(
    {
        "cluster": {
            "master": [f"127.0.0.1:{PORT}"],
            "worker": [f"127.0.0.1:{int(PORT) + 1}"],
        },
        "task": {"type": "master" if PID == 0 else "worker", "index": 0},
    }
)

import jax  # noqa: E402

from efficientvideoclassification_youtube8m_tpu.utils.compile_cache import (  # noqa: E402
    enable_compilation_cache,
)

enable_compilation_cache()

import numpy as np  # noqa: E402

from efficientvideoclassification_youtube8m_tpu.data.loader import (  # noqa: E402
    FrameBatch,
)
from efficientvideoclassification_youtube8m_tpu.parallel import (  # noqa: E402
    create_mesh,
    distributed,
    shard_batch,
)

distributed.initialize()
assert jax.process_count() == 2, jax.process_count()
assert jax.process_index() == PID, (jax.process_index(), PID)

host = distributed.host_context(8)
assert host.local_batch_size == 4
assert host.multi_host
assert host.is_master == (PID == 0)
assert distributed.is_master() == (PID == 0)

# --- global batch assembly + SPMD step + local_rows -------------------
mesh = create_mesh()  # 4 global devices on the data axis
assert mesh.devices.size == 4

base = (PID + 1) * 10
features = np.full((4, 3, 5), base, np.uint8)
features += np.arange(4, dtype=np.uint8)[:, None, None]  # distinct rows
labels = np.zeros((4, 7), bool)
num_frames = np.full((4,), 3, np.int32)
f, l, n = shard_batch(mesh, features, labels, num_frames)
assert f.shape == (8, 3, 5), f.shape  # global batch

from jax.sharding import NamedSharding, PartitionSpec as P  # noqa: E402


@jax.jit
def step(x):
    total = x.astype("float32").sum()  # psum over the data axis
    rows = x.astype("float32").sum(axis=(1, 2))
    return total, rows


total, rows = step(f)
# both hosts' blocks contribute: sum over rows 10..13 and 20..23, x15
expected_total = sum((10 + i) * 15 for i in range(4)) + sum(
    (20 + i) * 15 for i in range(4)
)
assert float(total) == expected_total, (float(total), expected_total)

# this host's rows of the batch-sharded output == the rows it fed in
mine = distributed.local_rows(rows)
np.testing.assert_allclose(mine, [(base + i) * 15.0 for i in range(4)])

# --- gather_eval_rows: per-host pads stripped, global order ------------
local_vals = np.asarray([PID * 100 + i for i in range(4)], np.float32)
pad = 1 if PID == 0 else 2
gathered, total_pad = distributed.gather_eval_rows({"x": local_vals}, pad)
np.testing.assert_array_equal(
    gathered["x"], np.asarray([0, 1, 2, 100, 101], np.float32)
)
assert total_pad == 3

# --- sync_host_streams on uneven streams --------------------------------


class FakeLoader:
    batch_size, max_frames, total_size, vocab_size = 4, 3, 5, 7

    def __init__(self, k):
        self.k = k

    def __iter__(self):
        for i in range(self.k):
            yield FrameBatch(
                video_ids=[f"v{i}"] * 4,
                features=np.zeros((4, 3, 5), np.uint8),
                labels=np.zeros((4, 7), bool),
                num_frames=np.ones((4,), np.int32),
                pad=0,
            )


k = 3 if PID == 0 else 2
train_batches = list(distributed.sync_host_streams(FakeLoader(k), "train"))
assert len(train_batches) == 2, len(train_batches)  # cross-host drop tail

eval_batches = list(distributed.sync_host_streams(FakeLoader(k), "eval"))
assert len(eval_batches) == 3, len(eval_batches)  # dry host pads
pads = [b.pad for b in eval_batches]
assert pads == ([0, 0, 0] if PID == 0 else [0, 0, 4]), pads

# --- REAL distillation train step over the 2-host mesh ------------------
from efficientvideoclassification_youtube8m_tpu.parallel import (  # noqa: E402
    build_sharded_distill_step,
    place_state,
)
from efficientvideoclassification_youtube8m_tpu.train import (  # noqa: E402
    init_distill_state,
    make_optimizer,
    restore_checkpoint,
    save_checkpoint,
)
from efficientvideoclassification_youtube8m_tpu.utils.config import (  # noqa: E402
    TrainConfig,
)

cfg = TrainConfig(
    num_classes=12, batch_size=8, lstm_cells=4, lstm_layers=2,
    max_num_frames=12, num_inputs_to_lstm=3, num_inputs_L1=3, every_n=2,
    feature_names="rgb, audio", feature_sizes="4, 2", scan_unroll=1,
    compute_dtype="float32",
)
opt = make_optimizer(cfg.optimizer, cfg.clip_gradient_norm)
state_host = init_distill_state(cfg, opt)  # same seed -> same init everywhere
state = place_state(state_host, mesh)
step = build_sharded_distill_step(cfg, opt, mesh, state_host, top_k=3)

hc = distributed.host_context(cfg.batch_size)
rng = np.random.default_rng(3)
all_feats = rng.integers(
    0, 256, size=(8, cfg.max_num_frames, cfg.total_feature_size),
    dtype=np.uint8,
)
all_labels = np.zeros((8, cfg.num_classes), bool)
all_labels[:, :2] = True
all_nf = rng.integers(3, cfg.max_num_frames + 1, size=8).astype(np.int32)
lo = PID * hc.local_batch_size
hi = lo + hc.local_batch_size
tf_, tl, tn = shard_batch(
    mesh, all_feats[lo:hi], all_labels[lo:hi], all_nf[lo:hi]
)
state, metrics = step(state, tf_, tl, tn)
assert int(metrics["global_step"]) == 2
loss = float(metrics["teacher_label_loss"])
assert np.isfinite(loss)
# the replicated loss is identical on both hosts
from jax.experimental import multihost_utils  # noqa: E402

losses = np.asarray(
    multihost_utils.process_allgather(np.asarray([loss], np.float32))
).reshape(-1)
assert losses.shape[0] == 2 and abs(losses[0] - losses[1]) == 0.0, losses

# per-host train-log rows come back through local_rows
topk_mine = distributed.local_rows(metrics["topk_val"])
assert topk_mine.shape == (hc.local_batch_size, 3)

# --- stacked steps-per-dispatch eval under REAL multi-host ---------------
# K batches per launch (cli.eval --steps_per_dispatch): the [K, B, ...]
# global assembly (shard_stacked_batch), the axis-1 addressable-shard
# fetch (_local_rows_axis1), and gather_stacked_outputs' per-batch
# streams must reproduce the per-batch program's gathered rows exactly.
from efficientvideoclassification_youtube8m_tpu.parallel import (  # noqa: E402
    build_sharded_eval_step,
    build_sharded_eval_step_stacked,
    shard_stacked_batch,
)
from jax.sharding import NamedSharding  # noqa: E402

ps_host = jax.tree.map(
    np.asarray, init_distill_state(cfg, opt).params_student
)
ev = build_sharded_eval_step(cfg, mesh, ps_host, top_k=3)
ev_stacked = build_sharded_eval_step_stacked(cfg, mesh, ps_host, top_k=3)
params_student = jax.device_put(ps_host, NamedSharding(mesh, P()))
kf = np.stack([all_feats[lo:hi], all_feats[lo:hi][::-1]])
kl = np.stack([all_labels[lo:hi]] * 2)
kn = np.stack([all_nf[lo:hi]] * 2)
sf, sl, sn = shard_stacked_batch(mesh, kf, kl, kn)
assert sf.shape == (2, 8, cfg.max_num_frames, cfg.total_feature_size), sf.shape
out_stacked = ev_stacked(params_student, sf, sl, sn)
metas = [(all_labels[lo:hi], 1), (all_labels[lo:hi], 0)]  # batch 0: 1 pad row
rows_list = list(distributed.gather_stacked_outputs(out_stacked, metas))
assert len(rows_list) == 2
for j, rows in enumerate(rows_list):
    bf, bl_, bn = shard_batch(mesh, kf[j], kl[j], kn[j])
    ref = distributed.gather_step_outputs(
        ev(params_student, bf, bl_, bn), all_labels[lo:hi], metas[j][1]
    )
    for key in ("topk_val", "topk_idx", "per_example_loss",
                "perr_precision", "labels"):
        np.testing.assert_array_equal(rows[key], ref[key], err_msg=key)

# --- master-decision broadcasts (cadence flags, checkpoint election) -----
assert distributed.broadcast_flag(PID == 0) is True  # master said True
assert distributed.broadcast_flag(False if PID == 0 else True) is False
got = distributed.broadcast_str("model.ckpt-42" if PID == 0 else None)
assert got == "model.ckpt-42", got
assert distributed.broadcast_str(None) is None

# --- multi-host orbax checkpoint: every process writes its shards -------
ckpt_dir = os.environ["MULTIHOST_CKPT_DIR"]
path = save_checkpoint(ckpt_dir, state, 2, backend="orbax")
multihost_utils.sync_global_devices("ckpt_written")
restored = restore_checkpoint(path, state)
np.testing.assert_array_equal(
    np.asarray(distributed.local_rows(
        restored.params_teacher["classifier"]["experts"]["b"])),
    np.asarray(distributed.local_rows(
        state.params_teacher["classifier"]["experts"]["b"])),
)
assert int(np.asarray(restored.global_step)) == 2

# --- multi-host msgpack save: replicated DP state, master-only write ----
# Regression for the r2 advisor finding: `is_fully_addressable` is False
# for EVERY jax.Array on a multi-process mesh, so the old gate rejected
# fully-REPLICATED DP state (the documented msgpack contract) and only
# the master raised — cluster deadlock. Fully-replicated leaves must
# save fine from every process.
mpath = save_checkpoint(ckpt_dir, restored, 3, backend="msgpack")
multihost_utils.sync_global_devices("msgpack_written")
assert os.path.exists(mpath), mpath
r2 = restore_checkpoint(mpath, jax.device_get(init_distill_state(cfg, opt)))
assert int(np.asarray(r2.global_step)) == 2

# ...and a CROSS-HOST-sharded state raises on BOTH processes (not just
# the master) so the failure is a clean crash, not a hang.
from jax.sharding import NamedSharding, PartitionSpec  # noqa: E402

sharded_leaf = jax.device_put(
    np.arange(jax.device_count() * 4, dtype=np.float32),
    NamedSharding(mesh, PartitionSpec("data")),
)
if not sharded_leaf.is_fully_addressable:
    try:
        save_checkpoint(ckpt_dir, {"x": sharded_leaf}, 4, backend="msgpack")
    except ValueError as e:
        assert "orbax" in str(e)
    else:
        raise AssertionError(
            "sharded msgpack save should raise on every process")
multihost_utils.sync_global_devices("msgpack_sharded_checked")

# --- ASYNC multi-host checkpointing: saves overlap stepping -------------
# orbax: every process's WRITER THREAD writes its own shards (commit
# barriers on the coordination service); msgpack: the master's thread
# writes the replicated state. The main threads keep running device
# collectives (train steps) while both drain — the interleaving that
# the r4 sync fallback existed to avoid.
from efficientvideoclassification_youtube8m_tpu.train import (  # noqa: E402
    AsyncCheckpointSaver,
)

async_dir = os.path.join(os.environ["MULTIHOST_CKPT_DIR"], "async")
saver = AsyncCheckpointSaver()
want = jax.device_get(state)  # replicated DP state: full copy per host
step_a = int(np.asarray(state.global_step))

saver.save(async_dir, state, step_a, backend="orbax")
assert saver._thread is not None, "orbax multi-host save must go async"
# train steps (device collectives) while the writer threads drain;
# the donated state buffers are protected by the snapshot
state, _ = step(state, tf_, tl, tn)
state, _ = step(state, tf_, tl, tn)
saver.wait()
apath = os.path.join(async_dir, f"model.ckpt-{step_a}")
assert os.path.isdir(apath), apath
restored_a = restore_checkpoint(apath, place_state(
    init_distill_state(cfg, opt), mesh))
jax.tree.map(
    lambda a, b: np.testing.assert_array_equal(np.asarray(a),
                                               np.asarray(b)),
    jax.device_get(restored_a), want,
)
if PID == 0:  # master wrote the pointer from its writer thread
    with open(os.path.join(async_dir, "checkpoint")) as fh:
        assert fh.readline().strip() == f"model.ckpt-{step_a}"
multihost_utils.sync_global_devices("async_orbax_checked")

want_m = jax.device_get(state)
step_m = int(np.asarray(state.global_step))
saver_m = AsyncCheckpointSaver()  # fresh: pins the non-master skip below
saver_m.save(async_dir, state, step_m, backend="msgpack")
assert (saver_m._thread is not None) == (PID == 0), \
    "msgpack multi-host: only the master has anything to write"
# non-masters write nothing, so they must not pay the snapshot either
assert (saver_m._mode is not None) == (PID == 0), saver_m._mode
state, _ = step(state, tf_, tl, tn)
saver_m.wait()
multihost_utils.sync_global_devices("async_msgpack_written")
mpath_a = os.path.join(async_dir, f"model.ckpt-{step_m}.msgpack")
restored_m = restore_checkpoint(
    mpath_a, jax.device_get(init_distill_state(cfg, opt)))
jax.tree.map(
    lambda a, b: np.testing.assert_array_equal(np.asarray(a),
                                               np.asarray(b)),
    restored_m, want_m,
)
# ...and a CROSS-HOST-sharded async msgpack save raises on EVERY process
if not sharded_leaf.is_fully_addressable:
    try:
        saver.save(async_dir, {"x": sharded_leaf}, 99, backend="msgpack")
    except ValueError as e:
        assert "orbax" in str(e)
    else:
        raise AssertionError(
            "sharded async msgpack save should raise on every process")

# writer-thread failure surfaces on EVERY process at the next save's
# entry (raise-together): a local-only raise would leave the peers
# blocking in the save's first collective until the coordination
# timeout. Poison one process's deferred-exception slot and save.
saver_f = AsyncCheckpointSaver()
if PID == 1:
    saver_f._exc = RuntimeError("injected writer failure")
try:
    saver_f.save(async_dir, state, 98, backend="orbax")
except RuntimeError as e:
    msg = str(e)
else:
    raise AssertionError("poisoned save must raise on every process")
assert ("injected" in msg) == (PID == 1), msg
assert ("peer" in msg) == (PID == 0), msg
multihost_utils.sync_global_devices("async_checked")

# --- the FULL cli.validate binary, 2 processes end-to-end ---------------
# (loader sharding, host-stream sync, gather_step_outputs, master-only
# summaries, broadcast-elected checkpoint — the whole multi-host eval
# path through the real entry point)
from efficientvideoclassification_youtube8m_tpu.data.yt8m import (  # noqa: E402
    write_synthetic_frame_shard,
)
from efficientvideoclassification_youtube8m_tpu.cli import (  # noqa: E402
    validate as validate_cli,
)

data_dir = os.path.join(os.environ["MULTIHOST_CKPT_DIR"], "data")
train_dir = os.path.join(os.environ["MULTIHOST_CKPT_DIR"], "train")
if PID == 0:
    os.makedirs(data_dir, exist_ok=True)
    for shard in range(2):
        write_synthetic_frame_shard(
            os.path.join(data_dir, f"validate-{shard:04d}.tfrecord"),
            num_videos=5 + shard, seed=shard, max_frames=cfg.max_num_frames,
            min_frames=3, vocab_size=cfg.num_classes,
            feature_sizes=(4, 2),
        )
    # a restorable msgpack checkpoint (master-only write inside).
    # NOTE: state_host's buffers may be aliased by place_state and were
    # donated to the train step above — save a freshly-initialized state.
    save_checkpoint(train_dir, jax.device_get(init_distill_state(cfg, opt)),
                    2, backend="msgpack")
multihost_utils.sync_global_devices("validate_fixture_ready")

validate_cli.main([
    "--train_dir", train_dir,
    "--eval_data_pattern", os.path.join(data_dir, "validate-*.tfrecord"),
    "--num_classes", str(cfg.num_classes),
    "--feature_sizes", "4, 2",
    "--max_num_frames", str(cfg.max_num_frames),
    "--lstm_cells", str(cfg.lstm_cells),
    "--num_inputs_to_lstm", str(cfg.num_inputs_to_lstm),
    "--num_inputs_L1", str(cfg.num_inputs_L1),
    "--every_n", str(cfg.every_n),
    "--batch_size", "4",
    "--top_k", "5",
    "--compute_dtype", "float32",
    "--scan_unroll", "1",
    "--num_readers", "1",
    "--run_once", "true",
])

# --- the FULL cli.train binary, 2 processes end-to-end + resume ---------
# (per-host loader shards, host-stream sync, broadcast cadences,
# collective orbax save, restore-from-latest on relaunch)
from efficientvideoclassification_youtube8m_tpu.cli import (  # noqa: E402
    train as train_cli,
)
from efficientvideoclassification_youtube8m_tpu.train import (  # noqa: E402
    latest_checkpoint,
)

cli_train_dir = os.path.join(os.environ["MULTIHOST_CKPT_DIR"], "train_cli")
if PID == 0:
    for shard in range(2):
        write_synthetic_frame_shard(
            os.path.join(data_dir, f"train-{shard:04d}.tfrecord"),
            num_videos=5 + shard, seed=10 + shard,
            max_frames=cfg.max_num_frames, min_frames=3,
            vocab_size=cfg.num_classes, feature_sizes=(4, 2),
        )
multihost_utils.sync_global_devices("train_fixture_ready")

train_flags = [
    "--train_dir", cli_train_dir,
    "--train_data_pattern", os.path.join(data_dir, "train-*.tfrecord"),
    "--num_classes", str(cfg.num_classes),
    "--feature_sizes", "4, 2",
    "--max_num_frames", str(cfg.max_num_frames),
    "--lstm_cells", str(cfg.lstm_cells),
    "--num_inputs_to_lstm", str(cfg.num_inputs_to_lstm),
    "--num_inputs_L1", str(cfg.num_inputs_L1),
    "--every_n", str(cfg.every_n),
    "--batch_size", "4",
    "--top_k", "5",
    "--num_epochs", "1",
    "--compute_dtype", "float32",
    "--scan_unroll", "1",
    "--num_readers", "1",
    "--checkpoint_format", "orbax",
]
train_cli.main(train_flags + ["--start_new_model", "true"])
ckpt1 = latest_checkpoint(cli_train_dir)
assert ckpt1 is not None and os.path.isdir(ckpt1), ckpt1
# 2 files -> host shards of 5/6 videos -> 2 synced steps, +2/step
assert ckpt1.endswith("model.ckpt-4"), ckpt1

# relaunch WITHOUT --start_new_model: resumes from the orbax checkpoint
train_cli.main(train_flags)
ckpt2 = latest_checkpoint(cli_train_dir)
assert ckpt2.endswith("model.ckpt-8"), ckpt2

print("MULTIHOST_OK")
