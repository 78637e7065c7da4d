"""TensorBoard-compatible scalar summary writer — no TensorFlow.

The reference emits hand-built `tf.Summary` protos via
`MakeSummary`/`AddGlobalStepSummary`/`AddEpochSummary`
(`/root/reference/code_student_uniform/utils.py:28-125`) into Supervisor
event files. This writes the same wire format directly: an events file is
a TFRecord stream of Event protos

    Event { double wall_time = 1; int64 step = 2;
            oneof { string file_version = 3; Summary summary = 5; } }
    Summary { repeated Value value = 1 { string tag = 1;
                                         float simple_value = 2; } }

readable by TensorBoard, with the reference's exact tag names.
"""

from __future__ import annotations

import os
import socket
import struct
import time
from typing import Dict, Optional

import numpy as np

from efficientvideoclassification_youtube8m_tpu.data.proto import (
    _len_field,
    _tag,
    write_varint,
)
from efficientvideoclassification_youtube8m_tpu.data.tfrecord import TFRecordWriter


def _double_field(field_num: int, value: float) -> bytes:
    return _tag(field_num, 1) + struct.pack("<d", value)


def _float_field(field_num: int, value: float) -> bytes:
    return _tag(field_num, 5) + struct.pack("<f", value)


def _varint_field(field_num: int, value: int) -> bytes:
    return _tag(field_num, 0) + write_varint(value & ((1 << 64) - 1))


def make_summary(name: str, value: float) -> bytes:
    """Serialized Summary proto with one simple_value (utils.py:28-34)."""
    val = _len_field(1, str(name).encode()) + _float_field(2, float(value))
    return _len_field(1, val)


def _default_bucket_limits() -> "np.ndarray":
    """TF's default exponential histogram buckets (histogram.cc
    InitDefaultBucketsInner): positives 1e-12 * 1.1^k, mirrored negatives,
    closed with DBL_MAX on both ends."""
    pos = []
    v = 1e-12
    while v < 1.7976931348623157e308:
        pos.append(v)
        v *= 1.1
    pos.append(1.7976931348623157e308)
    return np.asarray([-x for x in reversed(pos)] + pos)


_BUCKET_LIMITS = _default_bucket_limits()


def make_histogram_from_stats(
    tag: str,
    num: float,
    vmin: float,
    vmax: float,
    vsum: float,
    sum_squares: float,
    counts: "np.ndarray",
) -> bytes:
    """Serialized Summary proto with one HistogramProto value from
    precomputed statistics (`counts` aligned with _BUCKET_LIMITS).

    HistogramProto: min=1 max=2 num=3 sum=4 sum_squares=5 (doubles),
    bucket_limit=6 bucket=7 (packed doubles); Summary.Value carries it in
    field 5 (`histo`). Zero-count bucket runs are collapsed to their last
    limit, matching TF's EncodeToProto(preserve_zero_buckets=false).
    """
    histo = b""
    if num > 0:
        histo += _double_field(1, float(vmin))
        histo += _double_field(2, float(vmax))
    else:
        # empty histogram: TF's initial min/max sentinels
        histo += _double_field(1, _BUCKET_LIMITS[-1])
        histo += _double_field(2, _BUCKET_LIMITS[0])
    histo += _double_field(3, float(num))
    histo += _double_field(4, float(vsum))
    histo += _double_field(5, float(sum_squares))
    counts = np.asarray(counts, np.float64)
    limits_out, counts_out = [], []
    i = 0
    n = len(_BUCKET_LIMITS)
    while i < n:
        end = _BUCKET_LIMITS[i]
        count = counts[i]
        i += 1
        if count <= 0.0:
            while i < n and counts[i] <= 0.0:
                end = _BUCKET_LIMITS[i]
                i += 1
        limits_out.append(end)
        counts_out.append(count)
    histo += _tag(6, 2) + write_varint(8 * len(limits_out)) + struct.pack(
        f"<{len(limits_out)}d", *limits_out
    )
    histo += _tag(7, 2) + write_varint(8 * len(counts_out)) + struct.pack(
        f"<{len(counts_out)}d", *counts_out
    )
    val = _len_field(1, str(tag).encode()) + _len_field(5, histo)
    return _len_field(1, val)


def make_histogram(tag: str, values) -> bytes:
    """make_histogram_from_stats over host values. Non-finite entries are
    dropped everywhere (num/min/max/sum AND buckets) so the proto stays
    internally consistent even for diverging runs."""
    x = np.asarray(values, dtype=np.float64).ravel()
    x = x[np.isfinite(x)]
    # bucket i spans (limit[i-1], limit[i]]; searchsorted with side="left"
    # maps v to the first limit >= v
    counts = np.bincount(
        np.searchsorted(_BUCKET_LIMITS, x, side="left"),
        minlength=len(_BUCKET_LIMITS),
    ).astype(np.float64)
    return make_histogram_from_stats(
        tag,
        num=float(x.size),
        vmin=float(x.min()) if x.size else 0.0,
        vmax=float(x.max()) if x.size else 0.0,
        vsum=float(x.sum()),
        sum_squares=float(np.square(x).sum()),
        counts=counts,
    )


def histogram_stats_on_device(leaf):
    """Per-variable histogram statistics computed ON DEVICE: one jitted
    reduction per parameter returns (num, min, max, sum, sum_squares,
    bucket_counts) — a few KB over the host link instead of the full
    parameter value (the naive device_get of both towers is hundreds of
    MB per summary tick). Non-finite values are dropped, matching
    make_histogram."""
    import jax
    import jax.numpy as jnp

    global _DEVICE_HISTO_FN
    if _DEVICE_HISTO_FN is None:
        # f32 limits: every limit beyond f32 range collapses to +/-inf,
        # which only affects values > 3.4e38 — unrepresentable in the f32
        # parameters this consumes (errstate: the overflow in this cast
        # is exactly the collapse we want, not a bug to warn about)
        with np.errstate(over="ignore"):
            limits = jnp.asarray(_BUCKET_LIMITS.astype(np.float32))

        def stats(x):
            x = x.ravel().astype(jnp.float32)
            finite = jnp.isfinite(x)
            xf = jnp.where(finite, x, 0.0)
            num = jnp.sum(finite)
            vmin = jnp.min(jnp.where(finite, x, jnp.inf))
            vmax = jnp.max(jnp.where(finite, x, -jnp.inf))
            idx = jnp.clip(
                jnp.searchsorted(limits, x, side="left"), 0, limits.shape[0] - 1
            )
            # int32 counts: an f32 accumulator silently saturates at
            # 2^24 per bucket (16777216.0 + 1.0 == 16777216.0), which a
            # >16.7M-element near-constant leaf can reach
            counts = jnp.zeros((limits.shape[0],), jnp.int32).at[idx].add(
                finite.astype(jnp.int32)
            )
            return (num, vmin, vmax, jnp.sum(xf), jnp.sum(xf * xf), counts)

        _DEVICE_HISTO_FN = jax.jit(stats)
    return _DEVICE_HISTO_FN(leaf)


_DEVICE_HISTO_FN = None


def make_event(
    summary: Optional[bytes] = None,
    step: int = 0,
    wall_time: Optional[float] = None,
    file_version: Optional[str] = None,
) -> bytes:
    out = _double_field(1, time.time() if wall_time is None else wall_time)
    if step:
        out += _varint_field(2, step)
    if file_version is not None:
        out += _len_field(3, file_version.encode())
    if summary is not None:
        out += _len_field(5, summary)
    return out


class SummaryWriter:
    """Append-only events-file writer (one scalar or many per step)."""

    def __init__(self, logdir: str):
        os.makedirs(logdir, exist_ok=True)
        fname = f"events.out.tfevents.{int(time.time())}.{socket.gethostname()}"
        self._writer = TFRecordWriter(os.path.join(logdir, fname))
        self._writer.write(make_event(file_version="brain.Event:2"))

    def add_summary(self, summary: bytes, global_step: int = 0):
        self._writer.write(make_event(summary=summary, step=global_step))

    def scalar(self, tag: str, value: float, global_step: int = 0):
        self.add_summary(make_summary(tag, value), global_step)

    def histogram(self, tag: str, values, global_step: int = 0):
        self.add_summary(make_histogram(tag, values), global_step)

    def flush(self):
        self._writer.flush()

    def close(self):
        self._writer.close()


class NullSummaryWriter(SummaryWriter):
    """Drop-everything writer for non-master processes.

    Multi-host runs elect one summary/checkpoint owner (the reference's
    is_chief, train.py:444); the other hosts keep the identical control
    flow but write nothing.
    """

    def __init__(self, logdir: str = ""):
        pass

    def add_summary(self, summary: bytes, global_step: int = 0):
        pass

    def flush(self):
        pass

    def close(self):
        pass


def for_master(logdir: str, is_master: bool = True) -> SummaryWriter:
    """SummaryWriter on the master process, NullSummaryWriter elsewhere."""
    return SummaryWriter(logdir) if is_master else NullSummaryWriter()


def write_variable_histograms(
    writer: SummaryWriter, params, prefix: str, global_step: int
) -> None:
    """One histogram per model variable, tag = variable path — the
    rebuild of `tf.summary.histogram(variable.op.name, variable)` over
    `slim.get_model_variables()` (train.py:426-427), emitted by the
    train loops at the save_summaries_secs cadence.

    Device arrays are reduced ON DEVICE (histogram_stats_on_device) so a
    summary tick moves a few KB per variable instead of the variables
    themselves; numpy inputs take the host path."""
    import jax

    flat = jax.tree_util.tree_flatten_with_path(params)[0]
    named = []
    for path, leaf in flat:
        name = prefix + "/" + "/".join(
            str(getattr(k, "key", getattr(k, "idx", k))) for k in path
        )
        named.append((name, leaf))
    # dispatch every leaf's on-device reduction FIRST, then fetch them
    # in ONE device_get: a per-leaf blocking fetch costs one full
    # dispatch round trip per variable
    pending = [
        (name, histogram_stats_on_device(leaf))
        for name, leaf in named if isinstance(leaf, jax.Array)
    ]
    fetched = dict(zip((n for n, _ in pending),
                       jax.device_get([s for _, s in pending])))
    for name, leaf in named:
        if name in fetched:
            num, vmin, vmax, vsum, sumsq, counts = fetched[name]
            writer.add_summary(
                make_histogram_from_stats(
                    name, float(num),
                    float(vmin) if num else 0.0,
                    float(vmax) if num else 0.0,
                    float(vsum), float(sumsq), np.asarray(counts),
                ),
                global_step,
            )
        else:
            writer.histogram(name, np.asarray(leaf), global_step)


def add_global_step_summary(
    summary_writer: Optional[SummaryWriter],
    global_step_val: int,
    global_step_info_dict: Dict[str, float],
    summary_scope: str = "Eval",
) -> str:
    """Per-batch scalars + the reference's log line (utils.py:37-78)."""
    this_hit_at_one = global_step_info_dict["hit_at_one"]
    this_perr = global_step_info_dict["perr"]
    this_loss = global_step_info_dict["loss"]
    examples_per_second = global_step_info_dict.get("examples_per_second", -1)

    if summary_writer is not None:
        summary_writer.scalar(
            f"GlobalStep/{summary_scope}_Hit@1", this_hit_at_one, global_step_val
        )
        summary_writer.scalar(
            f"GlobalStep/{summary_scope}_Perr", this_perr, global_step_val
        )
        summary_writer.scalar(
            f"GlobalStep/{summary_scope}_Loss", this_loss, global_step_val
        )
        if examples_per_second != -1:
            summary_writer.scalar(
                f"GlobalStep/{summary_scope}_Example_Second",
                examples_per_second,
                global_step_val,
            )
        summary_writer.flush()
    return (
        "global_step {0} | Batch Hit@1: {1:.3f} | Batch PERR: {2:.3f} "
        "| Batch Loss: {3:.3f} | Examples_per_sec: {4:.3f}"
    ).format(
        global_step_val, this_hit_at_one, this_perr, this_loss,
        examples_per_second,
    )


def add_epoch_summary(
    summary_writer: Optional[SummaryWriter],
    global_step_val: int,
    epoch_info_dict: Dict[str, object],
    summary_scope: str = "Eval",
) -> str:
    """Epoch scalars + the reference's log line (utils.py:81-125)."""
    epoch_id = epoch_info_dict["epoch_id"]
    avg_hit_at_one = epoch_info_dict["avg_hit_at_one"]
    avg_perr = epoch_info_dict["avg_perr"]
    avg_loss = epoch_info_dict["avg_loss"]
    aps = epoch_info_dict["aps"]
    gap = epoch_info_dict["gap"]
    mean_ap = float(np.mean(aps))

    if summary_writer is not None:
        summary_writer.scalar(
            f"Epoch/{summary_scope}_Avg_Hit@1", avg_hit_at_one, global_step_val
        )
        summary_writer.scalar(
            f"Epoch/{summary_scope}_Avg_Perr", avg_perr, global_step_val
        )
        summary_writer.scalar(
            f"Epoch/{summary_scope}_Avg_Loss", avg_loss, global_step_val
        )
        summary_writer.scalar(f"Epoch/{summary_scope}_MAP", mean_ap, global_step_val)
        summary_writer.scalar(f"Epoch/{summary_scope}_GAP", gap, global_step_val)
        summary_writer.flush()
    return (
        "epoch/eval number {0} | Avg_Hit@1: {1:.3f} | Avg_PERR: {2:.3f} "
        "| MAP: {3:.3f} | GAP: {4:.3f} | Avg_Loss: {5:3f}"
    ).format(epoch_id, avg_hit_at_one, avg_perr, mean_ap, gap, avg_loss)
