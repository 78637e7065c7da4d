"""Microbenchmark: host-side epoch metric accumulation, r2 vs r3.

r2's host-side aggregation (Python B*k scatter + per-entry heap pushes,
metrics/eval_util.py r2) was the CLI epoch bottleneck. r3 vectorizes the
per-batch work and defers heap pushes to one epoch-wide bulk flush
through the C kernel (data/native/heap.cc).

Runs both implementations at production shapes (batch 512, top-20,
vocab 4716), cross-checks the epoch metrics bit-for-bit, and prints one
JSON line with the speedup and the host-side videos/s each sustains.
"""

import json
import sys
import time

import numpy as np

sys.path.insert(0, __file__.rsplit("/", 2)[0])

from efficientvideoclassification_youtube8m_tpu.metrics import (  # noqa: E402
    EvaluationMetrics,
)
from tests.test_metrics_fast import LegacyEpoch  # noqa: E402

B, K, C = 512, 20, 4716
NUM_BATCHES = 60  # ~31k videos: enough to amortize the epoch-end sweep


def make_stream(num_batches=NUM_BATCHES, seed=0):
    rng = np.random.default_rng(seed)
    batches = []
    for _ in range(num_batches):
        scores = rng.uniform(size=(B, C)).astype(np.float32)
        labels = rng.uniform(size=(B, C)) < (3.4 / C)  # ~3.4 labels/video
        labels[: B // 16, : K + 5] = True  # some > K-label videos
        order = np.argsort(-scores, axis=1, kind="stable")[:, :K]
        vals = np.take_along_axis(scores, order, axis=1)
        # the CLI gets exact per-row PERR from the device step
        # (perr_precision_on_device); a stand-in [B] array here
        perr = rng.uniform(size=B).astype(np.float32)
        batches.append((vals, order, labels, perr))
    return batches


def run_new(stream):
    m = EvaluationMetrics(C, K)
    t0 = time.perf_counter()
    for vals, idx, labels, perr in stream:
        m.accumulate_topk(vals, idx, labels, loss=np.zeros(B),
                          perr_precision=perr)
    epoch = m.get()  # includes the deferred flush + AP sweeps
    return time.perf_counter() - t0, epoch


def run_legacy(stream):
    m = LegacyEpoch(C, K)
    t0 = time.perf_counter()
    for vals, idx, labels, perr in stream:
        m.accumulate_topk(vals, idx, labels, perr_precision=perr)
    epoch = m.get()
    return time.perf_counter() - t0, epoch


def main():
    stream = make_stream()
    t_new, epoch_new = run_new(stream)
    t_old, epoch_old = run_legacy(stream)
    assert epoch_new["gap"] == epoch_old["gap"], (
        epoch_new["gap"], epoch_old["gap"])
    assert epoch_new["aps"] == epoch_old["aps"]
    videos = B * NUM_BATCHES
    print(json.dumps({
        "metric": "host_epoch_metrics_speedup",
        "value": round(t_old / t_new, 2),
        "unit": "x",
        "videos_per_sec_new": round(videos / t_new, 1),
        "videos_per_sec_legacy": round(videos / t_old, 1),
        "seconds_new": round(t_new, 3),
        "seconds_legacy": round(t_old, 3),
        "gap_check": "bit-identical",
    }))


if __name__ == "__main__":
    main()
