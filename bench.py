"""Benchmark: flagship throughput on one chip.

Primary metric — teacher+student distillation TRAIN throughput: the
reference's `run_train.sh` configuration (HierarchicalLstmModel 2x1024,
MoE head, 4716 classes, 300-frame videos, every_n=10 student) as
steady-state videos/sec for the full jitted train step (both towers
fwd+bwd + both Adam updates).

Also measured and reported in the same JSON line:
  * serving_videos_per_sec — the student inference path the serving
    API uses (predictions only);
  * eval_videos_per_sec — the full cli/eval step (student forward +
    per-example CE + top-k + exact PERR precision).

Baseline: the reference's logged TF1.3 run peaks at ~4.3 videos/sec
(global_step/sec 0.0167 x batch 256, /root/reference/README.md:113-123;
BASELINE.md). vs_baseline is the speedup over that number.

Runs on an NVIDIA GPU only: it refuses any other backend and prints the
card's name and power limit (nvidia-smi) before its result.

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline", ...}.
"""

import json
import subprocess
import sys
import time

import numpy as np


BASELINE_VIDEOS_PER_SEC = 4.3


def run(batch_size: int, compute_dtype: str):
    import jax
    import jax.numpy as jnp

    from efficientvideoclassification_youtube8m_tpu.parallel import (
        build_sharded_distill_step,
        create_mesh,
        place_state,
        shard_batch,
    )
    from efficientvideoclassification_youtube8m_tpu.train import (
        init_distill_state,
        make_optimizer,
    )
    from efficientvideoclassification_youtube8m_tpu.utils.config import TrainConfig

    cfg = TrainConfig(batch_size=batch_size, compute_dtype=compute_dtype)
    opt = make_optimizer(cfg.optimizer, cfg.clip_gradient_norm)
    state_host = init_distill_state(cfg, opt)
    mesh = create_mesh()  # all local devices on the data axis
    state = place_state(state_host, mesh)
    step = build_sharded_distill_step(cfg, opt, mesh, state_host, top_k=cfg.top_k)

    rng = np.random.default_rng(0)
    B = cfg.batch_size
    feats = rng.integers(
        0, 256, size=(B, cfg.max_num_frames, cfg.total_feature_size), dtype=np.uint8
    )
    labels = np.zeros((B, cfg.num_classes), bool)
    for i in range(B):
        labels[i, rng.choice(cfg.num_classes, 4, replace=False)] = True
    nf = rng.integers(30, cfg.max_num_frames + 1, size=B).astype(np.int32)
    f, l, n = shard_batch(mesh, feats, labels, nf)

    # warmup / compile
    state, metrics = step(state, f, l, n)
    jax.block_until_ready(state)

    def timed_window(iters: int) -> float:
        nonlocal state
        t0 = time.perf_counter()
        for _ in range(iters):
            state, metrics = step(state, f, l, n)
        jax.block_until_ready(state)
        return (time.perf_counter() - t0) / iters

    timed_window(2)  # settle
    windows = sorted(timed_window(10) for _ in range(3))
    # best-window rate plus the per-window spread (min/median/max v/s)
    return B / windows[0], [round(B / w, 1) for w in windows]


def _bench_batch(cfg, rng):
    B = cfg.batch_size
    feats = rng.integers(
        0, 256, size=(B, cfg.max_num_frames, cfg.total_feature_size),
        dtype=np.uint8,
    )
    labels = np.zeros((B, cfg.num_classes), bool)
    for i in range(B):
        labels[i, rng.choice(cfg.num_classes, 4, replace=False)] = True
    nf = rng.integers(30, cfg.max_num_frames + 1, size=B).astype(np.int32)
    return feats, labels, nf


def _timed_videos_per_sec(fn, sync, batch: int, iters: int = 10,
                          windows: int = 3):
    """Steady-state videos/s; sync() waits for the last launch
    (block_until_ready). Returns (best_rate, window_rates)."""
    fn()
    sync()  # compile + settle
    dts = []
    for _ in range(windows):
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        sync()
        dts.append((time.perf_counter() - t0) / iters)
    dts.sort()
    return batch / dts[0], [round(batch / dt, 1) for dt in dts]


def run_serving(batch_size: int, compute_dtype: str,
                quantize: str = "none") -> float:
    """Student serving path: the Predictor's jitted forward (predictions
    only) on device-resident uint8 batches. quantize='int8' runs the
    weight+activation int8 path (ops/quantize.py)."""
    import jax
    import jax.numpy as jnp

    from efficientvideoclassification_youtube8m_tpu.serving import Predictor
    from efficientvideoclassification_youtube8m_tpu.train import (
        init_distill_state,
        make_optimizer,
    )
    from efficientvideoclassification_youtube8m_tpu.utils.config import TrainConfig

    from efficientvideoclassification_youtube8m_tpu.ops.preprocess import (
        host_subsample,
    )

    cfg = TrainConfig(batch_size=batch_size, compute_dtype=compute_dtype)
    opt = make_optimizer(cfg.optimizer, cfg.clip_gradient_norm)
    state = init_distill_state(cfg, opt)
    predictor = Predictor(cfg, state.params_student, serve_batch=batch_size,
                          quantize=quantize)

    rng = np.random.default_rng(1)
    feats, _, nf = _bench_batch(cfg, rng)
    # the Predictor strides student frames on the host (predict());
    # feed its jitted forward the same pre-strided device-resident input
    f = jnp.asarray(host_subsample(feats, cfg.every_n))
    n = jnp.asarray(nf)

    holder = {}

    def fn():
        holder["preds"] = predictor._fwd(predictor.params, f, n)

    return _timed_videos_per_sec(
        fn, lambda: jax.block_until_ready(holder["preds"]), batch_size
    )


def run_serving_latency(batch_size: int, compute_dtype: str = "bfloat16",
                        requests: int = 100):
    """Per-request serving LATENCY (p50/p99 ms) at small batch — the
    number a serving deployment quotes alongside bulk throughput (the
    reference serves per-batch the same way,
    inference_ensemble.py:184-199). Device-resident input; each request
    ends in block_until_ready."""
    import jax
    import jax.numpy as jnp

    from efficientvideoclassification_youtube8m_tpu.ops.preprocess import (
        host_subsample,
    )
    from efficientvideoclassification_youtube8m_tpu.serving import Predictor
    from efficientvideoclassification_youtube8m_tpu.train import (
        init_distill_state,
        make_optimizer,
    )
    from efficientvideoclassification_youtube8m_tpu.utils.config import TrainConfig

    cfg = TrainConfig(batch_size=batch_size, compute_dtype=compute_dtype)
    opt = make_optimizer(cfg.optimizer, cfg.clip_gradient_norm)
    state = init_distill_state(cfg, opt)
    predictor = Predictor(cfg, state.params_student,
                          serve_batch=batch_size)
    rng = np.random.default_rng(3)
    feats, _, nf = _bench_batch(cfg, rng)
    f = jnp.asarray(host_subsample(feats, cfg.every_n))
    n = jnp.asarray(nf)

    for _ in range(5):  # compile + settle
        jax.block_until_ready(predictor._fwd(predictor.params, f, n))
    lat = []
    for _ in range(requests):
        t0 = time.perf_counter()
        jax.block_until_ready(predictor._fwd(predictor.params, f, n))
        lat.append((time.perf_counter() - t0) * 1e3)
    lat.sort()
    # nearest-rank percentiles: ceil(q*n)-1 (int(n*0.99) at n=100 would
    # index the MAX)
    import math

    def rank(q):
        return lat[min(len(lat) - 1, max(0, math.ceil(q * len(lat)) - 1))]

    return rank(0.50), rank(0.99)


def run_eval(batch_size: int, compute_dtype: str):
    """Full cli/eval pipeline at the production configuration: the
    host_subsampled device step (cli/eval strides frames at the parser,
    so the in-graph gather is NOT part of the real program) fed
    pre-strided batches, plus — as a second number — the end-to-end
    device-step + host epoch aggregation rate (EvaluationMetrics
    accumulate_topk on the fetched [B, k] rows, with the deferred
    epoch flush amortized in)."""
    import jax
    import jax.numpy as jnp

    from efficientvideoclassification_youtube8m_tpu.metrics import (
        EvaluationMetrics,
    )
    from efficientvideoclassification_youtube8m_tpu.ops.preprocess import (
        host_subsample,
    )
    from efficientvideoclassification_youtube8m_tpu.parallel import (
        build_sharded_eval_step,
        create_mesh,
        shard_batch,
    )
    from efficientvideoclassification_youtube8m_tpu.train import (
        init_distill_state,
        make_optimizer,
        student_state_from_distill,
    )
    from efficientvideoclassification_youtube8m_tpu.utils.config import TrainConfig

    cfg = TrainConfig(batch_size=batch_size, compute_dtype=compute_dtype)
    opt = make_optimizer(cfg.optimizer, cfg.clip_gradient_norm)
    state = student_state_from_distill(init_distill_state(cfg, opt), opt)
    mesh = create_mesh()
    step = build_sharded_eval_step(cfg, mesh, state.params_student,
                                   top_k=cfg.top_k, host_subsampled=True)
    params = jax.device_put(state.params_student)

    rng = np.random.default_rng(2)
    feats, labels, nf = _bench_batch(cfg, rng)
    f, l, n = shard_batch(mesh, host_subsample(feats, cfg.every_n),
                          labels, nf)

    holder = {}

    def fn():
        holder["out"] = step(params, f, l, n)

    device_rate, device_windows = _timed_videos_per_sec(
        fn, lambda: jax.block_until_ready(holder["out"]), batch_size
    )

    # end-to-end: device step + host-side epoch metric accumulation (the
    # real cli/eval inner loop: one packed D2H transfer per batch,
    # fetched one batch LAGGED so the round trip overlaps device
    # compute), with the deferred epoch finalize in the measured window.
    # Best-of-3 WINDOWS like every other metric. Each window gets a fresh
    # metrics sink so the per-window epoch flush covers exactly the
    # batches it is credited for.
    from efficientvideoclassification_youtube8m_tpu.parallel import distributed

    iters = 20

    def accumulate(sink, rows):
        sink.accumulate_topk(
            rows["topk_val"], rows["topk_idx"], rows["labels"],
            rows["per_example_loss"],
            perr_precision=rows["perr_precision"],
        )

    def best_of_windows(run_window, videos_per_window, windows=3):
        """run_window() executes one full lag-overlapped epoch window
        (including its epoch flush) and returns nothing; rates derive
        from wall time. First call is the warm-up."""
        run_window()  # settle (programs were compiled above or here)
        dts = []
        for _ in range(windows):
            t0 = time.perf_counter()
            run_window()
            dts.append(time.perf_counter() - t0)
        dts.sort()
        return (videos_per_window / dts[0],
                [round(videos_per_window / dt, 1) for dt in dts])

    def lag1_window():
        evl = EvaluationMetrics(cfg.num_classes, cfg.top_k)
        pending = None
        for _ in range(iters):
            out = step(params, f, l, n)
            if pending is not None:
                accumulate(evl, distributed.gather_step_outputs(
                    pending, labels, 0))
            pending = out
        accumulate(evl, distributed.gather_step_outputs(pending, labels, 0))
        assert np.isfinite(evl.get()["gap"])

    e2e_rate, e2e_windows = best_of_windows(
        lag1_window, batch_size * iters)

    # steps-per-dispatch e2e (cli.eval --steps_per_dispatch 24): K
    # batches scanned per launch, one packed [K, B, k+ceil(k/2)+2] fetch
    # (epoch metrics bit-identical; tests pin it).
    from efficientvideoclassification_youtube8m_tpu.parallel import (
        build_sharded_eval_step_stacked,
        shard_stacked_batch,
    )

    K = 24
    stacked = build_sharded_eval_step_stacked(
        cfg, mesh, state.params_student, top_k=cfg.top_k,
        host_subsampled=True)
    sub = np.asarray(host_subsample(feats, cfg.every_n))
    fk, lk, nk = shard_stacked_batch(
        mesh,
        np.broadcast_to(sub, (K,) + sub.shape),
        np.broadcast_to(labels, (K,) + labels.shape),
        np.broadcast_to(nf, (K,) + nf.shape),
    )
    metas = [(labels, 0)] * K
    stacks = max(2, (iters + K - 1) // K)

    def make_stacked_window(step_fn, step_params):
        def window():
            evl = EvaluationMetrics(cfg.num_classes, cfg.top_k)
            pending = None
            for _ in range(stacks):
                packs = step_fn(step_params, fk, lk, nk)
                if pending is not None:
                    for rows in distributed.gather_stacked_outputs(
                            pending, metas):
                        accumulate(evl, rows)
                pending = packs
            for rows in distributed.gather_stacked_outputs(pending, metas):
                accumulate(evl, rows)
            assert np.isfinite(evl.get()["gap"])
        return window

    e2e_stacked, e2e_stacked_windows = best_of_windows(
        make_stacked_window(stacked, params), batch_size * K * stacks)

    # int8 stacked e2e (cli.eval --quantize int8 --steps_per_dispatch 24) — best
    # effort: an int8-only failure must not discard the bf16 eval
    # numbers already measured at this batch (it is a separate loop in
    # the serving section for the same reason)
    e2e_stacked_int8 = e2e_stacked_int8_windows = None
    try:
        from efficientvideoclassification_youtube8m_tpu.ops.quantize import (
            quantize_hierarchical_params,
        )

        qparams_host = quantize_hierarchical_params(
            state.params_student, cfg.total_feature_size,
            cfg.lstm_cells, cfg.lstm_layers)
        qparams = jax.device_put(qparams_host)
        stacked_q = build_sharded_eval_step_stacked(
            cfg, mesh, qparams_host, top_k=cfg.top_k,
            host_subsampled=True, quantized=True)
        e2e_stacked_int8, e2e_stacked_int8_windows = best_of_windows(
            make_stacked_window(stacked_q, qparams),
            batch_size * K * stacks)
    except Exception as e:  # noqa: BLE001
        print(f"int8 stacked eval failed (bf16 numbers kept): {e}",
              file=sys.stderr)
    return (device_rate, device_windows, e2e_rate, e2e_windows,
            e2e_stacked, e2e_stacked_windows,
            e2e_stacked_int8, e2e_stacked_int8_windows)


def _require_gpu():
    """Refuse any backend but a GPU, and print the card's name and power
    limit beside the numbers."""
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"bench: no GPU (JAX's first device is {dev.platform!r})",
              file=sys.stderr)
        sys.exit(1)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(f"bench: {card} ({dev.device_kind}, {jax.device_count()} "
          "device(s))", file=sys.stderr)


def main():
    from efficientvideoclassification_youtube8m_tpu.utils.compile_cache import (
        enable_compilation_cache,
    )

    enable_compilation_cache()
    _require_gpu()
    videos_per_sec = train_windows = None
    for batch, dtype in [(512, "bfloat16"), (256, "bfloat16"),
                         (128, "bfloat16"), (64, "float32")]:
        try:
            videos_per_sec, train_windows = run(batch, dtype)
            break
        except Exception as e:  # OOM etc. -> try smaller
            print(f"bench config (batch={batch}, {dtype}) failed: {e}",
                  file=sys.stderr)
    if videos_per_sec is None:
        print(json.dumps({"metric": "train_videos_per_sec_per_chip", "value": 0,
                          "unit": "videos/s", "vs_baseline": 0}))
        sys.exit(1)

    # secondary metrics: best-effort, never fail the bench.
    serving = serving_int8 = eval_rate = None
    serving_windows = serving_int8_windows = eval_windows = None
    for batch, dtype in [(1024, "bfloat16"), (512, "bfloat16"),
                         (256, "bfloat16")]:
        try:
            serving, serving_windows = run_serving(batch, dtype)
            break
        except Exception as e:
            print(f"serving bench (batch={batch}) failed: {e}", file=sys.stderr)
    for batch, dtype in [(1024, "bfloat16"), (512, "bfloat16"),
                         (256, "bfloat16")]:
        try:
            serving_int8, serving_int8_windows = run_serving(
                batch, dtype, quantize="int8")
            break
        except Exception as e:
            print(f"int8 serving bench (batch={batch}) failed: {e}",
                  file=sys.stderr)
    eval_e2e = eval_e2e_stacked = eval_e2e_stacked_int8 = None
    eval_e2e_windows = eval_e2e_stacked_windows = None
    eval_e2e_stacked_int8_windows = None
    for batch, dtype in [(1024, "bfloat16"), (512, "bfloat16"),
                         (256, "bfloat16")]:
        try:
            (eval_rate, eval_windows, eval_e2e, eval_e2e_windows,
             eval_e2e_stacked, eval_e2e_stacked_windows,
             eval_e2e_stacked_int8,
             eval_e2e_stacked_int8_windows) = run_eval(batch, dtype)
            break
        except Exception as e:
            print(f"eval bench (batch={batch}) failed: {e}", file=sys.stderr)

    # per-request serving latency at small batch (best-effort)
    latency = {}
    for lb in (8, 64):
        try:
            p50, p99 = run_serving_latency(lb)
            latency[f"serving_latency_ms_p50_b{lb}"] = round(p50, 3)
            latency[f"serving_latency_ms_p99_b{lb}"] = round(p99, 3)
        except Exception as e:
            print(f"serving latency bench (batch={lb}) failed: {e}",
                  file=sys.stderr)
            latency[f"serving_latency_ms_p50_b{lb}"] = None
            latency[f"serving_latency_ms_p99_b{lb}"] = None

    print(json.dumps({
        "metric": "train_videos_per_sec_per_chip",
        "value": round(videos_per_sec, 2),
        "unit": "videos/s",
        "vs_baseline": round(videos_per_sec / BASELINE_VIDEOS_PER_SEC, 1),
        "serving_videos_per_sec": round(serving, 2) if serving else None,
        "serving_int8_videos_per_sec":
            round(serving_int8, 2) if serving_int8 else None,
        "eval_videos_per_sec": round(eval_rate, 2) if eval_rate else None,
        # lag-1 per-batch dispatch: what `cli.eval` with no flags runs
        # (auto --steps_per_dispatch resolves to 1)
        "eval_e2e_videos_per_sec": round(eval_e2e, 2) if eval_e2e else None,
        "eval_e2e_default_videos_per_sec":
            round(eval_e2e, 2) if eval_e2e else None,
        "eval_e2e_stacked_videos_per_sec":
            round(eval_e2e_stacked, 2) if eval_e2e_stacked else None,
        # cli.eval --quantize int8 --steps_per_dispatch 24
        "eval_e2e_stacked_int8_videos_per_sec":
            round(eval_e2e_stacked_int8, 2) if eval_e2e_stacked_int8
            else None,
        **latency,
        # per-window spread (sorted best->worst): deltas inside the spread
        # are measurement noise, not regressions
        "train_windows": train_windows,
        "serving_windows": serving_windows,
        "serving_int8_windows": serving_int8_windows,
        "eval_windows": eval_windows,
        "eval_e2e_windows": eval_e2e_windows,
        "eval_e2e_stacked_windows": eval_e2e_stacked_windows,
        "eval_e2e_stacked_int8_windows": eval_e2e_stacked_int8_windows,
    }))


if __name__ == "__main__":
    main()
