#!/usr/bin/env python
"""Bring-up check: the five-stage pipeline and serving on one NVIDIA GPU.

    python chip_smoke.py               # one card: every phase below
    python chip_smoke.py --four-cards  # four cards: the multi-device paths only

Everything runs in ONE process, through the entry points a user calls
(the CLI `main()` functions in-process, `serving.Predictor`): a JAX
process reserves most of a card's memory when it starts, so a second
process on the card would fail for want of memory.

One card, at the flagship widths (rgb+audio 1024+128 features, 300
frames, HierarchicalLstmModel 2x1024, 20 teacher / 5 student chunks,
every_n 10, 2-mixture MoE over 4716 classes, bf16 as the CLIs default):

  1. device     refuse anything but a GPU; print the card, JAX, XLA_FLAGS
                and the compile-cache directory;
  2. pipeline   seeded synthetic shards; cli.train at batch 256 for two
                batches (logged steps 2 and 4 held to the reference's
                golden log), cli.validate, cli.convert, cli.finetune,
                cli.eval in bf16 and int8, cli.infer -> CSV; wall and
                compile time per stage;
  3. serve      Predictor.from_checkpoint, bf16 and int8, requests of
                256 and 37 videos; int8 held to the bf16 predictions;
  4. numerics   bf16 forward and distillation gradients against float32
                at "highest" matmul precision on the card, and the
                float32 forward on the card against the CPU;
  5. snapshot   the async checkpoint saver's snapshot mode.

Four cards: GSPMD data parallelism, the shard_map train path, the MoE
head column-sharded over "model" (2x2 mesh), and data- and
sequence-parallel serving, each against the same batch on one card, in
float32 at "highest" precision.

A failed phase makes the script exit non-zero without the final line.
The last line of stdout is one JSON object:
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import logging
import math
import os
import re
import subprocess
import sys
import tempfile
import time
import traceback
from typing import Dict, List, Tuple

import numpy as np

# Tolerances (why each, in order):
# bf16 production path vs float32 at "highest" precision, predictions:
# bf16 keeps 8 mantissa bits, and the error compounds over up to 15+20
# recurrent steps; probabilities are in [0, 1], so an absolute bound.
BF16_PRED_ATOL = 3e-2
# bf16 vs float32 distillation-loss gradients: the direction of each
# leaf's gradient must survive bf16 rounding (cosine per leaf).
BF16_GRAD_MIN_COSINE = 0.99
# float32 "highest" on the card vs the CPU: the same math with another
# summation order; relative to the largest prediction.
CPU_GPU_MAX_REL = 1e-4
# int8 vs bf16 serving: the forward bar and the epoch-metric bar of
# tests/test_quantize.py (|dprob| < 0.02; Hit@1 and GAP within 2e-3).
INT8_PRED_ATOL = 2e-2
INT8_METRIC_ATOL = 2e-3
# cli.eval --quantize int8 vs bf16 epoch metrics (tests/test_pipeline_e2e.py)
INT8_EVAL_ATOL = 5e-2
# four cards vs one, float32 "highest" (the __graft_entry__ dry-run
# tolerances): reductions split across cards change the summation order.
MULTI_LOSS_RTOL, MULTI_LOSS_ATOL = 1e-4, 1e-6
MULTI_PRED_RTOL, MULTI_PRED_ATOL = 1e-5, 1e-6


class SmokeFailure(Exception):
    pass


def check(cond: bool, msg: str) -> None:
    print(f"  [{'ok' if cond else 'FAIL'}] {msg}", flush=True)
    if not cond:
        raise SmokeFailure(msg)


@dataclasses.dataclass(frozen=True)
class Widths:
    """Model widths and data sizes of one smoke run. The defaults are the
    flagship configuration (scripts/run_train.sh); tests pass tiny ones."""

    feature_sizes: Tuple[int, ...] = (1024, 128)
    lstm_cells: int = 1024
    max_num_frames: int = 300
    num_inputs_to_lstm: int = 20
    num_inputs_L1: int = 5
    every_n: int = 10
    num_classes: int = 4716
    batch_size: int = 256  # scripts/run_train.sh:14
    train_videos: int = 512  # two batches: logged steps 2 and 4
    # 256 + 256 + 37: the last eval batch is padded, and serving answers
    # two full requests and one partial one from the same videos
    heldout_videos: int = 549
    serve_requests: Tuple[int, ...] = (256, 256, 37)
    numerics_batch: int = 8
    four_card_batch: int = 16
    golden: bool = True  # hold steps 2 and 4 to the reference's log

    def flags(self) -> List[str]:
        return [
            "--feature_names", "rgb, audio",
            "--feature_sizes", ", ".join(map(str, self.feature_sizes)),
            "--model", "HierarchicalLstmModel",
            "--lstm_cells", str(self.lstm_cells),
            "--lstm_layers", "2",
            "--max_num_frames", str(self.max_num_frames),
            "--num_inputs_to_lstm", str(self.num_inputs_to_lstm),
            "--num_inputs_L1", str(self.num_inputs_L1),
            "--every_n", str(self.every_n),
            "--num_classes", str(self.num_classes),
            "--batch_size", str(self.batch_size),
            "--num_readers", "2",
        ]

    def config(self, **kw):
        """The TrainConfig the CLIs build from these flags (CLI defaults,
        e.g. bf16 compute), with `kw` replaced."""
        from efficientvideoclassification_youtube8m_tpu.cli import flags

        args = flags.base_parser("chip_smoke").parse_args(self.flags())
        return flags.config_from_args(args).replace(**kw)


FLAGSHIP = Widths()


class CompileClock:
    """Seconds JAX spends tracing, lowering and compiling, summed from
    its monitoring events."""

    _EVENTS = ("/jax/core/compile/jaxpr_trace_duration",
               "/jax/core/compile/jaxpr_to_mlir_module_duration",
               "/jax/core/compile/backend_compile_duration")

    def __init__(self):
        import jax.monitoring

        self.total = 0.0
        jax.monitoring.register_event_duration_secs_listener(self._on_event)

    def _on_event(self, event: str, duration: float, **_) -> None:
        if event in self._EVENTS:
            self.total += duration

    def close(self) -> None:
        import jax.monitoring

        jax.monitoring.unregister_event_duration_listener(self._on_event)


@contextlib.contextmanager
def stage(name: str, clock: CompileClock):
    t0, c0 = time.perf_counter(), clock.total
    yield
    print(f"stage {name}: wall {time.perf_counter() - t0:.2f} s, "
          f"compile {clock.total - c0:.2f} s", flush=True)


class LineCapture(logging.Handler):
    """Collects the messages of one logger that match a pattern."""

    def __init__(self, pattern: str):
        super().__init__()
        self.pattern = re.compile(pattern)
        self.matches: List[re.Match] = []

    def emit(self, record):
        m = self.pattern.search(record.getMessage())
        if m:
            self.matches.append(m)


@contextlib.contextmanager
def captured(logger_name: str, handler: logging.Handler):
    log = logging.getLogger(logger_name)
    level = log.level
    log.setLevel(logging.INFO)  # the CLIs log their results at INFO
    log.addHandler(handler)
    try:
        yield handler
    finally:
        log.removeHandler(handler)
        log.setLevel(level)


_EPOCH_RE = (r"Avg_Hit@1: ([\d.]+) \| Avg_PERR: ([\d.]+) \| MAP: ([\d.]+) "
             r"\| GAP: ([\d.]+) \| Avg_Loss: ([\d.naninf]+)")


def _epoch_metrics(cap: LineCapture) -> Dict[str, float]:
    check(len(cap.matches) == 1,
          f"one epoch summary logged (got {len(cap.matches)})")
    hit, perr, mean_ap, gap, loss = (float(v) for v in cap.matches[0].groups())
    return {"hit_at_one": hit, "perr": perr, "map": mean_ap, "gap": gap,
            "loss": loss}


# --- phases ------------------------------------------------------------------

def phase_device(expect_count: int) -> Dict[str, object]:
    """Refuses anything but a GPU; prints what the run ran on."""
    import jax

    from efficientvideoclassification_youtube8m_tpu.utils.compile_cache import (
        enable_compilation_cache,
    )

    devices = jax.devices()
    if devices[0].platform != "gpu":
        raise SmokeFailure(
            f"no GPU: JAX's first device is {devices[0].platform!r}")
    if len(devices) < expect_count:
        raise SmokeFailure(f"need {expect_count} GPUs, JAX sees {len(devices)}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    for line in smi.stdout.strip().splitlines():
        print(f"nvidia-smi: {line.strip()}")
    print(f"device_kind: {devices[0].device_kind}, count: {len(devices)}")
    print(f"jax {jax.__version__}")
    print(f"XLA_FLAGS: {os.environ.get('XLA_FLAGS', '')!r}")
    print(f"compile cache: {enable_compilation_cache()}", flush=True)
    return {"platform": devices[0].platform, "kind": devices[0].device_kind,
            "count": len(devices)}


def write_shards(workdir: str, w: Widths):
    """Seeded synthetic YT8M shards; returns (train pattern, held-out
    pattern, held-out ground truth)."""
    from efficientvideoclassification_youtube8m_tpu.data import (
        write_synthetic_frame_shard,
    )

    data = os.path.join(workdir, "data")
    os.makedirs(data, exist_ok=True)
    kw = dict(feature_names=("rgb", "audio"), feature_sizes=w.feature_sizes,
              max_frames=w.max_num_frames, vocab_size=w.num_classes)
    write_synthetic_frame_shard(os.path.join(data, "train-0000.tfrecord"),
                                w.train_videos, seed=0, **kw)
    heldout = write_synthetic_frame_shard(
        os.path.join(data, "validate-0000.tfrecord"), w.heldout_videos,
        seed=1, **kw)
    return (os.path.join(data, "train-*.tfrecord"),
            os.path.join(data, "validate-*.tfrecord"), heldout)


def phase_pipeline(workdir: str, w: Widths, clock: CompileClock):
    """train -> validate -> convert -> finetune -> eval (bf16, int8) ->
    infer through the CLI mains; returns the finetune directory and the
    held-out videos."""
    from efficientvideoclassification_youtube8m_tpu.cli import (
        convert, eval as eval_cli, finetune, infer, train, validate,
    )
    from efficientvideoclassification_youtube8m_tpu.ensemble import (
        read_pred_file,
    )
    from efficientvideoclassification_youtube8m_tpu.utils.fidelity import (
        StepCapture,
        check_trajectory,
    )

    with stage("write shards", clock):
        train_pat, heldout_pat, heldout = write_shards(workdir, w)
    flags = w.flags()
    train_dir = os.path.join(workdir, "model_train") + "/"

    with stage("train", clock), captured("train", StepCapture()) as steps:
        train.main(flags + ["--train_dir", train_dir,
                            "--train_data_pattern", train_pat,
                            "--num_epochs", "1", "--start_new_model", "true"])
    check(2 in steps.steps and 4 in steps.steps,
          f"training steps 2 and 4 logged (got {sorted(steps.steps)})")
    if w.golden:
        check(check_trajectory(steps.steps),
              "steps 2 and 4 inside the golden-log bands")

    with stage("validate", clock), captured(
            "validate", LineCapture(_EPOCH_RE)) as cap:
        validate.main(flags + ["--train_dir", train_dir,
                               "--eval_data_pattern", heldout_pat,
                               "--run_once", "true"])
    m = _epoch_metrics(cap)
    check(all(math.isfinite(v) for v in m.values()),
          f"validate epoch metrics finite: {m}")

    with stage("convert", clock):
        convert.main(flags + ["--train_dir", train_dir])
    # the reference's rule for the finetune directory (cli/convert.py)
    finetune_dir = train_dir.replace("train", "") + "finetune/"

    with stage("finetune", clock):
        finetune.main(flags + ["--train_dir", finetune_dir,
                               "--train_data_pattern", train_pat,
                               "--num_epochs", "1"])

    evals = {}
    for quant in ("none", "int8"):
        with stage(f"eval {quant}", clock), captured(
                "eval", LineCapture(_EPOCH_RE)) as cap:
            eval_cli.main(flags + ["--train_dir", finetune_dir,
                                   "--eval_data_pattern", heldout_pat,
                                   "--run_once", "true",
                                   "--quantize", quant])
        evals[quant] = _epoch_metrics(cap)
        check(all(math.isfinite(v) for v in evals[quant].values()),
              f"eval --quantize {quant} epoch metrics finite: "
              f"{evals[quant]}")
    for key in ("hit_at_one", "gap"):
        d = abs(evals["int8"][key] - evals["none"][key])
        check(d <= INT8_EVAL_ATOL,
              f"eval int8 {key} within {INT8_EVAL_ATOL} of bf16 ({d:.4f})")

    csv = os.path.join(workdir, "predictions.csv")
    with stage("infer", clock):
        infer.main(flags + ["--train_dir", finetune_dir,
                            "--input_data_pattern", heldout_pat,
                            "--output_file", csv])
    preds = read_pred_file(csv)
    check(len(preds) == len(heldout),
          f"infer wrote {len(preds)} rows for {len(heldout)} videos")
    check(all(0.0 <= p <= 1.0 for _, probs in preds.values() for p in probs),
          "infer probabilities in [0, 1]")
    return finetune_dir, heldout


def _frames_array(videos, w: Widths):
    feats = np.zeros((len(videos), w.max_num_frames,
                      sum(w.feature_sizes)), np.uint8)
    for i, v in enumerate(videos):
        feats[i, :v.num_frames] = v.features[:v.num_frames]
    nf = np.asarray([v.num_frames for v in videos], np.int32)
    labels = np.zeros((len(videos), w.num_classes), bool)
    for i, v in enumerate(videos):
        labels[i, v.labels] = True
    return feats, nf, labels


def _int8_dot_lowering(m: int, k: int, n: int) -> str:
    """How XLA compiled one int8 x int8 -> int32 product at [m,k]x[k,n]:
    the custom-call targets of the compiled module, or its fusions."""
    import jax
    import jax.numpy as jnp

    from efficientvideoclassification_youtube8m_tpu.ops.quantize import (
        int8_dot,
        quantize_weight,
    )

    wq, ws = quantize_weight(jnp.ones((k, n), jnp.float32))
    hlo = jax.jit(int8_dot).lower(
        jnp.ones((m, k), jnp.float32), wq, ws).compile().as_text()
    targets = sorted(set(re.findall(r'custom_call_target="([^"]+)"', hlo)))
    gemm_s8 = [ln.strip()[:160] for ln in hlo.splitlines()
               if "s8[" in ln and ("gemm" in ln or "dot(" in ln)]
    return (f"custom calls {targets or 'none'}; "
            f"int8 product: {gemm_s8[0] if gemm_s8 else 'no s8 dot/gemm'}")


def phase_serve(finetune_dir: str, heldout, w: Widths,
                clock: CompileClock) -> None:
    """Predictor.from_checkpoint on the finetune directory, bf16 and
    int8; requests of serve_batch rows and a partial one."""
    from efficientvideoclassification_youtube8m_tpu.metrics import (
        EvaluationMetrics,
    )
    from efficientvideoclassification_youtube8m_tpu.serving import Predictor

    cfg = w.config()
    feats, nf, labels = _frames_array(heldout, w)
    bounds = np.cumsum((0,) + w.serve_requests)
    check(bounds[-1] <= len(heldout),
          f"{bounds[-1]} served videos fit the {len(heldout)} held out")
    preds = {}
    for quant in ("none", "int8"):
        with stage(f"serve load {quant}", clock):
            p = Predictor.from_checkpoint(finetune_dir, cfg,
                                          serve_batch=w.batch_size,
                                          quantize=quant)
        out = []
        for a, b in zip(bounds[:-1], bounds[1:]):
            with stage(f"serve {quant} request of {b - a}", clock):
                out.append(p.predict(feats[a:b], nf[a:b]))
            check(out[-1].shape == (b - a, w.num_classes),
                  f"{quant} request of {b - a}: shape {out[-1].shape}")
        preds[quant] = np.concatenate(out)
        check(bool(np.all(np.isfinite(preds[quant]))
                   and np.all((preds[quant] >= 0) & (preds[quant] <= 1))),
              f"{quant} predictions finite and in [0, 1]")
    diff = float(np.max(np.abs(preds["int8"] - preds["none"])))
    check(diff < INT8_PRED_ATOL,
          f"int8 vs bf16 max |dprob| {diff:.5f} < {INT8_PRED_ATOL}")
    n = bounds[-1]
    metrics = {}
    for quant, probs in preds.items():
        evl = EvaluationMetrics(w.num_classes, 20)
        idx = np.argsort(-probs, axis=1, kind="stable")[:, :20]
        evl.accumulate_topk(np.take_along_axis(probs, idx, axis=1), idx,
                            labels[:n], loss=np.zeros(n))
        metrics[quant] = evl.get()
    for key in ("avg_hit_at_one", "gap"):
        d = abs(metrics["int8"][key] - metrics["none"][key])
        check(d <= INT8_METRIC_ATOL,
              f"int8 {key} within {INT8_METRIC_ATOL} of bf16 ({d:.5f})")
    state_dim = 4 * w.lstm_cells
    rows = w.batch_size * w.num_inputs_L1
    for name, shape in (
            ("L1 input projection",
             (rows * (w.max_num_frames // w.every_n // w.num_inputs_L1),
              sum(w.feature_sizes), 4 * w.lstm_cells)),
            ("L1 recurrence", (rows, w.lstm_cells, 4 * w.lstm_cells)),
            ("MoE gates", (w.batch_size, state_dim, 3 * w.num_classes))):
        print(f"  int8 dot {name} {shape}: {_int8_dot_lowering(*shape)}")


def _numerics_fns(cfg):
    """(forward, distillation loss) of the production step's math."""
    from efficientvideoclassification_youtube8m_tpu.ops.preprocess import (
        student_num_frames,
        uniform_subsample,
    )
    from efficientvideoclassification_youtube8m_tpu.train.step import (
        _distill_losses,
        forward_student,
        forward_teacher,
        preprocess_batch,
        resolve_label_loss,
    )

    label_loss = resolve_label_loss(cfg)

    def towers(pt, ps, feats, nf, labels, inference):
        x = preprocess_batch(cfg, feats, nf)
        xs = uniform_subsample(x, cfg.every_n)
        nfs = student_num_frames(nf, cfg.every_n, cfg.max_num_frames)
        return (forward_teacher(cfg, pt, x, nf, labels, inference=inference),
                forward_student(cfg, ps, xs, nfs, labels,
                                inference=inference))

    def forward(pt, ps, feats, nf):
        out_t, out_s = towers(pt, ps, feats, nf, None, True)
        return out_t["predictions"], out_s["predictions"]

    def loss(pt, ps, feats, nf, labels):
        out_t, out_s = towers(pt, ps, feats, nf, labels, False)
        ls = _distill_losses(cfg, out_t, out_s, labels, label_loss)
        return ls["teacher_final_loss"] + ls["total_student_loss"]

    return forward, loss


def phase_numerics(w: Widths, clock: CompileClock) -> None:
    """bf16 vs float32 "highest" on the default device (forward and
    distillation gradients), and the float32 forward against the CPU."""
    import jax

    from efficientvideoclassification_youtube8m_tpu.train import (
        init_distill_state,
        make_optimizer,
    )

    cfg32 = w.config(compute_dtype="float32")
    cfg16 = w.config(compute_dtype="bfloat16")
    opt = make_optimizer(cfg32.optimizer, cfg32.clip_gradient_norm)
    st = init_distill_state(cfg32, opt, host_optimizer_state=True)
    pt, ps = st.params_teacher, st.params_student
    rng = np.random.default_rng(3)
    B = w.numerics_batch
    feats = rng.integers(0, 256, (B, w.max_num_frames, sum(w.feature_sizes)),
                         dtype=np.uint8)
    nf = rng.integers(w.every_n, w.max_num_frames + 1, B).astype(np.int32)
    labels = np.zeros((B, w.num_classes), bool)
    labels[np.arange(B)[:, None], rng.integers(0, w.num_classes, (B, 3))] = True

    fwd32, loss32 = _numerics_fns(cfg32)
    fwd16, loss16 = _numerics_fns(cfg16)
    with stage("numerics float32 highest", clock), \
            jax.default_matmul_precision("highest"):
        ref_pred = jax.device_get(jax.jit(fwd32)(pt, ps, feats, nf))
        ref_grad = jax.device_get(jax.jit(jax.grad(loss32, argnums=(0, 1)))(
            pt, ps, feats, nf, labels))
    with stage("numerics bf16", clock):
        pred = jax.device_get(jax.jit(fwd16)(pt, ps, feats, nf))
        grad = jax.device_get(jax.jit(jax.grad(loss16, argnums=(0, 1)))(
            pt, ps, feats, nf, labels))
    for tower, got, want in zip(("teacher", "student"), pred, ref_pred):
        d = float(np.max(np.abs(got - want)))
        check(d <= BF16_PRED_ATOL,
              f"{tower} bf16 vs float32 predictions: max |d| {d:.5f} "
              f"<= {BF16_PRED_ATOL}")
    worst = (2.0, "")
    for (path, g), r in zip(jax.tree_util.tree_leaves_with_path(grad),
                            jax.tree.leaves(ref_grad)):
        g = np.asarray(g, np.float64).ravel()
        r = np.asarray(r, np.float64).ravel()
        denom = np.linalg.norm(g) * np.linalg.norm(r)
        cos = 1.0 if denom == 0 else float(g @ r / denom)
        worst = min(worst, (cos, jax.tree_util.keystr(path)))
    check(worst[0] >= BF16_GRAD_MIN_COSINE,
          f"bf16 vs float32 gradients: worst per-leaf cosine "
          f"{worst[0]:.5f} ({worst[1]}) >= {BF16_GRAD_MIN_COSINE}")

    cpu = jax.devices("cpu")[0]
    cfg_cpu = cfg32.replace(scan_unroll=1)  # same math; cheaper CPU compile
    fwd_cpu, _ = _numerics_fns(cfg_cpu)
    with stage("numerics CPU float32", clock), \
            jax.default_matmul_precision("highest"):
        cpu_pred = jax.device_get(jax.jit(fwd_cpu)(
            *jax.device_put((pt, ps, feats, nf), cpu)))
    for tower, got, want in zip(("teacher", "student"), ref_pred, cpu_pred):
        rel = float(np.max(np.abs(got - want)) / np.max(np.abs(want)))
        check(rel <= CPU_GPU_MAX_REL,
              f"{tower} float32 {jax.devices()[0].platform} vs CPU: "
              f"max rel {rel:.2e} <= {CPU_GPU_MAX_REL}")


def phase_snapshot(workdir: str, w: Widths, clock: CompileClock) -> str:
    """Save a full distillation train state through the async saver and
    report the snapshot mode it settled on."""
    import jax

    from efficientvideoclassification_youtube8m_tpu.train import (
        AsyncCheckpointSaver,
        init_distill_state,
        latest_checkpoint,
        make_optimizer,
        restore_checkpoint,
    )

    cfg = w.config()
    opt = make_optimizer(cfg.optimizer, cfg.clip_gradient_norm)
    state = jax.device_put(init_distill_state(cfg, opt))
    nbytes = sum(x.nbytes for x in jax.tree.leaves(state))
    ckpt_dir = os.path.join(workdir, "snapshot")
    saver = AsyncCheckpointSaver()
    with stage(f"snapshot + write of {nbytes / 2**30:.2f} GiB", clock):
        saver.save(ckpt_dir, state, 7)
        saver.wait()
    mode = saver.snapshot_mode
    print(f"  async checkpoint snapshot mode: {mode}")
    check(mode in ("host", "hbm"), f"a snapshot was taken (mode {mode})")
    restored = restore_checkpoint(latest_checkpoint(ckpt_dir),
                                  jax.device_get(state))
    same = all(np.array_equal(np.asarray(a), np.asarray(b)) for a, b in zip(
        jax.tree.leaves(restored), jax.tree.leaves(jax.device_get(state))))
    check(same, "the snapshot restores bit-identically")
    return mode


def phase_four_cards(w: Widths, clock: CompileClock, n: int = 4) -> None:
    """Each multi-device path against the same batch on one device, in
    float32 at "highest" matmul precision."""
    import jax

    from efficientvideoclassification_youtube8m_tpu.parallel import (
        build_sharded_distill_step,
        build_shardmap_distill_step,
        create_mesh,
        place_state,
        shard_batch,
        state_sharding,
    )
    from efficientvideoclassification_youtube8m_tpu.serving import Predictor
    from efficientvideoclassification_youtube8m_tpu.train import (
        init_distill_state,
        make_optimizer,
    )

    devices = jax.devices()[:n]
    # scan_unroll 1: the same math as the default unroll at half its
    # compile time (every path compiles twice: n cards and one)
    cfg = w.config(compute_dtype="float32", batch_size=w.four_card_batch,
                   scan_unroll=1)
    opt = make_optimizer(cfg.optimizer, cfg.clip_gradient_norm)
    rng = np.random.default_rng(4)
    B = cfg.batch_size
    feats = rng.integers(0, 256, (B, w.max_num_frames, sum(w.feature_sizes)),
                         dtype=np.uint8)
    nf = rng.integers(w.every_n, w.max_num_frames + 1, B).astype(np.int32)
    labels = np.zeros((B, w.num_classes), bool)
    labels[np.arange(B)[:, None], rng.integers(0, w.num_classes, (B, 3))] = True
    keys = ("teacher_label_loss", "total_student_loss", "pred_loss",
            "student_loss_state", "student_label_loss")
    # the MoE head's leaves end in the class axis, the only one this wide:
    # they alone shard over "model" (the CLI default, 4200, at flagship)
    min_dim = w.num_classes

    def train_metrics(mesh, shard_map: bool):
        host_state = init_distill_state(cfg, opt)
        if shard_map:
            step = build_shardmap_distill_step(cfg, opt, mesh, top_k=20)
            state = place_state(host_state, mesh)
        else:
            step = build_sharded_distill_step(cfg, opt, mesh, host_state,
                                              top_k=20, min_dim=min_dim)
            state = place_state(host_state, mesh, min_dim=min_dim)
        _, m = step(state, *shard_batch(mesh, feats, labels, nf))
        return {k: float(m[k]) for k in keys}

    one = create_mesh(data=1, model=1, devices=devices[:1])
    with jax.default_matmul_precision("highest"):
        with stage("train step on 1 device", clock):
            ref = train_metrics(one, False)
        for name, mesh, sm in (
                (f"GSPMD data parallel {n}x1",
                 create_mesh(data=n, model=1, devices=devices), False),
                (f"GSPMD {n // 2}x2, MoE head column-sharded over 'model'",
                 create_mesh(data=n // 2, model=2, devices=devices), False),
                (f"shard_map data parallel {n}x1",
                 create_mesh(data=n, model=1, devices=devices), True)):
            if not sm and mesh.shape["model"] > 1:
                specs = state_sharding(init_distill_state(cfg, opt), mesh,
                                       min_dim).params_teacher["classifier"]
                check(any("model" in tuple(s.spec) for s in
                          jax.tree.leaves(specs)),
                      "the MoE head is sharded over 'model'")
            with stage(f"train step, {name}", clock):
                got = train_metrics(mesh, sm)
            for k in keys:
                ok = math.isclose(got[k], ref[k], rel_tol=MULTI_LOSS_RTOL,
                                  abs_tol=MULTI_LOSS_ATOL)
                check(ok, f"{name}: {k} {got[k]:.6f} vs 1 device "
                          f"{ref[k]:.6f}")

        st = jax.device_get(init_distill_state(cfg, opt,
                                               host_optimizer_state=True))
        dp = create_mesh(data=n, model=1, devices=devices)
        for name, tower, params, kw in (
                (f"data-parallel Predictor over {n}", "student",
                 st.params_student, dict(mesh=dp)),
                (f"sequence-parallel Predictor over {n} (teacher chunks)",
                 "teacher", st.params_teacher,
                 dict(mesh=dp, sequence_parallel=True))):
            with stage(name, clock):
                got = Predictor(cfg, params, tower, serve_batch=B,
                                **kw).predict(feats, nf)
            with jax.default_device(devices[0]):
                want = Predictor(cfg, params, tower,
                                 serve_batch=B).predict(feats, nf)
            d = float(np.max(np.abs(got - want)
                             - MULTI_PRED_RTOL * np.abs(want)))
            check(d <= MULTI_PRED_ATOL,
                  f"{name}: predictions match 1 device (excess {d:.2e})")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the multi-device paths, on 4 cards")
    ap.add_argument("--workdir", default=None,
                    help="where shards and checkpoints go (default: a "
                    "fresh temporary directory, removed at exit)")
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.INFO,
                        format="%(levelname)s:%(name)s: %(message)s")
    count = 4 if args.four_cards else 1
    try:
        device = phase_device(count)
    except (SmokeFailure, OSError, subprocess.SubprocessError) as e:
        print(f"chip_smoke: {e}", file=sys.stderr)
        return 1

    clock = CompileClock()
    failed = []

    def run(name, fn, *a):
        print(f"== phase {name}", flush=True)
        t0 = time.perf_counter()
        try:
            out = fn(*a)
        except Exception:  # a failed phase is reported, then the run fails
            traceback.print_exc()
            failed.append(name)
            print(f"== phase {name}: FAILED", flush=True)
            return None
        print(f"== phase {name}: ok ({time.perf_counter() - t0:.1f} s)",
              flush=True)
        return out

    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        workdir = args.workdir or tmp
        if args.four_cards:
            run("four cards", phase_four_cards, FLAGSHIP, clock)
        else:
            out = run("pipeline", phase_pipeline, workdir, FLAGSHIP, clock)
            if out is not None:
                run("serve", phase_serve, *out, FLAGSHIP, clock)
            else:
                failed.append("serve")
            run("numerics", phase_numerics, FLAGSHIP, clock)
            run("snapshot", phase_snapshot, workdir, FLAGSHIP, clock)
    clock.close()
    if failed:
        print(f"chip_smoke: failed phases: {failed}", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": device}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
