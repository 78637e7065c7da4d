"""Embeddable serving API.

The production counterpart of the CSV-driven inference binaries: load a
checkpoint once, then call `predict` on uint8 frame batches. Uses the
same jitted forward as cli/eval, with automatic batch padding so
arbitrary request sizes hit one compiled program.

    from efficientvideoclassification_youtube8m_tpu.serving import Predictor
    p = Predictor.from_checkpoint("./model_finetune/")
    probs = p.predict(features_u8, num_frames)        # [B, 4716]
    vals, idx = p.predict_topk(features_u8, num_frames, k=20)

Serves the STUDENT (the paper's deliverable: ~10x fewer frames). Pass
`tower="teacher"` against a distillation checkpoint to serve the teacher.
Student frames are strided on the host, so requests move only
1/every_n of the uint8 bytes to the device.

Multi-device: pass `mesh=` (and optionally `sequence_parallel=True`).
With sequence parallelism the CHUNK axis of each video is sharded over
the mesh — each device scans its slice of every video's L1 blocks, one
all_gather assembles the block states (parallel/sequence_parallel.py) —
the low-batch/long-video serving layout where batch sharding would
leave devices idle.
"""

from __future__ import annotations

from collections import deque
from typing import Optional, Tuple

import numpy as np

import jax
import jax.numpy as jnp

from efficientvideoclassification_youtube8m_tpu.train import (
    init_distill_state,
    latest_checkpoint,
    make_optimizer,
    restore_checkpoint,
    student_state_from_distill,
)
from efficientvideoclassification_youtube8m_tpu.train.step import (
    forward_student,
    forward_teacher,
    preprocess_batch,
)
from efficientvideoclassification_youtube8m_tpu.ops.preprocess import (
    host_subsample,
    student_num_frames,
)
from efficientvideoclassification_youtube8m_tpu.utils.config import TrainConfig


class Predictor:
    def __init__(self, cfg: TrainConfig, params, tower: str = "student",
                 serve_batch: int = 256, mesh=None,
                 sequence_parallel: bool = False, quantize: str = "none",
                 fetch_depth: int = 4):
        assert tower in ("student", "teacher")
        if quantize not in ("none", "int8"):
            raise ValueError(f"quantize must be 'none' or 'int8', got {quantize!r}")
        self.cfg = cfg
        self.tower = tower
        self.serve_batch = serve_batch
        # in-flight dispatch depth of predict()'s chunk ring (lag-N)
        self.fetch_depth = fetch_depth
        # student requests are strided on the HOST (predict below), so
        # only 1/every_n of the uint8 bytes cross the host->device edge
        self._host_stride = cfg.every_n if tower == "student" else 1

        if quantize == "int8":
            self._fwd = self._build_int8_fwd(cfg, params, tower,
                                             mesh, sequence_parallel)
        elif sequence_parallel:
            self._fwd = self._build_sequence_parallel_fwd(cfg, mesh, tower)
            self.params = jax.device_put(params)
        elif mesh is not None:
            # data-parallel serving: replicated params, batch rows over
            # "data", one explicit per-device program (shard_map)
            from jax.sharding import PartitionSpec as P

            def local_fwd(params, features_u8, num_frames):
                if tower == "student":
                    # features arrive host-strided to every_n already
                    nfs = student_num_frames(num_frames, cfg.every_n,
                                             cfg.max_num_frames)
                    xs = preprocess_batch(cfg, features_u8, nfs)
                    out = forward_student(cfg, params, xs, nfs,
                                          inference=True)
                else:
                    model_input = preprocess_batch(cfg, features_u8,
                                                   num_frames)
                    out = forward_teacher(cfg, params, model_input,
                                          num_frames, inference=True)
                return out["predictions"]

            mapped = jax.shard_map(
                local_fwd, mesh=mesh,
                in_specs=(P(), P("data", None, None), P("data")),
                out_specs=P("data", None), check_vma=False,
            )
            self.params = jax.device_put(params)
            self._fwd = jax.jit(mapped)
        else:
            self.params = jax.device_put(params)

            def fwd(params, features_u8, num_frames):
                if tower == "student":
                    # features arrive host-strided to every_n already
                    nfs = student_num_frames(num_frames, cfg.every_n,
                                             cfg.max_num_frames)
                    xs = preprocess_batch(cfg, features_u8, nfs)
                    out = forward_student(cfg, params, xs, nfs,
                                          inference=True)
                else:
                    model_input = preprocess_batch(cfg, features_u8,
                                                   num_frames)
                    out = forward_teacher(cfg, params, model_input,
                                          num_frames, inference=True)
                return out["predictions"]

            self._fwd = jax.jit(fwd)

    def _build_int8_fwd(self, cfg: TrainConfig, params, tower: str,
                        mesh, sequence_parallel: bool):
        """int8 weight+activation forward (ops/quantize.py): both LSTM
        matmul sites and the MoE head run int8 x int8 -> int32; gate math
        stays f32. Params are quantized ONCE here (per-channel scales)
        and live on device as int8 — half the bytes of bf16 weights."""
        from efficientvideoclassification_youtube8m_tpu.ops.quantize import (
            quantize_hierarchical_params,
            quantized_hierarchical_forward,
        )

        if sequence_parallel:
            raise ValueError(
                "quantize='int8' + sequence_parallel is not supported")
        if (cfg.model != "HierarchicalLstmModel"
                or cfg.video_level_classifier_model != "MoeModel"):
            raise ValueError(
                "quantize='int8' covers the flagship "
                "HierarchicalLstmModel + MoeModel configuration"
            )
        num_chunks = (cfg.num_inputs_L1 if tower == "student"
                      else cfg.num_inputs_to_lstm)
        self.params = jax.device_put(quantize_hierarchical_params(
            params, cfg.total_feature_size, cfg.lstm_cells, cfg.lstm_layers
        ))

        def fwd(qparams, features_u8, num_frames):
            if tower == "student":
                # features arrive host-strided to every_n already
                num_frames = student_num_frames(num_frames, cfg.every_n,
                                                cfg.max_num_frames)
            model_input = preprocess_batch(cfg, features_u8, num_frames)
            return quantized_hierarchical_forward(
                qparams, model_input, num_frames, num_chunks,
                cfg.num_classes, cfg.moe_num_mixtures,
                scan_unroll=cfg.scan_unroll,
            )

        if mesh is None:
            return jax.jit(fwd)
        # data-parallel int8 serving: replicated int8 params, batch rows
        # over "data"
        from jax.sharding import PartitionSpec as P

        mapped = jax.shard_map(
            fwd, mesh=mesh,
            in_specs=(P(), P("data", None, None), P("data")),
            out_specs=P("data", None), check_vma=False,
        )
        return jax.jit(mapped)

    @staticmethod
    def _build_sequence_parallel_fwd(cfg: TrainConfig, mesh, tower: str):
        """Chunk-axis-sharded forward (parallel/sequence_parallel.py): the
        long-video/low-batch layout. Flagship hierarchical model only."""
        from efficientvideoclassification_youtube8m_tpu.models import get_model
        from efficientvideoclassification_youtube8m_tpu.parallel import (
            create_mesh,
        )
        from efficientvideoclassification_youtube8m_tpu.parallel.sequence_parallel import (
            build_sequence_parallel_state_fn,
        )

        if cfg.model != "HierarchicalLstmModel":
            raise ValueError(
                "sequence-parallel serving requires HierarchicalLstmModel"
            )
        mesh = mesh if mesh is not None else create_mesh()
        num_chunks = (cfg.num_inputs_L1 if tower == "student"
                      else cfg.num_inputs_to_lstm)
        compute_dtype = (jnp.bfloat16 if cfg.compute_dtype == "bfloat16"
                         else jnp.float32)
        state_fn = build_sequence_parallel_state_fn(
            cfg, mesh, num_chunks=num_chunks, compute_dtype=compute_dtype
        )
        cls = get_model(cfg.video_level_classifier_model)
        cls_kwargs = (
            {"num_mixtures": cfg.moe_num_mixtures}
            if cfg.video_level_classifier_model == "MoeModel"
            else {"num_hidden_units": cfg.num_hidden_units}
        )

        @jax.jit
        def fwd(params, features_u8, num_frames):
            if tower == "student":
                # features arrive host-strided to every_n already
                num_frames = student_num_frames(num_frames, cfg.every_n,
                                                cfg.max_num_frames)
            model_input = preprocess_batch(cfg, features_u8, num_frames)
            state = state_fn(params["rnn_l1"], params["rnn_l2"],
                             model_input, num_frames)
            out = cls.apply(
                params["classifier"], state, vocab_size=cfg.num_classes,
                compute_dtype=compute_dtype, **cls_kwargs,
            )
            return out["predictions"]

        return fwd

    @classmethod
    def from_checkpoint(
        cls,
        train_dir: str,
        cfg: Optional[TrainConfig] = None,
        tower: str = "student",
        serve_batch: int = 256,
        mesh=None,
        sequence_parallel: bool = False,
        quantize: str = "none",
    ) -> "Predictor":
        """Load the latest checkpoint from a (finetune or distillation)
        train_dir. Finetune checkpoints carry only the student."""
        cfg = cfg or TrainConfig()
        ckpt = latest_checkpoint(train_dir)
        if ckpt is None:
            raise IOError(f"no checkpoint in {train_dir}")
        opt = make_optimizer(cfg.optimizer, cfg.clip_gradient_norm)
        distill_template = init_distill_state(cfg, opt)
        if tower == "teacher":
            # distillation checkpoints only (msgpack or reference TF);
            # a student-only probe would FALSELY succeed on TF bundles
            # (both towers' variables share one bundle)
            try:
                state = restore_checkpoint(ckpt, distill_template)
            except (KeyError, ValueError) as e:
                # KeyError: TF bundle missing teacher vars; ValueError:
                # msgpack/orbax tree mismatch — all mean the same thing
                raise ValueError(
                    f"{ckpt} is a student-only checkpoint; no teacher tower"
                ) from e
            params = state.params_teacher
        else:
            try:
                state = restore_checkpoint(
                    ckpt, student_state_from_distill(distill_template, opt)
                )
            except (KeyError, ValueError):
                # a distillation checkpoint: take its student subtree
                state = restore_checkpoint(ckpt, distill_template)
            params = state.params_student
        return cls(cfg, params, tower, serve_batch, mesh=mesh,
                   sequence_parallel=sequence_parallel, quantize=quantize)

    def predict(self, features_u8: np.ndarray, num_frames: np.ndarray
                ) -> np.ndarray:
        """features_u8 [B, max_frames, D] uint8, num_frames [B] ->
        probabilities [B, vocab]. Requests are padded to serve_batch so
        any B reuses one compiled program.

        Multi-chunk requests are PIPELINED with a lag-N ring: several
        chunks stay dispatched in flight and only the oldest result is
        pulled to the host, so the H2D transfer, device compute, and
        per-launch dispatch + D2H latency of N consecutive chunks
        overlap (jax dispatch is async) — the same ring the CLI eval
        loops use. FIFO drain keeps output order identical."""
        B = features_u8.shape[0]
        if self._host_stride > 1:
            features_u8 = host_subsample(features_u8, self._host_stride)
        out = []
        ring: deque = deque()  # (device preds, valid row count)
        depth = max(1, self.fetch_depth)
        for start in range(0, B, self.serve_batch):
            chunk = features_u8[start : start + self.serve_batch]
            nf = num_frames[start : start + self.serve_batch]
            n = chunk.shape[0]
            if n < self.serve_batch:
                pad = self.serve_batch - n
                chunk = np.concatenate(
                    [chunk, np.zeros((pad,) + chunk.shape[1:], chunk.dtype)]
                )
                nf = np.concatenate([nf, np.zeros(pad, nf.dtype)])
            ring.append(
                (self._fwd(self.params, jnp.asarray(chunk), jnp.asarray(nf)),
                 n))
            # pop only when MORE than `depth` are in flight: `>=` kept
            # depth-1 launches outstanding (depth=1 degenerated to a
            # fully synchronous loop) — same convention as the CLI rings
            if len(ring) > depth:
                done = ring.popleft()
                out.append(np.asarray(done[0])[: done[1]])
        while ring:
            done = ring.popleft()
            out.append(np.asarray(done[0])[: done[1]])
        return np.concatenate(out, axis=0) if out else np.zeros(
            (0, self.cfg.num_classes), np.float32)

    def predict_topk(self, features_u8, num_frames, k: int = 20
                     ) -> Tuple[np.ndarray, np.ndarray]:
        probs = self.predict(features_u8, num_frames)
        idx = np.argpartition(probs, -k, axis=1)[:, -k:]
        rows = np.arange(probs.shape[0])[:, None]
        vals = probs[rows, idx]
        order = np.argsort(-vals, axis=1)
        return vals[rows, order], idx[rows, order]
