"""JAX framework for efficient video classification on YouTube-8M.

A from-scratch JAX/XLA re-design of the capabilities of
shwetabhardwaj44/EfficientVideoClassification_Youtube8M (CVPR'19
"Efficient Video Classification Using Fewer Frames"): teacher-student
distillation of hierarchical LSTM video classifiers, trained and served
on NVIDIA GPUs via `jit` over `jax.sharding.Mesh`.

Layering (bottom-up):
  data/     TFRecord + SequenceExample IO without TensorFlow (C++ hot path)
  ops/      compute primitives: TF1-semantics LSTM scan, preprocessing,
            int8 quantized inference
  models/   frame-level + video-level model zoo and registry
  losses    pure-function loss registry (9 losses)
  metrics/  Hit@1 / PERR / GAP / mAP machinery
  parallel/ mesh construction + sharding rules (dp/tp/sp)
  train/    jitted train/eval steps, optimizer schedules, checkpointing
  cli/      entry-point binaries mirroring the reference flag surface
"""

__version__ = "0.1.0"
