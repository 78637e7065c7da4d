"""Explicit sequence parallelism for the hierarchical LSTM.

The reference's sequence-scaling mechanism is the two-level hierarchy:
300 frames = 20 independent 15-frame L1 blocks (SURVEY.md §5
"long-context"). Under pure DP those blocks parallelize via the folded
batch axis; THIS module shards the BLOCK axis itself across the mesh —
each device runs L1 on its slice of every video's chunks, one
`all_gather` assembles the 20 block states, and the (tiny)
20-step L2 runs replicated. Useful when the batch is small relative to
the device count (long-video / low-latency serving).

Frame axis sharding: [B, 300, D] with T split in whole chunks, so the
mesh's data axis must divide num_chunks (20 % {2,4,5,10,20} == 0).
"""

from __future__ import annotations

from typing import Any

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from efficientvideoclassification_youtube8m_tpu.ops.lstm import multi_lstm_scan
from efficientvideoclassification_youtube8m_tpu.parallel.mesh import (
    DATA_AXIS,
    Mesh,
)
from efficientvideoclassification_youtube8m_tpu.utils.config import TrainConfig


def build_sequence_parallel_state_fn(
    cfg: TrainConfig,
    mesh: Mesh,
    num_chunks: int = None,
    compute_dtype: Any = jnp.float32,
):
    """fn(rnn_l1_params, rnn_l2_params, features_f32, num_frames) ->
    hierarchical state [B, layers*2*cells], with the chunk axis sharded
    over the mesh's data axis. Input features are the PREPROCESSED
    [B, T, D] floats (replicated); output state is replicated.
    """
    num_chunks = num_chunks or cfg.num_inputs_to_lstm
    ndev = mesh.shape[DATA_AXIS]
    if num_chunks % ndev:
        raise ValueError(
            f"num_chunks={num_chunks} not divisible by data axis {ndev}"
        )
    local_chunks = num_chunks // ndev

    def local_fn(rnn_l1, rnn_l2, x_local, num_frames):
        # x_local: [B, T/ndev, D] — this device's contiguous chunk slice
        B, t_local, D = x_local.shape
        chunk_len = t_local // local_chunks
        dev = jax.lax.axis_index(DATA_AXIS)

        x_chunks = x_local.reshape(B * local_chunks, chunk_len, D)
        chunk_ids = dev * local_chunks + jnp.arange(local_chunks, dtype=jnp.int32)
        starts = chunk_len * chunk_ids
        seq_l1 = jnp.clip(
            num_frames.astype(jnp.int32)[:, None] - starts[None, :],
            0,
            chunk_len,
        ).reshape(B * local_chunks)
        l1_state = multi_lstm_scan(
            rnn_l1, x_chunks, seq_l1, compute_dtype=compute_dtype,
            unroll=cfg.scan_unroll,
        )  # [B*local_chunks, S]
        l1_state = l1_state.reshape(B, local_chunks, -1)

        # ONE collective: assemble all block states on every device
        gathered = jax.lax.all_gather(
            l1_state, DATA_AXIS, axis=1, tiled=True
        )  # [B, num_chunks, S]

        seq_l2 = jnp.ceil(
            num_frames.astype(jnp.float32) / float(chunk_len)
        ).astype(jnp.int32)
        state = multi_lstm_scan(
            rnn_l2, gathered, seq_l2, compute_dtype=compute_dtype,
            unroll=cfg.scan_unroll,
        )
        return state

    mapped = jax.shard_map(
        local_fn,
        mesh=mesh,
        in_specs=(P(), P(), P(None, DATA_AXIS, None), P()),
        out_specs=P(),
        check_vma=False,
    )
    return jax.jit(mapped)
