"""The in-repo msgpack checkpoint codec (train/serialization.py) against
flax.serialization: the same bytes for every tree kind the repo
checkpoints, and flax-written bytes restore through the codec."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from efficientvideoclassification_youtube8m_tpu.train import serialization
from efficientvideoclassification_youtube8m_tpu.train.optimizer import (
    TfAdamState,
)
from efficientvideoclassification_youtube8m_tpu.utils.config import TrainConfig

TINY = TrainConfig(num_classes=12, lstm_cells=4, lstm_layers=2,
                   max_num_frames=8, num_inputs_to_lstm=2, num_inputs_L1=2,
                   every_n=2, feature_sizes="3, 2")


def _distill_state():
    from efficientvideoclassification_youtube8m_tpu.train import (
        init_distill_state,
        make_optimizer,
    )

    opt = make_optimizer(TINY.optimizer, TINY.clip_gradient_norm)
    return jax.device_get(init_distill_state(TINY, opt))


def _student_state():
    from efficientvideoclassification_youtube8m_tpu.train import (
        make_optimizer,
        student_state_from_distill,
    )

    opt = make_optimizer(TINY.optimizer, TINY.clip_gradient_norm)
    return jax.device_get(student_state_from_distill(_distill_state(), opt))


TREES = {
    "nested_dicts": lambda: {
        "a": {"w": np.arange(6, dtype=np.float32).reshape(2, 3),
              "b": np.zeros((0,), np.int32)},
        "z": {"deep": {"x": np.ones((2, 2, 2), np.float64)}},
    },
    "tf_adam_state": lambda: TfAdamState(
        count=np.asarray(3, np.int32),
        mu={"w": np.full((4,), 0.5, np.float32)},
        nu={"w": np.full((4,), 0.25, np.float32)},
    ),
    "bf16_and_int8_arrays": lambda: {
        "bf16": jnp.arange(5, dtype=jnp.bfloat16),
        "i8": np.asarray([-128, 0, 127], np.int8),
        "u8": np.arange(300, dtype=np.int32).astype(np.uint8),
    },
    "scalars": lambda: {
        "model": "MoeModel", "input_size": 1152, "num_models": 3,
        "neg": -40000, "big": 2**40, "f": 0.125, "flag": True,
        "none": None, "np_int": np.int64(7), "np_f32": np.float32(1.5),
        "bytes": b"\x00\x01",
    },
    "lists_and_tuples": lambda: {
        "cells": [{"kernel": np.ones((2, 4), np.float32)},
                  {"kernel": np.zeros((3, 4), np.float32)}],
        "pair": (np.asarray(1.0, np.float32), np.asarray([2, 3], np.int64)),
    },
    "long_strings_and_maps": lambda: {
        f"key_{i:03d}": "x" * (i * 7) for i in range(40)
    },
    "distill_state": _distill_state,
    "student_state": _student_state,
}


def _as_flax_tree(tree):
    """The same tree with each state dataclass rebuilt as the
    flax.struct dataclass the checkpoints were written from before."""
    import dataclasses

    import flax.struct

    if not dataclasses.is_dataclass(tree):
        return tree
    fields = [f.name for f in dataclasses.fields(tree)]
    flax_cls = flax.struct.dataclass(
        type(type(tree).__name__, (), {"__annotations__": {
            f: object for f in fields}}))
    return flax_cls(**{f: getattr(tree, f) for f in fields})


@pytest.mark.parametrize("kind", sorted(TREES))
def test_codec_bytes_equal_flax(kind):
    flax_ser = pytest.importorskip("flax.serialization")
    tree = TREES[kind]()
    assert serialization.to_bytes(tree) == flax_ser.to_bytes(
        _as_flax_tree(tree))


@pytest.mark.parametrize("kind", sorted(TREES))
def test_flax_bytes_restore_through_codec(kind):
    flax_ser = pytest.importorskip("flax.serialization")
    tree = TREES[kind]()
    restored = serialization.from_bytes(
        tree, flax_ser.to_bytes(_as_flax_tree(tree)))
    assert jax.tree.structure(restored) == jax.tree.structure(tree)
    for got, want in zip(jax.tree.leaves(restored), jax.tree.leaves(tree)):
        want = np.asarray(want)
        assert np.asarray(got).dtype == want.dtype
        np.testing.assert_array_equal(np.asarray(got), want)


def test_chunked_large_arrays_match_flax(monkeypatch):
    """Arrays above the chunk limit are split into flat pieces on write
    and stitched together on read — same layout as flax's."""
    flax_ser = pytest.importorskip("flax.serialization")
    monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 64)
    monkeypatch.setattr(flax_ser, "MAX_CHUNK_SIZE", 64)
    tree = {"big": np.arange(50, dtype=np.float32).reshape(5, 10),
            "small": np.arange(3, dtype=np.float32)}
    ours = serialization.to_bytes(tree)
    assert ours == flax_ser.to_bytes(tree)
    back = serialization.msgpack_restore(flax_ser.to_bytes(tree))
    np.testing.assert_array_equal(back["big"], tree["big"])
    np.testing.assert_array_equal(flax_ser.msgpack_restore(ours)["big"],
                                  tree["big"])


def test_restore_rejects_mismatched_tree():
    """A student-only template against a distillation checkpoint (and
    the reverse) raises ValueError — serving.from_checkpoint relies on
    it to tell the two apart."""
    data = serialization.to_bytes(_distill_state())
    with pytest.raises(ValueError):
        serialization.from_bytes(_student_state(), data)
    with pytest.raises(ValueError):
        serialization.from_bytes(_distill_state(),
                                 serialization.to_bytes(_student_state()))


def test_codec_needs_no_flax_or_msgpack():
    """cli.train, cli.eval, serving and train.checkpoint import neither
    flax nor msgpack."""
    import subprocess
    import sys

    code = (
        "import sys\n"
        "import efficientvideoclassification_youtube8m_tpu.cli.train\n"
        "import efficientvideoclassification_youtube8m_tpu.cli.eval\n"
        "import efficientvideoclassification_youtube8m_tpu.serving\n"
        "import efficientvideoclassification_youtube8m_tpu.train.checkpoint\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('flax', 'msgpack')]\n"
        "assert not bad, bad\n"
    )
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120)


def test_orbax_missing_raises_clear_error(monkeypatch):
    """orbax is optional: without it, --checkpoint_format orbax fails with
    a message that names the fix instead of a bare import error."""
    import sys

    import pytest

    from efficientvideoclassification_youtube8m_tpu.train import checkpoint

    monkeypatch.setitem(sys.modules, "orbax", None)
    monkeypatch.setitem(sys.modules, "orbax.checkpoint", None)
    with pytest.raises(ImportError, match="--checkpoint_format msgpack"):
        checkpoint.save_checkpoint("/nonexistent/unused", {"x": np.ones(2)},
                                   1, backend="orbax")
