"""Test harness: an 8-device virtual CPU platform, set BEFORE jax imports.

Every sharding/collective test runs over a real 8-device mesh on the CPU;
the same code paths compile for the GPU. What needs the card runs in
`chip_smoke.py` instead.
"""

import os

os.environ["JAX_PLATFORMS"] = "cpu"
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()

# Persistent compilation cache (utils/compile_cache.py: the env var if
# set, else the checkout's .jax_cache/) keeps repeated runs fast; cache
# even the cheap tiny-shape programs the tests compile.
os.environ.setdefault("JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS", "0")
os.environ.setdefault("JAX_PERSISTENT_CACHE_MIN_ENTRY_SIZE_BYTES", "0")

from efficientvideoclassification_youtube8m_tpu.utils.compile_cache import (  # noqa: E402
    enable_compilation_cache,
)

enable_compilation_cache()
