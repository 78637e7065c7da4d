"""Where JAX keeps its persistent compilation cache.

`JAX_COMPILATION_CACHE_DIR`, when set, wins and nothing else is set in
code (JAX reads the variable itself). Otherwise the cache lives at one
fixed path inside the checkout, `<repo>/.jax_cache/` (listed in
`.gitignore`): a path that changed between runs (a temporary name, a
process id) would never find what an earlier run compiled.
"""

from __future__ import annotations

import os

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache",
)


def enable_compilation_cache() -> str:
    """Point JAX's persistent compilation cache at its directory (call
    before the first compile) and return that directory."""
    env_dir = os.environ.get(ENV_VAR)
    if env_dir:
        return env_dir
    import jax

    jax.config.update("jax_compilation_cache_dir", DEFAULT_DIR)
    return DEFAULT_DIR
