"""utils/compile_cache.py: JAX_COMPILATION_CACHE_DIR wins; otherwise one
fixed directory inside the checkout."""

import os
import tempfile

import jax

from efficientvideoclassification_youtube8m_tpu.utils import compile_cache

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))


def test_env_var_is_honoured_and_nothing_else_set(monkeypatch):
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "/some/shared/cache")
    assert compile_cache.enable_compilation_cache() == "/some/shared/cache"
    assert jax.config.jax_compilation_cache_dir == before


def test_default_is_fixed_inside_the_checkout(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    got = compile_cache.enable_compilation_cache()
    assert got == os.path.join(REPO, ".jax_cache")
    assert jax.config.jax_compilation_cache_dir == got
    # the same path on every call: no pid, time or temporary name in it
    assert compile_cache.enable_compilation_cache() == got
    assert not got.startswith(tempfile.gettempdir())


def test_cache_dir_is_gitignored():
    with open(os.path.join(REPO, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()
