"""Persistent XLA compile cache: one rule for every entry point.

If `JAX_COMPILATION_CACHE_DIR` is set, JAX reads it itself and this code
sets no directory. Otherwise the cache lives at a fixed path inside the
checkout (`<repo>/.jax_cache`, listed in .gitignore): the path is part of
the cache key, so a directory that moves would never hit.
"""
from __future__ import annotations

import os

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), ".jax_cache")


def setup_compile_cache(min_compile_secs: float = 1.0) -> str:
    """Enable the persistent cache; returns the directory in use."""
    import jax
    cache_dir = os.environ.get(ENV_VAR)
    if not cache_dir:
        cache_dir = DEFAULT_DIR
        jax.config.update("jax_compilation_cache_dir", cache_dir)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
    jax.config.update("jax_persistent_cache_min_compile_time_secs",
                      min_compile_secs)
    return cache_dir
