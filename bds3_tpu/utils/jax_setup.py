"""JAX runtime configuration helpers."""
from __future__ import annotations

import os

# <checkout>/.xla_cache: a fixed path, since the path is part of the key
REPO_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), ".xla_cache")


def compilation_cache_dir() -> str:
    """The persistent compile-cache directory: JAX_COMPILATION_CACHE_DIR
    when set, else `.xla_cache/` inside the checkout."""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or REPO_CACHE_DIR


def enable_compilation_cache() -> str:
    """Turn on JAX's persistent compilation cache so repeated runs skip
    recompiling; returns the directory in use."""
    import jax

    cache_dir = compilation_cache_dir()
    os.makedirs(cache_dir, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", cache_dir)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
    return cache_dir
