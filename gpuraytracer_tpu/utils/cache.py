"""Persistent XLA compilation cache setup.

Compiling the kernels takes seconds to minutes per configuration; the
persistent cache makes that a one-time cost per (configuration, machine).
Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX already keeps its cache
there and nothing here overrides it; otherwise the cache lives at the
fixed in-checkout ``.jax_cache``. Called by the CLI and bench entry
points; library code never mutates global config.
"""
from __future__ import annotations

import os

DEFAULT_CACHE_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))), ".jax_cache")


def cache_dir() -> str:
    """The directory the compilation cache uses."""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or DEFAULT_CACHE_DIR


def enable_compilation_cache() -> str:
    import jax

    path = cache_dir()
    os.makedirs(path, exist_ok=True)
    if "JAX_COMPILATION_CACHE_DIR" not in os.environ:
        jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 5.0)
    return path
