"""Persistent XLA compilation cache.

Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX already keeps its cache
there and this module sets no other directory.  Otherwise the cache lives
in a fixed directory inside the checkout (``.jax_cache/``, git-ignored):
the directory is part of the cache's key, so a path that moved between
runs would never hit.  Called by the CLI, bench and scripts (not on
library import).
"""

from __future__ import annotations

import os

CHECKOUT_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))),
    ".jax_cache")


def compile_cache_dir(environ=os.environ) -> str | None:
    """The directory this module would configure, or None where the
    environment already names one."""
    if environ.get("JAX_COMPILATION_CACHE_DIR"):
        return None
    return CHECKOUT_CACHE_DIR


def enable_compile_cache() -> None:
    import jax

    path = compile_cache_dir()
    if path is not None:
        os.makedirs(path, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
