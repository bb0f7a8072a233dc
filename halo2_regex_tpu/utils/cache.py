"""Persistent JAX compilation cache.

Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX already keeps its cache
there and nothing else is set.  Otherwise the cache lives at a fixed path
inside the checkout (``<repo>/.jax_cache``, listed in ``.gitignore``): the
path is part of what a later process must find again, so it never depends
on a process id, the time or a temporary directory.

Disable with ``H2R_NO_COMPILE_CACHE=1``.
"""

from __future__ import annotations

import os
from pathlib import Path

DEFAULT_DIR = Path(__file__).resolve().parents[2] / ".jax_cache"


def cache_dir() -> str | None:
    """The directory the cache uses, or None when disabled."""
    if os.environ.get("H2R_NO_COMPILE_CACHE") == "1":
        return None
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or str(DEFAULT_DIR)


def enable_compilation_cache() -> str | None:
    """Point JAX at the persistent compilation cache. Returns the dir or
    None when disabled."""
    path = cache_dir()
    if path is None:
        return None
    import jax

    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        os.makedirs(path, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", path)
    # GPU compiles take seconds: keep every entry.
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0)
    return path
