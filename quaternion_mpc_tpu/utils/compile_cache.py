"""Persistent XLA compilation cache shared by every entry point.

A directory given in ``JAX_COMPILATION_CACHE_DIR`` is used as it is, and no
other is configured. Without it the cache lives at the fixed
``<repo>/.jax_cache`` (listed in ``.gitignore``): the path is part of what
makes a later run find the entries, so it never depends on the process, the
time or a temporary directory.
"""

from __future__ import annotations

import os
import pathlib

REPO_CACHE_DIR = pathlib.Path(__file__).resolve().parents[2] / ".jax_cache"


def cache_dir() -> str:
    """The directory the persistent compilation cache uses."""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or str(REPO_CACHE_DIR)


def enable_compile_cache() -> str:
    """Point JAX's persistent compilation cache at `cache_dir()` and cache
    every program that takes at least half a second to compile. Returns the
    directory."""
    import jax

    path = cache_dir()
    jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
    return path
