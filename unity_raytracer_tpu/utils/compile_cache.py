"""Where JAX keeps its persistent compilation cache.

``JAX_COMPILATION_CACHE_DIR`` wins when it is set; otherwise the cache
goes to ``<checkout>/.jax_cache`` (git-ignored), a fixed path, so that
processes of one checkout share compiled programs.
"""

from __future__ import annotations

import os
import pathlib

ENV = "JAX_COMPILATION_CACHE_DIR"
DEFAULT_DIR = pathlib.Path(__file__).resolve().parents[2] / ".jax_cache"


def cache_dir() -> str:
    return os.environ.get(ENV) or str(DEFAULT_DIR)


def enable_compile_cache() -> str:
    """Point JAX's persistent cache at ``cache_dir()`` and cache every
    program that took at least a second to compile. Returns the path."""
    import jax

    path = cache_dir()
    jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    return path
