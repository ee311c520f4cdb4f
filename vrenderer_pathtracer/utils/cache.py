"""Where JAX keeps its persistent compilation cache.

The cache's path is part of its key, so it must not move between runs: it
is ``JAX_COMPILATION_CACHE_DIR`` when that variable is set (JAX reads it
itself, and this module sets nothing else), and otherwise the fixed
``<checkout>/.jax_cache``.
"""

from __future__ import annotations

import os
import pathlib

import jax

CHECKOUT = pathlib.Path(__file__).resolve().parents[2]
DEFAULT_DIR = CHECKOUT / ".jax_cache"


def enable_compile_cache() -> str:
    """Turn on the persistent compilation cache; returns its directory."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    jax.config.update("jax_compilation_cache_dir", str(DEFAULT_DIR))
    return str(DEFAULT_DIR)
