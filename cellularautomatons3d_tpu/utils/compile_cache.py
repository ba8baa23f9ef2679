"""Where compiled programs are cached between runs."""

from __future__ import annotations

import os
from pathlib import Path

import jax

__all__ = ["enable_compile_cache"]

# A fixed directory inside the checkout: the cache key includes the path,
# so a directory that moves between runs never hits.
DEFAULT_DIR = Path(__file__).resolve().parents[2] / ".jax_cache"


def enable_compile_cache() -> str:
    """Turn on JAX's persistent compile cache and return its directory.

    ``JAX_COMPILATION_CACHE_DIR``, when set, is used as it is (JAX reads it
    itself) and nothing else is set.  Otherwise the cache goes to
    ``.jax_cache/`` at the root of the checkout."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    jax.config.update("jax_compilation_cache_dir", str(DEFAULT_DIR))
    return str(DEFAULT_DIR)
