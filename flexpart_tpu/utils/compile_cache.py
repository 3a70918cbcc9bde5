"""Persistent XLA compilation cache.

Compiling the met pipeline and the advance kernel at REF1 size is a
large share of a cold run, so the entry points (CLI, benchmarks, chip
smoke test) keep compiled programs on disk.  The cache path is part of
the cache key, so it is a fixed directory: `JAX_COMPILATION_CACHE_DIR`
when the environment sets it (JAX reads that variable itself), else
`<repo>/.jax_cache`.
"""

from __future__ import annotations

import os
from pathlib import Path

import jax

REPO_CACHE_DIR = Path(__file__).resolve().parents[2] / ".jax_cache"


def enable_compile_cache() -> str:
    """Point JAX's persistent compilation cache at its fixed directory
    and return that directory."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    jax.config.update("jax_compilation_cache_dir", str(REPO_CACHE_DIR))
    return str(REPO_CACHE_DIR)
