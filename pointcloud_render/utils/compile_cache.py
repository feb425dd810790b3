"""The persistent compile cache."""

from __future__ import annotations

import os

import jax

#: The compile cache's home when JAX_COMPILATION_CACHE_DIR is unset: one
#: fixed path inside the checkout (the path is part of the cache key, so
#: a directory that moves never hits).  Listed in .gitignore.
DEFAULT_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), ".jax_cache")


def enable_compile_cache() -> str:
    """Turn on JAX's persistent compile cache; returns its directory.

    If ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and
    nothing is set here; otherwise the cache goes to DEFAULT_CACHE_DIR.
    Entry points (the CLI, bench.py, chip_smoke.py) call this once.
    """
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    jax.config.update("jax_compilation_cache_dir", DEFAULT_CACHE_DIR)
    return DEFAULT_CACHE_DIR
