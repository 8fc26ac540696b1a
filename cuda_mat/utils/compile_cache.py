"""Placement of JAX's persistent compilation cache.

Compiling the solver loops for the GPU takes seconds to minutes per shape, so
every entry point (``cuda_mat.cli``, ``chip_smoke.py``, ``bench.py``,
``benchmarks/weak_scaling.py``) keeps compiled programs across processes
through :func:`enable_compile_cache`.
"""

from __future__ import annotations

import os

import jax

CHECKOUT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
DEFAULT_DIR = os.path.join(CHECKOUT, ".jax_cache")   # listed in .gitignore


def enable_compile_cache() -> str:
    """Return the compile-cache directory in use.

    When ``JAX_COMPILATION_CACHE_DIR`` is set, JAX already reads it and
    nothing else is set here.  Otherwise the cache goes to the fixed
    in-checkout directory :data:`DEFAULT_DIR` — never a temporary or
    per-process path, so a later process finds what an earlier one
    compiled."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    jax.config.update("jax_compilation_cache_dir", DEFAULT_DIR)
    return DEFAULT_DIR
