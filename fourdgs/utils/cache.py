"""Persistent compilation cache for the entry points.

Every script that compiles the pipeline (chip_smoke.py, bench*.py,
validate_kernels.py, the viewer) calls `enable_compile_cache()` before its
first compile. Where JAX_COMPILATION_CACHE_DIR is set, JAX reads it itself
and nothing is set here; otherwise the cache lives at a fixed directory in
the checkout, so that a later run of the same checkout finds it again.
"""

from __future__ import annotations

import os

import jax

CHECKOUT_CACHE = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), ".jax_cache")


def enable_compile_cache() -> str:
    """Turn the persistent compilation cache on; returns its directory."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    jax.config.update("jax_compilation_cache_dir", CHECKOUT_CACHE)
    return CHECKOUT_CACHE
