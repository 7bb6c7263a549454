"""Global compute configuration.

Plotfiles store float64; device compute defaults to float32.  Tools accept
``dtype=`` overrides; tests validate float32 results against float64 numpy
references with appropriate tolerances.

The persistent XLA compile cache lives where ``JAX_COMPILATION_CACHE_DIR``
says (JAX reads that variable itself), or else at ``<checkout>/.jax_cache``:
a fixed absolute path, so a run from any working directory finds the
programs an earlier run compiled.
"""
from __future__ import annotations

import os
from typing import Optional

import jax
import jax.numpy as jnp

compute_dtype = jnp.float32

CHECKOUT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def set_compute_dtype(dtype) -> None:
    global compute_dtype
    compute_dtype = dtype


def compile_cache_dir() -> Optional[str]:
    """The directory this program sets for the compile cache: None where
    ``JAX_COMPILATION_CACHE_DIR`` is set, else ``<checkout>/.jax_cache``."""
    if os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        return None
    return os.path.join(CHECKOUT, ".jax_cache")


def enable_compile_cache() -> Optional[str]:
    """Turn on the persistent compile cache (see the module docstring);
    returns the directory set, or None where the environment chose it."""
    cache = compile_cache_dir()
    if cache is not None:
        jax.config.update("jax_compilation_cache_dir", cache)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    return cache
