"""Persistent XLA compilation cache at one fixed place.

The fused pipeline takes tens of seconds to compile, and every harness
rebuilds the same programs. The cache key includes the directory, so
the directory must not move between runs: it is either the one
``JAX_COMPILATION_CACHE_DIR`` names (JAX reads that variable itself, so
nothing is set here) or ``<checkout>/.jax_cache/``, which git ignores.

Reference has no analog (single-process NumPy/CuPy, no compile step).
"""

from __future__ import annotations

import os

REPO_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), ".jax_cache")


def enable_persistent_cache(min_compile_secs: float = 5.0) -> str:
    """Turn on JAX's persistent compiled-program cache; returns its path.

    Call BEFORE the first jit compilation.
    """
    import jax

    path = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if not path:
        path = REPO_CACHE_DIR
        os.makedirs(path, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs",
                      float(min_compile_secs))
    return path
