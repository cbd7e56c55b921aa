"""Persistent XLA compile cache shared by every entry point.

The front-end compiles one program per image geometry, which takes tens of
seconds to minutes; the persistent cache turns reruns into cache hits.  The
cache key includes the directory, so it must not move between runs.
"""

from __future__ import annotations

import os

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
REPO_ROOT = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)
# fixed directory inside the checkout (listed in .gitignore)
DEFAULT_DIR = os.path.join(REPO_ROOT, ".jax_cache")


def setup_compile_cache() -> str:
    """Enable the persistent compile cache and return its directory.

    When JAX_COMPILATION_CACHE_DIR is set, JAX reads it itself and no
    directory is set here; otherwise the cache lives in DEFAULT_DIR."""
    import jax

    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    env = os.environ.get(ENV_VAR)
    if env:
        return env
    jax.config.update("jax_compilation_cache_dir", DEFAULT_DIR)
    return DEFAULT_DIR
