"""Where JAX keeps its persistent compilation cache.

JAX reads ``JAX_COMPILATION_CACHE_DIR`` itself; when it is set nothing is
changed here.  Otherwise the cache goes to ``<repo>/.jax_cache`` (listed
in .gitignore): a fixed path, because the path is part of the cache key,
so consecutive runs from one checkout reuse each other's compiles.
"""

from __future__ import annotations

import os

CACHE_ENV = "JAX_COMPILATION_CACHE_DIR"
REPO_CACHE = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache",
)


def enable_compile_cache() -> str:
    """Point JAX's persistent compilation cache at its directory and
    return that directory.  Call before the first compile."""
    env = os.environ.get(CACHE_ENV)
    if env:
        return env
    import jax

    jax.config.update("jax_compilation_cache_dir", REPO_CACHE)
    return REPO_CACHE
