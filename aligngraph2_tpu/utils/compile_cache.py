"""JAX's persistent compile cache, in one place for every entry point.

``JAX_COMPILATION_CACHE_DIR``, when set, is the cache and nothing else
is set.  Otherwise the cache is ``.jax_cache`` at the root of the
checkout (listed in .gitignore): a fixed path, because the path is part
of what makes a cached entry found again.
"""

from __future__ import annotations

import os

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def compile_cache_dir() -> str:
    return (os.environ.get("JAX_COMPILATION_CACHE_DIR")
            or os.path.join(REPO_ROOT, ".jax_cache"))


def enable_compile_cache() -> str:
    """Point JAX at compile_cache_dir(); returns it."""
    import jax
    path = compile_cache_dir()
    jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
    return path
