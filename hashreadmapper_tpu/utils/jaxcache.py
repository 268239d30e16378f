"""JAX's persistent compilation cache for this repository's entry points.

Where JAX_COMPILATION_CACHE_DIR is set, JAX reads it itself and nothing is
set here.  Otherwise the cache lives at the fixed path <repo>/.jax_cache
(listed in .gitignore): the path is part of each entry's key, so a fixed
directory is what lets a later process find what an earlier one compiled.
"""

from __future__ import annotations

import os

CACHE_DIR = os.path.abspath(os.path.join(
    os.path.dirname(__file__), os.pardir, os.pardir, ".jax_cache"))


def configure_compile_cache() -> str:
    """Point JAX's persistent cache at its directory; returns that path.
    Call before the first compilation."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax
    jax.config.update("jax_compilation_cache_dir", CACHE_DIR)
    # cache every executable, not only those that took over a second
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
    return CACHE_DIR
