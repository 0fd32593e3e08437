"""Where JAX keeps its persistent compilation cache.

Entry points call :func:`setup_compile_cache` before their first compile.
If ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and nothing is
set here.  Otherwise the cache goes to ``<repo>/.jax_cache`` (git-ignored):
a fixed path, because the path is part of what a cached entry is found by.
"""

from __future__ import annotations

import os
from pathlib import Path

import jax

REPO_CACHE_DIR = Path(__file__).resolve().parents[2] / ".jax_cache"


def setup_compile_cache() -> Path:
    """Point JAX's persistent cache at its directory; return that path."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return Path(env)
    jax.config.update("jax_compilation_cache_dir", str(REPO_CACHE_DIR))
    return REPO_CACHE_DIR
