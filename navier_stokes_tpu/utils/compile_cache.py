"""Where JAX keeps its persistent compilation cache.

A cold compile of a large Newton step takes tens of seconds; the cache lets
later processes reuse it.  The directory is part of the cache key, so it is
fixed: ``JAX_COMPILATION_CACHE_DIR`` when the environment sets it, otherwise
``.jax_cache`` at the root of this repository (listed in ``.gitignore``).
"""

from __future__ import annotations

import os
from pathlib import Path

__all__ = ["REPO_CACHE_DIR", "enable_compile_cache"]

REPO_CACHE_DIR = str(Path(__file__).resolve().parents[2] / ".jax_cache")


def enable_compile_cache() -> str:
    """Point JAX's persistent compilation cache at its directory; return it."""
    import jax

    path = os.environ.get("JAX_COMPILATION_CACHE_DIR") or REPO_CACHE_DIR
    jax.config.update("jax_compilation_cache_dir", path)
    return path
