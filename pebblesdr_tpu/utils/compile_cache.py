"""Where JAX keeps its persistent compilation cache.

Every entry point (the CLI, the IQ server, bench.py, chip_smoke.py,
tools/soak.py) calls enable() before its first compile, so repeated runs at
one geometry skip the compile.  If JAX_COMPILATION_CACHE_DIR is set, JAX
reads it itself and nothing is set here.  Otherwise the cache lives at one
fixed path, <checkout>/.jax_cache: the path is part of the cache key, so a
directory that moves between runs never hits.
"""

from __future__ import annotations

import os
from pathlib import Path

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
DEFAULT_DIR = Path(__file__).resolve().parents[2] / ".jax_cache"


def cache_dir() -> str:
    """The directory the cache uses: the env var's value, else the fixed
    <checkout>/.jax_cache."""
    return os.environ.get(ENV_VAR) or str(DEFAULT_DIR)


def enable() -> str:
    """Point JAX at cache_dir() (only when the env var does not already)
    and return the directory."""
    if not os.environ.get(ENV_VAR):
        import jax

        jax.config.update("jax_compilation_cache_dir", str(DEFAULT_DIR))
    return cache_dir()
