"""Where JAX keeps its persistent compilation cache.

One rule for every entry point (train.py, bench.py, chip_smoke.py and the
tools): when ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and
nothing here overrides it; otherwise the cache lives at one fixed path
inside the checkout, ``<repo>/.jax_cache`` (git-ignored). The path is part
of the cache key, so it is never built from a temp name, a pid or the
time.
"""

from __future__ import annotations

import os

import jax

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), ".jax_cache")


def configure_compile_cache() -> str:
    """Point JAX's persistent cache at the directory the rule above picks
    and return that directory."""
    env = os.environ.get(ENV_VAR)
    if env:
        return env
    jax.config.update("jax_compilation_cache_dir", DEFAULT_DIR)
    return DEFAULT_DIR
