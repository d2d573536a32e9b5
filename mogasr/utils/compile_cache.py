"""Persistent XLA compilation cache for the repository's entry scripts.

If ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and this module
sets nothing. Otherwise the cache goes to ``.jax_cache/`` at the root of the
checkout (listed in ``.gitignore``): a fixed path, because the path is part
of what a later process needs to find the entries again.
"""

from __future__ import annotations

import os

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
CHECKOUT_DIR = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
DEFAULT_DIR = os.path.join(CHECKOUT_DIR, ".jax_cache")


def cache_dir() -> str:
    """The directory the compilation cache uses."""
    return os.environ.get(ENV_VAR) or DEFAULT_DIR


def enable_compile_cache() -> str:
    """Turn the persistent compilation cache on; returns its directory."""
    import jax

    if not os.environ.get(ENV_VAR):
        jax.config.update("jax_compilation_cache_dir", DEFAULT_DIR)
    return cache_dir()
