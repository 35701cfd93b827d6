"""Persistent XLA compilation cache location, shared by every script.

``JAX_COMPILATION_CACHE_DIR``, when set, is honoured as JAX itself reads it:
nothing here overrides it.  Otherwise the cache lives at a fixed path,
``<checkout>/.jax_cache`` (listed in ``.gitignore``): the directory is part
of the cache key, so a fixed path is what lets a later run hit.
"""

from __future__ import annotations

import os

import jax

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache",
)


def enable_compile_cache() -> str:
    """Turn the persistent compilation cache on; returns its directory."""
    env_dir = os.environ.get(ENV_VAR)
    if env_dir:
        return env_dir
    jax.config.update("jax_compilation_cache_dir", DEFAULT_DIR)
    return DEFAULT_DIR
