"""Persistent XLA compile cache location.

A cold compile of a full transient takes tens of seconds to minutes, so
entry points keep compiled programs in JAX's persistent cache.  The cache
directory is part of every lookup, so it must be a fixed path: a
temporary or per-process directory never hits.
"""

from __future__ import annotations

import os
import pathlib

import jax

#: ``<checkout>/.jax_cache`` (listed in .gitignore)
DEFAULT_CACHE_DIR = pathlib.Path(__file__).resolve().parents[2] / ".jax_cache"


def setup_compile_cache() -> str:
    """Point JAX's persistent compile cache at ``<checkout>/.jax_cache``
    unless the caller already chose one.

    ``JAX_COMPILATION_CACHE_DIR`` (read by JAX itself) or an earlier
    ``jax.config.update("jax_compilation_cache_dir", ...)`` wins; this
    never overrides either.  Returns the directory in effect.
    """
    current = (os.environ.get("JAX_COMPILATION_CACHE_DIR")
               or jax.config.jax_compilation_cache_dir)
    if current:
        return current
    jax.config.update("jax_compilation_cache_dir", str(DEFAULT_CACHE_DIR))
    return str(DEFAULT_CACHE_DIR)
