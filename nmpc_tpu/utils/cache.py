"""Persistent XLA compilation cache location.

Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and this
module sets nothing.  Otherwise the cache lives at ``<checkout>/.cache/jax``
(``.gitignore`` lists ``.cache/``), a fixed path so that reruns from the
same checkout hit it.
"""

from __future__ import annotations

import os

CHECKOUT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def enable_compilation_cache() -> str:
    """Point JAX's persistent compilation cache at its directory; returns
    the directory in use."""
    import jax

    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    path = os.path.join(CHECKOUT, ".cache", "jax")
    jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    return path
