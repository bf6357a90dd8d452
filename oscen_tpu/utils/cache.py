"""Persistent XLA compile cache for the programs that drive a device.

Called by ``chip_smoke.py``, ``bench.py`` and the examples; importing the
library sets nothing.
"""

from __future__ import annotations

import os

CACHE_DIRNAME = ".jax_cache"


def checkout_root() -> str:
    """The directory that holds the ``oscen_tpu`` package."""
    return os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))


def enable_compile_cache() -> str:
    """Turn on JAX's persistent compile cache and return its directory.

    Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX uses it and nothing
    else is set here.  Otherwise the cache goes to ``.jax_cache/`` in the
    checkout (listed in ``.gitignore``) — a fixed path, since the path is
    part of the cache key.
    """
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax
    path = os.path.join(checkout_root(), CACHE_DIRNAME)
    jax.config.update("jax_compilation_cache_dir", path)
    return path
