"""Where the program keeps what it caches, and JAX's compile cache.

Everything cached (compiled programs, host-built model tables, the
materialized OTF stack, spectral-PSF tables) lives in one directory inside
the checkout, `.surfh_cache/`, which `.gitignore` lists.  The path is fixed:
JAX's persistent compile cache keys on nothing that moves, but a cache
directory that changes from run to run never hits.
"""

from __future__ import annotations

import os

_CHECKOUT = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)
CACHE_ROOT = os.path.join(_CHECKOUT, ".surfh_cache")


def cache_dir(kind: str) -> str:
    """The checkout-local cache directory for one kind of cached data."""
    return os.path.join(CACHE_ROOT, kind)


def enable_compile_cache() -> str:
    """Turn on JAX's persistent compilation cache and return its directory.

    When `JAX_COMPILATION_CACHE_DIR` is set, JAX has already taken its
    directory from it and this sets nothing.  Otherwise the cache goes to
    `.surfh_cache/jax` in the checkout."""
    import jax

    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        jax.config.update("jax_compilation_cache_dir", cache_dir("jax"))
    return jax.config.jax_compilation_cache_dir
