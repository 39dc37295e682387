"""Persistent XLA compilation cache.

A full render or photon run compiles for tens of seconds while its steady
state takes seconds, so the example drivers, ``bench.py``, ``chip_smoke.py``
and the CLI opt in through this helper.  Library users keep JAX's default
behaviour unless they ask.

Where the cache lives: ``JAX_COMPILATION_CACHE_DIR`` when it is set (JAX
reads that variable itself, so nothing else is configured), otherwise the
fixed ``.jax_cache/`` directory at the root of the checkout.  A cache whose
path moves between runs never hits, so the fallback is not per-user or
temporary.
"""

from __future__ import annotations

import os

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), ".jax_cache")


def enable_compile_cache() -> str:
    """Turn on JAX's persistent compilation cache (idempotent); returns its
    directory.

    Must run before the first compilation to be effective for it; later
    calls still cache subsequent compiles."""
    import jax

    path = os.environ.get(ENV_VAR)
    if not path:
        path = DEFAULT_DIR
        os.makedirs(path, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    return path
