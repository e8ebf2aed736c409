"""JAX's persistent compilation cache for the repository's entry points.

``chip_smoke.py``, ``bench.py`` and ``python -m fftw3_tpu.harness`` call
:func:`enable` at start-up; the library itself never does, so importing it
changes no global JAX setting.
"""
from __future__ import annotations

import os

#: the cache when JAX_COMPILATION_CACHE_DIR is unset: one fixed path in the
#: checkout (listed in .gitignore), so a later run finds what an earlier
#: one compiled
DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), ".jax_cache")


def enable() -> str:
    """Turn the cache on and return its directory.

    If ``JAX_COMPILATION_CACHE_DIR`` is set, JAX already reads it and no
    other path is set here; otherwise the cache goes to DEFAULT_DIR."""
    path = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if path:
        return path
    import jax
    jax.config.update("jax_compilation_cache_dir", DEFAULT_DIR)
    return DEFAULT_DIR
