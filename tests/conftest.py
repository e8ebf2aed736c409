"""Test configuration: run on a virtual 8-device CPU mesh with x64 enabled.

Correctness tests run on the CPU (f64 oracle + 8 virtual devices for the
distributed tier — the standard JAX multi-device-without-hardware trick,
SURVEY.md section 4).  ``jax.config.update`` works here because no backend
client exists yet; plain environment variables would be too late once a
backend has started.

Tests marked ``gpu`` need an NVIDIA GPU and skip elsewhere (the ``gpu``
fixture decides at run time).  Run them on the card with
``python -m pytest -m gpu tests/``: with exactly that marker expression the
CPU forcing below is left off, so JAX takes its default backend.
"""
import os

import numpy as np
import pytest


def pytest_configure(config):
    if (config.option.markexpr or "").strip() == "gpu":
        return
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8").strip()
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)


@pytest.fixture
def gpu():
    """The first GPU device; skips the test when JAX has no GPU."""
    import jax
    if jax.default_backend() != "gpu":
        pytest.skip("needs an NVIDIA GPU (python -m pytest -m gpu tests/ "
                    "on the card)")
    return jax.devices()[0]


@pytest.fixture
def rng():
    return np.random.default_rng(1234)


def tol_for(dtype) -> float:
    """FFTW verify tolerances: 1e-3 single, 1e-10 double
    (libbench2/bench-main.c:70)."""
    return 1e-3 if np.dtype(dtype) in (np.float32, np.complex64) else 1e-10
