"""Toolchain-stamped wisdom signatures.

The reference hashes its build configuration into every wisdom entry so
stale wisdom can never cross builds (signature_of_configuration,
fftw/fftw_api.c:14829).  The analog here stamps the COMPILER as well as
the device: a compiler upgrade changes which plan is fastest.
"""
import numpy as np
import pytest

import fftw3_tpu as ftpu
from fftw3_tpu import planner


def test_signature_stamps_toolchain():
    import jax
    import jaxlib

    sig = planner._device_signature()
    assert f"jax{jax.__version__}" in sig
    assert f"jl{jaxlib.__version__}" in sig
    # cached: second call returns the identical object fast
    assert planner._device_signature() is sig


def test_signature_change_invalidates_wisdom(monkeypatch):
    """A simulated toolchain upgrade (different signature) must orphan
    every existing wisdom entry — old keys never match, so stale
    winners/geometries can never be served to a new compiler."""
    p = planner.the_planner
    ftpu.forget_wisdom()
    try:
        plan = ftpu.plan_many_dft([256], howmany=8, dtype="complex64")
        old_keys = set(p.wisdom)
        assert old_keys, "planning must deposit wisdom"
        old_key = p._key("c2c", 256, np.float32, 8)
        assert old_key in old_keys
        monkeypatch.setattr(planner, "_sig_cache",
                            planner._device_signature() + "-upgraded")
        new_key = p._key("c2c", 256, np.float32, 8)
        assert new_key != old_key
        assert new_key not in old_keys
    finally:
        ftpu.forget_wisdom()


def test_exported_wisdom_carries_signature():
    ftpu.forget_wisdom()
    try:
        ftpu.plan_many_dft([128], howmany=4, dtype="complex64")
        import json

        doc = json.loads(planner.the_planner.export_wisdom())
        assert doc["signature"] == planner._device_signature()
        assert all(planner._device_signature() in k for k in doc["entries"])
    finally:
        ftpu.forget_wisdom()
