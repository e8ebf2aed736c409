"""Compensated-f32 (double-float) tier tests — VERDICT r2 item 6.

The tier's contract: for ``dtype=complex128`` plans the planner may choose
the ``df32`` solver, whose pure-f32 error-free-transform arithmetic must
stay inside FFTW's double-precision verify tolerance of 1e-10
(fftw/libbench2/bench-main.c:70) while avoiding every emulated-f64 matmul.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

import fftw3_tpu as ftpu
from fftw3_tpu import config
from fftw3_tpu import kinds as K
from fftw3_tpu.ops import c2c as c2c_ops
from fftw3_tpu.ops import df32
from fftw3_tpu.planner import Planner, validate_desc


def relerr(yr, yi, ref):
    y = np.asarray(yr) + 1j * np.asarray(yi)
    return np.max(np.abs(y - ref)) / np.max(np.abs(ref))


@pytest.mark.parametrize("n", [2, 4, 8, 12, 60, 360, 1000, 1024, 2048])
def test_df32_forward_backward(rng, n):
    rad = df32.df32_radices(n)
    assert rad is not None and int(np.prod(rad)) == n
    desc = {"alg": "df32", "n": n, "radices": rad}
    x = rng.standard_normal((3, n)) + 1j * rng.standard_normal((3, n))
    fwd = df32.build_df32_c2c_split(desc, -1, np.float64)
    yr, yi = jax.jit(fwd)(x.real, x.imag)
    assert relerr(yr, yi, np.fft.fft(x, axis=-1)) < 1e-12
    bwd = df32.build_df32_c2c_split(desc, +1, np.float64)
    zr, zi = jax.jit(bwd)(np.asarray(yr), np.asarray(yi))
    assert relerr(zr, zi, x * n) < 1e-12


def test_df32_applicability():
    assert df32.df32_applicable(720)
    assert not df32.df32_applicable(7)      # prime > 5
    assert not df32.df32_applicable(1)
    assert df32.df32_radices(14) is None


def test_planner_picks_df32_for_f64():
    pl = Planner()
    d = pl.plan_c2c(1024, np.float64, K.PATIENCE_ESTIMATE)
    assert d["alg"] == "df32"
    # f32 planning is unaffected by the tier
    d32 = pl.plan_c2c(1024, np.float32, K.PATIENCE_ESTIMATE)
    assert d32["alg"] != "df32"


def test_strict_f64_knob():
    old = config.strict_f64
    try:
        config.strict_f64 = True
        pl = Planner()
        d = pl.plan_c2c(1024, np.float64, K.PATIENCE_ESTIMATE)
        assert d["alg"] != "df32"
    finally:
        config.strict_f64 = old


def test_f64_composition_through_real_plans(rng):
    """f64 r2c routes its complex child through the df32 tier and still
    meets the double contract."""
    p = ftpu.plan_dft_r2c([1024], dtype="float64")
    x = rng.standard_normal(1024)
    y = np.asarray(p.execute(x))
    ref = np.fft.rfft(x)
    assert np.max(np.abs(y - ref)) / np.max(np.abs(ref)) < 1e-12
    assert "df32" in repr(p)


def test_f64_prime_composition(rng):
    """Prime n: rader/bluestein over df32 children."""
    p = ftpu.plan_dft((4, 101), axes=(1,), dtype="complex128")
    x = rng.standard_normal((4, 101)) + 1j * rng.standard_normal((4, 101))
    y = np.asarray(p.execute(x))
    assert np.max(np.abs(y - np.fft.fft(x, axis=1))) \
        / np.max(np.abs(y)) < 1e-10


def test_grad_through_df32(rng):
    """The error-free transforms are plain jnp ops — the custom-VJP-free
    autodiff path must produce the adjoint transform."""
    desc = {"alg": "df32", "n": 64, "radices": df32.df32_radices(64)}
    fwd = df32.build_df32_c2c_split(desc, -1, np.float64)
    x = rng.standard_normal(64)

    def loss(v):
        yr, yi = fwd(v, jnp.zeros_like(v))
        return jnp.sum(yr ** 2 + yi ** 2)
    g = jax.grad(loss)(x)
    # d/dx sum |F x|^2 = 2 F^H F x = 2 n x for the unnormalized DFT
    np.testing.assert_allclose(np.asarray(g), 2 * 64 * x, rtol=1e-10)


def test_validate_and_opcount():
    rad = df32.df32_radices(1024)
    assert validate_desc("c2c", 1024, {"alg": "df32", "n": 1024,
                                       "radices": rad})
    assert not validate_desc("c2c", 1024, {"alg": "df32", "n": 1024,
                                           "radices": [4, 4]})
    ops = c2c_ops.c2c_opcount({"alg": "df32", "n": 1024, "radices": rad})
    assert ops["add"] > 0 and ops["mul"] > 0


def test_wisdom_roundtrip_serves_df32():
    pl = Planner()
    d = pl.plan_c2c(256, np.float64, K.PATIENCE_ESTIMATE)
    assert d["alg"] == "df32"
    s = pl.export_wisdom()
    pl2 = Planner()
    assert pl2.import_wisdom(s)
    n0 = pl2.stats["nplan"]
    assert pl2.plan_c2c(256, np.float64, K.PATIENCE_ESTIMATE) == d
    assert pl2.stats["nplan"] == n0


def test_f64_cost_model_prefers_df32():
    """The dtype-aware cost model must rank df32 above every emulated-f64
    matmul solver at ESTIMATE (that is what makes the tier fire)."""
    pl = Planner()
    cands = pl._candidates("c2c", 1024, np.float64, K.PATIENCE_ESTIMATE)
    best = min(cands, key=lambda d: pl._cost("c2c", d, f64=True))
    assert best["alg"] == "df32"
    # and the same descriptors cost MORE under f64 than under f32 for the
    # matmul algs (emulation penalty), keeping f32 rankings untouched
    mixed = next(d for d in cands if d["alg"] == "mixed")
    assert pl._cost("c2c", mixed, f64=True) > pl._cost("c2c", mixed)
