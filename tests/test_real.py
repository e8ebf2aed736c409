"""r2c / c2r / halfcomplex correctness vs numpy double reference."""
import numpy as np
import pytest

import fftw3_tpu as ftpu

from conftest import tol_for


def relerr(a, b):
    scale = np.max(np.abs(b)) or 1.0
    return np.max(np.abs(np.asarray(a) - b)) / scale


SIZES = [2, 3, 4, 5, 8, 9, 12, 15, 16, 30, 64, 100, 101, 128, 256, 1000]


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_r2c_1d(rng, n, dtype):
    x = rng.standard_normal((3, n)).astype(dtype)
    p = ftpu.plan_dft_r2c((3, n), axes=(1,), dtype=dtype)
    assert p.out_shape == (3, n // 2 + 1)
    assert relerr(p(x), np.fft.rfft(np.float64(x), axis=1)) < tol_for(dtype)


@pytest.mark.parametrize("n", SIZES)
def test_c2r_1d(rng, n):
    x = rng.standard_normal((3, n))
    X = np.fft.rfft(x, axis=1)
    p = ftpu.plan_dft_c2r((3, n), axes=(1,), dtype="float64")
    # FFTW semantics: unnormalized, c2r(r2c(x)) = n*x
    assert relerr(p(X), n * x) < 1e-10


@pytest.mark.parametrize("shape", [(8, 8), (4, 6, 10), (5, 9)])
def test_r2c_nd(rng, shape):
    x = rng.standard_normal(shape)
    p = ftpu.plan_dft_r2c(shape, dtype="float64")
    ref = np.fft.rfftn(x)
    assert relerr(p(x), ref) < 1e-10


@pytest.mark.parametrize("shape", [(8, 8), (4, 6, 10), (5, 9)])
def test_c2r_nd(rng, shape):
    x = rng.standard_normal(shape)
    X = np.fft.rfftn(x)
    p = ftpu.plan_dft_c2r(shape, dtype="float64")
    n = int(np.prod(shape))
    assert relerr(p(X), n * x) < 1e-10


@pytest.mark.parametrize("n", [4, 7, 8, 9, 16, 25, 100])
def test_halfcomplex_roundtrip(rng, n):
    """R2HC layout matches FFTW: [r0..r_{n/2}, i_{(n+1)/2-1}..i_1] with
    i_k = Im of the forward DFT; HC2R is the unnormalized inverse."""
    x = rng.standard_normal((2, n))
    fwd = ftpu.plan_r2r((2, n), ["r2hc"], axes=(1,), dtype="float64")
    bwd = ftpu.plan_r2r((2, n), ["hc2r"], axes=(1,), dtype="float64")
    hc = np.asarray(fwd(x))
    X = np.fft.fft(x, axis=1)
    np.testing.assert_allclose(hc[:, :n // 2 + 1], X.real[:, :n // 2 + 1],
                               atol=1e-10 * n)
    for k in range(1, (n + 1) // 2):
        np.testing.assert_allclose(hc[:, n - k], X.imag[:, k], atol=1e-10 * n)
    assert relerr(bwd(hc), n * x) < 1e-10


def test_numpy_style_wrappers(rng):
    x = rng.standard_normal((4, 32))
    np.testing.assert_allclose(np.asarray(ftpu.rfft(x)), np.fft.rfft(x),
                               atol=1e-10)
    X = np.fft.rfft(x)
    np.testing.assert_allclose(np.asarray(ftpu.irfft(X)), x, atol=1e-10)
    z = rng.standard_normal((4, 16)) + 1j * rng.standard_normal((4, 16))
    np.testing.assert_allclose(np.asarray(ftpu.ifft(z)), np.fft.ifft(z),
                               atol=1e-12)
    np.testing.assert_allclose(np.asarray(ftpu.fftn(z)), np.fft.fft2(z),
                               rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(
        np.asarray(ftpu.fft(x[0], n=48)), np.fft.fft(x[0], n=48), atol=1e-10)


def test_fft_norms(rng):
    z = rng.standard_normal(16) + 1j * rng.standard_normal(16)
    for norm in (None, "ortho", "forward"):
        np.testing.assert_allclose(np.asarray(ftpu.fft(z, norm=norm)),
                                   np.fft.fft(z, norm=norm or "backward"),
                                   atol=1e-12)
        np.testing.assert_allclose(np.asarray(ftpu.ifft(z, norm=norm)),
                                   np.fft.ifft(z, norm=norm or "backward"),
                                   atol=1e-12)


def test_irfftn_non_hermitian_input_matches_numpy(rng):
    """rank>=2 c2r on a technically-INVALID (non-Hermitian-consistent)
    spectrum must match numpy exactly: numpy and the reference run FULL
    complex inverse passes on non-last axes (fftw_api.c:5552-6190), so
    imaginary junk in the DC/Nyquist columns' Nyquist rows contributes to
    the result.  Spectral-derivative workloads (irfft2 of i*k*W) depend
    on this; a DC/Nyquist column pack on the inverse silently projected
    it away (round-3 regression, caught at 1.8e-3 by the Navier-Stokes
    distributed-vs-single test)."""
    ny, nx = 32, 32
    w = rng.standard_normal((ny, nx))
    W = np.fft.rfft2(w)
    ky = np.fft.fftfreq(ny, 1.0 / ny)[:, None]
    G = 1j * ky * W                    # y-Nyquist row becomes imaginary
    got = np.asarray(ftpu.irfft2(G.astype(np.complex128), s=(ny, nx)))
    want = np.fft.irfft2(G, s=(ny, nx))
    np.testing.assert_allclose(got, want, atol=1e-10)
