"""The single-device c2c/r2c paths over the sizes the removed fused-kernel
tier covered, by both routes a plan can take: the ESTIMATE plan, and the
``xla`` solver (XLA's own FFT, cuFFT on a GPU) pinned through wisdom."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

import fftw3_tpu as ftpu
from fftw3_tpu.planner import the_planner

ROUTES = ["estimate", "xla"]
POW2 = [128, 256, 512, 1024, 2048, 4096, 8192]
NON_POW2 = [240, 384, 1000, 1500]


def _relerr(got, want):
    return np.max(np.abs(np.asarray(got) - want)) / np.max(np.abs(want))


@pytest.fixture
def route(request):
    """Yields a function pinning the route's descriptors for the
    (kind, n, batch) subproblems a plan will ask for."""
    ftpu.forget_wisdom()

    def pin(*subproblems):
        if request.param == "estimate":
            return
        for kind, n, batch in subproblems:
            if kind == "c2c":
                desc = {"alg": "xla", "n": n}
            else:
                desc = {"alg": f"{kind}_via_c2c", "n": n,
                        "child": {"alg": "xla", "n": n}}
            the_planner.wisdom[the_planner._key(kind, n, np.float32,
                                                batch)] = {
                "desc": desc, "patience": 99, "cost": 0.0}
    yield pin
    ftpu.forget_wisdom()


def _c2c_case(n, sign, pin, batch=9):
    rng = np.random.default_rng(n)
    x = rng.standard_normal((batch, n)) + 1j * rng.standard_normal((batch, n))
    pin(("c2c", n, batch))
    plan = ftpu.plan_many_dft([n], howmany=batch, sign=sign,
                              dtype="complex64")
    got = jax.jit(plan.apply)(jnp.asarray(x, jnp.complex64))
    want = np.fft.fft(x, axis=-1) if sign == -1 else \
        np.fft.ifft(x, axis=-1) * n
    assert _relerr(got, want) < 1e-4, (n, sign, repr(plan))
    return plan


@pytest.mark.parametrize("route", ROUTES, indirect=True)
@pytest.mark.parametrize("sign", [-1, +1])
@pytest.mark.parametrize("n", POW2)
def test_pow2(n, sign, route):
    _c2c_case(n, sign, route)


@pytest.mark.parametrize("route", ROUTES, indirect=True)
@pytest.mark.parametrize("sign", [-1, +1])
@pytest.mark.parametrize("n", NON_POW2)
def test_nonpow2(n, sign, route):
    _c2c_case(n, sign, route)


@pytest.mark.parametrize("route", ["xla"], indirect=True)
def test_xla_route_is_served(route):
    plan = _c2c_case(1024, -1, route)
    assert "(xla-1024)" in repr(plan)


@pytest.mark.parametrize("route", ROUTES, indirect=True)
def test_multidim_batch_and_leading_dims(route):
    """A (3, 5, n) problem over its last axis, then extra leading dims at
    apply time (plans embed in larger jitted programs)."""
    n = 256
    rng = np.random.default_rng(1)
    x = rng.standard_normal((3, 5, n)) + 1j * rng.standard_normal((3, 5, n))
    route(("c2c", n, 15))
    plan = ftpu.plan_dft((3, 5, n), axes=(2,), dtype="complex64")
    got = jax.jit(plan.apply)(jnp.asarray(x, jnp.complex64))
    assert _relerr(got, np.fft.fft(x, axis=-1)) < 1e-4
    xb = np.stack([x, 2 * x])
    got = jax.jit(plan.apply)(jnp.asarray(xb, jnp.complex64))
    assert _relerr(got, np.fft.fft(xb, axis=-1)) < 1e-4


@pytest.mark.parametrize("route", ROUTES, indirect=True)
@pytest.mark.parametrize("n", [256, 1024, 2000, 4096])
def test_r2c_c2r_roundtrip(n, route):
    batch = 5
    rng = np.random.default_rng(n)
    x = rng.standard_normal((batch, n)).astype(np.float32)
    route(("r2c", n, batch), ("c2r", n, batch))
    fwd = ftpu.plan_dft_r2c((batch, n), axes=(1,), dtype="float32")
    bwd = ftpu.plan_dft_c2r((batch, n), axes=(1,), dtype="float32")
    X = jax.jit(fwd.apply)(x)
    assert _relerr(X, np.fft.rfft(x.astype(np.float64), axis=1)) < 1e-4
    y = jax.jit(bwd.apply)(X)
    assert _relerr(np.asarray(y) / n, x) < 1e-4


@pytest.mark.parametrize("route", ROUTES, indirect=True)
@pytest.mark.parametrize("shape", [(256, 256), (128, 384)])
def test_2d(shape, route):
    n0, n1 = shape
    rng = np.random.default_rng(2)
    x = rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
    route(("c2c", n0, n1), ("c2c", n1, n0))
    plan = ftpu.plan_dft(shape, dtype="complex64")
    got = jax.jit(plan.apply)(jnp.asarray(x, jnp.complex64))
    assert _relerr(got, np.fft.fft2(x)) < 1e-4


@pytest.mark.parametrize("route", ROUTES, indirect=True)
@pytest.mark.parametrize("n", [256, 1024])
def test_gradients(n, route):
    """jax.grad through plan.apply: for real x, d/dx sum |F x|^2 = 2 n x
    (Parseval)."""
    batch = 2
    rng = np.random.default_rng(3)
    x = jnp.asarray(rng.standard_normal((batch, n)), jnp.float32)
    route(("c2c", n, batch))
    plan = ftpu.plan_many_dft([n], howmany=batch, dtype="complex64")

    def loss(a):
        y = plan.apply(a.astype(jnp.complex64))
        return jnp.sum(jnp.abs(y) ** 2)

    g = jax.grad(loss)(x)
    assert np.allclose(np.asarray(g), 2 * n * np.asarray(x),
                       rtol=1e-4, atol=1e-2)
