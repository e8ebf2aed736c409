#!/usr/bin/env python3
"""Smoke test of the planned FFT path on an NVIDIA GPU.

Drives the engine through the entry points a user calls
(``plan_many_dft`` / ``plan_dft`` / ``plan_dft_r2c`` / ``plan_r2r`` and
``parallel.plan_*_dist``, then ``jax.jit(plan.apply)``) at full size, times
each phase on the host clock around ``block_until_ready``, and compares
each phase's timed output with a float64 NumPy/SciPy reference computed on
the host.  Tolerances are FFTW's: 1e-3 single, 1e-10 double
(``fftw/libbench2/bench-main.c:70``).

    python chip_smoke.py            # one card, every single-card phase
    python chip_smoke.py --multi    # four cards, the distributed phases

The last line of standard output is one JSON object,
``{"ok": true, "device": {...}}``, printed only when every phase passed.
Without a GPU the script exits with status 2 and prints no result.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import math
import subprocess
import sys
import time
import traceback

import numpy as np

SINGLE_TOL = 1e-3
DOUBLE_TOL = 1e-10
#: Taylor-Green decay rule of tests/test_models.py (model error, not FFT)
MODEL_TOL = 2e-3

#: the card's ``name, power.limit``, printed beside every time and rate
CARD = "card unknown"


def card_lines():
    """``nvidia-smi`` name and power limit, one line per card, read by a
    child process that does not touch JAX."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True).stdout
    except (OSError, subprocess.SubprocessError) as exc:
        return [f"nvidia-smi unavailable ({type(exc).__name__})"]
    return [ln.strip() for ln in out.splitlines() if ln.strip()]


def _say(*parts):
    print(*parts, flush=True)


def _relerr(got, want) -> float:
    got = np.asarray(got)
    want = np.asarray(want)
    return float(np.max(np.abs(got - want))
                 / max(float(np.max(np.abs(want))), 1e-300))


def _check(what: str, err: float, tol: float) -> float:
    if not err < tol:
        raise AssertionError(f"{what}: rel err {err:.3e} >= {tol:g}")
    return err


def _time(fn, *args, reps: int = 10) -> float:
    from fftw3_tpu.utils import timing
    return timing.time_dispatched(fn, args, reps=reps)


def _time_queued(fn, x, calls: int) -> float:
    """Seconds per call with ``calls`` calls enqueued before one wait:
    the device's throughput with the host's per-call wait taken out."""
    from fftw3_tpu.utils import timing
    timing.sync(fn(x))
    t0 = time.perf_counter()
    outs = [fn(x) for _ in range(calls)]
    timing.sync(outs)
    return (time.perf_counter() - t0) / calls


def _compile(fn, *args):
    """(compiled, seconds) for ``jax.jit(fn)`` at ``args``."""
    import jax
    t0 = time.perf_counter()
    compiled = jax.jit(fn).lower(*args).compile()
    return compiled, time.perf_counter() - t0


def _rate(phase: str, tag: str, t: float, flops: float, nbytes: float):
    """One timing line: seconds per call, GFLOPS in FFTW's convention
    (5 N log2 N complex, 2.5 N log2 N real), and bytes moved at one read +
    one write of the arrays over the call time."""
    _say(f"{phase}: {tag} time={t:.6e} s gflops={flops / t / 1e9:.2f} "
         f"gbps={nbytes / t / 1e9:.2f} [{CARD}]")


def _random(key, shape, dtype):
    """Data made on the device from a seed (no host->device copy)."""
    import jax
    return jax.random.normal(jax.random.PRNGKey(key), shape, dtype=dtype)


@contextlib.contextmanager
def _pinned(kind: str, n: int, rdtype, batch: int, desc):
    """Plans made inside are served ``desc`` from wisdom for
    (kind, n, batch)."""
    import fftw3_tpu as ftpu
    from fftw3_tpu.planner import the_planner

    ftpu.forget_wisdom()
    the_planner.wisdom[the_planner._key(kind, n, rdtype, batch)] = {
        "desc": desc, "patience": 99, "cost": 0.0}
    try:
        yield
    finally:
        ftpu.forget_wisdom()


def _sample_rows(batch: int, count: int) -> np.ndarray:
    return np.unique(np.linspace(0, batch - 1, min(count, batch))
                     .astype(np.int64))


# ---------------------------------------------------------------------------
# single-card phases
# ---------------------------------------------------------------------------

def phase_precision(n_direct=128, n_mixed=1024, batch=65536, reps=10):
    """Relative error and time of the ``direct`` and ``mixed`` matrix-
    product solvers at Precision.HIGH (TF32 on the card) and HIGHEST; the
    precision in force must hold the single-precision contract."""
    import jax
    import jax.numpy as jnp
    import fftw3_tpu as ftpu
    from fftw3_tpu import config
    from fftw3_tpu.planner import the_planner

    default = config.precision_name()
    saved = config.matmul_precision
    for n in (n_direct, n_mixed):
        desc = the_planner.plan_c2c(n, np.float32, 0, batch)
        x = _random(10 + n, (batch, n), jnp.complex64)
        rows = _sample_rows(batch, 128)
        want = np.fft.fft(np.asarray(x[rows]).astype(np.complex128), axis=1)
        for prec in ("high", "highest"):
            config.matmul_precision = prec
            try:
                with _pinned("c2c", n, np.float32, batch, desc):
                    plan = ftpu.plan_many_dft([n], howmany=batch,
                                              dtype="complex64")
                run = jax.jit(plan.apply)
                err = _relerr(np.asarray(run(x)[rows]), want)
                t = _time(run, x, reps=reps)
            finally:
                config.matmul_precision = saved
            _say(f"precision: n={n} {plan!r} {prec} relerr={err:.3e}")
            _rate("precision", f"n={n} {prec}", t,
                  5.0 * n * math.log2(n) * batch, 2 * 8.0 * n * batch)
            if prec == default:
                _check(f"precision n={n} {prec}", err, SINGLE_TOL)
    _say(f"precision: default={default}")


def phase_headline(n=1024, batch=65536, sample=128, reps=20):
    """c2c n x batch complex64: the ESTIMATE plan (a), the ``xla`` solver
    pinned through wisdom (b, cuFFT), ``jnp.fft.fft`` itself, and a copy of
    the same bytes (c); then the MEASURE-mode plan."""
    import jax
    import jax.numpy as jnp
    import fftw3_tpu as ftpu
    from fftw3_tpu import kinds as K
    from fftw3_tpu.planner import the_planner
    from fftw3_tpu.utils import timing

    x = _random(1, (batch, n), jnp.complex64)
    rows = _sample_rows(batch, sample)
    want = np.fft.fft(np.asarray(x[rows]).astype(np.complex128), axis=1)
    flops = 5.0 * n * math.log2(n) * batch
    nbytes = 2 * 8.0 * n * batch

    ftpu.forget_wisdom()
    plan = ftpu.plan_many_dft([n], howmany=batch, dtype="complex64")
    compiled, secs = _compile(plan.apply, x)
    _say(f"headline: (a) {plan!r} compile={secs:.2f} s")
    _say(f"headline: memory_analysis {compiled.memory_analysis()}")
    runs = {"(a) estimate": jax.jit(plan.apply)}
    with _pinned("c2c", n, np.float32, batch, {"alg": "xla", "n": n}):
        xplan = ftpu.plan_many_dft([n], howmany=batch, dtype="complex64")
    runs["(b) xla solver"] = jax.jit(xplan.apply)
    runs["(b) jnp.fft.fft"] = jax.jit(lambda a: jnp.fft.fft(a, axis=-1))
    for tag, run in runs.items():
        err = _check(f"headline {tag}",
                     _relerr(np.asarray(run(x)[rows]), want), SINGLE_TOL)
        _say(f"headline: {tag} relerr={err:.3e}")
    runs["(c) copy"] = jax.jit(lambda a: -a)
    # timed in turns, so drift of the card's clocks hits every path alike
    times = timing.time_dispatched_multi(
        [(run, (x,)) for run in runs.values()], reps=reps)
    for (tag, run), t in zip(runs.items(), times):
        _rate("headline", tag, t, flops, nbytes)
        _rate("headline", f"{tag} queued", _time_queued(run, x, reps),
              flops, nbytes)

    ftpu.forget_wisdom()
    t0 = time.perf_counter()
    mplan = ftpu.plan_many_dft([n], howmany=batch, dtype="complex64",
                               flags=K.MEASURE)
    _say(f"headline: measure {mplan!r} plan={time.perf_counter() - t0:.2f}"
         f" s stats={the_planner.stats}")
    run = jax.jit(mplan.apply)
    err = _check("headline measure",
                 _relerr(np.asarray(run(x)[rows]), want), SINGLE_TOL)
    _say(f"headline: measure relerr={err:.3e}")
    _rate("headline", "measure", _time(run, x, reps=reps), flops, nbytes)
    ftpu.forget_wisdom()


def phase_f64(n=1024, batch=8192, sample=128, reps=10):
    """c2c complex128 as ESTIMATE plans it (at 1e-10), and with the
    double-float ``df32`` solver pinned through wisdom: where the device
    table says df32 does not hold 1e-10, the planner must not offer it."""
    import jax
    import jax.numpy as jnp
    import fftw3_tpu as ftpu
    from fftw3_tpu.ops import df32
    from fftw3_tpu.planner import the_planner

    with jax.enable_x64(True):
        x = _random(2, (batch, n), jnp.complex128)
        rows = _sample_rows(batch, sample)
        want = np.fft.fft(np.asarray(x[rows]), axis=1)
        ftpu.forget_wisdom()
        plans = {"estimate": ftpu.plan_many_dft([n], howmany=batch,
                                                dtype="complex128")}
        with _pinned("c2c", n, np.float64, batch,
                     {"alg": "df32", "n": n,
                      "radices": df32.df32_radices(n)}):
            plans["df32"] = ftpu.plan_many_dft([n], howmany=batch,
                                               dtype="complex128")
        offered = {d["alg"] for d in the_planner._candidates(
            "c2c", n, np.float64, 0, batch)}
        for tag, plan in plans.items():
            run = jax.jit(plan.apply)
            err = _relerr(np.asarray(run(x)[rows]), want)
            _say(f"f64: {tag} {plan!r} relerr={err:.3e}")
            _rate("f64", tag, _time(run, x, reps=reps),
                  5.0 * n * math.log2(n) * batch, 2 * 16.0 * n * batch)
            if tag == "estimate" or the_planner.hw.df32:
                _check(f"f64 {tag}", err, DOUBLE_TOL)
        _say(f"f64: df32 offered={'df32' in offered} "
             f"(device table: {the_planner.hw.df32})")
        if ("df32" in offered) != the_planner.hw.df32:
            raise AssertionError("f64: planner's df32 offer disagrees with "
                                 "the device table")


def phase_primes(sizes=(1009, 4006), batch=4096, sample=128, reps=10):
    """Prime and twice-prime sizes, as ESTIMATE plans them and with Rader
    (prime n) or Bluestein (otherwise) pinned through wisdom."""
    import jax
    import jax.numpy as jnp
    import fftw3_tpu as ftpu
    from fftw3_tpu.planner import the_planner
    from fftw3_tpu.utils import primes

    for n in sizes:
        x = _random(3 + n, (batch, n), jnp.complex64)
        rows = _sample_rows(batch, sample)
        want = np.fft.fft(np.asarray(x[rows]).astype(np.complex128), axis=1)
        ftpu.forget_wisdom()
        plans = {"estimate": ftpu.plan_many_dft([n], howmany=batch,
                                                dtype="complex64")}
        if primes.is_prime(n):
            tag = "rader"
            pin = {"alg": "rader", "n": n, "child": the_planner.plan_c2c(
                n - 1, np.float32, 0, batch)}
        else:
            tag = "bluestein"
            m = primes.next_pow2(2 * n - 1)
            pin = {"alg": "bluestein", "n": n, "m": m,
                   "child": the_planner.plan_c2c(m, np.float32, 0, batch)}
        with _pinned("c2c", n, np.float32, batch, pin):
            plans[tag] = ftpu.plan_many_dft([n], howmany=batch,
                                            dtype="complex64")
        for ptag, plan in plans.items():
            run = jax.jit(plan.apply)
            err = _relerr(np.asarray(run(x)[rows]), want)
            _say(f"primes: n={n} {ptag} {plan!r} relerr={err:.3e}")
            _rate("primes", f"n={n} {ptag}", _time(run, x, reps=reps),
                  5.0 * n * math.log2(n) * batch, 2 * 8.0 * n * batch)
            _check(f"primes n={n} {ptag}", err, SINGLE_TOL)


def phase_r2c2d(batch=8, n=2048, sample=2, reps=10):
    """2-D r2c of ``batch`` n x n images, then the c2r back."""
    import jax
    import jax.numpy as jnp
    import fftw3_tpu as ftpu

    shape = (batch, n, n)
    x = _random(4, shape, jnp.float32)
    fwd = ftpu.plan_dft_r2c(shape, axes=(1, 2), dtype="float32")
    bwd = ftpu.plan_dft_c2r(shape, axes=(1, 2), dtype="float32")
    rf, rb = jax.jit(fwd.apply), jax.jit(bwd.apply)
    imgs = _sample_rows(batch, sample)
    X = rf(x)
    x_imgs = np.asarray(x[imgs]).astype(np.float64)
    err = _relerr(np.asarray(X[imgs]), np.fft.rfft2(x_imgs))
    _say(f"r2c2d: {fwd!r} relerr={err:.3e}")
    _check("r2c2d r2c", err, SINGLE_TOL)
    y = rb(X)
    err2 = _relerr(np.asarray(y[imgs]) / (n * n), x_imgs)
    _say(f"r2c2d: {bwd!r} roundtrip relerr={err2:.3e}")
    _check("r2c2d c2r roundtrip", err2, SINGLE_TOL)
    flops = 2.5 * n * n * math.log2(n * n) * batch
    nbytes = (4.0 + 8.0 * (n // 2 + 1) / n) * n * n * batch
    _rate("r2c2d", "r2c", _time(rf, x, reps=reps), flops, nbytes)
    _rate("r2c2d", "c2r", _time(rb, X, reps=reps), flops, nbytes)


def phase_dct2(n=512, batch=65536, sample=128, reps=10):
    """DCT-II (FFTW REDFT10) against ``scipy.fft.dct`` type 2."""
    import jax
    import jax.numpy as jnp
    import scipy.fft
    import fftw3_tpu as ftpu

    x = _random(5, (batch, n), jnp.float32)
    plan = ftpu.plan_r2r((batch, n), ["redft10"], axes=(1,),
                         dtype="float32")
    run = jax.jit(plan.apply)
    rows = _sample_rows(batch, sample)
    want = scipy.fft.dct(np.asarray(x[rows]).astype(np.float64), type=2,
                         axis=1)
    err = _relerr(np.asarray(run(x)[rows]), want)
    _say(f"dct2: {plan!r} relerr={err:.3e}")
    _check("dct2", err, SINGLE_TOL)
    _rate("dct2", "redft10", _time(run, x, reps=reps),
          2.5 * n * math.log2(n) * batch, 2 * 4.0 * n * batch)


def phase_c2c3d(n=512, reps=10):
    """3-D c2c n^3 complex64 through ``plan_dft`` against scipy's fftn."""
    import jax
    import jax.numpy as jnp
    import scipy.fft
    import fftw3_tpu as ftpu

    shape = (n, n, n)
    x = _random(6, shape, jnp.complex64)
    plan = ftpu.plan_dft(shape, dtype="complex64")
    compiled, secs = _compile(plan.apply, x)
    _say(f"c2c3d: {plan!r} compile={secs:.2f} s")
    _say(f"c2c3d: memory_analysis {compiled.memory_analysis()}")
    run = jax.jit(plan.apply)
    want = scipy.fft.fftn(np.asarray(x).astype(np.complex128), workers=-1)
    err = _relerr(np.asarray(run(x)), want)
    del want
    _say(f"c2c3d: relerr={err:.3e}")
    _check("c2c3d", err, SINGLE_TOL)
    N = n ** 3
    _rate("c2c3d", "estimate", _time(run, x, reps=reps),
          5.0 * N * math.log2(N), 2 * 8.0 * N)


def phase_gradient(n=1024, batch=1024, reps=10):
    """``jax.grad`` through ``plan.apply`` against the adjoint transform:
    for L = Re<w, F x>, dL/dRe(x) + i dL/dIm(x) = F^H w = n ifft(w)."""
    import jax
    import jax.numpy as jnp
    import fftw3_tpu as ftpu

    plan = ftpu.plan_many_dft([n], howmany=batch, dtype="complex64")
    w = _random(7, (batch, n), jnp.complex64)
    xr = _random(8, (batch, n), jnp.float32)
    xi = _random(9, (batch, n), jnp.float32)

    def loss(a, b):
        y = plan.apply(a + 1j * b)
        return jnp.sum(jnp.real(w) * jnp.real(y) + jnp.imag(w) * jnp.imag(y))

    run = jax.jit(jax.grad(loss, argnums=(0, 1)))
    gr, gi = run(xr, xi)
    want = np.fft.ifft(np.asarray(w).astype(np.complex128), axis=1) * n
    err = _relerr(np.asarray(gr) + 1j * np.asarray(gi), want)
    _say(f"gradient: {plan!r} relerr={err:.3e}")
    _check("gradient", err, SINGLE_TOL)
    _rate("gradient", "grad", _time(run, xr, xi, reps=reps),
          5.0 * n * math.log2(n) * batch, 2 * 8.0 * n * batch)


def phase_model(n=2048, steps=20, nu=0.05, dt=0.01, kappa=2):
    """``models.navier_stokes_step`` on the Taylor-Green vortex against its
    analytic decay w0 exp(-2 nu kappa^2 t)."""
    import jax
    import jax.numpy as jnp
    from fftw3_tpu import models
    from fftw3_tpu.utils import timing

    step = jax.jit(models.navier_stokes_step(n, n, nu, dt))
    w0 = models.taylor_green_vorticity(n, n, kappa=kappa)
    w = jnp.asarray(w0)
    timing.sync(step(w))                           # compile outside
    t0 = time.perf_counter()
    for _ in range(steps):
        w = step(w)
    timing.sync(w)
    t = (time.perf_counter() - t0) / steps
    want = w0.astype(np.float64) * np.exp(-2.0 * nu * kappa ** 2
                                          * steps * dt)
    err = _relerr(np.asarray(w), want)
    _say(f"model: navier_stokes {n}x{n} {steps} steps relerr={err:.3e}")
    _check("model", err, MODEL_TOL)
    # one step = 2 r2c + 8 c2r 2-D transforms of n x n
    flops = 10 * 2.5 * n * n * math.log2(n * n)
    _rate("model", "step", t, flops, 10 * 2 * 4.0 * n * n)


SINGLE_PHASES = [phase_precision, phase_headline, phase_f64, phase_primes,
                 phase_r2c2d, phase_dct2, phase_c2c3d, phase_gradient,
                 phase_model]


# ---------------------------------------------------------------------------
# four-card phases (--multi)
# ---------------------------------------------------------------------------

def _mesh(devices, shape, names):
    from jax.sharding import Mesh
    return Mesh(np.asarray(devices[:math.prod(shape)]).reshape(shape), names)


def phase_slab3d(devices, n=512, reps=10):
    """Slab-decomposed 3-D c2c, transpose solver chosen by measurement."""
    import jax
    import jax.numpy as jnp
    import scipy.fft
    from fftw3_tpu import parallel

    mesh = _mesh(devices, (len(devices),), ("x",))
    plan = parallel.plan_dft_dist((n, n, n), mesh, "x",
                                  transpose_method="measure")
    x = jax.device_put(_random(11, (n, n, n), jnp.complex64),
                       plan.input_sharding())
    y = plan(x)
    err = _relerr(np.asarray(y), scipy.fft.fftn(
        np.asarray(x).astype(np.complex128), workers=-1))
    _say(f"slab3d: {plan!r} relerr={err:.3e}")
    _check("slab3d", err, SINGLE_TOL)
    N = n ** 3
    _rate("slab3d", "dist", _time(plan.apply, x, reps=reps),
          5.0 * N * math.log2(N), 2 * 8.0 * N)


def phase_r2c_dist(devices, n=2048, batch=8, reps=10):
    """Distributed 3-D r2c (batch x n x n) and its c2r round trip."""
    import jax
    import jax.numpy as jnp
    from fftw3_tpu import parallel

    mesh = _mesh(devices, (len(devices),), ("x",))
    shape = (batch, n, n)
    fwd = parallel.plan_dft_r2c_dist(shape, mesh, "x", axes=(1, 2),
                                     shard_axis=1)
    bwd = parallel.plan_dft_c2r_dist(shape, mesh, "x", axes=(1, 2),
                                     shard_axis=1)
    x = jax.device_put(_random(12, shape, jnp.float32), fwd.input_sharding())
    X = fwd(x)
    xh = np.asarray(x).astype(np.float64)
    err = _relerr(np.asarray(X), np.fft.rfft2(xh))
    _check("r2c_dist", err, SINGLE_TOL)
    y = bwd(X)
    err2 = _relerr(np.asarray(y) / (n * n), xh)
    _say(f"r2c_dist: {fwd!r} relerr={err:.3e} roundtrip={err2:.3e}")
    _check("r2c_dist roundtrip", err2, SINGLE_TOL)
    flops = 2.5 * n * n * math.log2(n * n) * batch
    _rate("r2c_dist", "r2c", _time(fwd.apply, x, reps=reps), flops,
          12.0 * n * n * batch)


def phase_pencil(devices, n=512, reps=10):
    """3-D c2c over a 2 x 2 pencil mesh."""
    import jax
    import jax.numpy as jnp
    import scipy.fft
    from fftw3_tpu import parallel

    mesh = _mesh(devices, (2, 2), ("y", "z"))
    plan = parallel.plan_dft_pencil((n, n, n), mesh)
    x = jax.device_put(_random(13, (n, n, n), jnp.complex64),
                       plan.input_sharding())
    err = _relerr(np.asarray(plan(x)), scipy.fft.fftn(
        np.asarray(x).astype(np.complex128), workers=-1))
    _say(f"pencil: {plan!r} relerr={err:.3e}")
    _check("pencil", err, SINGLE_TOL)
    N = n ** 3
    _rate("pencil", "dist", _time(plan.apply, x, reps=reps),
          5.0 * N * math.log2(N), 2 * 8.0 * N)


def phase_six_step(devices, n=1 << 24, reps=10):
    """Distributed 1-D c2c of one long vector (six-step)."""
    import jax
    import jax.numpy as jnp
    import scipy.fft
    from fftw3_tpu import parallel

    mesh = _mesh(devices, (len(devices),), ("x",))
    plan = parallel.plan_dft_1d_dist(n, mesh, "x")
    x = jax.device_put(_random(14, (n,), jnp.complex64),
                       plan.input_sharding())
    err = _relerr(np.asarray(plan(x)), scipy.fft.fft(
        np.asarray(x).astype(np.complex128), workers=-1))
    _say(f"six_step: {plan!r} relerr={err:.3e}")
    _check("six_step", err, SINGLE_TOL)
    _rate("six_step", "dist", _time(plan.apply, x, reps=reps),
          5.0 * n * math.log2(n), 2 * 8.0 * n)


def phase_filter_step(devices, batch=4, n=256, reps=5):
    """``models.spectral.distributed_filter_step`` under a seeded filter
    h = 1 + 0.1 r: its loss, mean |ifftn(fftn(x) h) - x|^2, against the
    same loss computed by SciPy in float64."""
    import jax
    import jax.numpy as jnp
    import scipy.fft
    from fftw3_tpu import models

    mesh = _mesh(devices, (len(devices),), ("x",))
    step, h0, in_sh = models.distributed_filter_step(mesh, (batch, n))
    shape = (batch, n, n, n)
    xr = jax.device_put(_random(15, shape, jnp.float32), in_sh)
    xi = jax.device_put(_random(16, shape, jnp.float32), in_sh)
    hp = 1.0 + 0.1 * np.asarray(_random(17, (1, n, n, n), jnp.float32))
    h = jax.device_put(hp.astype(np.float32), h0.sharding)
    h1, loss = step(h, xr, xi)
    x = np.asarray(xr).astype(np.float64) + 1j * np.asarray(xi)
    ax = (1, 2, 3)
    z = scipy.fft.ifftn(scipy.fft.fftn(x, axes=ax, workers=-1)
                        * hp.astype(np.float64), axes=ax, workers=-1)
    want = float(np.mean(np.abs(z - x) ** 2))
    del x, z
    err = abs(float(loss) - want) / want
    _say(f"filter_step: loss={float(loss):.6e} scipy={want:.6e} "
         f"relerr={err:.3e}")
    _check("filter_step loss", err, SINGLE_TOL)
    if not np.all(np.isfinite(np.asarray(h1))):
        raise AssertionError("filter_step: non-finite filter update")
    N = n ** 3
    # forward + inverse transform, and their adjoints in the gradient
    _rate("filter_step", "step", _time(step, h, xr, xi, reps=reps),
          4 * 5.0 * N * math.log2(N) * batch, 4 * 2 * 8.0 * N * batch)


MULTI_PHASES = [phase_slab3d, phase_r2c_dist, phase_pencil, phase_six_step,
                phase_filter_step]


def run_phases(phases, *args) -> list:
    """Run every phase; return the names of those that raised."""
    failed = []
    for phase in phases:
        t0 = time.perf_counter()
        try:
            phase(*args)
        except Exception:                              # noqa: BLE001
            traceback.print_exc()
            failed.append(phase.__name__)
            _say(f"{phase.__name__}: FAILED")
        _say(f"{phase.__name__}: wall={time.perf_counter() - t0:.1f} s")
    return failed


def main(argv=None) -> int:
    global CARD
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--multi", action="store_true",
                    help="run the distributed phases on four GPUs")
    args = ap.parse_args(argv)

    import jax
    devices = jax.devices()
    if devices[0].platform != "gpu":
        print(f"chip_smoke: needs an NVIDIA GPU; JAX found "
              f"{devices[0].platform!r}", file=sys.stderr)
        return 2
    from fftw3_tpu import native
    from fftw3_tpu.utils import compile_cache

    cache = compile_cache.enable()
    cards = card_lines()
    CARD = cards[0]
    for line in cards:
        _say(f"card: {line}")
    kind = devices[0].device_kind
    _say(f"device_kind: {kind}  devices: {len(devices)}  "
         f"jax: {jax.__version__}  native: {native.available()}  "
         f"compile_cache: {cache}")
    if args.multi:
        if len(devices) < 4:
            print(f"chip_smoke --multi: needs 4 GPUs, found {len(devices)}",
                  file=sys.stderr)
            return 2
        used = devices[:4]
        failed = run_phases(MULTI_PHASES, used)
    else:
        used = devices[:1]
        failed = run_phases(SINGLE_PHASES)
    if failed:
        print(f"chip_smoke: FAILED {failed}", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": devices[0].platform, "kind": kind,
        "count": len(used)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
