"""Benchmark harness — prints ONE JSON line, then one stderr line per config.

Metric convention is FFTW's (reference ``fftw/libbench2/mflops.c``):
complex transforms score ``5*N*log2(N)/t`` "normalized flops", real/r2r
``2.5*N*log2(N)/t``.  Times are host-clock medians of calls that end in
``block_until_ready`` (``fftw3_tpu/utils/timing.py``).

Every config is VERIFIED on the device before it is timed (the ``bench -y``
analog, ``fftw/libbench2/verify-dft.c``): a sample of the timed output is
compared against a NumPy float64 oracle, and the max relative error is
reported next to the GFLOPS number.

``vs_baseline`` is the fraction of the device-memory bandwidth bound: an
out-of-place c2c moves at least 16 bytes/point, so the bound is
5*log2(N) * BW/16 convention-flops/s, with BW from the device table
(``fftw3_tpu/devices.py``; an unlisted device is an error).

Usage: ``python bench.py [--quick] [--headline-only]`` on an NVIDIA GPU.
"""
from __future__ import annotations

import json
import math
import sys
import time

import numpy as np

#: FFTW's verify tolerances (libbench2/bench-main.c:70)
VERIFY_TOL = 1e-3
VERIFY_TOL_F64 = 1e-10


def _bw_peak() -> float:
    """Device-memory bandwidth of the attached device (bytes/s)."""
    from fftw3_tpu import devices
    return devices.current().hbm_bw


def _time(fn, *args) -> float:
    from fftw3_tpu.utils import timing
    return timing.time_dispatched(fn, args, reps=10)


def _relerr(actual: np.ndarray, ref: np.ndarray) -> float:
    return float(np.max(np.abs(actual - ref)) / np.max(np.abs(ref)))


def _check(relerr: float, what: str, tol: float = VERIFY_TOL) -> float:
    if not (relerr < tol):
        raise AssertionError(
            f"VERIFY FAILED for {what}: rel err {relerr:.2e} >= {tol:g}")
    return relerr


def _rows(batch: int, count: int = 128) -> np.ndarray:
    return np.unique(np.linspace(0, batch - 1, min(batch, count))
                     .astype(np.int64))


def bench_c2c_1d(n: int, batch: int, dtype="complex64"):
    import jax
    import jax.numpy as jnp

    import fftw3_tpu as ftpu

    f64 = dtype == "complex128"
    plan = ftpu.plan_many_dft([n], howmany=batch, dtype=dtype)
    run = jax.jit(plan.apply)
    x = jax.random.normal(jax.random.PRNGKey(0), (batch, n),
                          dtype=jnp.complex128 if f64 else jnp.complex64)
    rows = _rows(batch)
    ref = np.fft.fft(np.asarray(x[rows]).astype(np.complex128), axis=1)
    relerr = _check(_relerr(np.asarray(run(x)[rows]), ref),
                    f"c2c n={n} {dtype}",
                    VERIFY_TOL_F64 if f64 else VERIFY_TOL)
    t = _time(run, x)
    return 5.0 * n * np.log2(n) * batch / t, t, repr(plan), relerr


def bench_c2c_3d(n: int):
    import jax
    import jax.numpy as jnp

    import fftw3_tpu as ftpu

    x = jax.random.normal(jax.random.PRNGKey(1), (n, n, n),
                          dtype=jnp.complex64)
    plan = ftpu.plan_dft((n, n, n), dtype="complex64")
    run = jax.jit(plan.apply)
    ref = np.fft.fftn(np.asarray(x).astype(np.complex128))
    relerr = _check(_relerr(np.asarray(run(x)), ref), f"c2c 3d {n}^3")
    t = _time(run, x)
    flops = 5.0 * (n ** 3) * np.log2(float(n) ** 3)
    return flops / t, t, repr(plan), relerr


def bench_r2c_2d(n: int, batch: int = 8):
    import jax
    import jax.numpy as jnp

    import fftw3_tpu as ftpu

    x = jax.random.normal(jax.random.PRNGKey(2), (batch, n, n),
                          dtype=jnp.float32)
    plan = ftpu.plan_dft_r2c((batch, n, n), axes=(1, 2), dtype="float32")
    run = jax.jit(plan.apply)
    ref = np.fft.rfft2(np.asarray(x[:1]).astype(np.float64))
    relerr = _check(_relerr(np.asarray(run(x)[:1]), ref), f"r2c 2d {n}^2")
    t = _time(run, x)
    flops = 2.5 * (n * n) * np.log2(float(n) * n) * batch
    return flops / t, t, repr(plan), relerr


def bench_dct2(n: int, batch: int):
    import jax
    import jax.numpy as jnp

    import fftw3_tpu as ftpu

    x = jax.random.normal(jax.random.PRNGKey(3), (batch, n),
                          dtype=jnp.float32)
    plan = ftpu.plan_r2r((batch, n), ["redft10"], axes=(1,),
                         dtype="float32")
    run = jax.jit(plan.apply)
    # FFTW REDFT10: X[k] = 2 sum_j x[j] cos(pi(j+1/2)k/n)
    j = np.arange(n)[:, None]
    k = np.arange(n)[None, :]
    M = 2.0 * np.cos(np.pi * (j + 0.5) * k / n)
    rows = _rows(batch, 64)
    ref = np.asarray(x[rows]).astype(np.float64) @ M
    relerr = _check(_relerr(np.asarray(run(x)[rows]), ref), f"dct2 n={n}")
    t = _time(run, x)
    return 2.5 * n * np.log2(float(n)) * batch / t, t, repr(plan), relerr


def _bench_f64_1024():
    """1-D c2c n=1024 DOUBLE (libbench2 'ocf1024' class) at 1e-10."""
    import jax
    with jax.enable_x64(True):
        return bench_c2c_1d(1024, 8192, dtype="complex128")


def main():
    quick = "--quick" in sys.argv
    suite = not quick and "--headline-only" not in sys.argv

    import jax
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"bench.py: needs an NVIDIA GPU; JAX found {dev.platform!r}",
              file=sys.stderr)
        return 2
    from fftw3_tpu.utils import compile_cache
    compile_cache.enable()
    bw = _bw_peak()

    n, batch = 1024, (256 if quick else 65536)
    gf, t, desc, re0 = bench_c2c_1d(n, batch)
    roofline = 5.0 * math.log2(n) * (bw / 16.0)
    details = {"c2c_1d_1024_b%d" % batch:
               {"gflops": gf / 1e9, "sec": t, "plan": desc, "relerr": re0}}

    if suite:
        t_start = time.time()
        for name, fn in [("c2c_1d_1024_f64_b8192", _bench_f64_1024),
                         ("c2c_1d_4096_b4096",
                          lambda: bench_c2c_1d(4096, 4096)),
                         ("r2c_2d_2048", lambda: bench_r2c_2d(2048)),
                         ("c2c_3d_256", lambda: bench_c2c_3d(256)),
                         ("c2c_1d_1000_b32768",
                          lambda: bench_c2c_1d(1000, 32768)),
                         ("dct2_512_b65536", lambda: bench_dct2(512, 65536))]:
            try:
                g2, t2, d2, rel = fn()
            except Exception as exc:                   # noqa: BLE001
                print(f"# {name}: FAILED {exc}", file=sys.stderr)
                continue
            details[name] = {"gflops": g2 / 1e9, "sec": t2, "plan": d2,
                             "relerr": rel}
        print(f"# suite wall time {time.time() - t_start:.1f} s",
              file=sys.stderr)

    print(json.dumps({
        "metric": "c2c_1d_n1024_batched_gflops",
        "value": round(gf / 1e9, 2),
        "unit": "GFLOPS(5NlogN)",
        "vs_baseline": round(gf / roofline, 4),
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": 1},
    }))
    for k, v in details.items():
        print(f"# {k}: {v['gflops']:.1f} GFLOPS ({v['sec']*1e6:.0f} us) "
              f"relerr={v['relerr']:.1e} {v['plan']}", file=sys.stderr)
    from fftw3_tpu.planner import the_planner
    print(f"# planner stats: {the_planner.stats}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
