"""The ``bench`` binary analog (``fftw/libbench2/bench-main.c`` +
``fftw/tests/fftw-bench.c``)::

    python -m fftw3_tpu.harness -s c1024            # speed
    python -m fftw3_tpu.harness -y c1024 -y r256    # verify
    python -m fftw3_tpu.harness -oestimate -opatient ...
    python -m fftw3_tpu.harness --paranoid -y 32x64
    python -m fftw3_tpu.harness -owisdom -s c4096   # wis.dat read/write

Speed output follows the reference's ``report_benchmark`` shape:
``Problem: <p>, setup: <t>, time: <t>, ``mflops``: <x>``.

Distributed mode (``fftw/mpi/mpi-bench.c`` analog) times/verifies the same
problem strings on a P-device mesh::

    python -m fftw3_tpu.harness --dist 8 -y c1024 -y 256x256x256
    python -m fftw3_tpu.harness --dist 4 -s 1024x1024 --dist-method ppermute

``--dist P`` runs on the first P of the process's devices and exits if
there are fewer.  A process held to the CPU (``JAX_PLATFORMS=cpu``) gets a
virtual P-device CPU mesh instead, like ``mpiexec -np P mpi-bench``
oversubscribed on one host; the plans are the identical shard_map programs
either way.  The ``t`` problem-flag letter maps to TRANSPOSED_OUT
(rank >= 2) / SCRAMBLED_OUT (rank 1), like mpi-bench's ``-obflag=30/31``.
"""
from __future__ import annotations

import argparse
import contextlib
import sys
import time

import numpy as np

from .. import api
from .. import kinds as K
from .mflops import mflops
from .problem import make_plan, parse_problem
from .verify import VerificationError, verify_problem

WISFILE = "wis.dat"


def _speed(pstring: str, flags: int, verbose: int, dtype: str) -> None:
    from ..utils import timing

    import jax
    import jax.numpy as jnp

    prob = parse_problem(pstring)
    t0 = time.perf_counter()
    plan = make_plan(prob, flags, dtype)
    setup = time.perf_counter() - t0
    rng = np.random.default_rng(0)
    rdt = np.float32 if dtype in ("float32", "complex64") else np.float64
    complex_in = prob.kind in ("c2c", "c2r")
    complex_out = prob.kind in ("c2c", "r2c")
    apply = plan.apply

    # real inputs and outputs at the program boundary
    def wrap(fn):
        def run(*parts):
            y = fn(parts[0] + 1j * parts[1]) if complex_in else fn(parts[0])
            return (jnp.real(y), jnp.imag(y)) if complex_out else (y,)
        return run

    fn = jax.jit(wrap(apply))
    args = [jnp.asarray(rng.standard_normal(plan.in_shape), rdt)]
    if complex_in:
        args.append(jnp.asarray(rng.standard_normal(plan.in_shape), rdt))
    t = timing.time_dispatched(fn, tuple(args), reps=5)
    mf = mflops(prob, t)
    print(f"Problem: {pstring}, setup: {setup:.2f} s, time: {t:.3e} s, "
          f"``mflops'': {mf:.5g}")
    if verbose >= 2:
        plan.print_plan()


def _verify(pstring: str, flags: int, verbose: int, dtype: str,
            paranoid_mode: bool, rounds: int) -> None:
    rdtype = "float64" if dtype in ("float64", "complex128") else "float32"
    ctx = contextlib.nullcontext()
    if paranoid_mode:
        from .paranoid import paranoid
        ctx = paranoid()
    with ctx:
        res = verify_problem(pstring, flags=flags, rounds=rounds,
                             rdtype=rdtype)
    if verbose >= 1:
        print(f"{pstring} {res.max_err:.3e}")


def _held_to_cpu() -> bool:
    import os

    import jax
    platforms = jax.config.jax_platforms or os.environ.get(
        "JAX_PLATFORMS", "")
    return platforms.split(",")[0].strip() == "cpu"


def _dist_setup(nproc: int, on_cpu: bool):
    """A mesh over the first ``nproc`` devices.  A process held to the CPU
    gets ``nproc`` virtual CPU devices with f64 (this must run before the
    first device operation; mirrors tests/conftest.py)."""
    import os

    import jax
    if on_cpu:
        os.environ["XLA_FLAGS"] = (
            os.environ.get("XLA_FLAGS", "")
            + f" --xla_force_host_platform_device_count={nproc}")
        jax.config.update("jax_enable_x64", True)
    devs = jax.devices()
    if len(devs) < nproc:
        raise SystemExit(f"--dist {nproc}: only {len(devs)} "
                         "devices available")
    return jax.make_mesh((nproc,), ("x",), devices=devs[:nproc])


def _dist_plan(prob, mesh, flags: int, dtype: str, method: str):
    """Build the distributed plan for a parsed bench problem
    (mpi-bench's problem -> fftw_mpi_plan_* dispatch)."""
    from .. import parallel

    shape = prob.shape
    axes = prob.axes
    tout = prob.transposed
    if prob.kind == "c2c":
        return parallel.plan_dft_dist(
            shape, mesh, axes=axes, sign=prob.sign,
            shard_axis=axes[0], transposed_out=tout, flags=flags,
            dtype=dtype, transpose_method=method)
    if prob.kind in ("r2c", "c2r"):
        if len(axes) < 2:
            raise ValueError("distributed r2c/c2r needs rank >= 2 (the "
                             "halved axis must stay local), like FFTW-MPI")
        fn = parallel.plan_dft_r2c_dist if prob.kind == "r2c" \
            else parallel.plan_dft_c2r_dist
        kw = {"transposed_out": tout} if prob.kind == "r2c" else {}
        rdt = "float64" if dtype in ("float64", "complex128") else "float32"
        return fn(shape, mesh, axes=axes, shard_axis=axes[0], flags=flags,
                  dtype=rdt, transpose_method=method, **kw)
    rdt = "float64" if dtype in ("float64", "complex128") else "float32"
    return parallel.plan_r2r_dist(shape, list(prob.r2r_kinds), mesh,
                                  axes=axes, shard_axis=axes[0],
                                  transposed_out=tout, flags=flags,
                                  dtype=rdt, transpose_method=method)


def _dist_input_and_oracle(prob, rng):
    """(host input, f64 oracle of the unnormalized transform).  The oracle
    ignores layout: transposed/scrambled outputs hold the same values."""
    from ..ops import matrices

    shape = prob.shape
    caxes = prob.axes
    if prob.kind == "c2c":
        x = (rng.standard_normal(shape)
             + 1j * rng.standard_normal(shape)).astype(np.complex128)
        want = np.fft.fftn(x, axes=caxes) if prob.sign == K.FORWARD \
            else np.fft.ifftn(x, axes=caxes) * prob.logical_n
        return x, want
    if prob.kind == "r2c":
        x = rng.standard_normal(shape)
        return x, np.fft.rfftn(x, axes=caxes)
    if prob.kind == "c2r":
        r = rng.standard_normal(shape)
        x = np.fft.rfftn(r, axes=caxes)
        return x, r * prob.logical_n
    x = rng.standard_normal(shape)
    want = np.asarray(x, np.float64)
    for a, kk in zip(caxes, prob.r2r_kinds):
        M = matrices.r2r_matrix(kk.value, shape[a])
        want = np.moveaxis(np.moveaxis(want, a, -1) @ M, -1, a)
    return x, want


def _verify_dist(pstring: str, mesh, flags: int, verbose: int, dtype: str,
                 method: str) -> None:
    import jax
    from jax.sharding import NamedSharding

    prob = parse_problem(pstring)
    plan = _dist_plan(prob, mesh, flags, dtype, method)
    rng = np.random.default_rng(0)
    x, want = _dist_input_and_oracle(prob, rng)
    xg = jax.device_put(x, NamedSharding(mesh, plan.in_spec))
    got = np.asarray(plan(xg))
    if "scrambled" in plan.desc and "scrambled_in" not in plan.desc:
        # six-step SCRAMBLED_OUT: out[c + R*d] sits at matrix [c, d];
        # undo the documented scramble before comparing.  (transposed_out
        # changes only the sharding, not the logical layout.)
        R = int(plan.desc.split("R=")[1].split()[0])
        C = prob.sizes[-1] // R
        got = np.moveaxis(
            got.reshape(got.shape[:-1] + (R, C)), -1, -2
        ).reshape(got.shape)
    err = np.max(np.abs(got - want)) \
        / max(float(np.max(np.abs(want))), 1e-300)
    tol = 1e-10 if dtype in ("float64", "complex128") else 1e-3
    if err > tol:
        raise VerificationError(f"{pstring} dist relerr {err:.3e} > {tol}")
    if verbose >= 1:
        print(f"{pstring} [dist {mesh.shape}] {plan.desc} {err:.3e}")


def _speed_dist(pstring: str, mesh, flags: int, verbose: int, dtype: str,
                method: str) -> None:
    import jax
    from jax.sharding import NamedSharding

    from ..utils import timing

    prob = parse_problem(pstring)
    t0 = time.perf_counter()
    plan = _dist_plan(prob, mesh, flags, dtype, method)
    setup = time.perf_counter() - t0
    rng = np.random.default_rng(0)
    x, _ = _dist_input_and_oracle(prob, rng)
    xg = jax.device_put(x, NamedSharding(mesh, plan.in_spec))
    t = timing.time_dispatched(plan.apply, (xg,), reps=5)
    mf = mflops(prob, t)
    print(f"Problem: {pstring}, dist: {dict(mesh.shape)} {plan.desc}, "
          f"setup: {setup:.2f} s, time: {t:.3e} s, ``mflops'': {mf:.5g}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="fftw3_tpu.harness", add_help=True,
        description="FFTW-style bench/verify harness")
    ap.add_argument("-s", "--speed", action="append", default=[],
                    metavar="PROBLEM")
    ap.add_argument("-y", "--verify", action="append", default=[],
                    metavar="PROBLEM")
    ap.add_argument("-v", "--verbose", type=int, nargs="?", const=1,
                    default=0)
    ap.add_argument("-o", "--option", action="append", default=[],
                    help="estimate|measure|patient|exhaustive|"
                         "wisdom|paranoid|nthreads=N")
    ap.add_argument("--paranoid", action="store_true")
    ap.add_argument("--double", action="store_true",
                    help="float64/complex128 transforms")
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("--dist", type=int, default=0, metavar="P",
                    help="run every -s/-y problem distributed over a "
                         "P-device mesh (mpi-bench analog; a virtual CPU "
                         "mesh with f64 when the process is held to the "
                         "CPU)")
    ap.add_argument("--dist-method", default="all_to_all",
                    choices=["all_to_all", "ppermute", "recurse",
                             "measure"],
                    help="global-transpose algorithm for --dist")
    args = ap.parse_args(argv)

    flags = K.ESTIMATE
    use_wisdom = False
    for opt in args.option:
        o = opt.lower()
        if o == "estimate":
            flags = K.ESTIMATE
        elif o == "measure":
            flags = K.MEASURE
        elif o == "patient":
            flags = K.PATIENT
        elif o == "exhaustive":
            flags = K.EXHAUSTIVE
        elif o == "wisdom":
            use_wisdom = True
        elif o == "paranoid":
            args.paranoid = True
        elif o.startswith("nthreads="):
            from .. import threads
            threads.plan_with_nthreads(int(o.split("=", 1)[1]))
        else:
            ap.error(f"unknown -o option {opt!r}")

    if use_wisdom:
        api.import_wisdom_from_filename(WISFILE)

    dtype = "complex128" if args.double else "complex64"
    status = 0
    if args.dist:
        on_cpu = _held_to_cpu()
        mesh = _dist_setup(args.dist, on_cpu)
        if on_cpu:
            dtype = "complex128"    # virtual CPU mesh: f64 oracle-grade
        for p in args.verify:
            try:
                _verify_dist(p, mesh, flags, max(args.verbose, 1), dtype,
                             args.dist_method)
            except (VerificationError, ValueError) as exc:
                print(f"FAILED {p}: {exc}", file=sys.stderr)
                status = 1
        for p in args.speed:
            _speed_dist(p, mesh, flags, args.verbose, dtype,
                        args.dist_method)
        if use_wisdom:
            api.export_wisdom_to_filename(WISFILE)
        return status
    for p in args.verify:
        try:
            _verify(p, flags, args.verbose, dtype, args.paranoid,
                    args.rounds)
        except (VerificationError, ValueError) as exc:
            print(f"FAILED {p}: {exc}", file=sys.stderr)
            status = 1
    for p in args.speed:
        _speed(p, flags, args.verbose, dtype)

    if use_wisdom:
        api.export_wisdom_to_filename(WISFILE)
    return status


if __name__ == "__main__":
    sys.exit(main())
