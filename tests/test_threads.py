"""fftw/threads tier: plan_with_nthreads drives the multi-device engine.

Reference contract (fftw/threads/api.c:69-80 + the threads solvers):
plans created after fftw_plan_with_nthreads(k) split their loops over k
workers and produce bit-identical results to the serial plan.  Here the
workers are the 8 virtual CPU devices (parallel/smp.py): vector problems
shard the howmany dim, all-axes problems run the slab/six-step solvers.
"""
import jax
import numpy as np
import pytest

import fftw3_tpu as ftpu
from fftw3_tpu import threads


def relerr(a, b):
    return np.max(np.abs(np.asarray(a) - b)) / (np.max(np.abs(b)) or 1.0)


@pytest.fixture
def nthreads4():
    threads.init_threads()
    threads.plan_with_nthreads(4)
    yield 4
    threads.cleanup_threads()


def test_vector_plan_shards_howmany(rng, nthreads4):
    """A howmany plan under nthreads executes sharded over the batch dim
    (the threaded vrank-geq1 loop) and matches the serial result."""
    x = (rng.standard_normal((8, 64)) + 1j * rng.standard_normal((8, 64))
         ).astype(np.complex64)
    p = ftpu.plan_many_dft([64], howmany=8, dtype="complex64")
    assert p._par_fn is not None
    y = p.execute(x)
    assert relerr(y, np.fft.fft(x.astype(np.complex128), axis=1)) < 1e-3
    # the parallel path really uses >1 device
    assert len(y.sharding.device_set) == 4


def test_vector_plan_xla_solver(rng, nthreads4):
    """A howmany plan whose axis solver is XLA's own FFT (pinned through
    wisdom) must still shard: the custom-call output passes the
    shard_map's build and runs on all 4 devices."""
    from fftw3_tpu.planner import the_planner
    x = (rng.standard_normal((8, 512)) + 1j * rng.standard_normal((8, 512))
         ).astype(np.complex64)
    ftpu.forget_wisdom()
    try:
        the_planner.wisdom[the_planner._key("c2c", 512, np.float32, 8)] = {
            "desc": {"alg": "xla", "n": 512}, "patience": 99, "cost": 0.0}
        p = ftpu.plan_many_dft([512], howmany=8, dtype="complex64")
        assert p._par_fn is not None
        assert "xla" in repr(p)
        y = p.execute(x)
        assert relerr(y, np.fft.fft(x.astype(np.complex128), axis=1)) < 1e-3
        assert len(y.sharding.device_set) == 4
    finally:
        ftpu.forget_wisdom()


def test_all_axes_2d_uses_slab(rng, nthreads4):
    """An all-axes 2-D c2c has no vector loop: the engine falls to the
    slab solver (threads rank-geq2 ct role) and still matches numpy."""
    x = (rng.standard_normal((32, 48)) + 1j * rng.standard_normal((32, 48))
         ).astype(np.complex64)
    p = ftpu.plan_dft((32, 48), dtype="complex64")
    assert p._par_fn is not None
    y = p.execute(x)
    assert relerr(y, np.fft.fft2(x.astype(np.complex128))) < 1e-3
    assert len(y.sharding.device_set) > 1


def test_all_axes_1d_six_step(rng, nthreads4):
    """Rank-1 all-axes: the distributed six-step on the local mesh."""
    n = 256
    x = (rng.standard_normal(n) + 1j * rng.standard_normal(n)
         ).astype(np.complex64)
    p = ftpu.plan_dft((n,), dtype="complex64")
    assert p._par_fn is not None
    y = p.execute(x)
    assert relerr(y, np.fft.fft(x.astype(np.complex128))) < 1e-3


def test_r2c_and_c2r_threaded(rng, nthreads4):
    x = rng.standard_normal((24, 32)).astype(np.float32)
    pf = ftpu.plan_dft_r2c((24, 32), dtype="float32")
    pb = ftpu.plan_dft_c2r((24, 32), dtype="float32")
    assert pf._par_fn is not None and pb._par_fn is not None
    X = pf.execute(x)
    assert relerr(X, np.fft.rfft2(x.astype(np.float64))) < 1e-3
    back = pb.execute(np.asarray(X))
    assert relerr(back, 24 * 32 * x.astype(np.float64)) < 1e-3


def test_r2r_threaded(rng, nthreads4):
    x = rng.standard_normal((16, 8, 32)).astype(np.float32)
    p = ftpu.plan_r2r((16, 8, 32), ["redft10", "redft10"], axes=(1, 2),
                      dtype="float32")
    assert p._par_fn is not None
    y = p.execute(x)
    threads.plan_with_nthreads(1)
    ps = ftpu.plan_r2r((16, 8, 32), ["redft10", "redft10"], axes=(1, 2),
                       dtype="float32")
    assert ps._par_fn is None
    assert relerr(y, np.asarray(ps.execute(x), dtype=np.float64)) < 1e-5


def test_serial_fallback_when_unsplittable(rng, nthreads4):
    """A problem no engine case fits (prime rank-1 the six-step cannot
    factor over 4 devices) silently stays serial — FFTW's behavior when a
    loop has fewer iterations than threads."""
    x = (rng.standard_normal(1009) + 1j * rng.standard_normal(1009)
         ).astype(np.complex64)
    p = ftpu.plan_dft((1009,), dtype="complex64")
    y = p.execute(x)   # works either way
    assert relerr(y, np.fft.fft(x.astype(np.complex128))) < 1e-3


def test_nthreads_reset_restores_serial(rng):
    threads.init_threads()
    threads.plan_with_nthreads(4)
    threads.cleanup_threads()
    p = ftpu.plan_dft((64, 64), dtype="complex64")
    assert p._par_fn is None


def test_apply_stays_pure_under_nthreads(rng, nthreads4):
    """plan.apply must remain embeddable in a user jit (serial closure)."""
    x = (rng.standard_normal((8, 64)) + 1j * rng.standard_normal((8, 64))
         ).astype(np.complex64)
    p = ftpu.plan_many_dft([64], howmany=8, dtype="complex64")
    y = jax.jit(lambda a: p.apply(a) * 2.0)(x)
    assert relerr(y, 2 * np.fft.fft(x.astype(np.complex128), axis=1)) < 1e-3


def test_debug_surfaces_engine_bugs(rng, nthreads4, monkeypatch):
    """An engine BUG (as opposed to a legitimate no-fit) must not hide
    behind the serial fallback: under config.debug the exception
    propagates; without it, a stderr line is emitted (round-3 verdict —
    parallel/smp.py used to swallow every exception)."""
    import io
    import sys

    from fftw3_tpu import config
    from fftw3_tpu.parallel import dist, smp

    def boom(*a, **kw):
        raise RuntimeError("deliberately broken dist planner")

    monkeypatch.setattr(dist, "plan_dft_dist", boom)
    monkeypatch.setattr(config, "debug", True)
    with pytest.raises(RuntimeError, match="deliberately broken"):
        ftpu.plan_dft((64, 64), dtype="complex64")

    monkeypatch.setattr(config, "debug", False)
    err = io.StringIO()
    monkeypatch.setattr(sys, "stderr", err)
    p = ftpu.plan_dft((64, 64), dtype="complex64")
    assert p._par_fn is None                       # degraded to serial...
    assert "fell back to serial" in err.getvalue()  # ...but said so


def test_no_fit_fallback_stays_silent(rng, nthreads4, monkeypatch):
    """The legitimate no-fit case (1-D-of-2-D last-axis problem: no slab
    axis) must stay a SILENT serial fallback even under config.debug —
    FFTW's fewer-iterations-than-threads behavior, not a bug."""
    import io
    import sys

    from fftw3_tpu import config

    monkeypatch.setattr(config, "debug", True)
    err = io.StringIO()
    monkeypatch.setattr(sys, "stderr", err)
    # 7 rows: not divisible by 4 (no vector split); transform axis is the
    # last one only (no slab axis) -> _NoFit
    x = (rng.standard_normal((7, 64)) + 1j * rng.standard_normal((7, 64))
         ).astype(np.complex64)
    p = ftpu.plan_many_dft([64], howmany=7, dtype="complex64")
    assert p._par_fn is None
    assert "fell back" not in err.getvalue()
    y = p.execute(x)
    assert relerr(y, np.fft.fft(x.astype(np.complex128), axis=1)) < 1e-3
