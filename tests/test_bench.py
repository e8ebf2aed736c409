"""bench.py's configs at tiny sizes on the CPU (each verifies its own
timed output before timing), and its refusal to report without a GPU."""
import jax
import pytest

import bench


@pytest.mark.parametrize("fn,args", [
    (bench.bench_c2c_1d, (64, 16)),
    (bench.bench_c2c_1d, (60, 8)),
    (bench.bench_c2c_3d, (8,)),
    (bench.bench_r2c_2d, (32, 2)),
    (bench.bench_dct2, (32, 16)),
], ids=["c2c_pow2", "c2c_nonpow2", "c2c_3d", "r2c_2d", "dct2"])
def test_config_small(fn, args):
    gflops, t, plan, relerr = fn(*args)
    assert gflops > 0 and t > 0
    assert relerr < bench.VERIFY_TOL
    assert plan.startswith("(plan ")


def test_f64_config_small():
    gflops, t, plan, relerr = bench.bench_c2c_1d(64, 8, dtype="complex128")
    assert relerr < bench.VERIFY_TOL_F64


def test_bandwidth_bound_reads_the_device_table():
    from fftw3_tpu import devices
    assert bench._bw_peak() == devices.DEVICES["cpu"].hbm_bw


def test_check_rejects_a_miss():
    with pytest.raises(AssertionError, match="VERIFY FAILED"):
        bench._check(2e-3, "x")


def test_main_refuses_cpu(capsys, monkeypatch):
    monkeypatch.setattr("sys.argv", ["bench.py"])
    assert jax.default_backend() == "cpu"
    assert bench.main() == 2
    assert capsys.readouterr().out == ""
