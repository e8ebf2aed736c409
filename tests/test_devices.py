"""The device table, the platform's matmul precision, the compile-cache
helper and the host-clock timer."""
import jax
import numpy as np
import pytest

from fftw3_tpu import config, devices
from fftw3_tpu import planner as planner_mod
from fftw3_tpu.utils import compile_cache, timing


@pytest.mark.parametrize("kind", sorted(devices.DEVICES))
def test_table_entries_are_complete(kind):
    spec = devices.lookup(kind)
    assert spec.source
    assert spec.platform in config._PLATFORM_PRECISION
    for rate in (spec.hbm_bw, spec.hbm_bytes, spec.f32_flops,
                 spec.f64_flops, spec.f64_matmul_flops):
        assert rate > 0
    assert set(spec.f32_matmul_flops) >= {"high", "highest", "default"}


def test_h200_entry_is_the_data_sheet():
    spec = devices.lookup("NVIDIA H200")
    assert (spec.hbm_bw, spec.hbm_bytes) == (4.8e12, 141e9)
    assert spec.f32_flops == 67e12
    assert spec.f32_matmul_flops["high"] == 495e12       # TF32
    assert (spec.f64_flops, spec.f64_matmul_flops) == (34e12, 67e12)
    assert not spec.f64_emulated


def test_unknown_kind_raises():
    with pytest.raises(ValueError, match="not in the device table"):
        devices.lookup("Unlisted Accelerator")
    with pytest.raises(ValueError, match="not in the device table"):
        planner_mod.HardwareModel.for_kind("NVIDIA A100-SXM4-80GB")


def test_current_is_the_test_host():
    assert devices.current() is devices.DEVICES["cpu"]


def test_planner_refuses_unknown_device(monkeypatch):
    """The planner resolves its model from the first device at the first
    plan; an unlisted device is an error, never a default."""
    class FakeDevice:
        device_kind = "Mystery Accelerator"
    monkeypatch.setattr(jax, "devices", lambda *a: [FakeDevice()])
    with pytest.raises(ValueError, match="Mystery Accelerator"):
        planner_mod.Planner().plan_c2c(64, np.float32, 0)


def test_cpu_model_keeps_pinned_plans():
    """The CPU entry is the planning model the tests were pinned under."""
    hw = planner_mod.HardwareModel.for_kind("cpu")
    assert (hw.hbm_bw, hw.matmul_flops, hw.elem_flops) == (8e11, 4e13, 4e12)
    assert hw.matmul_k == 128
    assert hw.f64_matmul_penalty == pytest.approx(200.0)
    assert hw.f64_elem_penalty == pytest.approx(8.0)
    assert hw.f64_fft_penalty == pytest.approx(8.0)


def test_h200_prices_f64_natively():
    """No emulation penalty on the H200: f64 costs its doubled bytes and
    the data sheet's rate ratios, and XLA's f64 FFT is not inflated."""
    hw = planner_mod.HardwareModel.for_kind("NVIDIA H200")
    assert hw.f64_fft_penalty == 1.0
    assert hw.f64_matmul_penalty == pytest.approx(
        hw.matmul_flops / 67e12)
    xla = {"alg": "xla", "n": 1024}
    assert planner_mod._c2c_cost(xla, hw, f64=True) == pytest.approx(
        2 * planner_mod._c2c_cost(xla, hw))
    pl = planner_mod.Planner(hw=hw)
    desc = pl.plan_c2c(1024, np.float64, 0)
    assert desc["alg"] != "df32", desc


@pytest.mark.parametrize("kind,offered", [("cpu", True),
                                          ("NVIDIA H200", False)])
def test_df32_offered_only_where_exact(kind, offered):
    """df32's error-free transforms missed 1e-10 on the H200, so the
    planner offers it only on devices where they hold."""
    pl = planner_mod.Planner(hw=planner_mod.HardwareModel.for_kind(kind))
    algs = {d["alg"] for d in pl._candidates("c2c", 1024, np.float64, 0)}
    assert ("df32" in algs) == offered


@pytest.mark.parametrize("platform,name,enum", [
    ("gpu", "highest", jax.lax.Precision.HIGHEST),
    ("cpu", "high", jax.lax.Precision.HIGH)])
def test_precision_per_platform(monkeypatch, platform, name, enum):
    monkeypatch.setattr(config, "matmul_precision", None)
    monkeypatch.setattr(jax, "default_backend", lambda: platform)
    assert config.precision_name() == name
    assert config.precision() == enum


def test_precision_override_and_unknown_platform(monkeypatch):
    monkeypatch.setattr(jax, "default_backend", lambda: "mystery")
    monkeypatch.setattr(config, "matmul_precision", None)
    with pytest.raises(ValueError, match="mystery"):
        config.precision_name()
    monkeypatch.setattr(config, "matmul_precision", "high")
    assert config.precision() == jax.lax.Precision.HIGH


def test_h200_model_follows_the_precision(monkeypatch):
    """The cost model's matmul rate is the one of the precision in force:
    TF32 under "high", full f32 under "highest"."""
    monkeypatch.setattr(config, "matmul_precision", "high")
    assert planner_mod.HardwareModel.for_kind(
        "NVIDIA H200").matmul_flops == 495e12
    monkeypatch.setattr(config, "matmul_precision", "highest")
    assert planner_mod.HardwareModel.for_kind(
        "NVIDIA H200").matmul_flops == 67e12


def test_compile_cache_honours_the_variable(monkeypatch, tmp_path):
    calls = []
    monkeypatch.setattr(jax.config, "update",
                        lambda *a: calls.append(a))
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert compile_cache.enable() == str(tmp_path)
    assert calls == []                    # JAX reads the variable itself


def test_compile_cache_default_is_in_the_checkout(monkeypatch):
    import os
    calls = []
    monkeypatch.setattr(jax.config, "update",
                        lambda *a: calls.append(a))
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = compile_cache.enable()
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert path == os.path.join(repo, ".jax_cache")
    assert calls == [("jax_compilation_cache_dir", path)]
    with open(os.path.join(repo, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()


class _Clock:
    """A fake perf_counter advancing by the scripted call durations."""

    def __init__(self, durations):
        self.now = 0.0
        self.durations = list(durations)
        self.started = False

    def __call__(self):
        if self.started:
            self.now += self.durations.pop(0)
        self.started = not self.started
        return self.now


def test_timer_warms_up_and_takes_the_median(monkeypatch):
    # warm-up call (compile) 9 s, then 5 timed calls
    clock = _Clock([9.0, 1.0, 5.0, 2.0, 3.0, 100.0])
    monkeypatch.setattr(timing.time, "perf_counter", clock)
    synced = []
    monkeypatch.setattr(timing, "sync", synced.append)
    t = timing.time_dispatched(lambda a: a + 1, (np.ones(3),), reps=5)
    assert t == 3.0                       # median; warm-up and outlier out
    assert len(synced) == 6               # every call waited for its result


def test_timer_multi_interleaves(monkeypatch):
    order = []

    def make(tag):
        def fn(a):
            order.append(tag)
            return a
        return fn

    ts = timing.time_dispatched_multi(
        [(make("a"), (np.ones(2),)), (make("b"), (np.ones(2),))], reps=3)
    assert len(ts) == 2 and all(t >= 0 for t in ts)
    assert order == ["a", "b"] + ["a", "b"] * 3


def test_timer_real_device_call():
    x = jax.numpy.ones((64, 64))
    t = timing.time_dispatched(jax.jit(lambda a: a @ a), (x,), reps=3)
    assert 0 < t < 10
