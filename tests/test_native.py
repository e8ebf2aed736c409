"""Tests for the native C++ runtime tier (fftw3_tpu/native.py +
native/src/fftw3_tpu_native.cpp).  The key property: the native planner
implements the IDENTICAL policy as the Python planner, so plans are
deterministic across hosts and tiers."""
import hashlib
import json

import numpy as np
import pytest

from fftw3_tpu import config, devices, native
from fftw3_tpu import planner as planner_mod
from fftw3_tpu.utils import primes

pytestmark = pytest.mark.skipif(not native.available(),
                                reason="native library unavailable "
                                       "(no g++?)")


class TestMd5:
    @pytest.mark.parametrize("data", [b"", b"abc", b"x" * 1000,
                                      bytes(range(256)) * 17])
    def test_matches_hashlib(self, data):
        assert native.md5_hex(data) == hashlib.md5(data).hexdigest()


class TestPrimes:
    def test_is_prime(self):
        for n in list(range(100)) + [1009, 65537, 65536, 104729]:
            assert native.is_prime(n) == primes.is_prime(n), n

    def test_largest_prime_factor(self):
        for n in [1, 2, 12, 1024, 1000, 9973, 2 * 3 * 5 * 7 * 11 * 13]:
            assert native.largest_prime_factor(n) == \
                primes.largest_prime_factor(n), n

    def test_find_generator(self):
        for p in [3, 5, 7, 11, 13, 101, 1009]:
            assert native.find_generator(p) == primes.find_generator(p), p

    def test_next_fast_size(self):
        for n in [1, 17, 100, 1000, 12345]:
            assert native.next_fast_size(n, 5) == primes.next_fast_size(n, 5)

    def test_divisors(self):
        for n in [1, 12, 60, 1024, 1000, 97]:
            assert native.divisors(n) == primes.divisors(n), n


class TestWisdomStore:
    def test_roundtrip_and_subsumption(self):
        s = native.NativeWisdomStore()
        s.put("k1", {"alg": "direct", "n": 8}, patience=2, cost=1.5)
        assert len(s) == 1
        hit = s.get("k1")
        assert hit["desc"] == {"alg": "direct", "n": 8}
        assert hit["patience"] == 2 and hit["cost"] == 1.5
        # less-patient insert must NOT overwrite (subsumes rule)
        s.put("k1", {"alg": "nop", "n": 1}, patience=1, cost=9.0)
        assert s.get("k1")["desc"]["alg"] == "direct"
        # equal-or-more patient replaces
        s.put("k1", {"alg": "mixed", "n": 8, "p": 2,
                     "child": {"alg": "direct", "n": 4}}, 3, 0.5)
        assert s.get("k1")["desc"]["alg"] == "mixed"
        # min_patience filtering
        assert s.get("k1", min_patience=3) is not None
        assert s.get("missing") is None

    def test_export_import(self):
        s = native.NativeWisdomStore()
        s.put("a", {"alg": "direct", "n": 4}, 0, 0.25)
        s.put("b", {"alg": "nop", "n": 1}, 1, 0.0)
        dumped = s.export_json()
        assert set(dumped) == {"a", "b"}
        s2 = native.NativeWisdomStore()
        s2.import_entries(dumped)
        assert len(s2) == 2
        assert s2.get("a")["desc"] == {"alg": "direct", "n": 4}

    def test_clear(self):
        s = native.NativeWisdomStore()
        s.put("x", {"alg": "nop", "n": 1}, 0, 0.0)
        s.clear()
        assert len(s) == 0


#: every entry of the device table: the C++ mirror must reproduce the
#: Python ESTIMATE policy under each device's cost model
DEVICE_KINDS = sorted(devices.DEVICES)


def _python_plan(kind, n, hw):
    """Pure-Python ESTIMATE search under the cost model ``hw``."""
    from fftw3_tpu import kinds as K
    old = config.use_native
    config.use_native = False
    try:
        return planner_mod.Planner(hw=hw)._plan(kind, n, np.float32,
                                                K.PATIENCE_ESTIMATE)
    finally:
        config.use_native = old


class TestNativePlannerEquality:
    """Native ESTIMATE search == Python ESTIMATE search, descriptor for
    descriptor, over a broad size sweep and every device-table entry."""

    @pytest.mark.parametrize("device_kind", DEVICE_KINDS)
    @pytest.mark.parametrize("n", [1, 2, 8, 64, 128, 129, 256, 360, 480,
                                   1000, 1009, 1024, 2048, 4096, 6144,
                                   10000, 12289, 65536])
    def test_equal_plans(self, n, device_kind):
        hw = planner_mod.HardwareModel.for_kind(device_kind)
        want = _python_plan("c2c", n, hw)
        got = native.plan_c2c(n, 0, hw)
        assert got == want, (n, got, want)

    def test_planner_routes_through_native(self):
        pl = planner_mod.Planner()
        old = config.use_native
        config.use_native = True
        try:
            desc = pl.plan_c2c(1024, np.float32, 0)
        finally:
            config.use_native = old
        assert desc["n"] == 1024
        # plan result is wisdom-cached under the same key either way
        assert pl.stats["nplan"] == 1


class TestNativeAllKinds:
    """The C++ tier's ESTIMATE search must EQUAL the Python policy for
    every transform kind (determinism across hosts; CLAUDE.md invariant)."""

    @pytest.mark.parametrize("device_kind", DEVICE_KINDS)
    @pytest.mark.parametrize("kind", ["r2c", "c2r"])
    @pytest.mark.parametrize("n", [16, 100, 256, 1000, 1024, 2048, 4096,
                                   8192, 65536])
    def test_real_kinds_equal(self, kind, n, device_kind):
        from fftw3_tpu import kinds as K
        hw = planner_mod.HardwareModel.for_kind(device_kind)
        nat = native.plan_kind(kind, n, K.PATIENCE_ESTIMATE, hw)
        assert nat == _python_plan(kind, n, hw)

    @pytest.mark.parametrize("kind", ["r2hc", "hc2r", "dht", "redft00",
                                      "redft01", "redft10", "redft11",
                                      "rodft00", "rodft01", "rodft10",
                                      "rodft11"])
    @pytest.mark.parametrize("n", [8, 33, 100, 512, 1025, 4097, 8192])
    def test_r2r_kinds_equal(self, kind, n):
        from fftw3_tpu import kinds as K
        hw = planner_mod.HardwareModel.for_kind("cpu")
        nat = native.plan_kind(kind, n, K.PATIENCE_ESTIMATE, hw)
        assert nat == _python_plan(kind, n, hw), f"{kind} n={n}"

    @pytest.mark.parametrize("kind", ["dht", "redft00", "redft10",
                                      "redft11", "rodft00", "rodft11"])
    @pytest.mark.parametrize("n", [33, 512, 1025, 8192])
    def test_r2r_kinds_equal_h200(self, kind, n):
        """The r2r reductions under the GPU's cost model, whose matrix
        rate moves the dense/reduction crossovers."""
        from fftw3_tpu import kinds as K
        hw = planner_mod.HardwareModel.for_kind("NVIDIA H200")
        nat = native.plan_kind(kind, n, K.PATIENCE_ESTIMATE, hw)
        assert nat == _python_plan(kind, n, hw), f"{kind} n={n}"
