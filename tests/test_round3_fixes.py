"""Regression tests for the round-2 judge findings (VERDICT.md round 3):
MEASURE trust calibration, planner-path correction (FFTW_RANDOM_ESTIMATOR
role, fftw/fftw_api.c:15090-15104), and timelimit-aware wisdom subsumption
(timelimit_to_flags + subsumes, fftw/fftw_api.c:126-142, :14748)."""
import numpy as np
import pytest

import fftw3_tpu.planner as planner_mod
from fftw3_tpu import config
from fftw3_tpu import kinds as K
from fftw3_tpu.planner import Planner
from fftw3_tpu.utils import timing as timing_mod


@pytest.fixture
def small_measure():
    old_pts = config.measure_points
    config.measure_points = 1 << 12      # keep CPU MEASURE timing cheap
    yield
    config.measure_points = old_pts


@pytest.fixture
def hysteresis():
    old = config.measure_hysteresis
    yield
    config.measure_hysteresis = old


class _Tagged:
    """Stands in for a compiled MEASURE candidate; carries its alg."""

    def __init__(self, alg):
        self.alg = alg


def _stub_measure(monkeypatch, table):
    """Replace candidate compilation and the device timer with a canned
    per-alg oracle, leaving the real _measure_best search/hysteresis/
    wisdom machinery fully exercised."""
    monkeypatch.setattr(
        planner_mod, "_measure_fn",
        lambda kind, desc, n, rdtype, batch=None: (_Tagged(desc["alg"]),
                                                   ()))

    def fake_timer(fn, args, **kw):
        return table[fn.alg]
    monkeypatch.setattr(timing_mod, "time_dispatched", fake_timer)


def test_measure_flips_rigged_estimate(monkeypatch, hysteresis):
    """A rigged (wrong) cost model is corrected by MEASURE and wisdom then
    serves the flipped choice — the FFTW_RANDOM_ESTIMATOR planner-path
    property (fftw/fftw_api.c:15090-15104)."""
    config.measure_hysteresis = 0.9
    pl = Planner()
    real_cost = Planner._cost

    def rigged(self, kind, desc, f64=False):
        c = real_cost(self, kind, desc, f64)
        # rig: make every mixed split look like the best plan for n=64
        return c * 1e-6 if desc.get("alg") == "mixed" else c
    monkeypatch.setattr(Planner, "_cost", rigged)
    # the "device": direct is 5x faster than the rigged favourite.  Stub
    # BEFORE any PATIENT call — _candidates recursively plans children,
    # which would otherwise compile+time real kernels.
    _stub_measure(monkeypatch, {"mixed": 1.0, "direct": 0.2,
                                "bluestein": 2.0, "rader": 2.0, "xla": 2.0})
    cands = pl._candidates("c2c", 64, np.float32, K.PATIENCE_PATIENT)
    est_best = min(cands, key=lambda d: pl._cost("c2c", d))
    assert est_best["alg"] == "mixed"
    desc = pl.plan_c2c(64, np.float32, K.PATIENCE_PATIENT)
    assert desc["alg"] == "direct", \
        "MEASURE failed to correct the rigged estimator"
    assert pl.stats["nmeasure"] > 0
    # wisdom must now serve the corrected plan without re-measuring
    nm = pl.stats["nmeasure"]
    again = pl.plan_c2c(64, np.float32, K.PATIENCE_PATIENT)
    assert again == desc
    assert pl.stats["nmeasure"] == nm
    assert pl.stats["nwisdom_hit"] >= 1


def test_hysteresis_is_a_config_knob(monkeypatch, hysteresis):
    """VERDICT weak #5: the 30% one-way ratchet must be configurable.
    A 10% measured win is forfeited at hysteresis 0.7 and kept at 1.0."""
    pl = Planner()
    table = {a: 1.0 for a in ("mixed", "direct", "bluestein", "rader",
                              "xla")}
    _stub_measure(monkeypatch, table)      # before any MEASURE-level call
    cands = pl._candidates("c2c", 64, np.float32, K.PATIENCE_MEASURE)
    by_cost = sorted(cands, key=lambda d: pl._cost("c2c", d))
    est_alg = by_cost[0]["alg"]
    other = next(d["alg"] for d in by_cost[1:] if d["alg"] != est_alg)
    table[other] = 0.9                     # 10% faster than the estimate

    config.measure_hysteresis = 0.7
    d, _ = pl._measure_best("c2c", 64, np.float32,
                            [dict(c) for c in cands])
    assert d["alg"] == est_alg             # ratchet holds

    config.measure_hysteresis = 1.0
    d, _ = pl._measure_best("c2c", 64, np.float32,
                            [dict(c) for c in cands])
    assert d["alg"] == other               # full trust flips


def test_resolved_hysteresis_default(monkeypatch, hysteresis):
    """One default margin on every backend (5%): a measured winner within
    it keeps the ESTIMATE choice, one beyond it overrides."""
    assert config.measure_hysteresis == pytest.approx(0.95)
    pl = Planner()
    table = {a: 1.0 for a in ("mixed", "direct", "bluestein", "rader",
                              "xla")}
    _stub_measure(monkeypatch, table)
    cands = pl._candidates("c2c", 64, np.float32, K.PATIENCE_MEASURE)
    by_cost = sorted(cands, key=lambda d: pl._cost("c2c", d))
    est_alg = by_cost[0]["alg"]
    other = next(d["alg"] for d in by_cost[1:] if d["alg"] != est_alg)
    table[other] = 0.97                    # inside the margin
    d, _ = pl._measure_best("c2c", 64, np.float32,
                            [dict(c) for c in cands])
    assert d["alg"] == est_alg
    table[other] = 0.9                     # beyond it
    d, _ = pl._measure_best("c2c", 64, np.float32,
                            [dict(c) for c in cands])
    assert d["alg"] == other


def test_patient_pow2_terminates(monkeypatch, small_measure):
    """Regression: PATIENT planning of a power-of-two size recursed
    n -> 2n -> 4n via the patience-extra bluestein candidate (whose padded
    child regenerated the candidate).  The lpf(n) > 5 gate ends it."""
    table = {a: 1.0 for a in ("mixed", "direct", "bluestein", "rader",
                              "xla")}
    _stub_measure(monkeypatch, table)
    pl = Planner()
    cands = pl._candidates("c2c", 64, np.float32, K.PATIENCE_PATIENT)
    assert all(d["alg"] != "bluestein" for d in cands)
    # non-smooth n still races bluestein at PATIENT, and its pow2 child's
    # candidate set is bluestein-free
    cands = pl._candidates("c2c", 98, np.float32, K.PATIENCE_PATIENT)
    assert any(d["alg"] == "bluestein" for d in cands)


def test_timelimit_budget_subsumption(monkeypatch, small_measure):
    """VERDICT missing #6: a PATIENT search truncated by a tight timelimit
    must not mask a later untimed PATIENT search at the same key."""
    table = {a: 1.0 for a in ("mixed", "direct", "bluestein", "rader",
                              "xla")}
    _stub_measure(monkeypatch, table)
    pl = Planner()
    pl.timelimit = 1e-9                    # truncates after 1 candidate
    d1 = pl.plan_c2c(64, np.float32, K.PATIENCE_PATIENT)
    key = pl._key("c2c", 64, np.float32, None)
    assert pl.wisdom[key].get("budget") == pytest.approx(1e-9)
    nplan = pl.stats["nplan"]
    # same tight budget: the entry subsumes the request -> wisdom hit
    pl.plan_c2c(64, np.float32, K.PATIENCE_PATIENT)
    assert pl.stats["nplan"] == nplan
    # unlimited budget: the truncated entry must NOT subsume -> re-search
    # (children with truncated entries re-search too, so nplan grows by
    # at least one)
    pl.timelimit = None
    d2 = pl.plan_c2c(64, np.float32, K.PATIENCE_PATIENT)
    assert pl.stats["nplan"] > nplan
    assert pl.wisdom[key].get("budget") is None
    assert pl.wisdom[key]["desc"] == d2
    # the completed entry now serves everything, timelimited or not
    pl.timelimit = 1e-9
    nplan = pl.stats["nplan"]
    pl.plan_c2c(64, np.float32, K.PATIENCE_PATIENT)
    assert pl.stats["nplan"] == nplan
    del d1


def test_estimate_requests_ignore_budget(monkeypatch, small_measure):
    """ESTIMATE never times, so a truncated entry still serves it."""
    table = {a: 1.0 for a in ("mixed", "direct", "bluestein", "rader",
                              "xla")}
    _stub_measure(monkeypatch, table)
    pl = Planner()
    pl.timelimit = 1e-9
    pl.plan_c2c(64, np.float32, K.PATIENCE_PATIENT)
    pl.timelimit = None
    nplan = pl.stats["nplan"]
    pl.plan_c2c(64, np.float32, K.PATIENCE_ESTIMATE)
    assert pl.stats["nplan"] == nplan      # wisdom hit


def test_random_estimator_walks_plan_space(small_measure):
    """FFTW_RANDOM_ESTIMATOR analog (fftw/fftw_api.c:15090-15104): with a
    seeded pseudo-random cost oracle the planner must (a) still produce
    valid plans and (b) reach solver choices the calibrated estimator
    never picks, and wisdom entries must be keyed per seed."""
    import numpy as np
    from fftw3_tpu.planner import validate_desc
    old = config.random_estimator
    try:
        algs = set()
        pl = Planner()
        for seed in range(10):
            config.random_estimator = seed
            d = pl.plan_c2c(64, np.float32, K.PATIENCE_ESTIMATE)
            assert validate_desc("c2c", 64, d)
            algs.add((d["alg"], d.get("p")))
        assert len(algs) >= 2, f"estimator randomization inert: {algs}"
        # seeded entries must not pollute the real wisdom key space
        config.random_estimator = None
        d_real = pl.plan_c2c(64, np.float32, K.PATIENCE_ESTIMATE)
        key = pl._key("c2c", 64, np.float32, None)
        assert not key.startswith(":re")
        assert pl.wisdom[key]["desc"] == d_real
    finally:
        config.random_estimator = old


# ---------------------------------------------------------------------------
# DHT-Rader: prime-n DHT via a REAL length-(n-1) cyclic convolution
# (dht-rader analog, fftw/fftw_api.c:10398-10566; VERDICT r2 missing #4)
# ---------------------------------------------------------------------------

def _dht_oracle(x):
    n = x.shape[-1]
    jk = 2 * np.pi * np.mod(np.outer(np.arange(n), np.arange(n)), n) / n
    return x @ (np.cos(jk) + np.sin(jk))


class TestDhtRader:
    @pytest.mark.parametrize("n", [5, 7, 13, 101, 257])
    def test_solver_correct(self, rng, n):
        from fftw3_tpu.planner import build_apply, validate_desc
        pl = Planner()
        cands = pl._candidates("dht", n, np.float64, K.PATIENCE_ESTIMATE)
        rader = [c for c in cands if c["alg"] == "dht_rader"]
        assert len(rader) == 1, cands
        desc = rader[0]
        assert validate_desc("r2r", n, desc)
        fn = build_apply("r2r", desc, np.float64)
        x = rng.standard_normal((3, n))
        ref = _dht_oracle(x)
        scale = np.max(np.abs(ref))
        assert np.max(np.abs(np.asarray(fn(x)) - ref)) / scale < 1e-10

    def test_not_offered_for_composite(self):
        pl = Planner()
        cands = pl._candidates("dht", 16, np.float64, K.PATIENCE_ESTIMATE)
        assert not any(c["alg"] == "dht_rader" for c in cands)

    def test_races_and_wisdom_roundtrip(self):
        """The candidate set for a large prime contains BOTH reduction
        routes, and a dht_rader wisdom entry survives export/import."""
        import fftw3_tpu as ftpu
        from fftw3_tpu.planner import the_planner
        pl = Planner()
        cands = pl._candidates("dht", 1009, np.float64, K.PATIENCE_ESTIMATE)
        algs = {c["alg"] for c in cands}
        assert {"dht_via_r2c", "dht_rader"} <= algs
        try:
            the_planner.forget_wisdom()
            p = ftpu.plan_r2r((2, 101), ["dht"], axes=(1,), dtype="float64")
            s = ftpu.export_wisdom_to_string()
            the_planner.forget_wisdom()
            assert ftpu.import_wisdom_from_string(s)
        finally:
            the_planner.forget_wisdom()
