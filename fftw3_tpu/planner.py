"""The planner: cost-driven algorithm search with persistent wisdom.

This is the JAX-native re-design of FFTW's planner
(reference ``fftw/fftw_api.c:14748-15700``): a memoized recursive search over
a registered solver space, with an ESTIMATE cost model (analog of
``fftw_iestimate_cost``, fftw_api.c:15106-15121), a MEASURE mode that times
compiled candidates on the actual device (analog of
``fftw_measure_execution_time``, fftw_api.c:18584-18640), a patience ladder
(ESTIMATE -> MEASURE -> PATIENT -> EXHAUSTIVE widening the candidate set,
analog of the impatience-flag relaxation ``relax_tab``, fftw_api.c:15253-15262),
and JSON-serializable *wisdom* memoizing results per (kind, n, dtype, device)
(analog of the blessed wisdom hashtable + export format, fftw_api.c:15466).

The *plan descriptor* is a JSON-able dict tree; builders in ``ops/`` turn a
descriptor into a pure jittable apply closure.  Descriptors are the unit of
wisdom, so plans re-materialize deterministically from wisdom alone.
"""
from __future__ import annotations

import json
import math
import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional

import numpy as np

from . import config
from . import devices
from . import kinds as K
from .ops import c2c as c2c_ops
from .ops import r2r as r2r_ops
from .ops import real as real_ops
from .utils import primes

# ---------------------------------------------------------------------------
# Hardware model for the ESTIMATE cost heuristic, built from the device
# table (devices.py).  Only *relative* accuracy matters (MEASURE mode
# corrects the rest).
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class HardwareModel:
    hbm_bw: float                 # bytes/s
    matmul_flops: float           # f32 matrix products at the plan precision
    elem_flops: float             # f32 elementwise arithmetic
    matmul_k: int                 # contraction width of a full-rate product
    f64_matmul_penalty: float     # f32 / f64 matrix-product rate
    f64_elem_penalty: float       # f32 / f64 elementwise rate
    f64_fft_penalty: float        # XLA's f64 FFT beyond its doubled bytes
    df32: bool = True             # the df32 solver holds 1e-10 here
    gather_penalty: float = 4.0   # gathers/scatters cost more than streams

    def matmul_eff(self, k: int) -> float:
        """Matrix-product efficiency for a contraction of width k."""
        return min(k, self.matmul_k) / self.matmul_k

    @classmethod
    def for_kind(cls, device_kind: str) -> "HardwareModel":
        """The model of a device-table entry (ValueError if unlisted)."""
        spec = devices.lookup(device_kind)
        mm = spec.f32_matmul_flops[config.precision_name(spec.platform)]
        return cls(hbm_bw=spec.hbm_bw, matmul_flops=mm,
                   elem_flops=spec.f32_flops, matmul_k=spec.matmul_k,
                   f64_matmul_penalty=mm / spec.f64_matmul_flops,
                   f64_elem_penalty=spec.f32_flops / spec.f64_flops,
                   f64_fft_penalty=(spec.f32_flops / spec.f64_flops
                                    if spec.f64_emulated else 1.0),
                   df32=spec.df32_exact)


#: Largest leaf DFT-matrix size the planner will consider "direct".  FFTW's
#: codelets stop at 64 because opcount matters on CPUs; with matrix units
#: larger dense leaves are profitable.
DIRECT_MAX = 128
#: Cap for the O(n^2) last-resort dense solver (dft-generic analog).
GENERIC_MAX = 2048
#: Dense r2r kind-matrix solver cap: a real (n, n) matmul runs on the
#: matrix units, while the reduction path pays several elementwise HBM
#: passes.
R2R_GENERIC_MAX = 4096


def _c2c_cost(desc: Dict, hw: HardwareModel, f64: bool = False) -> float:
    """Estimated seconds per single 1-D transform (batch-amortized).

    ``f64=True`` costs the plan for double-precision execution: doubled
    element bytes and the device's f64 rate penalties.  The ``df32``
    double-float solver computes in f32 whatever the plan dtype, so it
    pays neither.
    """
    alg, n = desc["alg"], desc["n"]
    el = 16.0 if f64 else 8.0  # complex bytes
    mm = hw.matmul_flops / (hw.f64_matmul_penalty if f64 else 1.0)
    ew = hw.elem_flops / (hw.f64_elem_penalty if f64 else 1.0)
    if alg == "nop" or n == 1:
        return 0.0
    if alg == "df32":
        # double-float pipeline: per stage one elementwise HBM sweep of the
        # four f32 planes plus the df butterfly/twiddle f32 chains
        t = 0.0
        for p in desc["radices"]:
            per_pt = 260.0 if p in (2, 4) else 170.0 * p
            t += 32.0 * n / hw.hbm_bw + per_pt * n / hw.elem_flops
        return t
    if alg == "direct":
        bytes_moved = 2 * el * n
        flops = 8.0 * n * n
        return bytes_moved / hw.hbm_bw + flops / (mm *
                                                  hw.matmul_eff(n))
    if alg == "mixed":
        p = desc["p"]
        # the XLA stage really pays ~2 HBM round trips (einsum in/out plus
        # the final axis swap); keep in sync with the C++ mirror
        stage = (4 * el * n / hw.hbm_bw
                 + 8.0 * p * n / (mm * hw.matmul_eff(p))
                 + 6.0 * n / ew)
        return stage + p * _c2c_cost(desc["child"], hw, f64)
    if alg == "bluestein":
        m = desc["m"]
        extra = 6.0 * el * m / hw.hbm_bw + 12.0 * m / ew
        return 2 * _c2c_cost(desc["child"], hw, f64) + extra
    if alg == "rader":
        extra = hw.gather_penalty * 4 * el * n / hw.hbm_bw
        return 2 * _c2c_cost(desc["child"], hw, f64) + 6.0 * n / ew + extra
    if alg == "xla":
        # modeled as a generic log-n pipeline; MEASURE decides its real
        # worth.  Where f64 is emulated the pipeline's arithmetic is too.
        return (2 * el * n * max(1.0, math.log2(n)) / hw.hbm_bw
                * (hw.f64_fft_penalty if f64 else 1.0))
    raise ValueError(alg)


def _mixed_factor_candidates(n: int, patience: int) -> List[int]:
    """Divisor choices p<=DIRECT_MAX for one Cooley-Tukey split, best first.

    Mirrors fftw_choose_radix / the buddies heuristic (fftw_api.c:14622-14674):
    prefer large matrix-unit-friendly leaves, keep the cofactor smooth.
    """
    divs = [d for d in primes.divisors(n) if 2 <= d <= DIRECT_MAX and d != n]
    if not divs:
        return []
    # rank: prefer p close to sqrt(n) from above, then larger p
    def rank(p):
        q = n // p
        balance = abs(math.log2(p * p / n))
        return (balance, -p)
    divs.sort(key=rank)
    width = {K.PATIENCE_ESTIMATE: 3, K.PATIENCE_MEASURE: 4,
             K.PATIENCE_PATIENT: 8, K.PATIENCE_EXHAUSTIVE: 64}[patience]
    return divs[:width]


#: wisdom format version.  v2: keys carry the batch bucket (":b<N>").
#: Bump whenever the key schema changes so stale exports are rejected
#: loudly instead of importing permanently-dead entries.
WISDOM_FORMAT = "fftw3-tpu-wisdom-2"


class WisdomOnlyMiss(ValueError):
    """FFTW_WISDOM_ONLY requested but no wisdom covers a subproblem
    (the reference returns NULL from the planner; fftw3.h:487)."""


class Planner:
    """Singleton-style planner with wisdom (fftw_the_planner analog)."""

    def __init__(self, hw: Optional[HardwareModel] = None):
        #: the cost model; None = the model of the process's first device,
        #: resolved at the first plan (the backend is not touched before)
        self._hw = hw
        self.wisdom: Dict[str, Dict] = {}
        #: FFTW_WISDOM_ONLY mode: accept any wisdom hit, never search
        self.wisdom_only = False
        self.timelimit: Optional[float] = None
        #: let MEASURE mode also time XLA's built-in FFT custom-call as a
        #: competitor solver (off by default: the engine's own solvers are
        #: the product; flip on to sanity-check against the platform).
        self.allow_xla = False
        self._measure_t0: float = 0.0
        self._measure_truncated = False
        self.stats = {"nplan": 0, "nmeasure": 0, "nwisdom_hit": 0,
                      "nmeasure_failed": 0}
        #: hook called with (key, desc, cost) on every planned subproblem —
        #: the instrumentation point used by paranoid verification
        #: (planner->hook analog, fftw/fftw_api.h:865-867).
        self.hook: Optional[Callable[[str, Dict, float], None]] = None

    @property
    def hw(self) -> HardwareModel:
        if self._hw is None:
            import jax
            self._hw = HardwareModel.for_kind(jax.devices()[0].device_kind)
        return self._hw

    # -- wisdom keys ------------------------------------------------------
    def _key(self, kind: str, n: int, rdtype,
             batch: Optional[int] = None) -> str:
        dev = _device_signature()
        re_tag = "" if config.random_estimator is None \
            else f":re{config.random_estimator}"
        return (re_tag + f"{kind}:{n}:{np.dtype(rdtype).name}:{dev}"
                f":b{_batch_bucket(batch)}")

    # -- public entry points ----------------------------------------------
    # `batch` is the number of independent transforms per call (the vector
    # tensor of the problem).  FFTW hashes it into the wisdom key
    # (md5hash(problem,...), fftw/fftw_api.c:14858); the best alg depends
    # on it (a small batch cannot fill the device), so MEASURE times at
    # the caller's batch and wisdom is bucketed by it (powers of 4).
    def plan_c2c(self, n: int, rdtype, patience: int,
                 batch: Optional[int] = None) -> Dict:
        return self._plan("c2c", n, rdtype, patience, batch)

    def plan_r2c(self, n: int, rdtype, patience: int,
                 batch: Optional[int] = None) -> Dict:
        return self._plan("r2c", n, rdtype, patience, batch)

    def plan_c2r(self, n: int, rdtype, patience: int,
                 batch: Optional[int] = None) -> Dict:
        return self._plan("c2r", n, rdtype, patience, batch)

    def plan_r2r(self, kind: K.Kind, n: int, rdtype, patience: int,
                 batch: Optional[int] = None) -> Dict:
        return self._plan(kind.value, n, rdtype, patience, batch)

    # -- core search --------------------------------------------------------
    def _plan(self, kind: str, n: int, rdtype, patience: int,
              batch: Optional[int] = None) -> Dict:
        key = self._key(kind, n, rdtype, batch)
        hit = self.wisdom.get(key)
        # .get + isinstance: an imported entry may lack 'patience' or not
        # even be a dict (import_wisdom takes entries unvalidated) —
        # malformed wisdom falls through to the recovery rung, not KeyError
        if not isinstance(hit, dict):
            if hit is not None:
                del self.wisdom[key]
                self.stats["nbogus"] = self.stats.get("nbogus", 0) + 1
            hit = None
        if hit is not None and (self.wisdom_only
                                or (hit.get("patience", -1) >= patience
                                    and self._budget_subsumes(hit,
                                                              patience))):
            # wisdom-bogosity recovery rung 1 (fftw_api.c:283-315): a
            # structurally invalid entry (corrupt import, stale key) is
            # dropped and planning falls through to a fresh search
            if validate_desc(kind, n, hit.get("desc")):
                self.stats["nwisdom_hit"] += 1
                return hit["desc"]
            del self.wisdom[key]
            self.stats["nbogus"] = self.stats.get("nbogus", 0) + 1
        if self.wisdom_only:
            raise WisdomOnlyMiss(
                f"FFTW_WISDOM_ONLY: no wisdom for {kind} n={n}")
        self.stats["nplan"] += 1
        f64 = np.dtype(rdtype) == np.float64
        if patience == K.PATIENCE_ESTIMATE and config.use_native \
                and config.random_estimator is None:
            desc = self._plan_native(kind, n, rdtype, patience)
            if desc is not None:
                cost = self._cost(kind, desc, f64)
                self.stats["epcost"] = self.stats.get("epcost", 0.0) + cost
                self.stats["pcost"] = self.stats.get("pcost", 0.0) + cost
                self.wisdom[key] = {"desc": desc, "patience": patience,
                                    "cost": cost}
                if self.hook is not None:
                    self.hook(key, desc, cost)
                return desc
        cands = self._candidates(kind, n, rdtype, patience, batch)
        if not cands:
            raise ValueError(f"no applicable solver for {kind} n={n}")
        if patience == K.PATIENCE_ESTIMATE or len(cands) == 1:
            best = min(cands, key=lambda d: self._cost(kind, d, f64))
            cost = self._cost(kind, best, f64)
            self.stats["epcost"] = self.stats.get("epcost", 0.0) + cost
        else:
            self._measure_t0 = time.perf_counter()
            best, cost = self._measure_best(kind, n, rdtype, cands, batch)
        # planner counters (nplan/pcost/epcost, fftw/fftw_api.h:896-900)
        self.stats["pcost"] = self.stats.get("pcost", 0.0) + cost
        entry = {"desc": best, "patience": patience, "cost": cost}
        if getattr(self, "_measure_truncated", False):
            # timelimit-aware subsumption (timelimit_to_flags +
            # `subsumes`, fftw/fftw_api.c:126-142, :14748): a truncated
            # search records its budget so a later request with a larger
            # (or no) timelimit re-searches instead of being masked by a
            # possibly-poor rushed plan
            entry["budget"] = self.timelimit
        self._measure_truncated = False
        self.wisdom[key] = entry
        if self.hook is not None:
            self.hook(key, best, cost)
        return best

    def _budget_subsumes(self, hit: Dict, patience: int) -> bool:
        """Does the wisdom entry's search budget cover this request?
        Entries without a 'budget' field completed their search; truncated
        entries only serve requests with an equal-or-tighter timelimit
        (FFTW encodes the timelimit into the impatience lattice so
        `subsumes` sees it; fftw_api.c:126-142)."""
        if patience < K.PATIENCE_MEASURE:
            return True                # ESTIMATE requests never time
        b = hit.get("budget")
        if b is None:
            return True
        return self.timelimit is not None and self.timelimit <= b

    def _plan_native(self, kind: str, n: int, rdtype, patience: int
                     ) -> Optional[Dict]:
        """Deterministic ESTIMATE search in the C++ tier for any kind
        (same policy as the Python path; equality unit-tested).
        None -> fall back to the Python search."""
        from . import native
        if not native.available():
            return None
        if np.dtype(rdtype) == np.float64:
            # the C++ tier mirrors the f32 ESTIMATE policy; f64 search is
            # dtype-aware (df32 tier + f64 rate penalties) and Python-only
            return None
        if kind == "c2c":
            return native.plan_c2c(n, patience, self.hw)
        if n <= 1:
            return None                # tiny edge cases stay in Python
        return native.plan_kind(kind, n, patience, self.hw)

    def _candidates(self, kind: str, n: int, rdtype,
                    patience: int, batch: Optional[int] = None) -> List[Dict]:
        if kind == "c2c":
            return self._candidates_c2c(n, rdtype, patience, batch)
        if kind == "r2c":
            out = []
            if n <= R2R_GENERIC_MAX:
                out.append({"alg": "r2c_dense", "n": n})
            if n % 2 == 0 and n > 2:
                out.append({"alg": "r2c_pack", "n": n,
                            "child": self.plan_c2c(n // 2, rdtype, patience, batch)})
            out.append({"alg": "r2c_via_c2c", "n": n,
                        "child": self.plan_c2c(n, rdtype, patience, batch)})
            return out
        if kind == "c2r":
            out = []
            if n <= R2R_GENERIC_MAX:
                out.append({"alg": "c2r_dense", "n": n})
            if n % 2 == 0 and n > 2:
                out.append({"alg": "c2r_pack", "n": n,
                            "child": self.plan_c2c(n // 2, rdtype, patience, batch)})
            out.append({"alg": "c2r_via_c2c", "n": n,
                        "child": self.plan_c2c(n, rdtype, patience, batch)})
            return out
        # ---- r2r kinds ----
        out = []
        if kind == "dht":
            out.append({"alg": "dht_via_r2c", "n": n,
                        "child": self.plan_r2c(n, rdtype, patience, batch)})
            if n >= 5 and primes.is_prime(n):
                # dht-rader analog (fftw/fftw_api.c:10398-10566): the
                # length-(n-1) convolution stays REAL, racing the via-r2c
                # route whose prime child pays a complex Rader/Bluestein
                out.append({"alg": "dht_rader", "n": n, "children": [
                    self.plan_r2c(n - 1, rdtype, patience, batch),
                    self.plan_c2r(n - 1, rdtype, patience, batch)]})
        elif kind == "r2hc":
            out.append({"alg": "r2hc_via_r2c", "n": n,
                        "child": self.plan_r2c(n, rdtype, patience, batch)})
        elif kind == "hc2r":
            out.append({"alg": "hc2r_via_c2r", "n": n,
                        "child": self.plan_c2r(n, rdtype, patience, batch)})
        elif kind == "redft10":
            out.append({"alg": "redft10_half", "n": n,
                        "child": self.plan_r2c(n, rdtype, patience, batch)})
        elif kind == "redft01":
            out.append({"alg": "redft01_half", "n": n,
                        "child": self.plan_c2r(n, rdtype, patience, batch)})
        elif kind == "redft00" and n > 1:
            out.append({"alg": "redft00_ext", "n": n,
                        "child": self.plan_r2c(2 * (n - 1), rdtype, patience, batch)})
            if n % 2 == 1 and n >= 5:
                # split-radix (reodft00e-splitradix analog): evens -> DCT-I
                # of (n+1)/2, odds -> DCT-II of (n-1)/2; ~2x less work
                out.append({"alg": "redft00_split", "n": n, "children": [
                    self.plan_r2r(K.Kind.REDFT00, (n + 1) // 2, rdtype,
                                  patience, batch),
                    self.plan_r2r(K.Kind.REDFT10, (n - 1) // 2, rdtype,
                                  patience, batch)]})
        elif kind == "rodft00":
            out.append({"alg": "rodft00_ext", "n": n,
                        "child": self.plan_r2c(2 * (n + 1), rdtype, patience, batch)})
            if n % 2 == 1 and n >= 5:
                out.append({"alg": "rodft00_split", "n": n, "children": [
                    self.plan_r2r(K.Kind.RODFT00, (n - 1) // 2, rdtype,
                                  patience, batch),
                    self.plan_r2r(K.Kind.RODFT10, (n + 1) // 2, rdtype,
                                  patience, batch)]})
        elif kind == "redft11":
            out.append({"alg": "redft11_2n", "n": n,
                        "child": self.plan_c2c(2 * n, rdtype, patience, batch)})
            if n % 2 == 1:
                # odd n: ONE same-size R2HC via the 8n PFA signed
                # permutations (reodft11e-r2hc-odd analog); 2x less work
                # than the 2n route
                out.append({"alg": "redft11_odd", "n": n,
                            "child": self.plan_r2r(K.Kind.R2HC, n, rdtype,
                                                   patience, batch)})
        elif kind == "rodft10":
            out.append({"alg": "rodft10_flip", "n": n,
                        "child": self.plan_r2r(K.Kind.REDFT10, n, rdtype,
                                               patience, batch)})
        elif kind == "rodft01":
            out.append({"alg": "rodft01_flip", "n": n,
                        "child": self.plan_r2r(K.Kind.REDFT01, n, rdtype,
                                               patience, batch)})
        elif kind == "rodft11":
            out.append({"alg": "rodft11_flip", "n": n,
                        "child": self.plan_r2r(K.Kind.REDFT11, n, rdtype,
                                               patience, batch)})
        if n <= R2R_GENERIC_MAX:
            out.append({"alg": "r2r_matmul", "kind": kind, "n": n})
        return out

    def _candidates_c2c(self, n: int, rdtype, patience: int,
                        batch: Optional[int] = None) -> List[Dict]:
        out: List[Dict] = []
        if n == 1:
            return [{"alg": "nop", "n": 1}]
        if (np.dtype(rdtype) == np.float64 and not config.strict_f64
                and self.hw.df32):
            from .ops import df32
            if df32.df32_applicable(n):
                # compensated-f32 double-float tier: ~1e-13 rel err in
                # pure-f32 arithmetic, racing the f64 solvers below for
                # complex128 plans
                out.append({"alg": "df32", "n": n,
                            "radices": df32.df32_radices(n)})
        if n <= DIRECT_MAX or (n <= GENERIC_MAX and
                               primes.largest_prime_factor(n) > 64):
            out.append({"alg": "direct", "n": n})
        for p in _mixed_factor_candidates(n, patience):
            child = self.plan_c2c(n // p, rdtype, patience,
                                  None if batch is None else batch * p)
            out.append({"alg": "mixed", "n": n, "p": p, "child": child})
        lpf = primes.largest_prime_factor(n)
        # the PATIENT-extra bluestein (racing a padded size even for
        # mildly-smooth n) requires lpf > 5 so its own pow2/5-smooth
        # children can never regenerate the candidate — without that
        # gate, planning a pow2 size at PATIENT recursed n -> 2n -> ...
        if lpf > DIRECT_MAX or (patience >= K.PATIENCE_PATIENT and n > 16
                                and lpf > 5):
            m = primes.next_pow2(2 * n - 1)
            out.append({"alg": "bluestein", "n": n, "m": m,
                        "child": self.plan_c2c(m, rdtype, patience, batch)})
            m5 = primes.next_fast_size(2 * n - 1, smooth=5)
            if m5 != m and patience >= K.PATIENCE_PATIENT:
                out.append({"alg": "bluestein", "n": n, "m": m5,
                            "child": self.plan_c2c(m5, rdtype, patience, batch)})
        if primes.is_prime(n) and n > DIRECT_MAX:
            nm1 = self.plan_c2c(n - 1, rdtype, patience, batch)
            out.append({"alg": "rader", "n": n, "child": nm1})
        if self.allow_xla and patience >= K.PATIENCE_MEASURE:
            out.append({"alg": "xla", "n": n})
        return out

    # -- cost ----------------------------------------------------------------
    def _cost(self, kind: str, desc: Dict, f64: bool = False) -> float:
        if config.random_estimator is not None:
            # FFTW_RANDOM_ESTIMATOR analog (fftw_api.c:15090-15104): a
            # deterministic pseudo-random cost walks the off-winner plan
            # space for the fuzzer.  Keyed by (seed, kind, desc) so one
            # seed gives a consistent (memoizable) ranking.
            import hashlib
            h = hashlib.md5(f"{config.random_estimator}:{kind}:"
                            f"{sprint_desc(desc)}".encode()).digest()
            return 1e-6 * (1 + int.from_bytes(h[:8], 'big') / 2**64)
        mm = self.hw.matmul_flops / (self.hw.f64_matmul_penalty if f64
                                      else 1.0)
        if kind == "c2c":
            return _c2c_cost(desc, self.hw, f64)
        if kind in ("r2c", "c2r"):
            if desc["alg"] in ("r2c_dense", "c2r_dense"):
                n = desc["n"]
                return (12.0 * n / self.hw.hbm_bw
                        + 2.0 * n * (n // 2 + 1)
                        / (mm * self.hw.matmul_eff(n)))
            if desc["alg"] in ("r2c_pack", "c2r_pack"):
                # half-size complex child + a separate untangle HBM pass
                return 0.55 * _c2c_cost(desc["child"], self.hw, f64) \
                    + 16.0 * desc["n"] / self.hw.hbm_bw
            return _c2c_cost(desc["child"], self.hw, f64) \
                + 16.0 * desc["n"] / self.hw.hbm_bw
        # r2r
        if desc["alg"] == "r2r_matmul":
            n = desc["n"]
            return (8.0 * n / self.hw.hbm_bw
                    + 2.0 * n * n / (mm * self.hw.matmul_eff(n)))
        if desc["alg"] in ("redft00_split", "rodft00_split"):
            # two half-size r2r children + one recombination HBM pass
            return (self._cost("r2r", desc["children"][0], f64)
                    + self._cost("r2r", desc["children"][1], f64)
                    + 8.0 * desc["n"] / self.hw.hbm_bw)
        if desc["alg"] == "dht_rader":
            # real convolution children + permute/pointwise HBM passes
            return (self._cost("r2c", desc["children"][0], f64)
                    + self._cost("c2r", desc["children"][1], f64)
                    + 16.0 * desc["n"] / self.hw.hbm_bw)
        child_kind = {"dht_via_r2c": "r2c", "r2hc_via_r2c": "r2c",
                      "hc2r_via_c2r": "c2r", "redft10_half": "r2c",
                      "redft01_half": "c2r", "redft00_ext": "r2c",
                      "rodft00_ext": "r2c", "redft11_2n": "c2c",
                      "rodft10_flip": "r2r", "rodft01_flip": "r2r",
                      "rodft11_flip": "r2r", "redft11_odd": "r2r"}[desc["alg"]]
        if child_kind == "r2r":
            return self._cost("r2r", desc["child"], f64) \
                + 8.0 * desc["n"] / self.hw.hbm_bw
        return self._cost(child_kind, desc["child"], f64) \
            + 16.0 * desc["n"] / self.hw.hbm_bw

    # -- MEASURE mode ----------------------------------------------------
    def _measure_best(self, kind: str, n: int, rdtype, cands: List[Dict],
                      batch: Optional[int] = None):
        """Time compiled candidates, keep the fastest (measure() analog,
        fftw/fftw_api.c:18584-18640).

        Candidates are timed in TWO INTERLEAVED passes and ranked by their
        per-candidate minimum, so slow drift in the device's clocks lands
        on every candidate alike instead of flipping near-ties."""
        from .utils import timing

        f64 = np.dtype(rdtype) == np.float64
        # order by estimate so a timelimit still leaves a good plan
        cands = sorted(cands, key=lambda d: self._cost(kind, d, f64))
        prepared = []                 # (desc, fn, args) that compile
        times: Dict[int, float] = {}
        self._measure_truncated = False
        for rnd in range(2):
            for i, desc in enumerate(cands):
                if (self.timelimit is not None and times
                        and time.perf_counter() - self._measure_t0
                        > self.timelimit):
                    self._measure_truncated = True
                    break
                try:
                    if rnd == 0:
                        fn, args = _measure_fn(kind, desc, n, rdtype,
                                               batch)
                        prepared.append((i, fn, args))
                        t = timing.time_dispatched(fn, args, reps=3)
                        self.stats["nmeasure"] += 1
                    else:
                        hit = [p for p in prepared if p[0] == i]
                        if not hit:
                            continue
                        _, fn, args = hit[0]
                        t = timing.time_dispatched(fn, args, reps=3)
                except Exception as e:                 # noqa: BLE001
                    # a failing candidate (e.g. a compile failure) must
                    # not look like "the planner chose the slow path":
                    # count it and keep the last error visible in stats
                    self.stats["nmeasure_failed"] = \
                        self.stats.get("nmeasure_failed", 0) + 1
                    self.stats["last_measure_error"] = \
                        f"{sprint_desc(desc)}: {type(e).__name__}: " \
                        f"{e}"[:300]
                    continue
                times[i] = min(t, times.get(i, float("inf")))
        if not times:  # all candidates failed to compile: fall back
            best = min(cands, key=lambda d: self._cost(kind, d, f64))
            return best, self._cost(kind, best, f64)
        besti = min(times, key=times.get)
        # hysteresis: a measured winner must beat the ESTIMATE choice by
        # the configured margin to override it
        hyst = config.measure_hysteresis
        if 0 in times and besti != 0 \
                and times[besti] > hyst * times[0]:
            besti = 0
        return cands[besti], times[besti]

    # -- wisdom I/O (fftw_export_wisdom analog, fftw_api.c:895-1171) ------
    def export_wisdom(self) -> str:
        return json.dumps({"format": WISDOM_FORMAT,
                           "signature": _device_signature(),
                           "entries": self.wisdom}, indent=1)

    def import_wisdom(self, s: str) -> bool:
        try:
            data = json.loads(s)
            if data.get("format") != WISDOM_FORMAT:
                # older format versions fail LOUDLY (import returns False)
                # rather than importing entries whose keys can never hit —
                # the role of FFTW's wisdom version string
                return False
            self.wisdom.update(data["entries"])
            return True
        except (json.JSONDecodeError, KeyError, TypeError):
            return False

    def forget_wisdom(self) -> None:
        self.wisdom.clear()


# ---------------------------------------------------------------------------
# descriptor -> apply dispatch shared by Plan and MEASURE
# ---------------------------------------------------------------------------

def validate_desc(kind: str, n: int, desc) -> bool:
    """Structural sanity of a (possibly imported) wisdom descriptor —
    the bogus-wisdom detector of the recovery ladder."""
    if not isinstance(desc, dict):
        return False
    alg = desc.get("alg")
    if desc.get("n") != n or not isinstance(alg, str):
        return False
    if kind == "c2c":
        if alg in ("nop", "direct", "xla"):
            return True
        if alg == "mixed":
            p = desc.get("p")
            return (isinstance(p, int) and 1 < p < n and n % p == 0
                    and validate_desc("c2c", n // p, desc.get("child")))
        if alg == "df32":
            rad = desc.get("radices")
            return (isinstance(rad, list) and
                    math.prod(rad) == n and
                    all(isinstance(r, int) and 1 < r for r in rad))
        if alg == "bluestein":
            m = desc.get("m")
            return (isinstance(m, int) and m >= 2 * n - 1
                    and validate_desc("c2c", m, desc.get("child")))
        if alg == "rader":
            return (primes.is_prime(n)
                    and validate_desc("c2c", n - 1, desc.get("child")))
        return False
    if kind in ("r2c", "c2r"):
        if alg == f"{kind}_dense":
            return True
        if alg in (f"{kind}_pack",):
            return n % 2 == 0 and validate_desc("c2c", n // 2,
                                                desc.get("child"))
        if alg == f"{kind}_via_c2c":
            return validate_desc("c2c", n, desc.get("child"))
        return False
    # r2r kinds: check the child link matches the reduction table
    if alg in ("redft00_split", "rodft00_split"):
        ch = desc.get("children")
        if not (isinstance(ch, list) and len(ch) == 2 and n % 2 == 1):
            return False
        if alg == "redft00_split":
            sizes = ((n + 1) // 2, (n - 1) // 2)
        else:
            sizes = ((n - 1) // 2, (n + 1) // 2)
        return (validate_desc("r2r", sizes[0], ch[0])
                and validate_desc("r2r", sizes[1], ch[1]))
    if alg == "dht_rader":
        ch = desc.get("children")
        return (primes.is_prime(n) and isinstance(ch, list) and len(ch) == 2
                and validate_desc("r2c", n - 1, ch[0])
                and validate_desc("c2r", n - 1, ch[1]))
    child_kind = {"dht_via_r2c": ("r2c", n), "r2hc_via_r2c": ("r2c", n),
                  "hc2r_via_c2r": ("c2r", n), "redft10_half": ("r2c", n),
                  "redft01_half": ("c2r", n),
                  "redft00_ext": ("r2c", 2 * (n - 1)),
                  "rodft00_ext": ("r2c", 2 * (n + 1)),
                  "redft11_2n": ("c2c", 2 * n),
                  "rodft10_flip": ("r2r", n), "rodft01_flip": ("r2r", n),
                  "rodft11_flip": ("r2r", n),
                  "redft11_odd": ("r2r", n)}.get(alg)
    if alg == "r2r_matmul":
        return isinstance(desc.get("kind"), str)
    if child_kind is None:
        return False
    ck, cn = child_kind
    return validate_desc(ck, cn, desc.get("child"))


def build_apply(kind: str, desc: Dict, rdtype):
    if kind == "c2c":      # forward; backward built by caller with sign
        return c2c_ops.build_c2c(desc, K.FORWARD, rdtype)
    if kind == "r2c":
        return real_ops.build_r2c(desc, rdtype)
    if kind == "c2r":
        return real_ops.build_c2r(desc, rdtype)
    return r2r_ops.build_r2r(desc, rdtype)


def _measure_fn(kind: str, desc: Dict, n: int, rdtype,
                batch: Optional[int] = None):
    """(jitted fn, args) for MEASURE timing, with real-only inputs and
    outputs (the split-complex form every builder shares).

    With `batch` the candidate is timed at the caller's own vector size
    (capped by config.measure_points for memory); otherwise at a synthetic
    batch of ~measure_points total points — enough device time per call
    to rise well above the launch cost."""
    import jax
    import jax.numpy as jnp

    cap = max(1, config.measure_points // max(n, 1))
    batch = cap if batch is None else max(1, min(int(batch), cap))
    rng = np.random.default_rng(0)
    rdt = np.dtype(rdtype)
    if kind == "c2c":
        fn = c2c_ops.build_c2c_split(desc, K.FORWARD, rdtype)
        xr = jnp.asarray(rng.standard_normal((batch, n)), rdt)
        xi = jnp.asarray(rng.standard_normal((batch, n)), rdt)
        return jax.jit(fn), (xr, xi)
    if kind == "c2r":
        m = n // 2 + 1
        apply = real_ops.build_c2r(desc, rdtype)
        fn = jax.jit(lambda a, b: apply(a + 1j * b))
        xr = jnp.asarray(rng.standard_normal((batch, m)), rdt)
        xi = jnp.asarray(rng.standard_normal((batch, m)), rdt)
        return fn, (xr, xi)
    apply = build_apply(kind, desc, rdtype)
    if kind == "r2c":
        fn = jax.jit(lambda a: (lambda y: (jnp.real(y), jnp.imag(y)))(
            apply(a)))
    else:
        fn = jax.jit(apply)
    x = jnp.asarray(rng.standard_normal((batch, n)), rdt)
    return fn, (x,)


def _batch_bucket(batch: Optional[int]) -> str:
    """Coarse power-of-4 bucket of the vector size for wisdom keys: fine
    enough that occupancy regimes separate (128 vs 65536 batches land
    in buckets 4 and 8), coarse enough that keys don't explode."""
    if batch is None:
        return "d"
    return str(max(1, int(batch)).bit_length() // 2)


_sig_cache: Optional[str] = None


def _device_signature() -> str:
    """Wisdom-key signature: backend + device kind + TOOLCHAIN versions.

    FFTW hashes its build configuration into every wisdom entry so stale
    wisdom can never be reused across builds (signature_of_configuration,
    fftw/fftw_api.c:14829).  The analog here stamps the COMPILER, not just
    the device, since a compiler upgrade changes which plan is fastest.
    Components:

    * jax / jaxlib versions (the lowering pipeline), and
    * an 8-hex digest of the backend's ``platform_version`` (the runtime
      + compiler build string, which moves with the CUDA plugin).

    A jaxlib or runtime upgrade therefore silently RETIRES all old wisdom
    (keys never match) instead of serving stale winners or descriptors
    the new compiler rejects.  Cached per process: the backend cannot
    change after initialization."""
    global _sig_cache
    if _sig_cache is not None:
        return _sig_cache
    try:
        import jax
        import jaxlib
        d = jax.devices()[0]
        sig = f"{jax.default_backend()}-{getattr(d, 'device_kind', 'cpu')}" \
            f"-jax{jax.__version__}-jl{jaxlib.__version__}"
        pv = getattr(getattr(d, "client", None), "platform_version", "")
        if pv:
            import hashlib
            sig += "-pv" + hashlib.md5(pv.encode()).hexdigest()[:8]
        sig = sig.replace(" ", "_")
    except Exception:
        return "host"
    _sig_cache = sig
    return sig


# ---------------------------------------------------------------------------
# plan printing (fftw_sprint_plan analog, fftw/fftw_api.c:15917-16124)
# ---------------------------------------------------------------------------

def sprint_desc(desc: Dict) -> str:
    alg = desc["alg"]
    n = desc.get("n")
    if alg == "mixed":
        return f"(mixed-{desc['p']}/{n} {sprint_desc(desc['child'])})"
    if alg == "bluestein":
        return f"(bluestein-{n}->{desc['m']} {sprint_desc(desc['child'])})"
    if alg == "rader":
        return f"(rader-{n} {sprint_desc(desc['child'])})"
    if alg == "r2r_matmul":
        return f"(matmul-{desc['kind']}-{n})"
    if "child" in desc:
        return f"({alg}-{n} {sprint_desc(desc['child'])})"
    return f"({alg}-{n})"


#: module-level planner singleton (fftw_the_planner analog,
#: fftw/fftw_api.c:793-800)
the_planner = Planner()
