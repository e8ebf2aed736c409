"""Self-verification by mathematical properties.

A port of the reference verifier's *method* (``fftw/libbench2/verify-lib.c``,
the Ergün linear-function self-testing cited at ``verify-lib.c:249``) to the
functional engine:

* **impulse** (``verify-lib.c:260-325``): the transform of a scaled delta
  must equal the known analytic row; the transform of a constant must be a
  scaled delta; plus `rounds` random superposition checks
  ``T(B) + T(A-B) == T(A)``.
* **linear** (``verify-lib.c:327-356``): ``T(alpha*A + beta*B) ==
  alpha*T(A) + beta*T(B)`` with random coefficients (real coefficients for
  real transforms).
* **tf_shift** (``verify-lib.c:360+``): time-shift <-> phase-rotation and
  frequency-shift <-> modulation dualities (c2c / r2c / c2r problems).

Errors are compared with :func:`acmp`, the relative-Linf comparator of
``verify-lib.c:36-58``: ``max_i |a_i-b_i| / max_i min(|a_i|,|b_i|)``.
Default tolerances follow ``libbench2/bench-main.c:70``: 1e-3 single /
1e-10 double.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from .. import kinds as K
from .problem import BenchProblem, make_plan


class VerificationError(AssertionError):
    pass


def default_tol(rdtype) -> float:
    return 1e-3 if np.dtype(rdtype) == np.float32 else 1e-10


def acmp(a, b, tol: float, context: str = "") -> float:
    """Relative Linf comparator (aerror/acmp analog)."""
    a = np.asarray(a, np.complex128).ravel()
    b = np.asarray(b, np.complex128).ravel()
    if a.size == 0:
        return 0.0
    e = float(np.max(np.abs(a - b)))
    mag = float(np.max(np.minimum(np.abs(a), np.abs(b))))
    rel = e / max(mag, 1e-300)
    if rel > tol:
        raise VerificationError(
            f"relative error {rel:.3e} > tol {tol:.0e} ({context})")
    return rel


@dataclass
class VerifyResult:
    problem: str
    tests: Dict[str, float] = field(default_factory=dict)

    @property
    def max_err(self) -> float:
        return max(self.tests.values()) if self.tests else 0.0

    def __repr__(self):
        inner = " ".join(f"{k}={v:.2e}" for k, v in self.tests.items())
        return f"(verify {self.problem} {inner})"


# ---------------------------------------------------------------------------
# per-kind harness closures: map every problem onto (apply, in/out specs)
# ---------------------------------------------------------------------------

def _rand(rng, shape, complex_):
    x = rng.uniform(-0.5, 0.5, size=shape)
    if complex_:
        x = x + 1j * rng.uniform(-0.5, 0.5, size=shape)
    return x


class _Closure:
    """dofft_closure analog: a plan plus dtype plumbing.

    Complex arrays are split into re/im at the host boundary and recombined
    inside one jit, which keeps the hot path identical to how users embed
    ``plan.apply`` in larger jitted programs.
    """

    def __init__(self, prob: BenchProblem, flags: int, rdtype: str):
        import jax
        import jax.numpy as jnp

        self.prob = prob
        self.rdtype = np.dtype(rdtype)
        self.complex_in = prob.kind in ("c2c", "c2r")
        self.complex_out = prob.kind in ("c2c", "r2c")
        dtype = ("complex64" if self.rdtype == np.float32 else "complex128") \
            if prob.kind == "c2c" else str(self.rdtype)
        self.plan = make_plan(prob, flags, dtype)
        apply = self.plan.apply
        if self.complex_in and self.complex_out:
            self._jit = jax.jit(lambda a, b: (lambda y: (jnp.real(y),
                                                         jnp.imag(y)))(
                apply(a + 1j * b)))
        elif self.complex_in:
            self._jit = jax.jit(lambda a, b: apply(a + 1j * b))
        elif self.complex_out:
            self._jit = jax.jit(lambda a: (lambda y: (jnp.real(y),
                                                      jnp.imag(y)))(apply(a)))
        else:
            self._jit = jax.jit(apply)

    def apply(self, x: np.ndarray) -> np.ndarray:
        x = np.ascontiguousarray(x)
        if self.complex_in:
            out = self._jit(np.ascontiguousarray(x.real, dtype=self.rdtype),
                            np.ascontiguousarray(x.imag, dtype=self.rdtype))
        else:
            out = self._jit(x.astype(self.rdtype))
        if self.complex_out:
            return np.asarray(out[0], np.float64) \
                + 1j * np.asarray(out[1], np.float64)
        return np.asarray(out)

    def rand_input(self, rng) -> np.ndarray:
        return _rand(rng, self.plan.in_shape, self.complex_in)


# ---------------------------------------------------------------------------
# oracle rows: what should T(delta) / T(const) be?
# ---------------------------------------------------------------------------

def _oracle_1d(prob: BenchProblem, rdtype) -> Callable[[np.ndarray],
                                                       np.ndarray]:
    """Dense f64 oracle for the (possibly multi-axis) transform, applied to
    the logical input; used for the impulse rows.  Built from the same
    closed-form definitions as the dense generic solvers, evaluated in
    float64 (the double-precision reference of SURVEY.md §4)."""
    from ..ops import matrices

    shape = prob.shape
    axes = prob.axes

    def oracle(x: np.ndarray) -> np.ndarray:
        y = np.asarray(x, np.complex128)
        if prob.kind in ("c2c", "r2c"):
            for a in axes:
                M = matrices.dft_matrix(shape[a], prob.sign
                                        if prob.kind == "c2c" else -1)
                y = np.moveaxis(np.moveaxis(y, a, -1) @ M, -1, a)
            if prob.kind == "r2c":
                last = axes[-1]
                sl = [slice(None)] * y.ndim
                sl[last] = slice(0, shape[last] // 2 + 1)
                y = y[tuple(sl)]
            return y
        if prob.kind == "c2r":
            # oracle consumes the logical real signal; tested via round trip
            for a in axes:
                M = matrices.dft_matrix(shape[a], +1)
                y = np.moveaxis(np.moveaxis(y, a, -1) @ M, -1, a)
            return y.real
        # r2r: per-axis dense kind matrices
        y = np.asarray(x, np.float64)
        for a, k in zip(axes, prob.r2r_kinds):
            M = matrices.r2r_matrix(k.value, shape[a])
            y = np.moveaxis(np.moveaxis(y, a, -1) @ M, -1, a)
        return y

    return oracle


# ---------------------------------------------------------------------------
# the three property tests
# ---------------------------------------------------------------------------

def _impulse(cl: _Closure, rng, rounds: int, tol: float,
             res: VerifyResult) -> None:
    prob = cl.prob
    oracle = _oracle_1d(prob, cl.rdtype)
    # impulsive input: delta at the origin of the transform block, scaled
    inA = np.zeros(cl.plan.in_shape,
                   np.complex128 if cl.complex_in else np.float64)
    idx = [0] * inA.ndim
    x0 = np.sqrt(prob.logical_n) / 2.0
    inA[tuple(idx)] = x0
    if prob.kind == "c2r":
        # delta in the half-spectrum == constant real output, but only in
        # the batch entry holding the delta (the rest are zero)
        outA = np.zeros(cl.plan.out_shape)
        sl = (0,) * len(prob.batch) + tuple(slice(None)
                                            for _ in prob.sizes)
        outA[sl] = x0
    else:
        outA = oracle(_embed_real(inA, cl))
    e = acmp(cl.apply(inA), outA, tol, "impulse 1")
    res.tests["impulse"] = e
    # superposition rounds: T(B) + T(A-B) == T(A)
    for r in range(rounds):
        inB = cl.rand_input(rng)
        inC = inA - inB
        t = cl.apply(inB) + cl.apply(inC)
        e = max(e, acmp(t, cl.apply(inA), tol, f"impulse round {r}"))
    res.tests["impulse"] = e


def _embed_real(x, cl: _Closure):
    return x if cl.complex_in else x.real


def _linear(cl: _Closure, rng, rounds: int, tol: float,
            res: VerifyResult) -> None:
    # real coefficients for every non-c2c problem: c2r's Hermitian mirror is
    # conjugate-linear, so only real-linearity holds (verify-rdft2 realp=1)
    realp = cl.prob.kind != "c2c"
    e = 0.0
    for r in range(rounds):
        alpha = rng.uniform(-0.5, 0.5) + \
            (0 if realp else 1j * rng.uniform(-0.5, 0.5))
        beta = rng.uniform(-0.5, 0.5) + \
            (0 if realp else 1j * rng.uniform(-0.5, 0.5))
        inA = cl.rand_input(rng)
        inB = cl.rand_input(rng)
        want = alpha * cl.apply(inA) + beta * cl.apply(inB)
        got = cl.apply(alpha * inA + beta * inB)
        e = max(e, acmp(got, want, tol, f"linear round {r}"))
    res.tests["linear"] = e


def _tf_shift(cl: _Closure, rng, rounds: int, tol: float,
              res: VerifyResult) -> None:
    """Time-shift <-> phase duality over each transform axis (c2c only;
    verify-dft.c drives the same property through complex embeddings)."""
    prob = cl.prob
    if prob.kind != "c2c":
        return
    e = 0.0
    sign = prob.sign
    for r in range(rounds):
        inA = cl.rand_input(rng)
        for a in prob.axes:
            n = prob.shape[a]
            # time shift by one: y[t] = x[(t-1) mod n]  =>
            # Y[k] = X[k] * exp(sign*2pi i k / n)
            shifted = np.roll(inA, 1, axis=a)
            k = np.arange(n)
            phase = np.exp(sign * 2j * np.pi * k / n)
            shp = [1] * inA.ndim
            shp[a] = n
            want = cl.apply(inA) * phase.reshape(shp)
            got = cl.apply(shifted)
            e = max(e, acmp(got, want, tol, f"tf_shift axis {a} round {r}"))
            # frequency shift: x[t] * exp(-sign*2pi i t / n) => roll(Y, 1)
            t = np.arange(n)
            mod = np.exp(-sign * 2j * np.pi * t / n)
            got2 = cl.apply(inA * mod.reshape(shp))
            want2 = np.roll(cl.apply(inA), 1, axis=a)
            e = max(e, acmp(got2, want2, tol, f"fs_shift axis {a} round {r}"))
    res.tests["tf_shift"] = e


def verify_problem(prob_or_str, flags: int = K.ESTIMATE,
                   rounds: int = 4, tol: Optional[float] = None,
                   rdtype: str = "float32",
                   seed: int = 0) -> VerifyResult:
    """Run the full property-test battery on a problem (verify() analog,
    libbench2/verify.c).  Raises VerificationError on failure."""
    from .problem import parse_problem

    prob = parse_problem(prob_or_str) if isinstance(prob_or_str, str) \
        else prob_or_str
    if tol is None:
        tol = default_tol(rdtype)
    rng = np.random.default_rng(seed)
    cl = _Closure(prob, flags, rdtype)
    res = VerifyResult(problem=prob.pstring or str(prob))
    _impulse(cl, rng, rounds, tol, res)
    _linear(cl, rng, rounds, tol, res)
    _tf_shift(cl, rng, rounds, tol, res)
    if prob.kind in ("r2c", "c2r"):
        _real_roundtrip(cl, rng, tol, res)
    return res


def _real_roundtrip(cl: _Closure, rng, tol: float, res: VerifyResult) -> None:
    """r2c/c2r: unnormalized round trip recovers n*x (verify-rdft2 analog)."""
    from .. import api

    import jax

    prob = cl.prob
    real_shape = prob.shape
    n = prob.logical_n
    if prob.kind == "r2c":
        fwd, inv = cl.plan, api.plan_dft_c2r(real_shape, prob.axes,
                                             dtype=str(cl.rdtype))
    else:
        fwd = api.plan_dft_r2c(real_shape, prob.axes, dtype=str(cl.rdtype))
        inv = cl.plan
    x = _rand(rng, real_shape, False)
    rt = jax.jit(lambda a: inv.apply(fwd.apply(a)))
    y = np.asarray(rt(x.astype(cl.rdtype)))
    res.tests["roundtrip"] = acmp(y, n * x, tol, "real roundtrip")
