"""Double-double ("dd64") c2c tier: the long-double / quad precision
analog (FFTW's ``fftwl_``/``fftwq_`` library variants,
``fftw/fftw_api.h:102-118`` precision-prefix machinery, ``fftw3l.f03`` /
``fftw3q.f03``).

XLA has no f128 type and the accelerators have no arithmetic above f64,
so a *hardware* long-double/quad tier cannot exist.  The construction
here is the same one the df32 tier uses
one level up: every value travels as an UNEVALUATED SUM of two f64s and
every operation is an error-free transform (Dekker two-product with the
2^27+1 split, Knuth two-sum — the dtype-generic ``df_*`` ops in
:mod:`.df32`), giving ~106-bit effective mantissa (~1e-31 per-op error).
Trig constants are computed with mpmath at 40 significant digits and
split EXACTLY into f64 (hi, lo) pairs, so constant error (~1e-32) never
caps the tier.  Measured transform accuracy ~1e-30 relative — far inside
x86 long double's 64-bit mantissa (eps 1.1e-19) and within a few bits of
IEEE quad (eps 1.9e-34): the standard double-double trade, identical to
the libquadmath-vs-dd choice CPU packages make.

API shape: FFTW exposes long double / quad as parallel plan families
(``fftwl_plan_dft_1d`` + ``fftwl_execute``); numpy's widest complex is
``clongdouble`` (x86 80-bit).  Accordingly :class:`DdPlan` offers

* ``execute(x)`` on host ``np.clongdouble`` arrays (split/recombine on
  host — exact, since |lo| < ulp(hi) always fits f64), and
* ``apply_dd(rh, rl, ih, il)`` — the jittable double-double-pair form,
  the standard representation for quad-precision users (a dd pair IS
  how they hold values already).

Scope: c2c along the last axis, any leading batch dims, 2-3-5-smooth n
(other sizes raise — same gate as df32).  The rest of the API surface
stays at f64/df32; PARITY.md §2.13 records the stance.
"""
from __future__ import annotations

from typing import List, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .df32 import _canon, df_cadd, df_cmul, df32_radices

_MP_DPS = 40


def _mp():
    import mpmath
    mpmath.mp.dps = _MP_DPS
    return mpmath


def _split_mp(vals) -> Tuple[np.ndarray, np.ndarray]:
    """mpmath values -> exact f64 (hi, lo) pair arrays."""
    mp = _mp()
    hi = np.array([float(v) for v in vals], dtype=np.float64)
    lo = np.array([float(v - mp.mpf(h)) for v, h in zip(vals, hi)],
                  dtype=np.float64)
    return hi, lo


def _roots(n: int, ks, sign: int):
    """exp(sign*2*pi*i*k/n) at 40 digits via exact-argument cospi/sinpi."""
    mp = _mp()
    re, im = [], []
    for k in ks:
        a = mp.mpf(2 * int(k)) / n            # angle in units of pi
        re.append(mp.cospi(a))
        im.append(mp.sinpi(a) * sign)
    return re, im


def _split_roots(n: int, ks, sign: int, shape) -> Tuple[np.ndarray, ...]:
    re, im = _roots(n, ks, sign)
    rh, rl = _split_mp(re)
    ih, il = _split_mp(im)
    return tuple(a.reshape(shape) for a in (rh, rl, ih, il))


def _build(n: int, radices: List[int], sign: int):
    """Recursive CT level in dd64 arithmetic — the df32._build recursion
    with mpmath-split f64 constants (df32's constants come from complex128
    trig, whose 1e-16 rounding would cap this tier 14 orders short)."""
    if n == 1:
        return lambda x: x
    p = radices[0]
    q = n // p
    child = _build(q, radices[1:], sign)
    # butterfly matrix F[j,k] = w^(jk), w = exp(sign*2*pi*i/p)
    idx = [[(j * k) % p for j in range(p)] for k in range(p)]
    coeffs = []
    csplit = []
    for k in range(p):
        rh, rl, ih, il = _split_roots(p, idx[k], sign, (p,))
        coeffs.append([_canon(complex(rh[j] + 1j * ih[j]))
                       for j in range(p)])
        csplit.append([((np.array([rh[j], ih[j]]),
                         np.array([rl[j], il[j]]))) for j in range(p)])
    # twiddle grid w_n'^(k*j), n' = p*q, shaped (p, q)
    ks = [(k * j) % n for k in range(p) for j in range(q)]
    twrh, twrl, twih, twil = _split_roots(n, ks, sign, (p, q))

    def _coeff_mul(x, c, ch, cl):
        if c == 1:
            return x
        if c == -1:
            return (-x[0], -x[1], -x[2], -x[3])
        if c == 1j:
            return (-x[2], -x[3], x[0], x[1])
        if c == -1j:
            return (x[2], x[3], -x[0], -x[1])
        return df_cmul(x, (ch[0], cl[0], ch[1], cl[1]))

    def apply(x):
        shp = x[0].shape[:-1]
        xs = [tuple(v.reshape(*shp, p, q)[..., j, :] for v in x)
              for j in range(p)]
        outs = []
        for k in range(p):
            acc = None
            for j in range(p):
                t = _coeff_mul(xs[j], coeffs[k][j], *csplit[k][j])
                acc = t if acc is None else df_cadd(acc, t)
            if k > 0:
                w = (twrh[k], twrl[k], twih[k], twil[k])
                acc = df_cmul(acc, w)
            outs.append(acc)
        y = tuple(jnp.stack([o[i] for o in outs], axis=-2) for i in range(4))
        z = child(y)
        return tuple(jnp.swapaxes(v, -1, -2).reshape(*shp, n) for v in z)
    return apply


def dd64_applicable(n: int) -> bool:
    return n >= 2 and df32_radices(n) is not None


class DdPlan:
    """Long-double/quad-tier c2c plan (fftwl_plan / fftwq_plan analog)."""

    def __init__(self, n: int, sign: int = -1):
        if not dd64_applicable(n):
            raise ValueError(
                f"dd64 tier needs 2-3-5-smooth n >= 2, got {n}")
        if not jax.config.jax_enable_x64:
            raise RuntimeError(
                "dd64 tier needs jax_enable_x64 (the planes are f64)")
        self.n = n
        self.sign = sign
        core = _build(n, df32_radices(n), sign)
        adj = _build(n, df32_radices(n), -sign)

        @jax.custom_vjp
        def apply_dd(rh, rl, ih, il):
            return core((rh, rl, ih, il))

        def fwd(rh, rl, ih, il):
            return apply_dd(rh, rl, ih, il), None

        def bwd(_, g):
            # adjoint of the unnormalized linear map = opposite-sign
            # transform (same custom-VJP policy as df32: autodiff
            # through error-free chains loses the lo planes)
            return adj(tuple(g))

        apply_dd.defvjp(fwd, bwd)
        #: jittable double-double form: four (..., n) f64 planes in/out
        self.apply_dd = apply_dd
        self._jit = jax.jit(apply_dd)

    def execute(self, x: np.ndarray) -> np.ndarray:
        """Host np.clongdouble (or any complex) array -> np.clongdouble.
        Split and recombination happen on host in longdouble — exact for
        the hi plane; the lo plane carries bits 54-106, of which
        clongdouble can represent 54-64 (the container's limit, not the
        transform's — use ``apply_dd`` to keep all 106)."""
        x = np.asarray(x)
        ld = np.clongdouble
        xl = x.astype(ld)
        rh = xl.real.astype(np.float64)
        ih = xl.imag.astype(np.float64)
        rl = (xl.real - rh.astype(np.longdouble)).astype(np.float64)
        il = (xl.imag - ih.astype(np.longdouble)).astype(np.float64)
        yrh, yrl, yih, yil = (np.asarray(v) for v in
                              self._jit(rh, rl, ih, il))
        yr = yrh.astype(np.longdouble) + yrl.astype(np.longdouble)
        yi = yih.astype(np.longdouble) + yil.astype(np.longdouble)
        return (yr + 1j * yi).astype(ld)

    def flops(self) -> Tuple[float, float, float]:
        # dd ops cost ~20 f64 flops each; report the FFTW-convention
        # (adds, muls, fmas) triple like Plan.flops
        nlogn = self.n * np.log2(self.n)
        return (10.0 * nlogn, 8.0 * nlogn, 0.0)

    def __repr__(self):
        return (f"(dd64-{self.n} sign={self.sign} "
                f"radices={df32_radices(self.n)})")


class DdPlanNd:
    """Rank-n dd64 plan: one DdPlan per transform axis, applied along the
    last axis via moveaxis (every axis pass stays a batched last-axis
    transform — the same composition the f32/f64 tiers use)."""

    def __init__(self, shape, axes=None, sign: int = -1):
        shape = tuple(int(s) for s in shape)
        nd = len(shape)
        axes = tuple(a % nd for a in
                     (range(nd) if axes is None else axes))
        self.shape = shape
        self.axes = axes
        self.sign = sign
        self._plans = {a: DdPlan(shape[a], sign) for a in axes}

        def apply_dd(rh, rl, ih, il):
            x = (rh, rl, ih, il)
            for a in axes:
                x = tuple(jnp.moveaxis(v, a, -1) for v in x)
                x = self._plans[a].apply_dd(*x)
                x = tuple(jnp.moveaxis(v, -1, a) for v in x)
            return x

        self.apply_dd = apply_dd
        self._jit = jax.jit(apply_dd)

    def execute(self, x: np.ndarray) -> np.ndarray:
        xl = np.asarray(x).astype(np.clongdouble)
        rh = xl.real.astype(np.float64)
        ih = xl.imag.astype(np.float64)
        rl = (xl.real - rh.astype(np.longdouble)).astype(np.float64)
        il = (xl.imag - ih.astype(np.longdouble)).astype(np.float64)
        yrh, yrl, yih, yil = (np.asarray(v) for v in
                              self._jit(rh, rl, ih, il))
        yr = yrh.astype(np.longdouble) + yrl.astype(np.longdouble)
        yi = yih.astype(np.longdouble) + yil.astype(np.longdouble)
        return (yr + 1j * yi).astype(np.clongdouble)

    def __repr__(self):
        return f"(dd64-nd {self.shape} axes={self.axes} sign={self.sign})"


def plan_dft_1d_l(n: int, sign: int = -1) -> DdPlan:
    """fftwl_plan_dft_1d analog (x86 long double: eps 1.1e-19 — the dd64
    tier's ~1e-30 clears it by 11 orders)."""
    return DdPlan(n, sign)


def plan_dft_1d_q(n: int, sign: int = -1) -> DdPlan:
    """fftwq_plan_dft_1d analog (IEEE quad: eps 1.9e-34; dd64 reaches
    ~1e-30 — the double-double representation's limit, the same trade
    CPU double-double packages make vs libquadmath)."""
    return DdPlan(n, sign)


def plan_dft_l(shape, axes=None, sign: int = -1) -> DdPlanNd:
    """fftwl_plan_dft / _2d / _3d analog: rank-n long-double c2c."""
    return DdPlanNd(shape, axes, sign)


plan_dft_q = plan_dft_l
