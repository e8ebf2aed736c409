"""Compensated-f32 ("double-float") c2c solver: the fast double-precision
tier.

Every value travels as an UNEVALUATED SUM of two f32s (hi + lo, |lo| <=
ulp(hi)/2), and every multiply/add uses error-free transforms (Dekker
two-product via exact splitting, Knuth two-sum) so the pair behaves like a
~49-bit-mantissa float computed entirely in f32 arithmetic, reaching
~1e-13 relative error — inside FFTW's double-precision verify contract of
1e-10 (``fftw/libbench2/bench-main.c:70``, tolerance ladder
``verify.py``).  It serves devices whose f64 is slow or emulated; the
planner races it against the native f64 solvers for ``dtype=complex128``
plans.

Structure: a recursive mixed-radix Cooley-Tukey identical in shape to the
``mixed`` small-radix butterfly solver (``c2c.py`` apply_mixed_bfly) —
butterfly over axis -2, fused twiddle, child along the tail axis — but
with all arithmetic in double-float pairs.  Radix 2/4 butterflies touch
only +-1/+-i coefficients (pure adds/swaps); radices 3 and 5 pay dense
coefficient products, so any 2-3-5-smooth n is supported.

No reference analog: FFTW computes in hardware doubles.  The algorithmic
role matched here is the precision CONTRACT, not the mechanism.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from . import matrices

#: Dekker split constants (2^ceil(t/2) + 1 for a t-bit mantissa): split the
#: mantissa into two halves whose pairwise products are EXACT in the same
#: dtype.  f32: 2^12+1.  f64: 2^27+1 (used by the dd64 quad/long-double
#: tier, ops/dd64.py, which reuses these error-free transforms on f64
#: planes — the df_* ops below are dtype-generic).
_SPLIT = np.float32(4097.0)
_SPLIT64 = np.float64(134217729.0)

# A double-float number is a pair (hi, lo) of f32 arrays; a double-float
# complex is a 4-tuple (rh, rl, ih, il).


def _two_sum(a, b):
    """Error-free a + b = s + e (Knuth; no magnitude precondition)."""
    s = a + b
    bb = s - a
    return s, (a - (s - bb)) + (b - bb)


def _fast_two_sum(s, e):
    """Renormalize: |s| >= |e| assumed (true after any df op)."""
    h = s + e
    return h, e - (h - s)


def _two_prod(a, b):
    """Error-free a * b = p + e via Dekker splitting (pairwise products of
    half-mantissa pieces are exact in the working dtype).  Overflows for
    |a|,|b| >~ 2^115 (f32); FFT data scaled anywhere near that is outside
    every contract.  Dtype-generic: picks the split constant from the
    operand dtype (trace-time branch, zero runtime cost)."""
    split = _SPLIT64 if jnp.result_type(a) == jnp.float64 else _SPLIT
    p = a * b
    ah = split * a
    ah = ah - (ah - a)
    al = a - ah
    bh = split * b
    bh = bh - (bh - b)
    bl = b - bh
    e = ((ah * bh - p) + ah * bl + al * bh) + al * bl
    return p, e


def df_add(ah, al, bh, bl):
    s, e = _two_sum(ah, bh)
    return _fast_two_sum(s, e + (al + bl))


def df_sub(ah, al, bh, bl):
    return df_add(ah, al, -bh, -bl)


def df_mul(ah, al, bh, bl):
    p, e = _two_prod(ah, bh)
    return _fast_two_sum(p, e + (ah * bl + al * bh))


def df_cadd(a, b):
    return (*df_add(a[0], a[1], b[0], b[1]), *df_add(a[2], a[3], b[2], b[3]))


def df_csub(a, b):
    return (*df_sub(a[0], a[1], b[0], b[1]), *df_sub(a[2], a[3], b[2], b[3]))


def df_cmul(a, b):
    """(ar + i ai)(br + i bi), all components double-float."""
    rr = df_mul(a[0], a[1], b[0], b[1])
    ii = df_mul(a[2], a[3], b[2], b[3])
    ri = df_mul(a[0], a[1], b[2], b[3])
    ir = df_mul(a[2], a[3], b[0], b[1])
    return (*df_sub(*rr, *ii), *df_add(*ri, *ir))


def _split_const(x: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Host-side f64 -> (hi, lo) f32 pair, exact to ~2^-49."""
    hi = x.astype(np.float32)
    lo = (x - hi.astype(np.float64)).astype(np.float32)
    return np.ascontiguousarray(hi), np.ascontiguousarray(lo)


def _coeff_mul(x, c: complex, ch, cl):
    """x * c where c is a unit-circle coefficient known at trace time.
    +-1 / +-i are free (negations/swaps); otherwise a full df complex
    multiply against the host-split (ch, cl) pairs."""
    if c == 1:
        return x
    if c == -1:
        return (-x[0], -x[1], -x[2], -x[3])
    if c == 1j:
        return (-x[2], -x[3], x[0], x[1])
    if c == -1j:
        return (x[2], x[3], -x[0], -x[1])
    return df_cmul(x, (ch[0], cl[0], ch[1], cl[1]))


def _canon(c: complex) -> complex:
    """Snap near-exact butterfly coefficients to their exact values so the
    free-multiply special cases fire despite f64 trig rounding."""
    for exact in (1, -1, 1j, -1j):
        if abs(c - exact) < 1e-12:
            return exact
    return c


def df32_radices(n: int) -> Optional[List[int]]:
    """2-3-5-smooth factorization, largest radices first; None if n has a
    larger prime factor."""
    out = []
    m = n
    for p in (4, 3, 5, 2):
        while m % p == 0:
            out.append(p)
            m //= p
    if m != 1:
        return None
    return sorted(out, reverse=True)


def df32_applicable(n: int) -> bool:
    return n >= 2 and df32_radices(n) is not None


def _build(n: int, radices: List[int], sign: int):
    """Recursive CT level: butterfly radix p over axis -2 in df arithmetic,
    fused df twiddle, child along the tail.  Returns a closure on df
    complex 4-tuples of (..., n)-shaped f32 arrays."""
    if n == 1:
        return lambda x: x
    p = radices[0]
    q = n // p
    child = _build(q, radices[1:], sign)
    F = matrices.dft_matrix(p, sign)           # (p, p) complex128, exact-ish
    coeffs = [[_canon(complex(F[j, k])) for j in range(p)] for k in range(p)]
    csplit = [[(_split_const(np.array([F[j, k].real, F[j, k].imag])))
               for j in range(p)] for k in range(p)]
    tw = matrices.twiddle_2d(p, q, sign)       # (p, q) complex128
    twrh, twrl = _split_const(tw.real)
    twih, twil = _split_const(tw.imag)

    def apply(x):
        shp = x[0].shape[:-1]
        xs = [tuple(v.reshape(*shp, p, q)[..., j, :] for v in x)
              for j in range(p)]
        outs = []
        for k in range(p):
            acc = None
            for j in range(p):
                c = coeffs[k][j]
                if c == 0:
                    continue
                t = _coeff_mul(xs[j], c, *csplit[k][j])
                acc = t if acc is None else df_cadd(acc, t)
            if k > 0:          # row 0 of the twiddle grid is all ones
                w = (twrh[k], twrl[k], twih[k], twil[k])
                acc = df_cmul(acc, w)
            outs.append(acc)
        y = tuple(jnp.stack([o[i] for o in outs], axis=-2) for i in range(4))
        z = child(y)
        return tuple(jnp.swapaxes(v, -1, -2).reshape(*shp, n) for v in z)
    return apply


def build_df32_c2c_split(desc: Dict, sign: int, rdtype):
    """SplitApply builder for ``{"alg": "df32", "n": n, "radices": [...]}``.

    Boundary contract matches every other c2c builder: (xr, xi) in the
    plan's real dtype -> (yr, yi) same dtype.  For f64 the split to hi/lo
    f32 pairs and the final hi+lo recombination are the ONLY f64
    operations (elementwise, cheap even under XLA's f64 emulation).

    Differentiation: autodiff THROUGH the error-free-transform chains
    yields only f32-accurate adjoints (the cotangents ride the hi planes),
    so the adjoint of this unnormalized linear map is implemented as the
    opposite-sign df32 transform: J^T = conj(F) for symmetric F, keeping
    gradients at df accuracy."""
    n = desc["n"]
    radices = desc["radices"]
    rdtype = np.dtype(rdtype)
    core = _build(n, radices, sign)
    core_adj = _build(n, radices, -sign)

    def _run(which, xr, xi):
        xr = xr.astype(rdtype)
        xi = xi.astype(rdtype)
        rh = xr.astype(jnp.float32)
        ih = xi.astype(jnp.float32)
        rl = (xr - rh.astype(rdtype)).astype(jnp.float32)
        il = (xi - ih.astype(rdtype)).astype(jnp.float32)
        yrh, yrl, yih, yil = which((rh, rl, ih, il))
        return (yrh.astype(rdtype) + yrl.astype(rdtype),
                yih.astype(rdtype) + yil.astype(rdtype))

    @jax.custom_vjp
    def apply(xr, xi):
        return _run(core, xr, xi)

    def fwd(xr, xi):
        return apply(xr, xi), None

    def bwd(_, g):
        return _run(core_adj, g[0], g[1])

    apply.defvjp(fwd, bwd)
    return apply
