"""Complex-to-complex 1-D solver builders.

Each builder turns a *plan descriptor* (a JSON-able dict chosen by the
planner) into a pure, jittable ``apply`` closure acting on the last axis of a
complex array ``(..., n) -> (..., n)``.  Transforms are unnormalized; ``sign``
is FFTW_FORWARD (-1) or FFTW_BACKWARD (+1).

The core representation is **split complex**: every algorithm is built as a
function ``(xr, xi) -> (yr, yi)`` on real arrays (:func:`build_c2c_split`).
Matrix units are real-arithmetic units and XLA lowers complex ops to real
ones anyway; the split form lets us use the 3-real-matmul Karatsuba complex
product instead of XLA's 4.
:func:`build_c2c` wraps it back into a complex-in/complex-out closure.

Solver map to the reference (see SURVEY.md section 2.3):

* ``nop``       — dft-nop               (fftw/fftw_api.c:3959-4012)
* ``direct``    — dft-direct + dft-generic, unified: a whole-transform DFT
                  matrix multiply; an (B, n) @ (n, n) matmul runs on the
                  matrix units (fftw_api.c:3131-3377, :3390-3519)
* ``mixed``     — dft-ct Cooley-Tukey, in the transposed four-step (Stockham
                  autosort) formulation: no bit reversal, every stage is a
                  batched matmul + twiddle + transpose (fftw_api.c:2068-3103)
* ``rader``     — dft-rader, prime n via (n-1)-point cyclic convolution
                  (fftw_api.c:4139-4413)
* ``bluestein`` — dft-bluestein, any n via chirp-z convolution at a padded
                  smooth size m >= 2n-1 (fftw_api.c:1598-1804)
* ``xla``       — delegate to XLA's built-in FFT (cuFFT on an NVIDIA GPU);
                  registered as a competitor the planner may time against
                  (no FFTW analog).
"""
from __future__ import annotations

from typing import Callable, Dict, Tuple

import jax.numpy as jnp
import numpy as np

from .. import config
from ..utils import primes
from . import matrices

Apply = Callable[[jnp.ndarray], jnp.ndarray]
SplitApply = Callable[[jnp.ndarray, jnp.ndarray],
                      Tuple[jnp.ndarray, jnp.ndarray]]


def complex_dtype(rdtype) -> np.dtype:
    return np.dtype(np.complex64) if np.dtype(rdtype) == np.float32 \
        else np.dtype(np.complex128)


def cmatmul(xr, xi, Fr, Fi):
    """Karatsuba complex matmul: 3 real matmuls instead of 4.

    (xr + i xi)(Fr + i Fi): t1 = xr@Fr, t2 = xi@Fi,
    t3 = (xr+xi)@(Fr+Fi); yr = t1-t2, yi = t3-t1-t2.
    """
    prec = config.precision()
    t1 = jnp.matmul(xr, Fr, precision=prec)
    t2 = jnp.matmul(xi, Fi, precision=prec)
    t3 = jnp.matmul(xr + xi, Fr + Fi, precision=prec)
    return t1 - t2, t3 - t1 - t2


def cmul(ar, ai, br, bi):
    """Pointwise complex multiply in split form."""
    return ar * br - ai * bi, ar * bi + ai * br


def build_c2c(desc: Dict, sign: int, rdtype) -> Apply:
    """Complex-in/complex-out wrapper over the split-core builder."""
    split = build_c2c_split(desc, sign, rdtype)
    if desc["alg"] == "nop" or desc["n"] == 1:
        return lambda x: x

    def apply(x):
        yr, yi = split(jnp.real(x), jnp.imag(x))
        return yr + 1j * yi
    return apply


def build_c2c_split(desc: Dict, sign: int, rdtype) -> SplitApply:
    """Build the split-complex apply closure for a c2c descriptor tree."""
    alg = desc["alg"]
    n = desc["n"]
    rdtype = np.dtype(rdtype)

    if alg == "nop" or n == 1:
        return lambda xr, xi: (xr, xi)

    if alg == "direct":
        F = matrices.dft_matrix(n, sign)
        Fr = np.ascontiguousarray(F.real, dtype=rdtype)
        Fi = np.ascontiguousarray(F.imag, dtype=rdtype)
        return lambda xr, xi: cmatmul(xr, xi, Fr, Fi)

    if alg == "mixed":
        p = desc["p"]
        q = n // p
        tw = matrices.twiddle_2d(p, q, sign)
        twr = np.ascontiguousarray(tw.real, dtype=rdtype)
        twi = np.ascontiguousarray(tw.imag, dtype=rdtype)
        child = build_c2c_split(desc["child"], sign, rdtype)

        if p <= 8:
            # small radix: an explicit butterfly over axis -2 with scalar
            # complex coefficients — XLA fuses the p^2 scaled adds and the
            # twiddle into one elementwise pass, with no transposes before
            # the child (the dftw-direct small-radix role)
            F = matrices.dft_matrix(p, sign)

            def apply_mixed_bfly(xr, xi):
                shp = xr.shape[:-1]
                xr = xr.reshape(*shp, p, q)
                xi = xi.reshape(*shp, p, q)
                xs = [(xr[..., j, :], xi[..., j, :]) for j in range(p)]
                outs = []
                for k in range(p):
                    ar = 0.0
                    ai = 0.0
                    for j in range(p):
                        cr, ci = float(F[j, k].real), float(F[j, k].imag)
                        br, bi = xs[j]
                        if cr:
                            ar = ar + (br if cr == 1.0 else
                                       -br if cr == -1.0 else cr * br)
                            ai = ai + (bi if cr == 1.0 else
                                       -bi if cr == -1.0 else cr * bi)
                        if ci:
                            ar = ar - (bi if ci == 1.0 else
                                       -bi if ci == -1.0 else ci * bi)
                            ai = ai + (br if ci == 1.0 else
                                       -br if ci == -1.0 else ci * br)
                    # fused twiddle row w[k, :]
                    wr, wi = twr[k], twi[k]
                    outs.append((ar * wr - ai * wi, ar * wi + ai * wr))
                yr = jnp.stack([o[0] for o in outs], axis=-2)
                yi = jnp.stack([o[1] for o in outs], axis=-2)
                zr, zi = child(yr, yi)                         # along q
                zr = jnp.swapaxes(zr, -1, -2).reshape(*shp, n)
                zi = jnp.swapaxes(zi, -1, -2).reshape(*shp, n)
                return zr, zi
            return apply_mixed_bfly

        F = matrices.dft_matrix(p, sign)
        Fr = np.ascontiguousarray(F.real, dtype=rdtype)
        Fi = np.ascontiguousarray(F.imag, dtype=rdtype)
        prec = config.precision()

        def dotp(a, M):
            # contract the p axis in place; XLA folds the layout into the
            # dot (no materialized transposes around the product)
            return jnp.einsum("...pq,pk->...kq", a, M, precision=prec)

        def apply_mixed(xr, xi):
            shp = xr.shape[:-1]
            xr = xr.reshape(*shp, p, q)
            xi = xi.reshape(*shp, p, q)
            t1 = dotp(xr, Fr)
            t2 = dotp(xi, Fi)
            t3 = dotp(xr + xi, Fr + Fi)
            yr, yi = t1 - t2, t3 - t1 - t2
            zr, zi = child(*cmul(yr, yi, twr, twi))             # along q
            zr = jnp.swapaxes(zr, -1, -2).reshape(*shp, n)
            zi = jnp.swapaxes(zi, -1, -2).reshape(*shp, n)
            return zr, zi
        return apply_mixed

    if alg == "df32":
        from . import df32
        return df32.build_df32_c2c_split(desc, sign, rdtype)

    if alg == "bluestein":
        m = desc["m"]
        c = matrices.chirp(n, sign)                 # host f64
        v = np.zeros(m, np.complex128)
        v[:n] = np.conj(c)
        v[m - n + 1:] = np.conj(c[1:])[::-1]
        fwd = build_c2c_split(desc["child"], -1, rdtype)
        bwd = build_c2c_split(desc["child"], +1, rdtype)
        # V = F(v) precomputed at plan time on host (exact f64 chirp).
        V = np.fft.fft(v) / m                       # fold 1/m into kernel
        Vr = np.ascontiguousarray(V.real, dtype=rdtype)
        Vi = np.ascontiguousarray(V.imag, dtype=rdtype)
        cr = np.ascontiguousarray(c.real, dtype=rdtype)
        ci = np.ascontiguousarray(c.imag, dtype=rdtype)

        def apply_bluestein(xr, xi):
            ur, ui = cmul(xr, xi, cr, ci)
            pad = [(0, 0)] * (ur.ndim - 1) + [(0, m - n)]
            Ur, Ui = fwd(jnp.pad(ur, pad), jnp.pad(ui, pad))
            sr, si = bwd(*cmul(Ur, Ui, Vr, Vi))
            return cmul(sr[..., :n], si[..., :n], cr, ci)
        return apply_bluestein

    if alg == "rader":
        p = n
        g = primes.find_generator(p)
        ginv = pow(g, p - 2, p)
        perm_a = np.array([pow(g, t, p) for t in range(p - 1)], np.int32)
        idx_out = np.array([pow(ginv, t, p) for t in range(p - 1)], np.int32)
        # b[j] = w^{g^{-j}}, exact integer exponents (rader omega table analog,
        # fftw/fftw_api.c:16541-16570).
        e = np.array([pow(ginv, t, p) for t in range(p - 1)], np.int64)
        b = np.exp(sign * 2j * np.pi * e / p)
        fwd = build_c2c_split(desc["child"], -1, rdtype)
        bwd = build_c2c_split(desc["child"], +1, rdtype)
        B = np.fft.fft(b) / (p - 1)
        Br = np.ascontiguousarray(B.real, dtype=rdtype)
        Bi = np.ascontiguousarray(B.imag, dtype=rdtype)

        def apply_rader(xr, xi):
            ar, ai = xr[..., perm_a], xi[..., perm_a]
            Ar, Ai = fwd(ar, ai)
            convr, convi = bwd(*cmul(Ar, Ai, Br, Bi))
            outr = jnp.empty_like(xr)
            outi = jnp.empty_like(xi)
            outr = outr.at[..., idx_out].set(xr[..., 0:1] + convr)
            outi = outi.at[..., idx_out].set(xi[..., 0:1] + convi)
            outr = outr.at[..., 0].set(jnp.sum(xr, axis=-1))
            outi = outi.at[..., 0].set(jnp.sum(xi, axis=-1))
            return outr, outi
        return apply_rader

    if alg == "xla":
        if sign == -1:
            def apply_xf(xr, xi):
                y = jnp.fft.fft(xr + 1j * xi, axis=-1)
                return jnp.real(y), jnp.imag(y)
            return apply_xf

        def apply_xb(xr, xi):
            y = jnp.fft.ifft(xr + 1j * xi, axis=-1) * n
            return jnp.real(y), jnp.imag(y)
        return apply_xb

    raise ValueError(f"unknown c2c algorithm {alg!r}")


# ---------------------------------------------------------------------------
# Op counts per transform (for plan.flops(), analog of the codelet desc
# opcounts consumed by fftw_flops, fftw/fftw_api.c:489-501).  Counts are for
# one 1-D transform, in real operations.
# ---------------------------------------------------------------------------

def c2c_opcount(desc: Dict) -> Dict[str, float]:
    alg, n = desc["alg"], desc["n"]
    if alg == "nop" or n == 1:
        return {"add": 0.0, "mul": 0.0, "fma": 0.0}
    if alg in ("direct", "xla"):
        # Karatsuba complex matmul: 3 real matmuls of n^2 MACs
        return {"add": 3.0 * n * n, "mul": 0.0, "fma": 3.0 * n * n}
    if alg == "mixed":
        p = desc["p"]
        q = n // p
        child = c2c_opcount(desc["child"])
        return {
            "add": 3.0 * p * p * q + p * child["add"],
            "mul": 6.0 * n + p * child["mul"],          # twiddle mult
            "fma": 3.0 * p * p * q + p * child["fma"],
        }
    if alg == "df32":
        # underlying f32 ops of the double-float pipeline (df add = 11
        # real adds; df mul = 9 mul + 12 add; complex df mul = 4 df mul +
        # 2 df add): per stage n(p-1) complex df adds, plus (p-1)^2 dense
        # butterfly products per group for p not in {2, 4} (whose +-1/+-i
        # coefficients are free), plus p-1 twiddle products per group
        total = {"add": 0.0, "mul": 0.0, "fma": 0.0}
        for p in desc["radices"]:
            g = n / p
            cmul = g * ((0 if p in (2, 4) else (p - 1) ** 2) + (p - 1))
            cadd = n * (p - 1)
            total["add"] += cadd * 22.0 + cmul * 70.0
            total["mul"] += cmul * 36.0
        return total
    if alg == "bluestein":
        child = c2c_opcount(desc["child"])
        return {
            "add": 2 * child["add"] + 2.0 * desc["m"],
            "mul": 2 * child["mul"] + 6.0 * (2 * desc["n"] + desc["m"]),
            "fma": 2 * child["fma"],
        }
    if alg == "rader":
        child = c2c_opcount(desc["child"])
        return {
            "add": 2 * child["add"] + 4.0 * n,
            "mul": 2 * child["mul"] + 6.0 * n,
            "fma": 2 * child["fma"],
        }
    raise ValueError(alg)
