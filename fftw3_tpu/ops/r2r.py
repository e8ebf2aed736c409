"""Real-to-real 1-D solver builders: halfcomplex DFT, DHT, and the eight
real-even/odd transforms (DCT/DST I-IV), all with FFTW's unnormalized
definitions ("What FFTW Really Computes").

Every fast solver here is a *reduction to r2c/c2r/c2c* with O(n) pre/post
passes — exactly the architecture of FFTW's reodft layer, where everything
reduces to R2HC (reference ``fftw/fftw_api.c:11705-14160``):

* ``redft10_half`` — DCT-II via Makhoul's even/odd permutation + half-size
  real FFT + quarter-sample twiddle (reodft010e-r2hc analog,
  fftw_api.c:12404-12788).
* ``redft01_half`` — DCT-III, the exact inverse route.
* ``redft00_ext`` / ``rodft00_ext`` — DCT-I / DST-I via even/odd extension
  to a 2(n∓1)-point real FFT (redft00e-r2hc-pad, fftw_api.c:11914-12076).
* ``redft11_2n`` — DCT-IV via a zero-padded 2n-point FFT with half-sample
  shifts (reodft11e analog, fftw_api.c:13326-13806).
* ``rodft*_flip`` — each DST kind from the matching DCT kind by the exact
  sign-flip/reversal identities (same trick FFTW's RO* apply functions use).
* ``dht_via_r2c`` — DHT = Re - Im of the real DFT (dht-r2hc analog,
  fftw_api.c:6800-7114).
* ``dht_rader`` — prime-n DHT via Rader's generator permutation reducing
  to a REAL cyclic convolution of length n-1 (dht-rader analog,
  fftw_api.c:10398-10566).  Unlike the via-r2c route, whose prime-n child
  ends in a *complex* Rader/Bluestein convolution, the convolution here
  stays real end-to-end (r2c -> halfcomplex pointwise -> c2r), roughly
  halving the convolution work.  The cas kernel's DFT is precomputed on
  the host in f64 with exact integer exponents.
* ``r2hc_via_r2c`` / ``hc2r_via_c2r`` — halfcomplex packing of the real DFT.
* ``r2r_matmul`` — dense-matrix fallback for any kind/size; an (n,n)
  matmul runs on the matrix units and is competitive at small n (the
  planner decides), taking the role of FFTW's generic O(n^2) solvers.
"""
from __future__ import annotations

from typing import Callable, Dict

import jax.numpy as jnp
import numpy as np

from .. import config
from ..utils import primes
from . import c2c as c2c_ops
from . import matrices
from . import real as real_ops

Apply = Callable[[jnp.ndarray], jnp.ndarray]


def _makhoul_perm(n: int) -> np.ndarray:
    """v[j] = x[perm[j]]: even samples ascending then odd samples descending."""
    idx = np.empty(n, np.int32)
    h = (n + 1) // 2
    idx[:h] = np.arange(0, n, 2)
    idx[h:] = np.arange(1, n, 2)[::-1]
    return idx


def _makhoul_inv(n: int) -> np.ndarray:
    perm = _makhoul_perm(n)
    inv = np.empty(n, np.int32)
    inv[perm] = np.arange(n, dtype=np.int32)
    return inv


def _redft11_odd_maps(n: int):
    """Host-side signed-permutation maps for the odd-n DCT-IV via a single
    same-size R2HC (the 8 x n PFA route of S.C. Chan & K.L. Ho, IEEE
    Trans. CAS-II 39(3) 1992; reodft11e-r2hc-odd analog,
    fftw/fftw_api.c:13056-13322).  The pre-step samples the canonical
    DCT-IV symmetry extension (even about -1/2, odd about n-1/2) of x at
    positions n//2 + 4i mod 4n; the post-step combines pairs of
    halfcomplex bins with signs and a global sqrt(2).  Both derived
    numerically-verified against the dense DCT-IV matrix."""
    n2 = n // 2
    m = (n2 + 4 * np.arange(n, dtype=np.int64)) % (4 * n)
    pre_idx = np.empty(n, np.int64)
    pre_sgn = np.empty(n, np.float64)
    for i, mm in enumerate(m):
        if mm < n:
            pre_idx[i], pre_sgn[i] = mm, 1.0
        elif mm < 2 * n:
            pre_idx[i], pre_sgn[i] = 2 * n - 1 - mm, -1.0
        elif mm < 3 * n:
            pre_idx[i], pre_sgn[i] = mm - 2 * n, -1.0
        else:
            pre_idx[i], pre_sgn[i] = 4 * n - 1 - mm, 1.0
    ia = np.zeros(n, np.int64)
    sa = np.zeros(n)
    ib = np.zeros(n, np.int64)
    sb = np.zeros(n)

    def sgn(t):
        return -1.0 if t % 2 else 1.0

    i = 0
    while 2 * i + 1 < n2:
        k = 2 * i + 1
        ia[i], sa[i] = k, sgn((i + 1) // 2)
        ib[i], sb[i] = n - k, sgn(i // 2)
        ia[n - (i + 1)], sa[n - (i + 1)] = k, sgn((n - i) // 2)
        ib[n - (i + 1)], sb[n - (i + 1)] = n - k, -sgn((n - (i + 1)) // 2)
        ia[n2 - (i + 1)], sa[n2 - (i + 1)] = k + 1, sgn((n2 - i) // 2)
        ib[n2 - (i + 1)], sb[n2 - (i + 1)] = \
            n - (k + 1), -sgn((n2 - (i + 1)) // 2)
        ia[n2 + (i + 1)], sa[n2 + (i + 1)] = k + 1, sgn((n2 + i + 2) // 2)
        ib[n2 + (i + 1)], sb[n2 + (i + 1)] = \
            n - (k + 1), sgn((n2 + (i + 1)) // 2)
        i += 1
    if 2 * i + 1 == n2:
        ia[i], sa[i] = n2, sgn((i + 1) // 2)
        ib[i], sb[i] = n - n2, sgn(i // 2)
        ia[n - (i + 1)], sa[n - (i + 1)] = n2, sgn((i + 2) // 2)
        ib[n - (i + 1)], sb[n - (i + 1)] = n - n2, sgn((i + 1) // 2)
    ia[n2], sa[n2] = 0, sgn((n2 + 1) // 2)
    ib[n2], sb[n2] = 0, 0.0
    rt2 = np.sqrt(2.0)
    return pre_idx, pre_sgn, ia, sa * rt2, ib, sb * rt2


def build_r2r(desc: Dict, rdtype) -> Apply:
    alg = desc["alg"]
    n = desc["n"]
    ctype = c2c_ops.complex_dtype(rdtype)

    if alg == "r2r_matmul":
        M = np.asarray(matrices.r2r_matrix(desc["kind"], n), dtype=rdtype)
        return lambda x: jnp.matmul(x, M, precision=config.precision())

    if alg == "dht_via_r2c":
        child = real_ops.build_r2c(desc["child"], rdtype)

        def apply_dht(x):
            X = child(x)
            head = jnp.real(X) - jnp.imag(X)                     # k = 0..n//2
            mid = X[..., 1:(n + 1) // 2]
            tail = (jnp.real(mid) + jnp.imag(mid))[..., ::-1]    # k > n//2
            return jnp.concatenate([head, tail], axis=-1)
        return apply_dht

    if alg == "dht_rader":
        p = n
        g = primes.find_generator(p)
        ginv = pow(g, p - 2, p)
        perm_a = np.array([pow(g, t, p) for t in range(p - 1)], np.int32)
        idx_out = np.array([pow(ginv, t, p) for t in range(p - 1)], np.int32)
        # cas kernel h[m] = cas(2*pi*g^{-m}/p): H[g^{-t}] - x[0] =
        # (x[g^.] * h)[t], a real length-(p-1) cyclic convolution.
        e = np.array([pow(ginv, m, p) for m in range(p - 1)], np.int64)
        t = 2.0 * np.pi * e / p
        K = np.fft.rfft(np.cos(t) + np.sin(t)) / (p - 1)  # fold 1/(p-1)
        Kc = np.ascontiguousarray(K, dtype=ctype)
        fwd = real_ops.build_r2c(desc["children"][0], rdtype)
        bwd = real_ops.build_c2r(desc["children"][1], rdtype)

        def apply_dht_rader(x):
            conv = bwd(fwd(x[..., perm_a]) * Kc)
            out = jnp.empty_like(x)
            out = out.at[..., idx_out].set(x[..., 0:1] + conv)
            return out.at[..., 0].set(jnp.sum(x, axis=-1))
        return apply_dht_rader

    if alg == "r2hc_via_r2c":
        child = real_ops.build_r2c(desc["child"], rdtype)

        def apply_r2hc(x):
            X = child(x)
            re = jnp.real(X)                                     # r_0..r_{n/2}
            im = jnp.imag(X[..., 1:(n + 1) // 2])[..., ::-1]
            return jnp.concatenate([re, im], axis=-1)
        return apply_r2hc

    if alg == "hc2r_via_c2r":
        child = real_ops.build_c2r(desc["child"], rdtype)
        nre = n // 2 + 1

        def apply_hc2r(hc):
            re = hc[..., :nre]
            im_rev = hc[..., nre:]
            zero = jnp.zeros_like(hc[..., :1])
            im = jnp.concatenate([zero, im_rev[..., ::-1]], axis=-1)
            if n % 2 == 0:
                im = jnp.concatenate([im, zero], axis=-1)
            return child((re + 1j * im).astype(ctype))
        return apply_hc2r

    if alg == "redft10_half":                                    # DCT-II
        child = real_ops.build_r2c(desc["child"], rdtype)
        perm = np.asarray(_makhoul_perm(n))
        k = np.arange(n // 2 + 1, dtype=np.int64)
        w = np.asarray(np.exp(-1j * np.pi * k / (2 * n)), dtype=ctype)

        def apply_dct2(x):
            V = child(x[..., perm])
            t = w * V
            head = 2.0 * jnp.real(t)                             # Y[0..n//2]
            tail = (-2.0 * jnp.imag(t[..., 1:(n + 1) // 2]))[..., ::-1]
            return jnp.concatenate([head, tail], axis=-1)
        return apply_dct2

    if alg == "redft01_half":                                    # DCT-III
        child = real_ops.build_c2r(desc["child"], rdtype)
        inv = np.asarray(_makhoul_inv(n))
        k = np.arange(n // 2 + 1, dtype=np.int64)
        w = np.asarray(np.exp(+1j * np.pi * k / (2 * n)), dtype=ctype)

        def apply_dct3(y):
            re = y[..., : n // 2 + 1] * 0.5
            imt = -0.5 * y[..., n // 2 + 1:][..., ::-1]
            zero = jnp.zeros_like(y[..., :1])
            if n % 2 == 0:
                # Nyquist bin: Im t[n/2] = -Re t[n/2] (derivation: t[n/2] =
                # e^{-i pi/4} V[n/2] with V[n/2] real)
                im = jnp.concatenate([zero, imt, -re[..., -1:]], axis=-1)
            else:
                im = jnp.concatenate([zero, imt], axis=-1)
            V = w * (re + 1j * im)
            v = child(V) * 2.0                                   # 2n * irfft(V)
            return v[..., inv]
        return apply_dct3

    if alg == "redft00_ext":                                     # DCT-I
        child = real_ops.build_r2c(desc["child"], rdtype)        # size 2(n-1)

        def apply_dct1(x):
            e = jnp.concatenate([x, x[..., 1:-1][..., ::-1]], axis=-1)
            return jnp.real(child(e))                            # bins 0..n-1
        return apply_dct1

    if alg == "rodft00_ext":                                     # DST-I
        child = real_ops.build_r2c(desc["child"], rdtype)        # size 2(n+1)

        def apply_dst1(x):
            z = jnp.zeros_like(x[..., :1])
            o = jnp.concatenate([z, x, z, -x[..., ::-1]], axis=-1)
            return -jnp.imag(child(o))[..., 1:n + 1]
        return apply_dst1

    if alg == "redft11_2n":                                      # DCT-IV
        child = c2c_ops.build_c2c(desc["child"], -1, rdtype)     # size 2n
        j = np.arange(n, dtype=np.int64)
        k = np.arange(n, dtype=np.int64)
        wj = np.asarray(np.exp(-1j * np.pi * j / (2 * n)), dtype=ctype)
        wk = np.asarray(np.exp(-1j * np.pi * (2 * k + 1) / (4 * n)),
                         dtype=ctype)

        def apply_dct4(x):
            u = x.astype(ctype) * wj
            pad = [(0, 0)] * (u.ndim - 1) + [(0, n)]
            G = child(jnp.pad(u, pad))[..., :n]
            return 2.0 * jnp.real(wk * G)
        return apply_dct4

    if alg == "redft00_split":                                   # DCT-I
        # split-radix for odd n (logical size N = n-1 even): evens are a
        # half-size DCT-I, odds a half-size DCT-II, recombined by the
        # cosine mirror symmetries (reodft00e-splitradix role,
        # fftw/fftw_api.c:12088-12401, re-derived; ~2x less work than the
        # zero-padded route)
        N = n - 1
        h = N // 2
        ce = build_r2r(desc["children"][0], rdtype)   # REDFT00, size h+1
        co = build_r2r(desc["children"][1], rdtype)   # REDFT10, size h

        def apply_dct1s(x):
            E = ce(x[..., 0::2])
            O = co(x[..., 1::2])
            zero = jnp.zeros_like(O[..., :1])
            head = E + jnp.concatenate([O, zero], axis=-1)   # k = 0..h
            tail = (E[..., 0:h] - O)[..., ::-1]              # k = h+1..N
            return jnp.concatenate([head, tail], axis=-1)
        return apply_dct1s

    if alg == "rodft00_split":                                   # DST-I
        # sine mirror of the split: interior evens are a half-size DST-I,
        # odds a half-size DST-II
        N = n + 1
        h = N // 2
        ce = build_r2r(desc["children"][0], rdtype)   # RODFT00, size h-1
        co = build_r2r(desc["children"][1], rdtype)   # RODFT10, size h

        def apply_dst1s(x):
            E = ce(x[..., 1::2])
            O = co(x[..., 0::2])
            zero = jnp.zeros_like(O[..., :1])
            head = jnp.concatenate([E, zero], axis=-1) + O   # Y[0..h-1]
            tail = (O[..., 0:h - 1] - E)[..., ::-1]          # Y[h..n-1]
            return jnp.concatenate([head, tail], axis=-1)
        return apply_dst1s

    if alg == "redft11_odd":                                     # DCT-IV
        pre_idx, pre_sgn, ia, sa, ib, sb = _redft11_odd_maps(n)
        child = build_r2r(desc["child"], rdtype)      # R2HC, size n
        pre_idx = np.asarray(pre_idx)
        preS = np.asarray(pre_sgn, rdtype)
        saA = np.asarray(sa, rdtype)
        sbA = np.asarray(sb, rdtype)
        iaA, ibA = np.asarray(ia), np.asarray(ib)

        def apply_dct4o(x):
            H = child(x[..., pre_idx] * preS)
            return saA * H[..., iaA] + sbA * H[..., ibA]
        return apply_dct4o

    if alg == "rodft10_flip":                                    # DST-II
        child = build_r2r(desc["child"], rdtype)
        sgn = np.asarray((-1.0) ** np.arange(n), dtype=rdtype)
        return lambda x: child(x * sgn)[..., ::-1]

    if alg == "rodft01_flip":                                    # DST-III
        child = build_r2r(desc["child"], rdtype)
        sgn = np.asarray((-1.0) ** np.arange(n), dtype=rdtype)
        return lambda x: sgn * child(x[..., ::-1])

    if alg == "rodft11_flip":                                    # DST-IV
        child = build_r2r(desc["child"], rdtype)
        sgn = np.asarray((-1.0) ** np.arange(n), dtype=rdtype)
        return lambda x: sgn * child(x[..., ::-1])

    raise ValueError(f"unknown r2r algorithm {alg!r}")


def r2r_opcount(desc: Dict) -> Dict[str, float]:
    alg, n = desc["alg"], desc["n"]
    if alg == "r2r_matmul":
        return {"add": float(n * n), "mul": 0.0, "fma": float(n * n)}
    if alg in ("redft00_split", "rodft00_split"):
        a = r2r_opcount(desc["children"][0])
        b = r2r_opcount(desc["children"][1])
        return {"add": a["add"] + b["add"] + 2.0 * n,
                "mul": a["mul"] + b["mul"], "fma": a["fma"] + b["fma"]}
    if alg == "dht_rader":
        a = real_ops.r2c_opcount(desc["children"][0])
        b = real_ops.c2r_opcount(desc["children"][1])
        ptwise = 6.0 * ((n - 1) // 2 + 1)      # halfcomplex pointwise mul
        return {"add": a["add"] + b["add"] + 2.0 * n,
                "mul": a["mul"] + b["mul"] + ptwise,
                "fma": a["fma"] + b["fma"]}
    child_key = "child"
    if alg in ("rodft10_flip", "rodft01_flip", "rodft11_flip",
               "redft11_odd"):
        inner = r2r_opcount(desc[child_key])
    elif alg == "redft11_2n":
        inner = c2c_ops.c2c_opcount(desc[child_key])
    elif alg in ("redft01_half", "hc2r_via_c2r"):
        inner = real_ops.c2r_opcount(desc[child_key])
    else:
        inner = real_ops.r2c_opcount(desc[child_key])
    return {"add": inner["add"] + 2.0 * n, "mul": inner["mul"] + 2.0 * n,
            "fma": inner["fma"]}
