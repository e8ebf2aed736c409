"""Real-input / real-output DFT solver builders (rdft2 format).

``r2c`` maps real ``(..., n)`` to complex ``(..., n//2+1)`` (FFTW's rdft2
format, reference ``fftw/fftw_api.c:9298-9410``); ``c2r`` is the unnormalized
inverse (``c2r(r2c(x)) = n*x``).

Solver map to the reference (SURVEY.md section 2.4):

* ``r2c_pack`` / ``c2r_pack`` — even n via a half-size complex DFT over
  packed even/odd samples plus an untangling twiddle pass; the
  replacement for the rdft2-ct-hc2c codelet path
  (fftw/fftw_api.c:5552-6190).
* ``r2c_via_c2c`` / ``c2r_via_c2c`` — any n by complex embedding /
  Hermitian extension (rdft2-rdft analog, fftw/fftw_api.c:6482-6761).
"""
from __future__ import annotations

from typing import Callable, Dict

import jax.numpy as jnp
import numpy as np

from . import c2c as c2c_ops

Apply = Callable[[jnp.ndarray], jnp.ndarray]


def full_spectrum(X: jnp.ndarray, n: int) -> jnp.ndarray:
    """Reconstruct the length-n Hermitian spectrum from its n//2+1 half."""
    mirror = jnp.conj(X[..., 1:(n + 1) // 2])[..., ::-1]
    return jnp.concatenate([X, mirror], axis=-1)


def build_r2c(desc: Dict, rdtype) -> Apply:
    alg = desc["alg"]
    n = desc["n"]
    ctype = c2c_ops.complex_dtype(rdtype)

    if alg == "r2c_dense":
        # dense cos/sin matrices on the matrix units: ~2n real flops/point
        # in one pass, against the reduction path's elementwise passes
        # (the dft-generic idea)
        m = n // 2 + 1
        j = np.arange(n, dtype=np.int64)[:, None]
        k = np.arange(m, dtype=np.int64)[None, :]
        e = 2.0 * np.pi * np.mod(j * k, n) / n
        Cr = np.ascontiguousarray(np.cos(e), dtype=rdtype)
        Ci = np.ascontiguousarray(-np.sin(e), dtype=rdtype)

        def apply_dense(x):
            from .. import config
            prec = config.precision()
            yr = jnp.matmul(x, Cr, precision=prec)
            yi = jnp.matmul(x, Ci, precision=prec)
            return yr + 1j * yi
        return apply_dense

    if alg == "r2c_via_c2c":
        child = c2c_ops.build_c2c(desc["child"], -1, rdtype)

        def apply_via(x):
            X = child(x.astype(ctype))
            return X[..., : n // 2 + 1]
        return apply_via

    if alg == "r2c_pack":
        assert n % 2 == 0
        m = n // 2
        child = c2c_ops.build_c2c(desc["child"], -1, rdtype)
        k = np.arange(m + 1, dtype=np.int64)
        w = np.asarray(np.exp(-2j * np.pi * k / n), dtype=ctype)

        def apply_pack(x):
            z = x[..., 0::2] + 1j * x[..., 1::2]
            Z = child(z.astype(ctype))
            Zf = jnp.concatenate([Z, Z[..., :1]], axis=-1)       # Z[0..m]
            Zr = jnp.conj(Zf[..., ::-1])                          # conj Z[m-k]
            Ze = 0.5 * (Zf + Zr)
            Zo = -0.5j * (Zf - Zr)
            return Ze + w * Zo
        return apply_pack

    raise ValueError(f"unknown r2c algorithm {alg!r}")


def build_c2r(desc: Dict, rdtype) -> Apply:
    alg = desc["alg"]
    n = desc["n"]
    ctype = c2c_ops.complex_dtype(rdtype)

    if alg == "c2r_dense":
        m = n // 2 + 1
        k = np.arange(m, dtype=np.int64)[:, None]
        t = np.arange(n, dtype=np.int64)[None, :]
        e = 2.0 * np.pi * np.mod(k * t, n) / n
        w = np.full((m, 1), 2.0)
        w[0] = 1.0
        if n % 2 == 0:
            w[-1] = 1.0
        Br = np.ascontiguousarray(w * np.cos(e), dtype=rdtype)
        Bi = np.ascontiguousarray(-w * np.sin(e), dtype=rdtype)

        def apply_dense(X):
            from .. import config
            prec = config.precision()
            return (jnp.matmul(jnp.real(X), Br, precision=prec)
                    + jnp.matmul(jnp.imag(X), Bi, precision=prec))
        return apply_dense

    if alg == "c2r_via_c2c":
        child = c2c_ops.build_c2c(desc["child"], +1, rdtype)

        def apply_via(X):
            return jnp.real(child(full_spectrum(X.astype(ctype), n)))
        return apply_via

    if alg == "c2r_pack":
        assert n % 2 == 0
        m = n // 2
        child = c2c_ops.build_c2c(desc["child"], +1, rdtype)
        k = np.arange(m + 1, dtype=np.int64)
        w = np.asarray(np.exp(+2j * np.pi * k / n), dtype=ctype)

        def apply_pack(X):
            X = X.astype(ctype)
            # drop imaginary parts of the DC/Nyquist bins first: numpy,
            # FFTW's hc format, and every other c2r solver here ignore
            # them (pocketfft convention); the even/odd untangle below
            # would otherwise leak them into the output
            X = jnp.concatenate(
                [jnp.real(X[..., :1]).astype(ctype), X[..., 1:m],
                 jnp.real(X[..., m:m + 1]).astype(ctype)], axis=-1)
            Xr = jnp.conj(X[..., ::-1])                           # conj X[m-k]
            Ze = 0.5 * (X + Xr)
            Zo = 0.5 * (X - Xr) * w
            Z = (Ze + 1j * Zo)[..., :m]
            z = child(Z) * 2.0                                    # unnormalized
            out = jnp.stack([jnp.real(z), jnp.imag(z)], axis=-1)
            return out.reshape(*z.shape[:-1], n)
        return apply_pack

    raise ValueError(f"unknown c2r algorithm {alg!r}")


def r2c_opcount(desc: Dict) -> Dict[str, float]:
    n = desc["n"]
    if desc["alg"] in ("r2c_dense", "c2r_dense"):
        mac = 2.0 * n * (n // 2 + 1)
        return {"add": mac, "mul": 0.0, "fma": mac}
    child = c2c_ops.c2c_opcount(desc["child"])
    extra = 6.0 * (n // 2 + 1)
    return {"add": child["add"] + extra, "mul": child["mul"] + extra,
            "fma": child["fma"]}


c2r_opcount = r2c_opcount
