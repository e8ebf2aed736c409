"""scipy.fft-compatible interface over the engine.

Mirrors ``scipy.fft``'s public surface: the complex/real FFT family plus
DCT/DST I-IV with scipy's norm conventions ("backward" default, "ortho",
"forward"), and the n-dimensional dctn/dstn variants.  All transforms route
through the plan-cached engine (FFTW-convention unnormalized kernels with
the scipy factors applied on top, exactly how scipy wraps pocketfft).
"""
from __future__ import annotations

from typing import Optional, Sequence

import jax.numpy as jnp
import numpy as np

from .. import api as _api
from .. import kinds as K

# complex/real FFT family — scipy norm semantics match numpy's
fft = _api.fft
ifft = _api.ifft
fft2 = _api.fft2
ifft2 = _api.ifft2
fftn = _api.fftn
ifftn = _api.ifftn
rfft = _api.rfft
irfft = _api.irfft
rfft2 = _api.rfft2
irfft2 = _api.irfft2
rfftn = _api.rfftn
irfftn = _api.irfftn
fftfreq = _api.fftfreq
rfftfreq = _api.rfftfreq
fftshift = _api.fftshift
ifftshift = _api.ifftshift

from .numpy_fft import hfft, ihfft  # noqa: E402


def _axis_n(x, axis):
    return x.shape[axis % x.ndim]


def _shape_vec(x, axis, vals):
    shp = [1] * x.ndim
    shp[axis % x.ndim] = len(vals)
    return jnp.asarray(vals, x.dtype).reshape(shp)


def _norm_scale(norm, den: float) -> float:
    if norm in (None, "backward"):
        return 1.0
    if norm == "forward":
        return 1.0 / den
    if norm == "ortho":
        return 1.0 / np.sqrt(den)
    raise ValueError(f"bad norm {norm!r}")


def _trig_transform(api_fn, x, type, n, axis, norm, orthogonalize,
                    is_dct: bool):
    """Shared scipy dct/dst semantics: ``orthogonalize`` (defaulting to
    True under norm='ortho', scipy >= 1.8) rescales the boundary input /
    output elements by sqrt(2) factors independent of the uniform norm
    scaling — exactly how scipy layers it over pocketfft."""
    x = jnp.asarray(x, jnp.float32 if jnp.asarray(x).dtype != jnp.float64
                    else jnp.float64)
    if n is not None:
        x = _api._fit_length(x, n, axis)
    N = _axis_n(x, axis)
    if type not in (1, 2, 3, 4):
        raise ValueError(f"bad {'DCT' if is_dct else 'DST'} type {type}")
    if is_dct and type == 1 and N < 2:
        raise ValueError("DCT-I needs n >= 2")
    ortho = (norm == "ortho") if orthogonalize is None \
        else bool(orthogonalize)
    pre = np.ones(N)
    post = np.ones(N)
    if ortho:
        rt2 = np.sqrt(2.0)
        if is_dct:
            if type == 1:
                pre[0] = pre[-1] = rt2
                post[0] = post[-1] = 1.0 / rt2
            elif type == 2:
                post[0] = 1.0 / rt2
            elif type == 3:
                pre[0] = rt2
        else:
            if type == 2:
                post[-1] = 1.0 / rt2
            elif type == 3:
                pre[-1] = rt2
    scale = _norm_scale(norm, _forward_den(type, N, is_dct))
    if not np.all(pre == 1.0):
        x = x * _shape_vec(x, axis, pre)
    y = api_fn(x, type, axis, None)
    post = post * scale
    if not np.all(post == 1.0):
        y = y * _shape_vec(y, axis, post)
    return y


def dct(x, type: int = 2, n=None, axis: int = -1, norm=None,
        overwrite_x: bool = False, workers=None, orthogonalize=None):
    del overwrite_x, workers            # XLA owns memory and scheduling
    return _trig_transform(_api.dct, x, type, n, axis, norm,
                           orthogonalize, is_dct=True)


def dst(x, type: int = 2, n=None, axis: int = -1, norm=None,
        overwrite_x: bool = False, workers=None, orthogonalize=None):
    del overwrite_x, workers
    return _trig_transform(_api.dst, x, type, n, axis, norm,
                           orthogonalize, is_dct=False)


def _forward_den(type_: int, N: int, is_dct: bool) -> float:
    """Logical size: the "forward" norm divides by it (scipy convention)."""
    if type_ == 1:
        return 2.0 * (N - 1) if is_dct else 2.0 * (N + 1)
    return 2.0 * N


_INV_TYPE = {1: 1, 2: 3, 3: 2, 4: 4}


def idct(x, type: int = 2, n=None, axis: int = -1, norm=None,
         overwrite_x: bool = False, workers=None, orthogonalize=None):
    del overwrite_x, workers
    it = _INV_TYPE[type]
    N = _axis_n(jnp.asarray(x), axis) if n is None else n
    if norm == "ortho":
        return dct(x, it, n, axis, "ortho", orthogonalize=orthogonalize)
    if norm == "forward":
        return dct(x, it, n, axis, None, orthogonalize=orthogonalize)
    return dct(x, it, n, axis, None, orthogonalize=orthogonalize) \
        / _forward_den(it, N, True)


def idst(x, type: int = 2, n=None, axis: int = -1, norm=None,
         overwrite_x: bool = False, workers=None, orthogonalize=None):
    del overwrite_x, workers
    it = _INV_TYPE[type]
    N = _axis_n(jnp.asarray(x), axis) if n is None else n
    if norm == "ortho":
        return dst(x, it, n, axis, "ortho", orthogonalize=orthogonalize)
    if norm == "forward":
        return dst(x, it, n, axis, None, orthogonalize=orthogonalize)
    return dst(x, it, n, axis, None, orthogonalize=orthogonalize) \
        / _forward_den(it, N, False)


def _nd(fn1, x, type, axes, norm, orthogonalize=None):
    x = jnp.asarray(x)
    axes = tuple(range(x.ndim)) if axes is None else \
        tuple(a % x.ndim for a in axes)
    for a in axes:
        x = fn1(x, type, None, a, norm, orthogonalize=orthogonalize)
    return x


def dctn(x, type: int = 2, axes=None, norm=None, overwrite_x: bool = False,
         workers=None, orthogonalize=None):
    del overwrite_x, workers
    return _nd(dct, x, type, axes, norm, orthogonalize)


def idctn(x, type: int = 2, axes=None, norm=None, overwrite_x: bool = False,
          workers=None, orthogonalize=None):
    del overwrite_x, workers
    return _nd(idct, x, type, axes, norm, orthogonalize)


def dstn(x, type: int = 2, axes=None, norm=None, overwrite_x: bool = False,
         workers=None, orthogonalize=None):
    del overwrite_x, workers
    return _nd(dst, x, type, axes, norm, orthogonalize)


def idstn(x, type: int = 2, axes=None, norm=None, overwrite_x: bool = False,
          workers=None, orthogonalize=None):
    del overwrite_x, workers
    return _nd(idst, x, type, axes, norm, orthogonalize)
