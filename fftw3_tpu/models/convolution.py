"""FFT fast convolution / correlation — the canonical FFT application tier.

(The reference ships no applications, but fast convolution is the workload
its docs use throughout; these are the "models" of an FFT framework.)

All functions are pure and jittable, route through the plan-cached engine
(so repeated shapes reuse compiled XLA plans), and support 'full',
'same', 'valid' modes with real or complex inputs, batched over leading
dimensions.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import jax.numpy as jnp
import numpy as np

from .. import api
from ..utils import primes


def _fft_size(n: int) -> int:
    """Smallest 7-smooth size >= n (keeps the planner on fast paths)."""
    return primes.next_fast_size(n, smooth=7)


def _axes_shapes(x_shape, y_shape, axes):
    full = [x_shape[a] + y_shape[a] - 1 for a in axes]
    return full


def fftconvolve(x, y, mode: str = "full", axes: Sequence[int] = None):
    """scipy.signal.fftconvolve-compatible convolution via the engine."""
    x = jnp.asarray(x)
    y = jnp.asarray(y)
    if x.ndim != y.ndim:
        raise ValueError("x and y must have the same rank")
    axes = tuple(range(x.ndim)) if axes is None else \
        tuple(a % x.ndim for a in axes)
    full = _axes_shapes(x.shape, y.shape, axes)
    padded = [_fft_size(n) for n in full]
    complex_ = (jnp.issubdtype(x.dtype, jnp.complexfloating)
                or jnp.issubdtype(y.dtype, jnp.complexfloating))

    sx = list(x.shape)
    sy = list(y.shape)
    for a, n in zip(axes, padded):
        sx[a] = n
        sy[a] = n
    X = _fftn(_pad_to(x, sx), axes, complex_)
    Y = _fftn(_pad_to(y, sy), axes, complex_)
    z = _ifftn(X * Y, axes, complex_, [sx[a] for a in axes])
    out = _crop(z, x.shape, y.shape, axes, full, mode)
    return out


def fftcorrelate(x, y, mode: str = "full", axes: Sequence[int] = None):
    """Cross-correlation: conv(x, reversed-conj(y))."""
    y = jnp.asarray(y)
    axes = tuple(range(y.ndim)) if axes is None else \
        tuple(a % y.ndim for a in axes)
    rev = y
    for a in axes:
        rev = jnp.flip(rev, axis=a)
    return fftconvolve(x, jnp.conj(rev), mode, axes)


def _pad_to(x, shape):
    pads = [(0, t - s) for s, t in zip(x.shape, shape)]
    return jnp.pad(x, pads)


def _fftn(x, axes, complex_):
    if complex_:
        return api.fftn(x, axes=axes)
    return api.rfftn(x, axes=axes)


def _ifftn(X, axes, complex_, sizes):
    if complex_:
        return api.ifftn(X, axes=axes)
    return api.irfftn(X, s=sizes, axes=axes)


def _crop(z, xs, ys, axes, full, mode):
    sl = [slice(None)] * z.ndim
    for a, n in zip(axes, full):
        if mode == "full":
            sl[a] = slice(0, n)
        elif mode == "same":
            start = (ys[a] - 1) // 2
            sl[a] = slice(start, start + xs[a])
        elif mode == "valid":
            if xs[a] < ys[a]:
                raise ValueError("valid mode needs x >= y along all axes")
            sl[a] = slice(ys[a] - 1, xs[a])
        else:
            raise ValueError(f"bad mode {mode!r}")
    return z[tuple(sl)]
