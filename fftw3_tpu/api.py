"""Public API.

Two surfaces, both pure jittable functions underneath:

1. **FFTW-style planned API** mirroring ``fftw3.h`` semantics (reference
   ``fftw/fftw_api.c:234-1533``): ``plan_dft*``, ``plan_dft_r2c*``,
   ``plan_dft_c2r*``, ``plan_r2r*``, guru variants, ``execute``, wisdom I/O,
   ``flops``/``cost``.  Strides/pointers have no JAX analog: the *capability*
   (batched, embedded, arbitrary-axis transforms) is expressed with array
   shapes and ``axes`` instead — the guru rank/vector-rank model maps 1:1.

2. **numpy-style functional API** (``fft``, ``ifft``, ``rfftn``, ``dct``, …)
   with numpy/scipy norm conventions, plan-cached per (shape, dtype, axes).

All planned transforms are unnormalized, like FFTW; the numpy-style wrappers
apply the conventional normalizations on top.
"""
from __future__ import annotations

import threading
from functools import lru_cache
from typing import Optional, Sequence, Tuple, Union

import jax.numpy as jnp
import numpy as np

from . import kinds as K
from . import plan as plan_mod
from . import planner as planner_mod
from .kinds import (BACKWARD, CONSERVE_MEMORY, DESTROY_INPUT, ESTIMATE,
                    EXHAUSTIVE, FORWARD, MEASURE, PATIENT, PRESERVE_INPUT,
                    UNALIGNED, WISDOM_ONLY, Kind)

Plan = plan_mod.Plan
Problem = plan_mod.Problem

_lock = threading.Lock()


def _rdtype_of(dtype) -> str:
    dt = np.dtype(dtype)
    if dt in (np.complex64, np.float32):
        return "float32"
    if dt in (np.complex128, np.float64):
        return "float64"
    if dt == np.dtype(jnp.bfloat16):
        return "float32"
    raise ValueError(f"unsupported dtype {dtype}")


def _axes_tuple(shape, axes) -> Tuple[int, ...]:
    if axes is None:
        return tuple(range(len(shape)))
    if isinstance(axes, int):
        return (axes,)
    return tuple(axes)


# ---------------------------------------------------------------------------
# FFTW-style planned API
# ---------------------------------------------------------------------------

def plan_dft(shape: Sequence[int], axes=None, sign: int = FORWARD,
             flags: int = ESTIMATE, dtype="complex64") -> Plan:
    """Complex DFT plan over `axes` of arrays of `shape` (plan_dft analog)."""
    shape = tuple(shape)
    prob = Problem(shape=shape, axes=_axes_tuple(shape, axes), kind="c2c",
                   sign=sign, rdtype=_rdtype_of(dtype))
    with _lock:
        return plan_mod.make_plan(prob, flags)


def plan_dft_1d(n: int, sign: int = FORWARD, flags: int = ESTIMATE,
                dtype="complex64") -> Plan:
    return plan_dft((n,), (0,), sign, flags, dtype)


def plan_dft_2d(n0: int, n1: int, sign: int = FORWARD, flags: int = ESTIMATE,
                dtype="complex64") -> Plan:
    return plan_dft((n0, n1), (0, 1), sign, flags, dtype)


def plan_dft_3d(n0: int, n1: int, n2: int, sign: int = FORWARD,
                flags: int = ESTIMATE, dtype="complex64") -> Plan:
    return plan_dft((n0, n1, n2), (0, 1, 2), sign, flags, dtype)


def plan_many_dft(n: Sequence[int], howmany: int, sign: int = FORWARD,
                  flags: int = ESTIMATE, dtype="complex64") -> Plan:
    """Batched DFT (advanced 'many' API analog, fftw_api.c:642-772): the
    batch is a leading vector dimension."""
    n = tuple(n)
    shape = (howmany,) + n
    axes = tuple(range(1, len(n) + 1))
    return plan_dft(shape, axes, sign, flags, dtype)


def plan_dft_r2c(shape: Sequence[int], axes=None, flags: int = ESTIMATE,
                 dtype="float32") -> Plan:
    shape = tuple(shape)
    prob = Problem(shape=shape, axes=_axes_tuple(shape, axes), kind="r2c",
                   rdtype=_rdtype_of(dtype))
    with _lock:
        return plan_mod.make_plan(prob, flags)


def plan_dft_r2c_1d(n, flags=ESTIMATE, dtype="float32"):
    return plan_dft_r2c((n,), (0,), flags, dtype)


def plan_dft_r2c_2d(n0, n1, flags=ESTIMATE, dtype="float32"):
    return plan_dft_r2c((n0, n1), (0, 1), flags, dtype)


def plan_dft_r2c_3d(n0, n1, n2, flags=ESTIMATE, dtype="float32"):
    return plan_dft_r2c((n0, n1, n2), (0, 1, 2), flags, dtype)


def plan_dft_c2r(shape: Sequence[int], axes=None, flags: int = ESTIMATE,
                 dtype="float32") -> Plan:
    """`shape` is the *logical real output* shape (FFTW convention)."""
    shape = tuple(shape)
    prob = Problem(shape=shape, axes=_axes_tuple(shape, axes), kind="c2r",
                   rdtype=_rdtype_of(dtype))
    with _lock:
        return plan_mod.make_plan(prob, flags)


def plan_dft_c2r_1d(n, flags=ESTIMATE, dtype="float32"):
    return plan_dft_c2r((n,), (0,), flags, dtype)


def plan_dft_c2r_2d(n0, n1, flags=ESTIMATE, dtype="float32"):
    return plan_dft_c2r((n0, n1), (0, 1), flags, dtype)


def plan_dft_c2r_3d(n0, n1, n2, flags=ESTIMATE, dtype="float32"):
    return plan_dft_c2r((n0, n1, n2), (0, 1, 2), flags, dtype)


def plan_r2r(shape: Sequence[int], kinds: Sequence[Union[Kind, str]],
             axes=None, flags: int = ESTIMATE, dtype="float32") -> Plan:
    shape = tuple(shape)
    axes = _axes_tuple(shape, axes)
    ks = tuple(K.kind_from_name(k)        # Kind | name | fftw3.h enum int
               for k in (kinds if isinstance(kinds, (list, tuple))
                         else [kinds] * len(axes)))
    prob = Problem(shape=shape, axes=axes, kind="r2r", r2r_kinds=ks,
                   rdtype=_rdtype_of(dtype))
    with _lock:
        return plan_mod.make_plan(prob, flags)


def plan_r2r_1d(n: int, kind: Union[Kind, str], flags: int = ESTIMATE,
                dtype="float32") -> Plan:
    return plan_r2r((n,), [kind], (0,), flags, dtype)


def plan_r2r_2d(n0: int, n1: int, kind0, kind1, flags: int = ESTIMATE,
                dtype="float32") -> Plan:
    return plan_r2r((n0, n1), [kind0, kind1], (0, 1), flags, dtype)


def plan_r2r_3d(n0: int, n1: int, n2: int, kind0, kind1, kind2,
                flags: int = ESTIMATE, dtype="float32") -> Plan:
    return plan_r2r((n0, n1, n2), [kind0, kind1, kind2], (0, 1, 2), flags,
                    dtype)


def plan_guru_dft(dims: Sequence[int], howmany_dims: Sequence[int] = (),
                  sign: int = FORWARD, flags: int = ESTIMATE,
                  dtype="complex64") -> Plan:
    """Guru interface (fftw_api.c:1172-1533): `dims` are transform extents,
    `howmany_dims` are vector/batch extents (leading).  Strides are logical
    (row-major); arbitrary memory layouts are expressed by the caller via
    reshapes/transposes of the JAX array, which XLA fuses."""
    shape = tuple(howmany_dims) + tuple(dims)
    axes = tuple(range(len(howmany_dims), len(shape)))
    return plan_dft(shape, axes, sign, flags, dtype)


def execute(plan: Plan, x) -> jnp.ndarray:
    """fftw_execute analog (new-array execute: arrays are arguments)."""
    return plan.execute(x)


def flops(plan: Plan) -> Tuple[float, float, float]:
    return plan.flops()


def cost(plan: Plan) -> float:
    return plan.cost()


def print_plan(plan: Plan) -> None:
    plan.print_plan()


def fprint_plan(plan: Plan, file) -> None:
    """fftw_fprint_plan analog: write the plan tree to a file object."""
    print(repr(plan), file=file)


def sprint_plan(plan: Plan) -> str:
    return repr(plan)


def set_timelimit(t: Optional[float]) -> None:
    """Bound MEASURE-mode planning time in seconds (fftw_set_timelimit)."""
    planner_mod.the_planner.timelimit = None if t is None or t < 0 else t


# -- wisdom (fftw_api.c:895-1171) -------------------------------------------

def export_wisdom_to_string() -> str:
    return planner_mod.the_planner.export_wisdom()


def import_wisdom_from_string(s: str) -> bool:
    return planner_mod.the_planner.import_wisdom(s)


def export_wisdom_to_filename(path: str) -> bool:
    try:
        with open(path, "w") as f:
            f.write(export_wisdom_to_string())
        return True
    except OSError:
        return False


def import_wisdom_from_filename(path: str) -> bool:
    try:
        with open(path) as f:
            return import_wisdom_from_string(f.read())
    except OSError:
        return False


def export_wisdom(write_char) -> None:
    """fftw_export_wisdom analog (the write-callback form): calls
    ``write_char`` with the serialized wisdom (whole string — the
    per-character C protocol is an implementation detail)."""
    write_char(export_wisdom_to_string())


def import_wisdom(read_char) -> bool:
    """fftw_import_wisdom analog (the read-callback form): ``read_char``
    returns the serialized wisdom string."""
    return import_wisdom_from_string(read_char())


def import_system_wisdom() -> bool:
    """fftw_import_system_wisdom analog (fftw_api.c:895-917): load wisdom
    from $FFTW3_TPU_SYSTEM_WISDOM or /etc/fftw3_tpu/wisdom.json."""
    import os
    path = os.environ.get("FFTW3_TPU_SYSTEM_WISDOM",
                          "/etc/fftw3_tpu/wisdom.json")
    return import_wisdom_from_filename(path)


def estimate_cost(shape: Sequence[int], axes=None, kind: str = "c2c",
                  dtype="complex64", r2r_kinds: Sequence = ()) -> float:
    """fftw_estimate_cost analog: the planner's ESTIMATE-mode cost (seconds
    per full transform, heuristic) without building the plan's closures."""
    shape = tuple(shape)
    axes = _axes_tuple(shape, axes)
    pl = planner_mod.the_planner
    rd = np.dtype(_rdtype_of(dtype))
    pat = K.PATIENCE_ESTIMATE
    total = 0.0
    for i, a in enumerate(axes):
        n = shape[a]
        if kind == "r2r":
            k = r2r_kinds[i] if i < len(r2r_kinds) else Kind.R2HC
            k = K.kind_from_name(k)
            total += pl._cost("r2r", pl.plan_r2r(k, n, rd, pat))
        elif kind in ("r2c", "c2r") and a == axes[-1]:
            desc = (pl.plan_r2c if kind == "r2c" else pl.plan_c2r)(n, rd, pat)
            total += pl._cost(kind, desc)
        else:
            total += pl._cost("c2c", pl.plan_c2c(n, rd, pat))
    batch = 1
    for i, s in enumerate(shape):
        if i not in axes:
            batch *= s
    return total * batch


def forget_wisdom() -> None:
    planner_mod.the_planner.forget_wisdom()
    _cached_plan.cache_clear()


def cleanup() -> None:
    """fftw_cleanup analog: drop all cached plans and wisdom."""
    forget_wisdom()


# ---------------------------------------------------------------------------
# numpy-style functional API (plan-cached)
# ---------------------------------------------------------------------------

#: planning patience of the numpy/scipy functional surface.  FFTW's
#: functional users get ESTIMATE by default; set_functional_flags(MEASURE)
#: lets fft()/dct()/... plans go through device timing (the knob the
#: round-1 review flagged as missing).
_functional_flags: int = ESTIMATE


def set_functional_flags(flags: int) -> None:
    """Set the planner flags used by the numpy-style functional API
    (fft, rfftn, dct, ...).  Existing cached plans are dropped so they
    re-plan at the new patience."""
    global _functional_flags
    _functional_flags = int(flags)
    _cached_plan.cache_clear()


def get_functional_flags() -> int:
    return _functional_flags


@lru_cache(maxsize=512)
def _cached_plan(kind: str, shape: Tuple[int, ...], axes: Tuple[int, ...],
                 sign: int, dtype_name: str, r2r_kinds: Tuple[str, ...] = (),
                 flags: Optional[int] = None) -> Plan:
    if flags is None:
        flags = _functional_flags
    if kind == "c2c":
        return plan_dft(shape, axes, sign, flags, dtype_name)
    if kind == "r2c":
        return plan_dft_r2c(shape, axes, flags, dtype_name)
    if kind == "c2r":
        return plan_dft_c2r(shape, axes, flags, dtype_name)
    return plan_r2r(shape, list(r2r_kinds), axes, flags, dtype_name)


def _norm_scale(norm: Optional[str], n: int, forward: bool) -> float:
    if norm in (None, "backward"):
        return 1.0 if forward else 1.0 / n
    if norm == "ortho":
        return 1.0 / np.sqrt(n)
    if norm == "forward":
        return 1.0 / n if forward else 1.0
    raise ValueError(f"bad norm {norm!r}")


def _as_complex(x):
    x = jnp.asarray(x)
    if not jnp.issubdtype(x.dtype, jnp.complexfloating):
        x = x.astype(jnp.complex128 if x.dtype == jnp.float64
                     else jnp.complex64)
    return x


def _c2c(x, axes, sign, norm, forward):
    x = _as_complex(x)
    axes = _axes_tuple(x.shape, axes)
    p = _cached_plan("c2c", tuple(x.shape), axes, sign, str(x.dtype))
    y = p.apply(x)
    n = int(np.prod([x.shape[a] for a in axes]))
    s = _norm_scale(norm, n, forward)
    return y if s == 1.0 else y * jnp.asarray(s, dtype=y.dtype)


def fft(x, n=None, axis=-1, norm=None):
    x = _fit_length(jnp.asarray(x), n, axis)
    return _c2c(x, (axis,), FORWARD, norm, True)


def ifft(x, n=None, axis=-1, norm=None):
    x = _fit_length(jnp.asarray(x), n, axis)
    return _c2c(x, (axis,), BACKWARD, norm, False)


def _fit_shape(x, s, axes):
    """numpy's `s=` semantics: crop/zero-pad each axis to s[i]."""
    if s is None:
        return x, axes
    if axes is None:
        axes = tuple(range(x.ndim - len(s), x.ndim))
    axes = _axes_tuple(x.shape, axes)
    for a, n in zip(axes, s):
        x = _fit_length(x, n, a)
    return x, axes


def fft2(x, s=None, axes=(-2, -1), norm=None):
    x, axes = _fit_shape(jnp.asarray(x), s, axes)
    return _c2c(x, axes, FORWARD, norm, True)


def ifft2(x, s=None, axes=(-2, -1), norm=None):
    x, axes = _fit_shape(jnp.asarray(x), s, axes)
    return _c2c(x, axes, BACKWARD, norm, False)


def fftn(x, s=None, axes=None, norm=None):
    x, axes = _fit_shape(jnp.asarray(x), s, axes)
    return _c2c(x, axes, FORWARD, norm, True)


def ifftn(x, s=None, axes=None, norm=None):
    x, axes = _fit_shape(jnp.asarray(x), s, axes)
    return _c2c(x, axes, BACKWARD, norm, False)


def rfft(x, n=None, axis=-1, norm=None):
    x = _fit_length(jnp.asarray(x), n, axis)
    return rfftn(x, axes=(axis,), norm=norm)


def rfftn(x, s=None, axes=None, norm=None):
    x, axes = _fit_shape(jnp.asarray(x), s, axes)
    return _rfftn_core(x, axes, norm)


def _rfftn_core(x, axes=None, norm=None):
    x = jnp.asarray(x)
    if jnp.issubdtype(x.dtype, jnp.complexfloating):
        raise TypeError("rfft requires real input")
    if x.dtype not in (jnp.float32, jnp.float64):
        x = x.astype(jnp.float32)
    axes = _axes_tuple(x.shape, axes)
    p = _cached_plan("r2c", tuple(x.shape), axes, FORWARD, str(x.dtype))
    y = p.apply(x)
    n = int(np.prod([x.shape[a] for a in axes]))
    s = _norm_scale(norm, n, True)
    return y if s == 1.0 else y * jnp.asarray(s, dtype=y.dtype)


def rfft2(x, s=None, axes=(-2, -1), norm=None):
    return rfftn(x, s, axes, norm)


def irfft(x, n=None, axis=-1, norm=None):
    return irfftn(x, s=None if n is None else (n,), axes=(axis,), norm=norm)


def irfftn(x, s=None, axes=None, norm=None):
    x = _as_complex(x)
    axes = _axes_tuple(x.shape, axes)
    if s is None:
        last = axes[-1]
        s = [x.shape[a] for a in axes]
        s[-1] = 2 * (x.shape[last] - 1)
    s = tuple(s)
    shape = list(x.shape)
    for a, dim in zip(axes, s):
        shape[a] = dim
    rdt = "float64" if x.dtype == jnp.complex128 else "float32"
    p = _cached_plan("c2r", tuple(shape), axes, BACKWARD, rdt)
    y = p.apply(x)
    n = int(np.prod(s))
    sc = _norm_scale(norm, n, False)
    return y if sc == 1.0 else y * jnp.asarray(sc, dtype=y.dtype)


def irfft2(x, s=None, axes=(-2, -1), norm=None):
    return irfftn(x, s, axes, norm)


_DCT_KINDS = {1: Kind.REDFT00, 2: Kind.REDFT10, 3: Kind.REDFT01,
              4: Kind.REDFT11}
_DST_KINDS = {1: Kind.RODFT00, 2: Kind.RODFT10, 3: Kind.RODFT01,
              4: Kind.RODFT11}
_IDCT_TYPE = {1: 1, 2: 3, 3: 2, 4: 4}


def _r2r_1axis(x, kind: Kind, axis, norm, logical_n):
    x = jnp.asarray(x)
    if x.dtype not in (jnp.float32, jnp.float64):
        x = x.astype(jnp.float32)
    axis = axis % x.ndim
    p = _cached_plan("r2r", tuple(x.shape), (axis,), FORWARD, str(x.dtype),
                     (kind.value,))
    return p.apply(x)


def dct(x, type: int = 2, axis: int = -1, norm=None):
    """scipy-compatible DCT (norm=None == FFTW unnormalized convention;
    "ortho"/"forward" delegate to the scipy-norm layer)."""
    if norm is not None:
        from .interfaces import scipy_fft
        return scipy_fft.dct(x, type, None, axis, norm)
    return _r2r_1axis(x, _DCT_KINDS[type], axis, None, None)


def idct(x, type: int = 2, axis: int = -1, norm=None):
    """With norm=None, the unnormalized inverse: idct(dct(x)) == 2*n*x
    (FFTW semantics); "ortho" is the scipy orthonormal inverse."""
    if norm is not None:
        from .interfaces import scipy_fft
        return scipy_fft.idct(x, type, None, axis, norm)
    return dct(x, _IDCT_TYPE[type], axis, None)


def dst(x, type: int = 2, axis: int = -1, norm=None):
    if norm is not None:
        from .interfaces import scipy_fft
        return scipy_fft.dst(x, type, None, axis, norm)
    return _r2r_1axis(x, _DST_KINDS[type], axis, None, None)


def idst(x, type: int = 2, axis: int = -1, norm=None):
    if norm is not None:
        from .interfaces import scipy_fft
        return scipy_fft.idst(x, type, None, axis, norm)
    return dst(x, _IDCT_TYPE[type], axis, None)


def dht(x, axis: int = -1):
    """Discrete Hartley transform (FFTW_DHT), self-inverse up to n."""
    return _r2r_1axis(x, Kind.DHT, axis, None, None)


def _fit_length(x, n, axis):
    if n is None:
        return x
    axis = axis % x.ndim
    cur = x.shape[axis]
    if n == cur:
        return x
    if n < cur:
        sl = [slice(None)] * x.ndim
        sl[axis] = slice(0, n)
        return x[tuple(sl)]
    pad = [(0, 0)] * x.ndim
    pad[axis] = (0, n - cur)
    return jnp.pad(x, pad)


# re-exported helpers
fftfreq = jnp.fft.fftfreq
rfftfreq = jnp.fft.rfftfreq
fftshift = jnp.fft.fftshift
ifftshift = jnp.fft.ifftshift


# ---------------------------------------------------------------------------
# source-compatibility shims (fftw3.h odds and ends)
# ---------------------------------------------------------------------------

#: fftw_version / fftw_cc / fftw_codelet_optim analogs (fftw3.h exports
#: these as global strings; tools print them)
version = "fftw3_tpu-2.0 (FFTW-3.3.8 capability surface, JAX/XLA)"
cc = "jax/XLA + g++ host tier"
codelet_optim = "split-complex Stockham matrix-product stages"


def alloc_real(n: int, dtype="float32") -> np.ndarray:
    """fftw_alloc_real analog: a zeroed real buffer.  Alignment is XLA's
    concern (fftw_malloc's SIMD-alignment role has no analog for
    logical arrays); provided for source compatibility."""
    return np.zeros(int(n), dtype=np.dtype(dtype))


def alloc_complex(n: int, dtype="complex64") -> np.ndarray:
    """fftw_alloc_complex analog (see alloc_real)."""
    return np.zeros(int(n), dtype=np.dtype(dtype))


def alignment_of(x) -> int:
    """fftw_alignment_of analog: always 0 — every logical array is
    'aligned'; plans never specialize on alignment."""
    return 0


def malloc(n: int) -> np.ndarray:
    """fftw_malloc analog: a zeroed byte buffer.  SIMD alignment is
    meaningless for logical arrays (XLA owns device layout);
    provided for source compatibility (fftw3.h declares fftw_malloc
    beside the typed alloc_real/alloc_complex)."""
    return np.zeros(int(n), dtype=np.uint8)


def free(x) -> None:
    """fftw_free analog: a no-op — the Python GC / XLA own every buffer.
    Accepts anything alloc_real/alloc_complex/malloc returned."""


def destroy_plan(plan) -> None:
    """fftw_destroy_plan analog: a no-op — plans are garbage-collected
    (plan lifecycle, fftw_api.c mkapiplan/destroy role).  Dropping the
    caller's reference is the 'destroy'; cached wisdom is
    owned by the planner, not the plan (use forget_wisdom/cleanup)."""


def export_wisdom_to_file(f) -> bool:
    """fftw_export_wisdom_to_file analog: write wisdom to an open
    file OBJECT (the FILE* form; the _to_filename variant opens a
    path)."""
    try:
        f.write(export_wisdom_to_string())
        return True
    except (OSError, AttributeError):
        return False


def import_wisdom_from_file(f) -> bool:
    """fftw_import_wisdom_from_file analog: read wisdom from an open
    file object."""
    try:
        return import_wisdom_from_string(f.read())
    except (OSError, AttributeError):
        return False
