"""Problem and Plan ADTs.

The analogs of FFTW's ``problem``/``plan`` abstract data types
(reference ``fftw/fftw_api.h:599-692``).  A :class:`Problem` is a logical
transform spec (shape, axes, kinds, precision) — strides and vector ranks are
expressed by the array shape itself, since JAX arrays are logical values.
A :class:`Plan` is an immutable, jittable pure function plus introspection
(op counts, printable tree), built from planner descriptors.

Multidimensional transforms compose 1-D axis passes exactly like FFTW's
rank-geq2 solvers (fftw/fftw_api.c:4436-4570): XLA fuses the interleaving
transposes, so "apply along axis" is a moveaxis + batched last-axis transform.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from . import kinds as K
from . import planner as planner_mod
from .ops import c2c as c2c_ops
from .ops import r2r as r2r_ops
from .ops import real as real_ops


def _along_axis(fn: Callable, axis: int) -> Callable:
    """Lift a last-axis transform to an arbitrary axis."""
    def apply(x):
        if axis in (-1, x.ndim - 1):
            return fn(x)
        y = jnp.moveaxis(x, axis, -1)
        y = fn(y)
        return jnp.moveaxis(y, -1, axis)
    return apply


def _c2c_stage(desc: Dict, sign: int, rdtype, axis: int,
               shape: Tuple[int, ...]) -> Callable:
    """One c2c axis pass: the last-axis transform lifted with moveaxis.

    Axes are applied right-relative so extra *leading* batch dims at call
    time Just Work (plans embed in larger jitted programs)."""
    fn = c2c_ops.build_c2c_split(desc, sign, rdtype)
    return _along_axis_split(fn, axis - len(shape))


def _complex_of_split(split_fn: Callable) -> Callable:
    """Lift a split-complex stage to a complex-array stage (the split and
    recombine fuse into the neighboring XLA ops)."""
    def apply(x):
        yr, yi = split_fn(jnp.real(x), jnp.imag(x))
        return yr + 1j * yi
    return apply


def _along_axis_split(fn: Callable, axis: int) -> Callable:
    """Lift a split-complex last-axis transform to an arbitrary axis."""
    def apply(xr, xi):
        if axis in (-1, xr.ndim - 1):
            return fn(xr, xi)
        yr, yi = fn(jnp.moveaxis(xr, axis, -1), jnp.moveaxis(xi, axis, -1))
        return jnp.moveaxis(yr, -1, axis), jnp.moveaxis(yi, -1, axis)
    return apply


@dataclass(frozen=True)
class Problem:
    """Logical transform specification (problem ADT analog)."""
    shape: Tuple[int, ...]
    axes: Tuple[int, ...]
    kind: str                      # 'c2c' | 'r2c' | 'c2r' | 'r2r'
    sign: int = K.FORWARD          # c2c only
    r2r_kinds: Tuple[K.Kind, ...] = ()   # per-axis, r2r only
    rdtype: str = "float32"        # base real precision

    def __post_init__(self):
        ax = tuple(a % len(self.shape) for a in self.axes)
        object.__setattr__(self, "axes", ax)
        if self.kind == "r2r" and len(self.r2r_kinds) != len(ax):
            raise ValueError("need one r2r kind per transform axis")

    @property
    def transform_sizes(self) -> Tuple[int, ...]:
        return tuple(self.shape[a] for a in self.axes)

    def tag(self) -> str:
        bits = [self.kind, "x".join(map(str, self.shape)),
                ",".join(map(str, self.axes)), str(self.sign), self.rdtype]
        if self.kind == "r2r":
            bits.append("+".join(k.value for k in self.r2r_kinds))
        return ":".join(bits)


class Plan:
    """Executable plan: immutable pytree of composed axis transforms."""

    def __init__(self, problem: Problem, descriptors: Dict[int, Dict],
                 apply_fn: Callable, in_shape: Tuple[int, ...],
                 out_shape: Tuple[int, ...], out_dtype,
                 apply_split: Optional[Callable] = None):
        self.problem = problem
        self.descriptors = descriptors          # axis -> planner descriptor
        self._apply = apply_fn
        self.in_shape = in_shape
        self.out_shape = out_shape
        self.out_dtype = out_dtype
        #: split-complex entry point (c2c only): (xr, xi) -> (yr, yi),
        #: with no complex array at the program boundary.
        self.apply_split = apply_split
        self._jitted = jax.jit(apply_fn)
        #: multi-device execute path (the fftw/threads engine analog),
        #: attached by make_plan when plan_with_nthreads(k>1) is active —
        #: see parallel/smp.py.  apply/apply_split stay serial-pure.
        self._par_fn: Optional[Callable] = None

    # -- execution (fftw_execute + new-array execute, fftw_api.c:428-487) --
    def __call__(self, x) -> jnp.ndarray:
        return self.execute(x)

    def execute(self, x) -> jnp.ndarray:
        x = jnp.asarray(x)
        if tuple(x.shape) != self.in_shape:
            raise ValueError(
                f"plan expects shape {self.in_shape}, got {x.shape}")
        if self._par_fn is not None:
            return self._par_fn(x)
        return self._jitted(x)

    @property
    def apply(self) -> Callable:
        """The raw (unjitted) pure function, for embedding in larger jits."""
        return self._apply

    # -- introspection (fftw_flops/fftw_cost, fftw_api.c:489-509) ----------
    def flops(self) -> Tuple[float, float, float]:
        """(add, mul, fma) counts for one full execution."""
        total = {"add": 0.0, "mul": 0.0, "fma": 0.0}
        shape = list(self.problem.shape)
        for axis, desc in self.descriptors.items():
            n = shape[axis]
            batch = int(np.prod(shape)) // max(n, 1)
            ops = _opcount_of(self.problem, axis, desc)
            for k in total:
                total[k] += batch * ops[k]
        return (total["add"], total["mul"], total["fma"])

    def cost(self) -> float:
        a, m, f = self.flops()
        return a + m + 2 * f

    def __repr__(self) -> str:
        inner = " ".join(
            f"[axis {a}: {planner_mod.sprint_desc(d)}]"
            for a, d in sorted(self.descriptors.items()))
        return (f"(plan {self.problem.kind} {self.problem.shape} "
                f"axes={self.problem.axes} {inner})")

    def print_plan(self) -> None:
        print(repr(self))


def _opcount_of(problem: Problem, axis: int, desc: Dict) -> Dict[str, float]:
    if problem.kind == "c2c":
        return c2c_ops.c2c_opcount(desc)
    if problem.kind == "r2c":
        if axis == problem.axes[-1]:
            return real_ops.r2c_opcount(desc)
        return c2c_ops.c2c_opcount(desc)
    if problem.kind == "c2r":
        if axis == problem.axes[-1]:
            return real_ops.c2r_opcount(desc)
        return c2c_ops.c2c_opcount(desc)
    return r2r_ops.r2r_opcount(desc)


# ---------------------------------------------------------------------------
# plan construction (fftw_mkapiplan analog, fftw/fftw_api.c:265-423)
# ---------------------------------------------------------------------------

def make_plan(problem: Problem, flags: int = K.ESTIMATE,
              planner: Optional[planner_mod.Planner] = None) -> Plan:
    pl = planner or planner_mod.the_planner
    patience = K.patience_of_flags(flags)
    if flags & K.WISDOM_ONLY:
        # FFTW_WISDOM_ONLY: plan only from existing wisdom, else fail
        # (fftw3.h:487; the reference planner returns NULL).  Serialized
        # by the api lock, so the temporary mode flag is safe.
        pl.wisdom_only = True
        try:
            plan = _make_plan_inner(problem, flags, pl, patience)
        finally:
            pl.wisdom_only = False
    else:
        plan = _make_plan_inner(problem, flags, pl, patience)
    from . import threads
    if threads.planner_nthreads() > 1:
        # fftw_plan_with_nthreads engine (parallel/smp.py): plans created
        # under an nthreads hint execute over a local device mesh
        from .parallel import smp
        plan._par_fn = smp.parallel_executor(plan)
    return plan


def _make_plan_inner(problem: Problem, flags: int,
                     pl: planner_mod.Planner, patience: int) -> Plan:
    rdtype = np.dtype(problem.rdtype)
    ctype = c2c_ops.complex_dtype(rdtype)
    shape = problem.shape
    axes = problem.axes

    descriptors: Dict[int, Dict] = {}
    stages = []  # callables composed left-to-right
    in_shape = shape
    npoints = int(np.prod(shape)) if shape else 1

    def _vec(a):
        # vector size seen by the axis-a pass: everything except axis a
        return max(1, npoints // max(shape[a], 1))

    if problem.kind == "c2c":
        # split-complex through the whole multi-axis pipeline: one
        # real/imag split at entry, one combine at exit
        split_stages = []
        for a in axes:
            desc = pl.plan_c2c(shape[a], rdtype, patience, batch=_vec(a))
            descriptors[a] = desc
            split_stages.append(
                _c2c_stage(desc, problem.sign, rdtype, a, shape))

        def apply_split(xr, xi):
            for s in split_stages:
                xr, xi = s(xr, xi)
            return xr, xi

        def apply_c2c(x):
            yr, yi = apply_split(jnp.real(x), jnp.imag(x))
            return yr + 1j * yi

        return Plan(problem, descriptors, apply_c2c, shape, shape, ctype,
                    apply_split=apply_split)

    elif problem.kind == "r2c":
        last = axes[-1]
        n_last = shape[last]
        nd = len(shape)
        desc = pl.plan_r2c(n_last, rdtype, patience, batch=_vec(last))
        descriptors[last] = desc
        stages.append(_along_axis(real_ops.build_r2c(desc, rdtype),
                                  last - nd))
        out = list(shape)
        out[last] = n_last // 2 + 1
        # non-last axes run on the HALVED complex array
        for a in axes[:-1]:
            d = pl.plan_c2c(shape[a], rdtype, patience, batch=_vec(a))
            descriptors[a] = d
            stages.append(_complex_of_split(
                _c2c_stage(d, K.FORWARD, rdtype, a, tuple(out))))
        out_shape, out_dtype = tuple(out), ctype

    elif problem.kind == "c2r":
        # problem.shape is the *logical real* shape; input is halved complex.
        last = axes[-1]
        n_last = shape[last]
        nd = len(shape)
        ins = list(shape)
        ins[last] = n_last // 2 + 1
        # Full c2c passes on the non-last axes, never a DC/Nyquist column
        # pack: packing columns 0 and n/2 assumes they are
        # conjugate-symmetric along every non-last axis — true only for
        # Hermitian-VALID input.  Spectral-derivative workloads routinely
        # feed technically-invalid spectra (e.g. irfft2 of i*ky*W leaves
        # imaginary junk in the y-Nyquist row), and both numpy and the
        # reference (rank>=2 c2r = full c2c passes on non-last axes,
        # fftw_api.c:5552-6190) USE that content.
        for a in axes[:-1]:
            d = pl.plan_c2c(shape[a], rdtype, patience, batch=_vec(a))
            descriptors[a] = d
            stages.append(_complex_of_split(
                _c2c_stage(d, K.BACKWARD, rdtype, a, tuple(ins))))
        desc = pl.plan_c2r(n_last, rdtype, patience, batch=_vec(last))
        descriptors[last] = desc
        stages.append(_along_axis(real_ops.build_c2r(desc, rdtype),
                                  last - nd))
        in_shape = tuple(ins)
        out_shape, out_dtype = shape, rdtype

    elif problem.kind == "r2r":
        nd = len(shape)
        for a, kind in zip(axes, problem.r2r_kinds):
            desc = pl.plan_r2r(kind, shape[a], rdtype, patience,
                               batch=_vec(a))
            descriptors[a] = desc
            stages.append(_along_axis(r2r_ops.build_r2r(desc, rdtype),
                                      a - nd))
        out_shape, out_dtype = shape, rdtype

    else:
        raise ValueError(f"unknown problem kind {problem.kind!r}")

    def apply_fn(x):
        for s in stages:
            x = s(x)
        return x

    return Plan(problem, descriptors, apply_fn, in_shape, out_shape,
                out_dtype)
