"""Shared-memory parallel execution engine (the fftw/threads tier).

FFTW's threads layer is a real parallelism engine, not bookkeeping:
``fftw_plan_with_nthreads(k)`` makes subsequent plans split their loops
over k workers — the vector (howmany) loop of vrank-geq1 solvers and the
per-axis row loops of rank-geq2 solvers (reference ``fftw/threads/``:
api.c:69-80 records nthreads, the ``*-vrank-geq1.c``/``ct.c`` solvers
shard loop ranges across the worker pool; SURVEY.md §2.8).

The JAX analog of "k threads on one shared-memory node" is k
locally-attached devices on one host.  This module gives every plan
created while ``threads.planner_nthreads() > 1`` a parallel EXECUTE path
over a k-device 1-D mesh:

* **vector problems** (some dim is not a transform axis): ``shard_map``
  of the serial pure function with that dim sharded — the threaded
  howmany loop, zero collectives (threads/vrank-geq1 role);
* **all-axes rank >= 2**: the slab-decomposed distributed solvers
  (:mod:`fftw3_tpu.parallel.dist`) on the local mesh — the threaded
  per-axis row loops become local passes + one global transpose
  (threads rank-geq2 ct role);
* **all-axes rank 1**: the distributed six-step solver.

Only ``plan.execute`` (the ``fftw_execute`` analog — a host program
driving a plan) takes this path; ``plan.apply`` stays the pure unsharded
closure for embedding in user jit programs, where sharding is the user's
program-level choice.  Everything here is best-effort: if no device
split or distributed solver fits the problem, the plan stays serial —
exactly FFTW's behavior when a loop has fewer iterations than threads.
"""
from __future__ import annotations

from typing import Callable, Optional

import jax
import numpy as np
from jax.sharding import Mesh
from jax.sharding import PartitionSpec as P

from .. import kinds as K


class _NoFit(Exception):
    """No device split fits the problem — the expected serial fallback
    (FFTW's fewer-iterations-than-threads case), never logged or raised
    to the user even under ``config.debug``."""


def _local_mesh(k: int) -> Optional[Mesh]:
    devs = jax.devices()
    k = min(int(k), len(devs))
    if k < 2:
        return None
    return Mesh(np.asarray(devs[:k]), ("smp",))


def _vector_dim(in_shape, axes, k: int) -> Optional[int]:
    """Leftmost non-transform dim divisible by k (the howmany loop)."""
    for d, ext in enumerate(in_shape):
        if d not in axes and ext % k == 0 and ext >= k:
            return d
    return None


def parallel_executor(plan) -> Optional[Callable]:
    """Build a k-device execute path for ``plan``, or None to stay serial.

    Called from ``make_plan`` when the nthreads hint is > 1.  Never
    raises: any planner/solver failure (indivisible extents, prime sizes
    the six-step cannot split, unsupported kind combinations) returns
    None and the serial path stands.
    """
    from .. import config, threads

    mesh = _local_mesh(threads.planner_nthreads())
    if mesh is None:
        return None
    try:
        return _build(plan, mesh)
    except _NoFit:
        return None
    except Exception as exc:                           # noqa: BLE001
        if config.debug:
            raise
        import sys
        print(f"# smp: parallel executor fell back to serial for "
              f"{plan.problem}: {type(exc).__name__}: {str(exc)[:200]}",
              file=sys.stderr)
        return None


def _build(plan, mesh: Mesh) -> Optional[Callable]:
    prob = plan.problem
    k = mesh.shape["smp"]
    nd = len(plan.in_shape)

    # -- vector split: shard the howmany dim, zero collectives ------------
    d = _vector_dim(plan.in_shape, prob.axes, k)
    if d is not None:
        spec = P(*[("smp" if i == d else None) for i in range(nd)])
        # check_vma=False: this split is a pure batch shard (no
        # collectives), so the varying-across-mesh check is vacuous here,
        # and it would reject solver outputs that carry no vma annotation.
        inner = jax.shard_map(plan.apply, mesh=mesh,
                              in_specs=spec, out_specs=spec,
                              check_vma=False)
        return jax.jit(inner)

    # -- all axes transformed: the distributed solvers on the local mesh --
    from . import dist

    # slab shard axis: a transform axis other than the (halved/lane) last
    # one — the threaded rank-geq2 row loops become local passes + one
    # global transpose.  _NoFit (1-D-of-multi problems whose only
    # transform axis is last) is the LEGITIMATE serial fallback, distinct
    # from engine bugs which the caller logs/raises.
    def slab_axis():
        for a in prob.axes:
            if a != prob.axes[-1]:
                return a
        raise _NoFit(f"no slab axis for axes={prob.axes}")

    cdtype = "complex64" if prob.rdtype == "float32" else "complex128"
    if prob.kind == "c2c":
        if nd >= 2:
            dp = dist.plan_dft_dist(
                prob.shape, mesh, "smp", axes=prob.axes, sign=prob.sign,
                shard_axis=slab_axis(), dtype=cdtype, _skip_measure=True)
        else:
            dp = dist.plan_dft_1d_dist(prob.shape[0], mesh, "smp",
                                       sign=prob.sign, dtype=cdtype)
        return dp.apply
    if prob.kind == "r2c" and nd >= 2:
        dp = dist.plan_dft_r2c_dist(prob.shape, mesh, "smp",
                                    axes=prob.axes, shard_axis=slab_axis(),
                                    dtype=prob.rdtype)
        return dp.apply
    if prob.kind == "c2r" and nd >= 2:
        dp = dist.plan_dft_c2r_dist(prob.shape, mesh, "smp",
                                    axes=prob.axes, shard_axis=slab_axis(),
                                    dtype=prob.rdtype)
        return dp.apply
    if prob.kind == "r2r" and nd >= 2:
        dp = dist.plan_r2r_dist(prob.shape, list(prob.r2r_kinds), mesh,
                                "smp", axes=prob.axes,
                                shard_axis=slab_axis(), dtype=prob.rdtype)
        return dp.apply
    return None
