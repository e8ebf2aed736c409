"""fftw3-mpi.h-named convenience surface over the distributed tier.

The reference exports dimension-suffixed and "many" planner entry points
(``fftw/mpi/fftw3-mpi.h`` XM() list: plan_dft_2d/3d, plan_dft_r2c_2d/3d,
plan_dft_c2r_2d/3d, plan_r2r_2d/3d, plan_many_dft{,_r2c,_c2r},
plan_many_r2r, plan_many_transpose, ddim, cleanup).  These are thin
delegations onto the shard_map planners in ``dist.py`` — the JAX
semantics (mesh + axis_name instead of an MPI communicator) are
documented there.

The "many" family follows FFTW's convention (``fftw/mpi/api.c:248-510``):
``howmany`` is a contiguous vector length carried along every
transformed point (a trailing non-transform axis here).
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

from .. import kinds as K
from . import dist as D


class ddim(NamedTuple):
    """fftw_mpi_ddim analog (fftw3-mpi.h): a distributed dimension with
    input/output block sizes."""
    n: int
    ib: int
    ob: int


#: fftw_mpi_cleanup analog.
cleanup = D.mpi_cleanup

#: generic-rank fftw3-mpi.h names -> the dist planners (communicator ->
#: mesh + axis_name; see dist.py docstrings)
plan_dft = D.plan_dft_dist
plan_dft_1d = D.plan_dft_1d_dist
plan_dft_r2c = D.plan_dft_r2c_dist
plan_dft_c2r = D.plan_dft_c2r_dist
plan_r2r = D.plan_r2r_dist


def plan_dft_2d(n0: int, n1: int, mesh, axis_name: str = "x",
                sign: int = K.FORWARD, flags: int = K.ESTIMATE, **kw):
    return D.plan_dft_dist((n0, n1), mesh, axis_name, sign=sign,
                           flags=flags, **kw)


def plan_dft_3d(n0: int, n1: int, n2: int, mesh, axis_name: str = "x",
                sign: int = K.FORWARD, flags: int = K.ESTIMATE, **kw):
    return D.plan_dft_dist((n0, n1, n2), mesh, axis_name, sign=sign,
                           flags=flags, **kw)


def plan_dft_r2c_2d(n0: int, n1: int, mesh, axis_name: str = "x",
                    flags: int = K.ESTIMATE, **kw):
    return D.plan_dft_r2c_dist((n0, n1), mesh, axis_name, flags=flags, **kw)


def plan_dft_r2c_3d(n0: int, n1: int, n2: int, mesh, axis_name: str = "x",
                    flags: int = K.ESTIMATE, **kw):
    return D.plan_dft_r2c_dist((n0, n1, n2), mesh, axis_name, flags=flags,
                               **kw)


def plan_dft_c2r_2d(n0: int, n1: int, mesh, axis_name: str = "x",
                    flags: int = K.ESTIMATE, **kw):
    return D.plan_dft_c2r_dist((n0, n1), mesh, axis_name, flags=flags, **kw)


def plan_dft_c2r_3d(n0: int, n1: int, n2: int, mesh, axis_name: str = "x",
                    flags: int = K.ESTIMATE, **kw):
    return D.plan_dft_c2r_dist((n0, n1, n2), mesh, axis_name, flags=flags,
                               **kw)


def plan_r2r_2d(n0: int, n1: int, kind0, kind1, mesh, axis_name: str = "x",
                flags: int = K.ESTIMATE, **kw):
    return D.plan_r2r_dist((n0, n1), [kind0, kind1], mesh, axis_name,
                           flags=flags, **kw)


def plan_r2r_3d(n0: int, n1: int, n2: int, kind0, kind1, kind2, mesh,
                axis_name: str = "x", flags: int = K.ESTIMATE, **kw):
    return D.plan_r2r_dist((n0, n1, n2), [kind0, kind1, kind2], mesh,
                           axis_name, flags=flags, **kw)


def _many_shape(n: Sequence[int], howmany: int):
    n = tuple(int(v) for v in n)
    if howmany < 1:
        raise ValueError("howmany must be >= 1")
    shape = n + ((howmany,) if howmany > 1 else ())
    axes = tuple(range(len(n)))
    return shape, axes


def plan_many_dft(n: Sequence[int], howmany: int, mesh,
                  axis_name: str = "x", block0: Optional[int] = None,
                  block1: Optional[int] = None, sign: int = K.FORWARD,
                  flags: int = K.ESTIMATE, **kw):
    """fftw_mpi_plan_many_dft analog: ``howmany`` interleaved transforms
    (a trailing vector axis, never sharded, FFTW's tuple layout)."""
    shape, axes = _many_shape(n, howmany)
    return D.plan_dft_dist(shape, mesh, axis_name, axes=axes, sign=sign,
                           flags=flags, block0=block0, block1=block1, **kw)


def plan_many_dft_r2c(n: Sequence[int], howmany: int, mesh,
                      axis_name: str = "x", flags: int = K.ESTIMATE, **kw):
    shape, axes = _many_shape(n, howmany)
    return D.plan_dft_r2c_dist(shape, mesh, axis_name, axes=axes,
                               flags=flags, **kw)


def plan_many_dft_c2r(n: Sequence[int], howmany: int, mesh,
                      axis_name: str = "x", flags: int = K.ESTIMATE, **kw):
    shape, axes = _many_shape(n, howmany)
    return D.plan_dft_c2r_dist(shape, mesh, axis_name, axes=axes,
                               flags=flags, **kw)


def plan_many_r2r(n: Sequence[int], howmany: int, kinds, mesh,
                  axis_name: str = "x", flags: int = K.ESTIMATE, **kw):
    shape, axes = _many_shape(n, howmany)
    return D.plan_r2r_dist(shape, list(kinds), mesh, axis_name, axes=axes,
                           flags=flags, **kw)


def plan_many_transpose(n0: int, n1: int, howmany: int, mesh,
                        axis_name: str = "x", **kw):
    return D.plan_transpose(n0, n1, mesh, axis_name, howmany=howmany, **kw)
