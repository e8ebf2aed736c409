"""SMP-threads API (``fftw/threads/api.c`` analog).

FFTW's threads layer (reference ``fftw/threads/``, SURVEY.md §2.8) adds a
worker pool plus solvers that shard loop ranges across threads.  Here the
worker pool is the host's set of locally-attached devices:
``plan_with_nthreads(k)`` makes every subsequently created plan execute
over a k-device mesh (see :mod:`fftw3_tpu.parallel.smp` — vector loops
shard with zero collectives, all-axes rank>=2 problems run the slab
solvers, rank-1 the six-step).  Within ONE chip, parallelism is owned by
XLA (kernel grids, vectorized batching), so ``nthreads`` counts devices,
not threads; with a single device plans stay serial, exactly like FFTW
with one worker.  The hint also feeds the distributed planners'
``overlap_chunks`` pipeline depth (parallel/dist.py).

``make_planner_thread_safe`` is real: the planner mutates shared wisdom, so
plan creation takes a lock (the public API already serializes through
``api._lock``; this upgrades it to an RLock explicitly).
"""
from __future__ import annotations

import threading as _threading

_nthreads: int = 1
_initialized: bool = False


def init_threads() -> int:
    """fftw_init_threads analog (threads/api.c:38-56).  Always succeeds."""
    global _initialized
    _initialized = True
    return 1


def plan_with_nthreads(n: int) -> None:
    """fftw_plan_with_nthreads analog (threads/api.c:69-80): subsequent
    plans execute over min(n, local device count) devices — see
    parallel/smp.py for how each problem class splits.  n=1 restores
    serial planning."""
    global _nthreads
    if n < 1:
        raise ValueError("nthreads must be >= 1")
    _nthreads = int(n)


def planner_nthreads() -> int:
    """fftw_planner_nthreads analog."""
    return _nthreads


def make_planner_thread_safe() -> None:
    """fftw_make_planner_thread_safe analog (threads/api.c:82-85).
    Planning is already serialized by the API lock; kept for parity."""
    from . import api
    if not isinstance(api._lock, type(_threading.RLock())):
        api._lock = _threading.RLock()


def cleanup_threads() -> None:
    """fftw_cleanup_threads analog."""
    global _nthreads, _initialized
    _nthreads = 1
    _initialized = False
