"""Device timing on the host clock (libbench2/timer.c analog).

JAX dispatches asynchronously, so every timed call ends in
``jax.block_until_ready``: the clock then covers the device work, not just
the enqueue.  Each timing warms up first (compilation and first-touch
allocation stay out of the window) and reports the MEDIAN of repeated
calls, which one slow outlier (a clock change, a neighbour on the host)
cannot move the way it moves a mean.
"""
from __future__ import annotations

import statistics
import time
from typing import Callable, List, Sequence, Tuple

import jax
import numpy as np


def sync(out) -> None:
    """Wait until every array in ``out`` has been computed."""
    jax.block_until_ready(out)


def _on_device(args: Sequence) -> Tuple:
    # numpy arguments would pay a host->device copy inside every call
    return tuple(jax.device_put(a) if isinstance(a, np.ndarray) else a
                 for a in args)


def _once(fn: Callable, args: Tuple) -> float:
    t0 = time.perf_counter()
    sync(fn(*args))
    return time.perf_counter() - t0


def time_dispatched(fn: Callable, args: Sequence, reps: int = 5,
                    warmup: int = 1) -> float:
    """Median seconds per call of ``fn(*args)``."""
    args = _on_device(args)
    for _ in range(warmup):
        _once(fn, args)
    return statistics.median(_once(fn, args) for _ in range(reps))


def time_dispatched_multi(configs: Sequence[Tuple[Callable, Sequence]],
                          reps: int = 5, warmup: int = 1) -> List[float]:
    """Median seconds per call for several ``(fn, args)`` configs, timed
    in turns (one call of each config per round), so slow drift of the
    device's clocks lands on every config alike.  Aligned with
    ``configs``."""
    prepared = [(fn, _on_device(args)) for fn, args in configs]
    for fn, args in prepared:
        for _ in range(warmup):
            _once(fn, args)
    samples: List[List[float]] = [[] for _ in prepared]
    for _ in range(reps):
        for s, (fn, args) in zip(samples, prepared):
            s.append(_once(fn, args))
    return [statistics.median(s) for s in samples]
