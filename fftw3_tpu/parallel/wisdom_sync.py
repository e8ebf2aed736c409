"""Multi-host wisdom synchronization (fftw_mpi_gather/broadcast_wisdom,
reference ``fftw/mpi/wisdom-api.c:44-110``).

FFTW keeps planner state consistent across ranks with an MPI tree-gather and
broadcast.  In JAX the analog runs once per *process* (host): host 0 plans
(or aggregates), every host imports the same wisdom, so the deterministic
planner produces identical plans everywhere — the property FFTW enforces
with per-plan wisdom votes (``mpi/api.c:60-130``).

Single-process: both functions are no-ops (return the local state).
"""
from __future__ import annotations

import json

import numpy as np

from .. import api


def _bcast_bytes(data: bytes) -> bytes:
    import jax
    from jax.experimental import multihost_utils as mhu

    # two-phase: broadcast length, then a padded payload
    n = np.asarray([len(data)], np.int64)
    n = int(mhu.broadcast_one_to_all(n)[0])
    buf = np.zeros(n, np.uint8)
    local = np.frombuffer(data[:n], np.uint8)
    buf[:len(local)] = local
    return bytes(mhu.broadcast_one_to_all(buf).tobytes())


def broadcast_wisdom() -> None:
    """Host 0's wisdom replaces every host's (fftw_mpi_broadcast_wisdom)."""
    import jax
    if jax.process_count() == 1:
        return
    payload = api.export_wisdom_to_string().encode() \
        if jax.process_index() == 0 else b""
    data = _bcast_bytes(payload)
    api.import_wisdom_from_string(data.decode())


def gather_wisdom() -> None:
    """Every host's wisdom is merged into every host (symmetric version of
    fftw_mpi_gather_wisdom; an allgather is the natural mesh collective —
    host 0 holding the union is the FFTW post-state, and here all do)."""
    import jax
    from jax.experimental import multihost_utils as mhu
    if jax.process_count() == 1:
        return
    mine = api.export_wisdom_to_string().encode()
    n = np.asarray([len(mine)], np.int64)
    lens = np.asarray(mhu.process_allgather(n)).reshape(-1)
    cap = int(lens.max())
    buf = np.zeros(cap, np.uint8)
    buf[:len(mine)] = np.frombuffer(mine, np.uint8)
    allbuf = np.asarray(mhu.process_allgather(buf))
    for i, ln in enumerate(lens):
        s = bytes(allbuf[i][:int(ln)].tobytes()).decode()
        api.import_wisdom_from_string(s)
