"""Distributed transforms over a device mesh — the fftw/mpi tier.

FFTW-MPI distributes arrays in 1-d blocks over ranks and moves data with
global transposes implemented by three interchangeable MPI solvers
(pairwise sendrecv / alltoall / recursive, reference ``fftw/mpi/transpose-*.c``,
SURVEY.md section 2.9).  Here the mesh replaces the communicator, a
``PartitionSpec`` replaces the block distribution, and the global transpose is
a *resharding*: ``lax.all_to_all`` (or a ``ppermute`` ring) inside
``shard_map``, which XLA hands to NCCL over NVLink on GPUs.  Because all_to_all delivers chunks in peer order,
the "transposed" output is simply the same logical array with a different
PartitionSpec — FFTW's ``TRANSPOSED_OUT`` trick (skip half the communication,
``mpi/dft-rank-geq2-transposed.c``) becomes free layout choice.

Solvers:

* :func:`plan_dft_dist` rank >= 2 — slab decomposition: local FFTs over
  non-sharded axes, one global transpose, FFT over the formerly sharded axis
  (``mpi/dft-rank-geq2.c`` analog), optional transposed-out.
* :func:`plan_dft_1d_dist` — the six-step distributed 1-D DFT: transpose,
  local DFT, twiddle, transpose, local DFT, transpose (``mpi/dft-rank1.c``
  analog) with FFTW's SCRAMBLED_OUT option to skip the final transpose.
* batch-sharded transforms (``dft-rank1-bigvec`` analog) need no machinery:
  a local plan under shard_map; :func:`plan_dft_dist` handles it when the
  sharded axis is not a transform axis.

Wisdom note: plans must be identical across hosts; descriptors come from the
deterministic ESTIMATE path or from broadcast wisdom (``fftw_mpi_gather/
broadcast_wisdom`` analog: host 0 plans, others import).
"""
from __future__ import annotations

from functools import partial
from typing import Callable, Dict, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding
from jax.sharding import PartitionSpec as P

from .. import kinds as K
from .. import planner as planner_mod
from ..ops import c2c as c2c_ops
from ..ops import matrices


# ---------------------------------------------------------------------------
# local_size helpers (mpi/block.c analog)
# ---------------------------------------------------------------------------

def default_block(n: int, nproc: int) -> int:
    """FFTW's default 1-d block: ceil(n/P) (mpi/block.c)."""
    return (n + nproc - 1) // nproc


def local_size_1d(n: int, nproc: int, rank: int) -> Tuple[int, int]:
    """(local_n, local_start) of `rank` under the default block."""
    b = default_block(n, nproc)
    start = min(rank * b, n)
    return min(b, n - start), start


def _transpose_a2a(x, axis_name: str, split_axis: int, concat_axis: int):
    """Global transpose via all-to-all (transpose-alltoall analog)."""
    return jax.lax.all_to_all(x, axis_name, split_axis=split_axis,
                              concat_axis=concat_axis, tiled=True)


def _transpose_ppermute(x, axis_name: str, split_axis: int, concat_axis: int):
    """Global transpose as a P-1-step ppermute ring (transpose-pairwise
    analog, mpi/transpose-pairwise.c:49-100): each step rotates blocks one
    hop; block j lands after j hops.  Same result as all_to_all; gives the
    planner a second communication schedule to time (SURVEY.md section 5,
    'communication algorithm selection is inside the autotuning loop')."""
    P_ = jax.lax.axis_size(axis_name)
    me = jax.lax.axis_index(axis_name)
    parts = jnp.stack(jnp.split(x, P_, axis=split_axis))  # chunks by dest
    acc = jnp.zeros_like(parts)
    acc = jax.lax.dynamic_update_index_in_dim(
        acc, jnp.take(parts, me, axis=0), me, axis=0)
    # P-1 rounds; in round k every rank sends exactly the chunk addressed
    # k hops ahead directly to its destination — the stall-free round-robin
    # schedule of transpose-pairwise (one send + one recv per rank per round).
    for k in range(1, P_):
        perm = [(i, (i + k) % P_) for i in range(P_)]
        send = jnp.take(parts, (me + k) % P_, axis=0)
        recv = jax.lax.ppermute(send, axis_name, perm)
        src = (me - k) % P_        # block from source s lands at position s
        acc = jax.lax.dynamic_update_index_in_dim(acc, recv, src, axis=0)
    chunks = [jnp.take(acc, i, axis=0) for i in range(P_)]
    return jnp.concatenate(chunks, axis=concat_axis)


def _transpose_recurse(x, axis_name: str, split_axis: int, concat_axis: int):
    """Global transpose by recursive halving (transpose-recurse analog,
    mpi/transpose-recurse.c): a log2(P)-step hypercube exchange.  Each step
    swaps, with partner ``me XOR 2^k``, every chunk whose destination's bit
    k differs from ours.  Moves (P/2)*log2(P) chunks total vs. P-1 for the
    pairwise ring — more volume, exponentially fewer rounds; wins in
    latency-bound regimes (huge P, small chunks).  Requires P a power of 2.
    """
    P_ = jax.lax.axis_size(axis_name)
    if P_ & (P_ - 1):
        raise ValueError("transpose-recurse needs a power-of-two mesh axis")
    me = jax.lax.axis_index(axis_name)
    parts = jnp.stack(jnp.split(x, P_, axis=split_axis))  # slot j: dst j
    slots = jnp.arange(P_)
    # Invariant after processing bit k: the chunk with (src s, dst d) sits
    # on the rank matching d in bits <= k / s above, in the slot matching s
    # in bits <= k / d above.  Each step sends the slots whose bit k
    # differs from ours and stores the received ones XOR-reindexed, so
    # after log2(P) steps slot j holds the chunk FROM source j.
    k = 0
    while (1 << k) < P_:
        bit = 1 << k
        perm = [(i, i ^ bit) for i in range(P_)]
        sel = ((slots & bit) != (me & bit))
        mshape = (P_,) + (1,) * (parts.ndim - 1)
        selb = sel.reshape(mshape)
        recv = jax.lax.ppermute(jnp.where(selb, parts, 0), axis_name, perm)
        recv_x = jnp.take(recv, slots ^ bit, axis=0)   # slot j' -> j' ^ bit
        parts = jnp.where(selb, recv_x, parts)
        k += 1
    chunks = [jnp.take(parts, i, axis=0) for i in range(P_)]
    return jnp.concatenate(chunks, axis=concat_axis)


_TRANSPOSE_IMPLS = {"all_to_all": _transpose_a2a,
                    "ppermute": _transpose_ppermute,
                    "recurse": _transpose_recurse}


def measure_transpose_method(mesh: Mesh, axis_name: str,
                             local_shape: Tuple[int, ...],
                             dtype=np.complex64,
                             methods: Sequence[str] = ("all_to_all",
                                                       "ppermute",
                                                       "recurse")) -> str:
    """Time the registered global-transpose algorithms on the actual mesh
    and return the fastest — FFTW's 'planner times all three MPI transpose
    solvers and picks per problem' (SURVEY.md §5)."""
    from ..utils import timing

    nproc = mesh.shape[axis_name]
    best, best_t = "all_to_all", float("inf")
    shape = tuple(local_shape)
    full = (shape[0] * nproc,) + shape[1:]
    spec = P(*([axis_name] + [None] * (len(shape) - 1)))
    # the timing input is created ON device inside a jit: no host copy,
    # and collective timing is value-independent anyway
    x = jax.jit(lambda: jnp.zeros(full, dtype),
                out_shardings=NamedSharding(mesh, spec))()
    for m in methods:
        impl = _TRANSPOSE_IMPLS[m]
        if m == "recurse" and nproc & (nproc - 1):
            continue
        if full[-1] % nproc:
            continue
        try:
            fn = jax.jit(jax.shard_map(
                lambda v, impl=impl: impl(v, axis_name, v.ndim - 1, 0),
                mesh=mesh, in_specs=spec,
                out_specs=P(*([None] * (len(shape) - 1) + [axis_name]))))
            t = timing.time_dispatched(fn, (x,), reps=3)
        except Exception:                              # noqa: BLE001
            continue
        if t < best_t:
            best, best_t = m, t
    return _sync_choice(best, list(methods))


def _sync_choice(choice: str, methods: Sequence[str]) -> str:
    """Multi-process meshes must agree on the plan: near-tied timings can
    rank differently per host, and divergent shard_map programs
    (all_to_all on one host, ppermute on another) hang the collective.
    Broadcast process 0's choice (the wisdom-vote idea of mpi/api.c:60-130:
    all ranks fail/choose together)."""
    if jax.process_count() == 1:
        return choice
    from jax.experimental import multihost_utils
    idx = int(multihost_utils.broadcast_one_to_all(
        np.int32(list(methods).index(choice))))
    return list(methods)[idx]


def _resolve_transpose(method: str, mesh: Mesh, axis_name: str,
                       shape, dtype, exchange_local=None):
    """Resolve a transpose algorithm name; "measure" times the registered
    algorithms on the actual mesh and picks (the reference planner times
    its three MPI transpose solvers per problem, SURVEY.md section 5).

    ``exchange_local`` is the ACTUAL local array shape at the exchange
    point, sharded dim first and the split dim last (post-r2c halving,
    six-step matrix view, ragged padding all included) — without it the
    timing falls back to a guessed slab shape."""
    if method == "measure":
        nproc = mesh.shape[axis_name]
        if exchange_local is None:
            exchange_local = (max(nproc, shape[0] // nproc),) \
                + tuple(shape[1:])
        method = measure_transpose_method(mesh, axis_name, exchange_local,
                                          dtype)
    return _TRANSPOSE_IMPLS[method]


def _measure_whole_plans(tag: str, build, params_list, in_dtype):
    """Whole-plan MEASURE for the distributed tier: time COMPLETE candidate
    DistPlans (not just the transpose collective) and memoize the winning
    parameter set in the planner's wisdom.  The reference planner times
    complete MPI plans the same way — slab layout, transpose algorithm and
    radix all compete inside one search (``fftw/mpi/conf.c:28-52``).

    All processes agree on the winner (process 0's choice is broadcast),
    mirroring the wisdom-vote hooks of ``mpi/api.c:60-130``.
    """
    from .. import planner as planner_mod
    from ..utils import timing

    pl = planner_mod.the_planner
    key = f"dist:{tag}:{planner_mod._device_signature()}"
    hit = pl.wisdom.get(key)
    if isinstance(hit, dict) and hit.get("desc") in params_list:
        pl.stats["nwisdom_hit"] += 1
        return hit["desc"]
    best_i, best_t = 0, float("inf")
    for i, prm in enumerate(params_list):
        try:
            plan = build(**prm)
            # build the timing input ON device inside a jit (no host copy)
            x = jax.jit(lambda: jnp.zeros(plan.global_shape, in_dtype),
                        out_shardings=plan.input_sharding())()
            t = timing.time_dispatched(plan.apply, (x,), reps=3)
            pl.stats["nmeasure"] += 1
        except Exception as e:                         # noqa: BLE001
            pl.stats["nmeasure_failed"] = \
                pl.stats.get("nmeasure_failed", 0) + 1
            pl.stats["last_measure_error"] = \
                f"dist {prm}: {type(e).__name__}: {e}"[:300]
            continue
        if t < best_t:
            best_i, best_t = i, t
    if jax.process_count() > 1:
        from jax.experimental import multihost_utils
        best_i = int(multihost_utils.broadcast_one_to_all(
            np.int32(best_i)))
    best = params_list[best_i]
    pl.wisdom[key] = {"desc": best, "patience": K.PATIENCE_MEASURE}
    return best


def _transpose_method_candidates(nproc: int):
    out = ["all_to_all", "ppermute"]
    if nproc & (nproc - 1) == 0:
        out.append("recurse")
    return out


def _pad_ax(x, axis, amount):
    pads = [(0, 0)] * x.ndim
    pads[axis] = (0, amount)
    return jnp.pad(x, pads)


def _crop_ax(x, axis, size):
    sl = [slice(None)] * x.ndim
    sl[axis] = slice(0, size)
    return x[tuple(sl)]


def _sharded_axis_fft(x, *, transpose, axis_name, shard_axis, swap,
                      n_shard, pad0, n_swap, pad1, fn_shard,
                      skip_back=False):
    """The global-transpose + sharded-axis-FFT + transpose-back phase every
    slab solver shares.  Ragged extents (pad0/pad1 > 0) are padded only for
    the collectives; the FFT itself always runs at the true n_shard
    (mpi/block.c short-last-block analog, realized as pad-and-crop)."""
    if pad1:
        x = _pad_ax(x, swap, pad1)         # swap axis is locally whole here
    x = transpose(x, axis_name, split_axis=swap, concat_axis=shard_axis)
    if pad0:
        x = _crop_ax(x, shard_axis, n_shard)
    x = _apply_along(fn_shard, x, shard_axis)
    if not skip_back:
        if pad0:
            x = _pad_ax(x, shard_axis, pad0)
        x = transpose(x, axis_name, split_axis=shard_axis, concat_axis=swap)
        if pad1:
            x = _crop_ax(x, swap, n_swap)
    return x


def _ragged_pre_post(ndim, shard_axis, pad0, out_axis, out_n, out_padded):
    """(pre, post) jit-level wrappers: pad the sharded input axis so the
    shard_map program sees even blocks; crop the output back to the true
    extent.  Either may be None."""
    pre = post = None
    if pad0:
        def pre(x):
            return _pad_ax(x, shard_axis, pad0)
    if out_padded:
        def post(y):
            return _crop_ax(y, out_axis, out_n)
    return pre, post


def _spec_with_vectors(ndim: int, main_dim: Optional[int], axis_name: str,
                       vector_shardings) -> P:
    """PartitionSpec with the transform shard axis plus caller-requested
    shardings of *vector* (batch) dims over other mesh axes — the
    generalization FFTW-MPI lacks: data-parallel batch composes freely with
    the transform decomposition because vector dims never enter the global
    transposes."""
    names = [None] * ndim
    if main_dim is not None:
        names[main_dim] = axis_name
    for d, nm in (vector_shardings or {}).items():
        d = int(d) % ndim
        if names[d] is not None:
            raise ValueError(f"dim {d} already sharded over {names[d]!r}")
        if nm == axis_name:
            raise ValueError("vector dims must use a different mesh axis "
                             "than the transform decomposition")
        names[d] = nm
    return P(*names)


class DistPlan:
    """Executable distributed plan over global jax.Arrays.

    ``pre``/``post`` run OUTSIDE the shard_map (inside the jit): the
    ragged-block plans (extents not divisible by the mesh axis,
    ``mpi/block.c`` short-last-block analog) pad the sharded input axis up
    to a multiple there and crop the output back."""

    def __init__(self, fn: Callable, mesh: Mesh, in_spec: P, out_spec: P,
                 global_shape: Tuple[int, ...], desc: str,
                 pre: Optional[Callable] = None,
                 post: Optional[Callable] = None):
        self.mesh = mesh
        self.in_spec = in_spec
        self.out_spec = out_spec
        self.global_shape = global_shape
        self.desc = desc
        self._ragged_in = pre is not None
        inner = jax.shard_map(fn, mesh=mesh, in_specs=in_spec,
                              out_specs=out_spec)
        if pre is None and post is None:
            self._fn = jax.jit(inner)
        else:
            if any(t == jax.sharding.AxisType.Explicit
                   for t in mesh.axis_types):
                # under explicit-sharding meshes the jit-level pad/crop of
                # a non-divisible sharded dim is unimplemented in the
                # sharding type system; run them in Auto mode so GSPMD
                # inserts the reshards (the ragged-block price).  An
                # UNEVENLY sharded result is unrepresentable entirely —
                # drop the sharding of non-divisible result axes (the
                # explicit-mode analog of FFTW's uneven last block).
                from jax.sharding import auto_axes

                def _even(spec, shape):
                    names = list(spec) + [None] * (len(shape) - len(spec))
                    return P(*[nm if nm is not None and
                               shape[d] % mesh.shape[nm] == 0 else None
                               for d, nm in enumerate(names)])
                if pre is not None:
                    pre = auto_axes(pre, out_sharding=NamedSharding(
                        mesh, in_spec))
                if post is not None:
                    self.out_spec = _even(out_spec, global_shape)
                    post = auto_axes(post, out_sharding=NamedSharding(
                        mesh, self.out_spec))

            def outer(x):
                if pre is not None:
                    x = pre(x)
                y = inner(x)
                return y if post is None else post(y)
            self._fn = jax.jit(outer)

    def __call__(self, x):
        return self._fn(x)

    #: fftw_mpi_execute_* analog, matching the serial Plan interface
    execute = __call__

    @property
    def apply(self):
        return self._fn

    def input_sharding(self) -> NamedSharding:
        if self._ragged_in:
            # a ragged sharded extent cannot be device_put evenly; the
            # plan pads inside its jit and reshards there (one extra
            # interconnect distribution pass — the ragged-block price)
            return NamedSharding(self.mesh, P())
        return NamedSharding(self.mesh, self.in_spec)

    def output_sharding(self) -> NamedSharding:
        return NamedSharding(self.mesh, self.out_spec)

    def __repr__(self):
        return f"(dist-plan {self.desc} {self.global_shape} {self.in_spec})"


def plan_dft_dist(shape: Sequence[int], mesh: Mesh, axis_name: str = "x",
                  axes: Optional[Sequence[int]] = None,
                  sign: int = K.FORWARD, shard_axis: int = 0,
                  transposed_out: bool = False, flags: int = K.ESTIMATE,
                  dtype="complex64",
                  transpose_method: str = "all_to_all",
                  overlap_chunks: Optional[int] = None,
                  vector_shardings: Optional[Dict[int, str]] = None,
                  block0: Optional[int] = None,
                  block1: Optional[int] = None,
                  transposed_in: bool = False,
                  _skip_measure: bool = False,
                  _swap: Optional[int] = None) -> DistPlan:
    """Slab-decomposed distributed c2c DFT, rank >= 1.

    `shape` is the global array shape; the array is sharded along
    `shard_axis` over mesh axis `axis_name`.  If `shard_axis` is not a
    transform axis this reduces to purely-local plans (bigvec analog).
    With ``transposed_out=True`` the result is sharded along the swap axis
    instead — no final global transpose (TRANSPOSED_OUT analog).

    With ``transposed_in=True`` the INPUT is in the transposed format — the
    exact layout a ``transposed_out`` plan of the same (shape, shard_axis)
    produces (sharded over the swap axis) — so the one global transpose of
    this plan returns the data to natural orientation
    (``fftw/mpi/dft-rank-geq2-transposed.c:22-80`` TRANSPOSED_IN analog,
    flag semantics ``fftw/mpi/ifftw-mpi.h:30-151``).  A
    forward(transposed_out) -> pointwise -> inverse(transposed_in) round
    trip therefore pays exactly TWO global transposes total instead of
    four.  ``transposed_in`` together with ``transposed_out`` keeps the
    transposed layout on both sides (two transposes).  For rank-1
    transforms the flags map to the six-step solver's SCRAMBLED formats.

    ``overlap_chunks=K > 1`` pipelines communication with compute: the
    global-transpose + sharded-axis-FFT phase is split into K independent
    chunks along a non-participating axis, so XLA's latency-hiding
    scheduler can run chunk k+1's all_to_all on the interconnect while chunk k's
    local FFT occupies the compute units.  (The reference never overlapped
    — ``mpi/transpose-pairwise.c:53`` leaves it as a TODO; SURVEY.md §7
    hard-part 4 requires it for weak-scaling targets.)  The default is the
    ``threads.plan_with_nthreads`` hint (fftw_plan_with_nthreads analog:
    the user's declared intra-plan parallelism becomes pipeline depth).
    """
    if overlap_chunks is None:
        from .. import threads
        overlap_chunks = max(1, threads.planner_nthreads())
    shape = tuple(shape)
    ndim = len(shape)
    axes = tuple(a % ndim for a in
                 (range(ndim) if axes is None else axes))
    shard_axis %= ndim
    if transposed_in:
        if shard_axis not in axes:
            raise ValueError("transposed_in needs the sharded axis to be "
                             "a transform axis")
        if len(axes) >= 2:
            # Role reversal: the transposed-format input arrives sharded
            # over the axis the forward's transposed_out picked (its swap);
            # this plan's one global transpose returns it to natural
            # orientation.  A transposed_in request is therefore the
            # mirror plan: shard/swap exchanged, out-format flag flipped.
            t = _swap if _swap is not None \
                else [a for a in axes if a != shard_axis][0]
            shard_axis, _swap = t, shard_axis
            transposed_out = not transposed_out
            transposed_in = False
    nproc = mesh.shape[axis_name]
    rdtype = np.float32 if np.dtype(dtype) in (np.complex64, np.float32) \
        else np.float64
    patience = K.patience_of_flags(flags)
    pl = planner_mod.the_planner

    if vector_shardings:
        for d in vector_shardings:
            if int(d) % ndim in axes:
                raise ValueError("vector_shardings must name non-transform "
                                 f"dims; dim {d} is a transform axis")
    in_spec = _spec_with_vectors(ndim, shard_axis, axis_name,
                                 vector_shardings)

    if (patience >= K.PATIENCE_MEASURE and not _skip_measure
            and shard_axis in axes and len(axes) >= 2):
        # whole-plan MEASURE: complete candidates over transpose method x
        # overlap depth compete (fftw/mpi/conf.c:28-52 analog)
        chunks = sorted({1, 2, 4} | {overlap_chunks or 1})
        params = [{"transpose_method": m, "overlap_chunks": c}
                  for m in _transpose_method_candidates(nproc)
                  for c in chunks]

        def build(**prm):
            return plan_dft_dist(shape, mesh, axis_name, axes, sign,
                                 shard_axis, transposed_out, K.ESTIMATE,
                                 dtype, vector_shardings=vector_shardings,
                                 block0=block0, block1=block1,
                                 _skip_measure=True, _swap=_swap, **prm)
        tag = (f"slab:{shape}:{axes}:{shard_axis}:{sign}:"
               f"{int(transposed_out)}:{block0}:{block1}:{_swap}:"
               f"{tuple(mesh.shape.items())}")
        best = _measure_whole_plans(tag, build, params, np.dtype(dtype))
        return plan_dft_dist(shape, mesh, axis_name, axes, sign,
                             shard_axis, transposed_out, flags, dtype,
                             vector_shardings=vector_shardings,
                             block0=block0, block1=block1,
                             _skip_measure=True, _swap=_swap, **best)

    if shard_axis not in axes:
        # batch-sharded: all transform axes local (dft-rank1-bigvec analog)
        builders = [(a, c2c_ops.build_c2c(pl.plan_c2c(shape[a], rdtype,
                                                      patience), sign, rdtype))
                    for a in axes]

        def local_fn(x):
            for a, fn in builders:
                x = _apply_along(fn, x, a)
            return x
        padb = (-shape[shard_axis]) % nproc
        pre, post = _ragged_pre_post(ndim, shard_axis, padb, shard_axis,
                                     shape[shard_axis],
                                     out_padded=bool(padb))
        return DistPlan(local_fn, mesh, in_spec, in_spec, shape,
                        "bigvec-local" + ("-ragged" if padb else ""),
                        pre=pre, post=post)

    if len(axes) == 1:
        return _plan_six_step(shape, mesh, axis_name, axes[0], sign,
                              flags, rdtype, transpose_method, in_spec,
                              scrambled_out=transposed_out,
                              scrambled_in=transposed_in)

    # ragged blocks (mpi/block.c analog): extents not divisible by the
    # mesh axis are padded up to a multiple for the shard_map program;
    # the transforms themselves always run at the true sizes (crop/pad
    # around the sharded-axis FFT), and the output is cropped back.
    # An explicit block0 (fftw_mpi explicit-block analog) pads further so
    # each rank holds exactly block0 rows.
    if block0 is not None:
        if block0 < default_block(shape[shard_axis], nproc):
            raise ValueError(
                f"block0={block0} < default block "
                f"{default_block(shape[shard_axis], nproc)}")
        pad0 = block0 * nproc - shape[shard_axis]
    else:
        pad0 = (-shape[shard_axis]) % nproc
    # pick the swap axis: another transform axis (prefer the next one);
    # a transposed_in role reversal forces it (the original shard axis)
    others = [a for a in axes if a != shard_axis]
    swap = _swap if _swap is not None else others[0]
    # explicit output block (block1, fftw_mpi_local_size_many_transposed
    # analog, mpi/api.c:248-510): the swap-axis decomposition granularity
    # of the exchange and of a transposed_out result
    if block1 is not None:
        if block1 < default_block(shape[swap], nproc):
            raise ValueError(
                f"block1={block1} < default block "
                f"{default_block(shape[swap], nproc)}")
        pad1 = block1 * nproc - shape[swap]
    else:
        pad1 = (-shape[swap]) % nproc
    # "measure" times the candidates at the ACTUAL exchange-time local
    # shape: padded shard rows over P, other dims, padded swap extent last
    rest = [shape[i] for i in range(ndim) if i not in (shard_axis, swap)]
    transpose = _resolve_transpose(
        transpose_method, mesh, axis_name, shape, np.complex64,
        exchange_local=((shape[shard_axis] + pad0) // nproc, *rest,
                        shape[swap] + pad1))

    # local plans: transform axes != shard_axis on the local slab, then the
    # shard axis after the global transpose
    fns_local = [(a, c2c_ops.build_c2c(pl.plan_c2c(shape[a], rdtype,
                                                   patience), sign, rdtype))
                 for a in others]
    fn_shard = c2c_ops.build_c2c(pl.plan_c2c(shape[shard_axis], rdtype,
                                             patience), sign, rdtype)

    # pick the chunking axis for communication/compute overlap: any axis
    # not taking part in the global transpose whose LOCAL extent (the
    # jnp.split runs inside shard_map, so vector-sharded dims are divided
    # by their mesh axis first) is divisible by K
    chunk_axis = None
    if overlap_chunks > 1:
        vs = {int(d) % ndim: nm for d, nm in
              (vector_shardings or {}).items()}
        for cand in range(ndim - 1, -1, -1):
            if cand in (shard_axis, swap):
                continue
            local_ext = shape[cand]
            if cand in vs:
                local_ext //= mesh.shape[vs[cand]]
            if local_ext % overlap_chunks == 0:
                chunk_axis = cand
                break
        if chunk_axis is None:
            overlap_chunks = 1

    n0 = shape[shard_axis]
    n1 = shape[swap]

    def _exchange_and_fft(x):
        return _sharded_axis_fft(
            x, transpose=transpose, axis_name=axis_name,
            shard_axis=shard_axis, swap=swap, n_shard=n0, pad0=pad0,
            n_swap=n1, pad1=pad1, fn_shard=fn_shard,
            skip_back=transposed_out)

    def local_fn(x):
        # 1. FFT over all locally-complete transform axes
        for a, fn in fns_local:
            x = _apply_along(fn, x, a)
        # 2+3. transpose + sharded-axis FFT, chunked for comm/compute overlap
        if overlap_chunks == 1:
            return _exchange_and_fft(x)
        parts = jnp.split(x, overlap_chunks, axis=chunk_axis)
        return jnp.concatenate([_exchange_and_fft(c) for c in parts],
                               axis=chunk_axis)

    out_axis = swap if transposed_out else shard_axis
    out_spec = _spec_with_vectors(ndim, out_axis, axis_name,
                                  vector_shardings)
    crop_ax, crop_n = ((shard_axis, n0) if not transposed_out
                       else (swap, n1))
    pre, post = _ragged_pre_post(
        ndim, shard_axis, pad0, crop_ax, crop_n,
        out_padded=(pad0 and not transposed_out)
        or (pad1 and transposed_out))
    return DistPlan(local_fn, mesh, in_spec, out_spec, shape,
                    f"slab[{transpose_method}]"
                    + ("-transposed_out" if transposed_out else "")
                    + ("-ragged" if pad0 or pad1 else ""),
                    pre=pre, post=post)


def plan_dft_1d_dist(n: int, mesh: Mesh, axis_name: str = "x",
                     sign: int = K.FORWARD, flags: int = K.ESTIMATE,
                     dtype="complex64", scrambled_out: bool = False,
                     scrambled_in: bool = False,
                     transpose_method: str = "all_to_all",
                     batch_shape: Tuple[int, ...] = ()) -> DistPlan:
    """Distributed 1-D DFT of size n, sharded over its only axis
    (six-step, mpi/dft-rank1.c analog).  Input shape: batch_shape + (n,).
    ``scrambled_in`` consumes a ``scrambled_out`` plan's output format
    directly (FFTW_MPI_SCRAMBLED_IN, ``fftw/mpi/api.c:248-510``)."""
    shape = tuple(batch_shape) + (n,)
    rdtype = np.float32 if np.dtype(dtype) in (np.complex64, np.float32) \
        else np.float64
    in_spec = P(*([None] * len(batch_shape) + [axis_name]))
    return _plan_six_step(shape, mesh, axis_name, len(shape) - 1, sign,
                          flags, rdtype, transpose_method, in_spec,
                          scrambled_out, scrambled_in=scrambled_in)


def _six_step_radix_candidates(n: int, nproc: int, k: int = 3):
    """Top-k radix choices R (balance-ranked, exact splits first) for
    whole-plan MEASURE (mpi/choose-radix.c candidates, planner-timed)."""
    from ..utils import primes
    cands = []
    for R in primes.divisors(n):
        C = n // R
        if C % nproc or R < 2 or C < 2:
            continue
        cands.append((R % nproc != 0, abs(np.log2(R * R / n)), R))
    cands.sort()
    return [R for _, _, R in cands[:k]]


def _plan_six_step(shape, mesh, axis_name, axis, sign, flags, rdtype,
                   transpose_method, in_spec, scrambled_out,
                   scrambled_in=False, radix_R=None, _skip_measure=False):
    """Six-step 1-D DFT over a sharded axis: n = R*C viewed as an (R, C)
    matrix; out[c + R*d] = F_C_d( w^{rc} * F_R_c(x[r, c]) ) (four-step
    identity; radix choice analog of mpi/choose-radix.c).

    ``scrambled_in`` (FFTW_MPI_SCRAMBLED_IN, ``fftw/mpi/dft-rank1.c:20-60``)
    consumes exactly the format a ``scrambled_out`` plan of the same
    (n, nproc) produces — the row-sharded (R/P, C) matrix with
    M[c, d] = x[c + R*d] — running the pipeline in the reversed data-
    movement order: DFT_C along the LOCAL rows, twiddle w^{c*j1}, ONE
    global transpose, DFT_R, final transpose to natural block layout.
    Two global transposes instead of three, so a forward(scrambled_out) ->
    pointwise -> backward(scrambled_in) loop pays 4 instead of 6.
    With ``scrambled_out`` as well the final transpose is also skipped
    (one transpose total) and the output is the j1-sharded (R, C/P)
    matrix flattened j2-major — a layout consumed only by this library's
    own scrambled_in when R == C (FFTW likewise leaves the combined
    format undocumented)."""
    if axis != len(shape) - 1:
        raise NotImplementedError("six-step expects the sharded transform "
                                  "axis last; move it with jnp.moveaxis")
    n = shape[-1]
    nproc = mesh.shape[axis_name]
    patience = K.patience_of_flags(flags)
    pl = planner_mod.the_planner
    if patience >= K.PATIENCE_MEASURE and not _skip_measure:
        # whole-plan MEASURE: radix R and transpose method compete as
        # complete plans (fftw/mpi/conf.c + choose-radix, planner-timed).
        # Scrambled formats pin R to the deterministic choice: producer
        # (scrambled_out) and consumer (scrambled_in) plans are planned
        # separately and their matrix views must agree.
        if scrambled_out or scrambled_in:
            radii = [_choose_six_step_radix(n, nproc)]
        else:
            radii = _six_step_radix_candidates(n, nproc)
        params = [{"radix_R": r, "transpose_method": m}
                  for r in radii
                  for m in _transpose_method_candidates(nproc)]
        if len(params) > 1:
            ctype = c2c_ops.complex_dtype(rdtype)

            def build(**prm):
                return _plan_six_step(shape, mesh, axis_name, axis, sign,
                                      K.ESTIMATE, rdtype,
                                      in_spec=in_spec,
                                      scrambled_out=scrambled_out,
                                      scrambled_in=scrambled_in,
                                      _skip_measure=True, **prm)
            tag = (f"sixstep:{shape}:{sign}:{int(scrambled_out)}:"
                   f"{int(scrambled_in)}:{tuple(mesh.shape.items())}")
            best = _measure_whole_plans(tag, build, params, ctype)
            return _plan_six_step(shape, mesh, axis_name, axis, sign,
                                  flags, rdtype, in_spec=in_spec,
                                  scrambled_out=scrambled_out,
                                  scrambled_in=scrambled_in,
                                  _skip_measure=True, **best)
    # choose R ~ sqrt(n) with nproc | C (nproc | R preferred; otherwise the
    # row dimension is ragged and padded below)
    R = radix_R if radix_R is not None else _choose_six_step_radix(n, nproc)
    C = n // R
    Rp = R + ((-R) % nproc)            # padded row count (ragged blocks)
    if Rp != R and (scrambled_out or scrambled_in):
        # DOCUMENTED RESTRICTION (vs fftw/mpi/dft-rank1.c, which applies
        # its scrambled format to arbitrary block interactions): the
        # scrambled format is implementation-defined in both libraries
        # (FFTW: "the scrambled format is deliberately undocumented");
        # this implementation defines it only for nproc | R — i.e. when
        # some divisor R of n has nproc | R AND nproc | n/R, which
        # _choose_six_step_radix prefers whenever one exists.  Ragged
        # (n, nproc) pairs (no such R, e.g. n=12 over 8 devices) would
        # need a padded matrix format whose local size exceeds n/P;
        # natural layout handles those pairs instead (same transform,
        # one extra transpose).  See PARITY.md §2.9.
        raise ValueError(
            f"SCRAMBLED_IN/OUT needs nproc | R (n={n} has no divisor R "
            f"with {nproc} | R and {nproc} | n/R) — use natural layout, "
            f"which supports ragged (n, nproc) pairs")
    transpose = _resolve_transpose(
        transpose_method, mesh, axis_name, shape, np.complex64,
        exchange_local=(Rp // nproc, C))   # the actual matrix-view block
    pl_R = c2c_ops.build_c2c(pl.plan_c2c(R, rdtype, patience), sign, rdtype)
    pl_C = c2c_ops.build_c2c(pl.plan_c2c(C, rdtype, patience), sign, rdtype)
    ctype = c2c_ops.complex_dtype(rdtype)
    # full twiddle (R, C) built on host in f64, sharded along C like the
    # post-transpose layout (device-dependent constants travel as operands)
    W = np.asarray(matrices.twiddle_2d(R, C, sign), dtype=ctype)

    nb = len(shape) - 1

    def local_fn_sci(x, wr, wi):
        # scrambled input: local rows c of the (R, C) matrix view,
        # M[c, d] = x[c + R*d] — the scrambled_out format.  Reversed
        # data-movement order: the column DFT is local FIRST.
        w = wr + 1j * wi
        bshape = x.shape[:-1]
        x = x.reshape(*bshape, R // nproc, C)
        # step 1: DFT_C along the local d axis -> A[c, j1]
        x = _apply_along(pl_C, x, nb + 1)
        # step 2: twiddle w^{c*j1} (w = the local R/P-row slice of W)
        x = x * w
        # step 3: ONE global transpose -> (R, C/P)
        x = transpose(x, axis_name, split_axis=nb + 1, concat_axis=nb)
        # step 4: DFT_R down the rows: [j2, j1] holds out[j1 + C*j2]
        x = _apply_along(pl_R, x, nb)
        if scrambled_out:
            # combined-format output: j1-sharded matrix, j2-major flatten
            return x.reshape(*bshape, R * (C // nproc))
        # step 5: transpose to natural block layout (j2-row blocks local;
        # j2 is the major part of the flat index j1 + C*j2)
        x = transpose(x, axis_name, split_axis=nb, concat_axis=nb + 1)
        return x.reshape(*bshape, (R // nproc) * C)

    def local_fn(x, wr, wi):
        # x local: batch + (Rp*C/P,) == batch + (Rp/P, C) rows of the
        # (possibly row-padded) matrix view
        w = wr + 1j * wi          # combined on-device
        bshape = x.shape[:-1]
        x = x.reshape(*bshape, Rp // nproc, C)
        # step 1: transpose -> (Rp, C/P): gather rows, scatter cols
        x = transpose(x, axis_name, split_axis=nb + 1, concat_axis=nb)
        if Rp != R:               # ragged: the DFT runs at the TRUE size
            x = jax.lax.slice_in_dim(x, 0, R, axis=nb)
        # step 2: DFT_R down the rows (axis nb), batched over local cols
        x = _apply_along(pl_R, x, nb)
        # step 3: twiddle w^{rc} (w is the local C/P-slice of W)
        x = x * w
        if Rp != R:
            pads = [(0, 0)] * x.ndim
            pads[nb] = (0, Rp - R)
            x = jnp.pad(x, pads)
        # step 4: transpose back -> (Rp/P, C)
        x = transpose(x, axis_name, split_axis=nb, concat_axis=nb + 1)
        # step 5: DFT_C along the rows (axis nb+1, local)
        x = _apply_along(pl_C, x, nb + 1)
        if scrambled_out:
            # layout: out[c + R*d] at matrix position [c, d]; flattened local
            # block is the c-major "scrambled" order (SCRAMBLED_OUT analog)
            return x.reshape(*bshape, (R // nproc) * C)
        # step 6: local transpose (c,d)->(d,c) + global transpose for the
        # natural contiguous-k sharding
        x = jnp.swapaxes(x, nb, nb + 1)                  # (C, Rp/P)
        x = transpose(x, axis_name, split_axis=nb, concat_axis=nb + 1)
        if Rp != R:               # drop the pad columns: exact n output
            x = jax.lax.slice_in_dim(x, 0, R, axis=nb + 1)
        return x.reshape(*bshape, C // nproc * R)

    # scrambled_in twiddles at the row-sharded stage; natural-in at the
    # column-sharded stage — the SAME (R, C) matrix, different slicing
    w_spec = P(*([None] * nb
                 + ([axis_name, None] if scrambled_in
                    else [None, axis_name])))
    out_spec = in_spec

    class _SixStep(DistPlan):
        def __init__(self):
            self.mesh = mesh
            self.in_spec = in_spec
            self.out_spec = out_spec
            self.global_shape = shape
            # nproc | C and n = R*C, so the flat input axis always shards
            # evenly — even when the row dimension R is ragged
            self._ragged_in = False
            self.desc = f"six-step R={R} C={C}" + \
                (" scrambled_in" if scrambled_in else "") + \
                (" scrambled" if scrambled_out else "") + \
                (" ragged" if Rp != R else "")
            inner = jax.shard_map(local_fn_sci if scrambled_in
                                  else local_fn, mesh=mesh,
                                  in_specs=(in_spec, w_spec, w_spec),
                                  out_specs=out_spec)
            sh = NamedSharding(mesh, w_spec)
            wshape = (1,) * nb + W.shape
            rdt = np.float32 if ctype == np.dtype(np.complex64) \
                else np.float64
            wr = jax.device_put(
                np.ascontiguousarray(W.real, rdt).reshape(wshape), sh)
            wi = jax.device_put(
                np.ascontiguousarray(W.imag, rdt).reshape(wshape), sh)
            if Rp == R:
                self._fn = jax.jit(lambda x: inner(x, wr, wi))
            else:
                pads = [(0, 0)] * (nb + 1)
                pads[-1] = (0, (Rp - R) * C)   # row pad IS a suffix pad

                def padded(x):
                    return inner(jnp.pad(x, pads), wr, wi)
                self._fn = jax.jit(padded)

    return _SixStep()


def _choose_six_step_radix(n: int, nproc: int) -> int:
    """R ~ sqrt(n) with nproc | n/R (mpi/choose-radix.c analog).  An exact
    nproc | R split is preferred; otherwise the row dimension is ragged
    and the plan pads it (mpi/block.c short-last-block analog)."""
    from ..utils import primes
    best_exact = None
    best_ragged = None
    for R in primes.divisors(n):
        C = n // R
        if C % nproc or R < 2 or C < 2:
            continue
        score = abs(np.log2(R * R / n))
        if R % nproc == 0:
            if best_exact is None or score < best_exact[0]:
                best_exact = (score, R)
        else:
            if best_ragged is None or score < best_ragged[0]:
                best_ragged = (score, R)
    if best_exact is not None:
        return best_exact[1]
    if best_ragged is not None:
        return best_ragged[1]
    raise ValueError(f"six-step needs a divisor C of {n} with {nproc} | C "
                     f"(choose a padded size or a smaller mesh)")


def _apply_along(fn, x, axis):
    if axis == x.ndim - 1:
        return fn(x)
    x = jnp.moveaxis(x, axis, -1)
    x = fn(x)
    return jnp.moveaxis(x, -1, axis)


# ---------------------------------------------------------------------------
# local_size family (the data-distribution oracle, mpi/api.c:248-510)
# ---------------------------------------------------------------------------

def local_size_2d(n0: int, n1: int, nproc: int, rank: int):
    """(local_n0, local_0_start) for an (n0, n1) array block-distributed
    over its first axis (fftw_mpi_local_size_2d analog; the 'alloc' return
    is meaningless for logical arrays and omitted)."""
    return local_size_1d(n0, nproc, rank)


def local_size_3d(n0: int, n1: int, n2: int, nproc: int, rank: int):
    return local_size_1d(n0, nproc, rank)


def local_size_2d_transposed(n0: int, n1: int, nproc: int, rank: int):
    """((local_n0, start0), (local_n1, start1)) — input block over axis 0
    plus the TRANSPOSED_OUT block over axis 1 (local_size_2d_transposed)."""
    return local_size_1d(n0, nproc, rank), local_size_1d(n1, nproc, rank)


def local_size_3d_transposed(n0: int, n1: int, n2: int, nproc: int,
                             rank: int):
    return local_size_1d(n0, nproc, rank), local_size_1d(n1, nproc, rank)


def local_size_many(n: Sequence[int], howmany: int, block0: Optional[int],
                    nproc: int, rank: int):
    """(local_n0, local_0_start) under an explicit block size
    (fftw_mpi_local_size_many analog; block0=None -> default block)."""
    n0 = n[0]
    b = block0 or default_block(n0, nproc)
    start = min(rank * b, n0)
    return min(b, n0 - start), start


def local_size(n: Sequence[int], nproc: int, rank: int):
    """fftw_mpi_local_size (guru rank-n form): (local_n0, local_0_start)
    of `rank` for an array block-distributed over axis 0."""
    return local_size_1d(int(n[0]), nproc, rank)


def local_size_transposed(n: Sequence[int], nproc: int, rank: int):
    """fftw_mpi_local_size_transposed: input block over axis 0 plus the
    TRANSPOSED_OUT block over axis 1."""
    return (local_size_1d(int(n[0]), nproc, rank),
            local_size_1d(int(n[1]), nproc, rank))


def local_size_many_1d(n0: int, howmany: int, nproc: int, rank: int,
                       scrambled_in: bool = False,
                       scrambled_out: bool = False):
    """fftw_mpi_local_size_many_1d analog for the six-step 1-D solver:
    ((local_ni, local_i_start), (local_no, local_o_start)).  With the
    default even distribution both sides use ceil(n0/P) row blocks of the
    matrix view (scrambled flags don't change the counts here — the
    six-step keeps n0/P points per rank either way)."""
    del howmany, scrambled_in, scrambled_out
    b = local_size_1d(n0, nproc, rank)
    return b, b


def local_size_many_transposed(n: Sequence[int], howmany: int,
                               block0: Optional[int], block1: Optional[int],
                               nproc: int, rank: int):
    """fftw_mpi_local_size_many_transposed analog: explicit input/output
    block sizes (None -> default)."""
    n0, n1 = int(n[0]), int(n[1])
    b0 = block0 or default_block(n0, nproc)
    b1 = block1 or default_block(n1, nproc)
    s0 = min(rank * b0, n0)
    s1 = min(rank * b1, n1)
    return (min(b0, n0 - s0), s0), (min(b1, n1 - s1), s1)


def init() -> None:
    """fftw_mpi_init analog.  JAX initializes the distributed runtime
    itself (jax.distributed / the mesh); plan determinism across hosts is
    by construction (deterministic native ESTIMATE search + wisdom
    broadcast), so there are no planner hooks to install."""


def mpi_cleanup() -> None:
    """fftw_mpi_cleanup analog: forget wisdom (mirrors fftw_cleanup)."""
    from .. import api
    api.forget_wisdom()


def execute_dft(plan: DistPlan, x):
    """fftw_mpi_execute_dft analog (new-array execute on a DistPlan)."""
    return plan(x)


execute_dft_r2c = execute_dft
execute_dft_c2r = execute_dft
execute_r2r = execute_dft


def alloc_local(n: Sequence[int], nproc: int, rank: int, howmany: int = 1,
                transposed: bool = False) -> int:
    """FFTW's alloc_local return value: elements this rank must hold for an
    array of global shape `n` block-distributed over axis 0 (and, with
    ``transposed``, the max against the axis-1-distributed output layout,
    like fftw_mpi_local_size_*_transposed, mpi/api.c:248-510).  XLA
    allocates for logical arrays, so this is an oracle for parity and for
    sizing host staging buffers, not an allocation contract."""
    n = tuple(int(v) for v in n)
    rest = int(np.prod(n[1:], dtype=np.int64)) if len(n) > 1 else 1
    a_in = local_size_1d(n[0], nproc, rank)[0] * rest
    if transposed and len(n) > 1:
        rest_t = (n[0] * int(np.prod(n[2:], dtype=np.int64))
                  if len(n) > 2 else n[0])
        a_out = local_size_1d(n[1], nproc, rank)[0] * rest_t
        a_in = max(a_in, a_out)
    return a_in * howmany


# ---------------------------------------------------------------------------
# standalone distributed transpose plan (fftw_mpi_plan_many_transpose,
# mpi/api.c:521)
# ---------------------------------------------------------------------------

def plan_transpose(n0: int, n1: int, mesh: Mesh, axis_name: str = "x",
                   howmany: int = 1, scrambled_out: bool = False,
                   transpose_method: str = "all_to_all",
                   dtype="complex64") -> DistPlan:
    """Distributed (n0, n1) -> (n1, n0) transpose of row-distributed data.

    Input global shape (n0, n1[, howmany]) sharded over axis 0; output
    (n1, n0[, howmany]) sharded over axis 0.  With ``scrambled_out`` the
    local transpose is skipped and each rank holds its (n0, n1/P) block
    untouched (FFTW's TRANSPOSED/SCRAMBLED formats for chaining)."""
    nproc = mesh.shape[axis_name]
    if n0 % nproc or n1 % nproc:
        raise ValueError(f"{n0}x{n1} transpose needs {nproc} | both dims")
    transpose = _resolve_transpose(transpose_method, mesh,
                                   axis_name, (n0, n1),
                                   np.complex64)
    vec = (howmany,) if howmany > 1 else ()
    shape = (n0, n1) + vec
    in_spec = P(*([axis_name] + [None] * (len(shape) - 1)))
    out_shape = (n1, n0) + vec
    out_spec = in_spec

    def local_fn(x):
        # local (n0/P, n1, ...) -> gather rows, scatter cols
        y = transpose(x, axis_name, split_axis=1, concat_axis=0)
        # y: (n0, n1/P, ...)
        if scrambled_out:
            return y
        return jnp.swapaxes(y, 0, 1)                    # (n1/P, n0, ...)

    return DistPlan(local_fn, mesh, in_spec,
                    in_spec if not scrambled_out else
                    P(*([None, axis_name] + [None] * len(vec))),
                    out_shape, f"transpose[{transpose_method}]"
                    + ("-scrambled" if scrambled_out else ""))


# ---------------------------------------------------------------------------
# real and r2r distributed plans (the rdft/rdft2 MPI solver mirrors,
# mpi/rdft-*.c, mpi/rdft2-*.c; SURVEY.md section 2.9)
# ---------------------------------------------------------------------------

def _pick_swap(shape, axes, shard_axis, last, nproc, cshape):
    """Choose the axis that trades places with shard_axis in the global
    transpose; prefer a full (non-halved) transform axis, and among those
    an evenly-divisible one (a ragged swap costs a pad-and-crop)."""
    cands = [a for a in axes if a not in (shard_axis, last)]
    if last != shard_axis:
        cands.append(last)
    if not cands:
        raise ValueError("need a second transform axis to trade places "
                         "with the sharded axis")
    for a in cands:
        if cshape[a] % nproc == 0:
            return a
    return cands[0]


def plan_dft_r2c_dist(shape: Sequence[int], mesh: Mesh, axis_name: str = "x",
                      axes: Optional[Sequence[int]] = None,
                      shard_axis: int = 0, transposed_out: bool = False,
                      flags: int = K.ESTIMATE, dtype="float32",
                      transpose_method: str = "all_to_all") -> DistPlan:
    """Slab-decomposed distributed r2c (mpi/rdft2 dft-rank-geq2 analog).

    Real input of global `shape` sharded over `shard_axis`; complex output
    (last transform axis halved to n//2+1) sharded over `shard_axis` (or the
    swap axis with transposed_out).  The halved axis is transformed locally
    (it is never the shard axis), so there is exactly one global transpose
    pair, like the complex slab solver.
    """
    from .. import planner as planner_mod
    from ..ops import c2c as c2c_ops
    from ..ops import real as real_ops

    shape = tuple(shape)
    ndim = len(shape)
    axes = tuple(a % ndim for a in (range(ndim) if axes is None else axes))
    shard_axis %= ndim
    last = axes[-1]
    if last == shard_axis:
        raise ValueError("the halved (last transform) axis must be local; "
                         "shard a different axis")
    nproc = mesh.shape[axis_name]
    rdtype = np.float32 if np.dtype(dtype) in (np.float32, np.complex64) \
        else np.float64
    patience = K.patience_of_flags(flags)
    pl = planner_mod.the_planner

    cshape = list(shape)
    cshape[last] = shape[last] // 2 + 1
    in_spec = P(*[axis_name if i == shard_axis else None
                  for i in range(ndim)])

    r2c_fn = real_ops.build_r2c(pl.plan_r2c(shape[last], rdtype, patience),
                                rdtype)
    mids = [a for a in axes if a not in (last, shard_axis)]
    mid_fns = [(a, c2c_ops.build_c2c(pl.plan_c2c(shape[a], rdtype, patience),
                                     K.FORWARD, rdtype)) for a in mids]
    if shard_axis in axes:
        swap = _pick_swap(shape, axes, shard_axis, last, nproc, cshape)
        shard_fn = c2c_ops.build_c2c(
            pl.plan_c2c(shape[shard_axis], rdtype, patience), K.FORWARD,
            rdtype)
        pad0 = (-cshape[shard_axis]) % nproc
        pad1 = (-cshape[swap]) % nproc
        rest = [cshape[i] for i in range(ndim)
                if i not in (shard_axis, swap)]
        transpose = _resolve_transpose(
            transpose_method, mesh, axis_name, shape, np.complex64,
            exchange_local=((cshape[shard_axis] + pad0) // nproc, *rest,
                            cshape[swap] + pad1))
    else:
        swap = None
        shard_fn = None
        pad0 = (-shape[shard_axis]) % nproc    # ragged batch blocks
        pad1 = 0
        transpose = None

    def local_fn(x):
        x = _apply_along(r2c_fn, x, last)                 # halved, complex
        for a, fn in mid_fns:
            x = _apply_along(fn, x, a)
        if swap is not None:
            x = _sharded_axis_fft(
                x, transpose=transpose, axis_name=axis_name,
                shard_axis=shard_axis, swap=swap,
                n_shard=cshape[shard_axis], pad0=pad0,
                n_swap=cshape[swap], pad1=pad1, fn_shard=shard_fn,
                skip_back=transposed_out)
        return x

    out_axis = shard_axis if (swap is None or not transposed_out) else swap
    out_spec = P(*[axis_name if i == out_axis else None
                   for i in range(ndim)])
    crop_ax, crop_n = ((shard_axis, cshape[shard_axis])
                       if out_axis == shard_axis
                       else (swap, cshape[swap]))
    pre, post = _ragged_pre_post(
        ndim, shard_axis, pad0, crop_ax, crop_n,
        out_padded=(pad0 and out_axis == shard_axis)
        or (swap is not None and pad1 and out_axis == swap))
    return DistPlan(local_fn, mesh, in_spec, out_spec, tuple(cshape),
                    f"r2c-slab[{transpose_method}]"
                    + ("-transposed_out" if transposed_out else "")
                    + ("-ragged" if pad0 or pad1 else ""),
                    pre=pre, post=post)


def plan_dft_c2r_dist(shape: Sequence[int], mesh: Mesh, axis_name: str = "x",
                      axes: Optional[Sequence[int]] = None,
                      shard_axis: int = 0, flags: int = K.ESTIMATE,
                      dtype="float32",
                      transpose_method: str = "all_to_all") -> DistPlan:
    """Inverse of plan_dft_r2c_dist: `shape` is the logical REAL shape;
    input is the halved complex array sharded over shard_axis; output the
    real array, same sharding.  Unnormalized (c2r(r2c(x)) == N*x)."""
    from .. import planner as planner_mod
    from ..ops import c2c as c2c_ops
    from ..ops import real as real_ops

    shape = tuple(shape)
    ndim = len(shape)
    axes = tuple(a % ndim for a in (range(ndim) if axes is None else axes))
    shard_axis %= ndim
    last = axes[-1]
    if last == shard_axis:
        raise ValueError("the halved (last transform) axis must be local")
    nproc = mesh.shape[axis_name]
    rdtype = np.float32 if np.dtype(dtype) in (np.float32, np.complex64) \
        else np.float64
    patience = K.patience_of_flags(flags)
    pl = planner_mod.the_planner

    cshape = list(shape)
    cshape[last] = shape[last] // 2 + 1
    in_spec = P(*[axis_name if i == shard_axis else None
                  for i in range(ndim)])

    c2r_fn = real_ops.build_c2r(pl.plan_c2r(shape[last], rdtype, patience),
                                rdtype)
    mids = [a for a in axes if a not in (last, shard_axis)]
    mid_fns = [(a, c2c_ops.build_c2c(pl.plan_c2c(shape[a], rdtype, patience),
                                     K.BACKWARD, rdtype)) for a in mids]
    if shard_axis in axes:
        swap = _pick_swap(shape, axes, shard_axis, last, nproc, cshape)
        shard_fn = c2c_ops.build_c2c(
            pl.plan_c2c(shape[shard_axis], rdtype, patience), K.BACKWARD,
            rdtype)
        pad0 = (-cshape[shard_axis]) % nproc
        pad1 = (-cshape[swap]) % nproc
        rest = [cshape[i] for i in range(ndim)
                if i not in (shard_axis, swap)]
        transpose = _resolve_transpose(
            transpose_method, mesh, axis_name, shape, np.complex64,
            exchange_local=((cshape[shard_axis] + pad0) // nproc, *rest,
                            cshape[swap] + pad1))
    else:
        swap, shard_fn = None, None
        pad0 = (-shape[shard_axis]) % nproc
        pad1 = 0
        transpose = None

    def local_fn(x):
        if swap is not None:
            x = _sharded_axis_fft(
                x, transpose=transpose, axis_name=axis_name,
                shard_axis=shard_axis, swap=swap,
                n_shard=cshape[shard_axis], pad0=pad0,
                n_swap=cshape[swap], pad1=pad1, fn_shard=shard_fn)
        for a, fn in mid_fns:
            x = _apply_along(fn, x, a)
        return _apply_along(c2r_fn, x, last)

    pre, post = _ragged_pre_post(ndim, shard_axis, pad0, shard_axis,
                                 shape[shard_axis], out_padded=bool(pad0))
    return DistPlan(local_fn, mesh, in_spec, in_spec, shape,
                    f"c2r-slab[{transpose_method}]"
                    + ("-ragged" if pad0 or pad1 else ""),
                    pre=pre, post=post)


def plan_r2r_dist(shape: Sequence[int], kinds, mesh: Mesh,
                  axis_name: str = "x",
                  axes: Optional[Sequence[int]] = None, shard_axis: int = 0,
                  transposed_out: bool = False, flags: int = K.ESTIMATE,
                  dtype="float32",
                  transpose_method: str = "all_to_all") -> DistPlan:
    """Distributed separable r2r (mpi/rdft r2r analog): per-axis kinds,
    local passes over non-sharded axes, one global transpose pair for the
    sharded axis."""
    from .. import planner as planner_mod
    from ..ops import r2r as r2r_ops

    shape = tuple(shape)
    ndim = len(shape)
    axes = tuple(a % ndim for a in (range(ndim) if axes is None else axes))
    shard_axis %= ndim
    ks = [k if isinstance(k, K.Kind) else K.Kind(str(k).lower())
          for k in (kinds if isinstance(kinds, (list, tuple))
                    else [kinds] * len(axes))]
    if len(ks) != len(axes):
        raise ValueError("need one r2r kind per transform axis")
    nproc = mesh.shape[axis_name]
    rdtype = np.float32 if np.dtype(dtype) == np.float32 else np.float64
    patience = K.patience_of_flags(flags)
    pl = planner_mod.the_planner

    in_spec = P(*[axis_name if i == shard_axis else None
                  for i in range(ndim)])
    fns = {a: r2r_ops.build_r2r(pl.plan_r2r(k, shape[a], rdtype, patience),
                                rdtype) for a, k in zip(axes, ks)}
    if shard_axis in axes:
        others = [a for a in axes if a != shard_axis]
        if not others:
            raise ValueError("need a second transform axis to trade "
                             "places with the sharded axis")
        others.sort(key=lambda a: shape[a] % nproc != 0)   # even first
        swap = others[0]
        pad0 = (-shape[shard_axis]) % nproc
        pad1 = (-shape[swap]) % nproc
        rest = [shape[i] for i in range(ndim)
                if i not in (shard_axis, swap)]
        transpose = _resolve_transpose(
            transpose_method, mesh, axis_name, shape, np.float32,
            exchange_local=((shape[shard_axis] + pad0) // nproc, *rest,
                            shape[swap] + pad1))
    else:
        swap = None
        pad0 = (-shape[shard_axis]) % nproc
        pad1 = 0
        transpose = None

    def local_fn(x):
        for a in axes:
            if a != shard_axis:
                x = _apply_along(fns[a], x, a)
        if swap is not None:
            x = _sharded_axis_fft(
                x, transpose=transpose, axis_name=axis_name,
                shard_axis=shard_axis, swap=swap,
                n_shard=shape[shard_axis], pad0=pad0,
                n_swap=shape[swap], pad1=pad1,
                fn_shard=fns[shard_axis], skip_back=transposed_out)
        return x

    out_axis = swap if (swap is not None and transposed_out) else shard_axis
    out_spec = P(*[axis_name if i == out_axis else None
                   for i in range(ndim)])
    crop_ax, crop_n = out_axis, shape[out_axis]
    pre, post = _ragged_pre_post(
        ndim, shard_axis, pad0, crop_ax, crop_n,
        out_padded=(pad0 and out_axis == shard_axis)
        or (swap is not None and pad1 and out_axis == swap))
    return DistPlan(local_fn, mesh, in_spec, out_spec, shape,
                    f"r2r-slab[{transpose_method}]"
                    + ("-ragged" if pad0 or pad1 else ""),
                    pre=pre, post=post)


# ---------------------------------------------------------------------------
# pencil decomposition: 3-D FFT over a 2-D mesh.  No FFTW analog (FFTW-MPI
# is slab-only); pencils keep scaling past P > n0 devices, where a slab
# runs out of planes to give each device.
# ---------------------------------------------------------------------------

def plan_dft_pencil(shape: Sequence[int], mesh: Mesh,
                    axis_names: Tuple[str, str] = ("y", "z"),
                    sign: int = K.FORWARD, flags: int = K.ESTIMATE,
                    dtype="complex64",
                    transpose_method: str = "all_to_all") -> DistPlan:
    """3-D c2c DFT with the array pencil-distributed over a 2-D mesh.

    Input (n0, n1, n2) sharded P(y, z, None): each device owns an
    (n0/Py, n1/Pz, n2) pencil.  Three local 1-D FFT passes separated by two
    single-mesh-axis global transposes; output sharded P(None, y, z)
    (the transposed-out layout; chain a plan_transpose to restore).
    """
    from .. import planner as planner_mod
    from ..ops import c2c as c2c_ops

    shape = tuple(shape)
    if len(shape) != 3:
        raise ValueError("pencil decomposition is for rank-3 transforms")
    ay, az = axis_names
    py, pz = mesh.shape[ay], mesh.shape[az]
    n0, n1, n2 = shape
    if n0 % py or n1 % pz or n1 % py or n2 % pz:
        raise ValueError(f"pencil needs {py} | n0, {py} | n1, {pz} | n1, "
                         f"{pz} | n2; got {shape}")
    rdtype = np.float32 if np.dtype(dtype) in (np.float32, np.complex64) \
        else np.float64
    patience = K.patience_of_flags(flags)
    pl = planner_mod.the_planner
    # resolve per mesh axis ("measure" times each axis independently)
    transposes = {name: _resolve_transpose(transpose_method, mesh, name,
                                           shape, np.complex64)
                  for name in (ay, az)}

    def transpose(x, name, split_axis, concat_axis):
        return transposes[name](x, name, split_axis, concat_axis)

    fns = [c2c_ops.build_c2c(pl.plan_c2c(n, rdtype, patience), sign, rdtype)
           for n in shape]

    in_spec = P(ay, az, None)
    out_spec = P(None, ay, az)

    def local_fn(x):
        # local (n0/Py, n1/Pz, n2): axis 2 complete
        x = fns[2](x)
        # unshard axis 1 over z, scatter axis 2 -> (n0/Py, n1, n2/Pz)
        x = transpose(x, az, split_axis=2, concat_axis=1)
        x = _apply_along(fns[1], x, 1)
        # unshard axis 0 over y, scatter axis 1 -> (n0, n1/Py, n2/Pz)
        x = transpose(x, ay, split_axis=1, concat_axis=0)
        x = _apply_along(fns[0], x, 0)
        return x

    return DistPlan(local_fn, mesh, in_spec, out_spec, shape,
                    f"pencil[{transpose_method}]")
