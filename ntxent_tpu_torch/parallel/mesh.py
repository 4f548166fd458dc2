"""Process groups and collectives of the port's data-parallel path,
counterpart of the parts of ``ntxent_tpu/parallel/mesh.py`` it needs.

* ``init_from_env(device)``: the process group from ``torchrun``'s
  environment (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``,
  ``MASTER_PORT``); ``init_from_file(path, rank, world_size, device)``:
  the same over a ``torch.distributed.FileStore`` (no TCP port). NCCL on
  CUDA, gloo on the CPU; a CUDA rank runs on ``cuda:LOCAL_RANK``. A
  collective waits up to 10 minutes for the other ranks (``timeout``
  shortens it, as the tests do).
* ``process_info()`` (``mesh.py:1222``), ``local_row_gids`` (``:1205``).
* ``all_gather`` (tiled along dim 0), ``psum`` and ``pmean``
  (``:756, 772, 787``), differentiable: the backward of the all-gather is
  the reduce-scatter of the cotangent (gloo has none, so there it is an
  all-reduce and a slice: the same sum), that of ``psum`` a ``psum`` of the
  cotangents and that of ``pmean`` a ``pmean``. Each rank differentiates its
  own copy of a replicated value, so a gradient through ``psum`` is P times
  the rank's share, as it is under JAX's ``shard_map`` (its psum
  transposes to a psum); the train step's ``pmean`` of the gradients
  divides it back.
* ``pmax`` (``:893``): the maximum over ranks, not differentiable (the
  InfoNCE column-lse merge runs it inside a ``torch.autograd.Function``).
* ``pmean_(tensors)``: an in-place mean over ranks of a list of fp32
  tensors (gradients, BatchNorm statistics) in one all-reduce.
* ``ppermute(x, perm_or_shift, group)`` (``:807``): the ring hop, each
  rank sending to ``rank + shift`` (or along the ``(source, destination)``
  pairs of a permutation) over ``dist.batch_isend_irecv``; differentiable,
  its backward the inverse hop. ``ppermute_start`` issues the hop and
  returns a handle to wait on, so that a ring can send a block before it
  folds it. ``chunk_bounds`` and ``ppermute_chunked`` (``:836, 850``)
  split a hop into independent sends along one dimension. At P = 1 a hop
  is the identity, as JAX's ``ppermute`` with the permutation
  ``[(0, 0)]``.
* ``all_to_all(x, split_dim, concat_dim, group)`` (``:900``, tiled):
  differentiable, its backward the reverse all-to-all.
* ``psum_scatter(x, group)`` (``:866``, tiled, dim 0): the sum over
  ranks, this rank's tile; differentiable (its backward all-gathers).
* Megatron's two conjugate operators for tensor parallelism, which
  GSPMD inserts by itself in the JAX package: ``copy_to_group`` (the
  identity forward, a psum of the cotangent backward: the input of a
  column-sharded product) and ``reduce_from_group`` (a psum forward, the
  identity backward: the output of a row-sharded product); and
  ``split_rows`` (this rank's tile of dim 0 forward, an all-gather of the
  cotangent backward: a replicated activation handed to a loss whose
  rows spread over the group).
* ``init_distributed`` (``mesh.py:1138``): the process group of a
  ``torchrun`` environment, or of ``--coordinator``, ``--num-processes``
  and ``--process-id`` over TCP; ``grid_groups(outer, inner)``: the
  groups of a row-major 2-D grid of the ranks (the (data, model) grid of
  tensor parallelism, the ('dcn', 'data') grid of hybrid ZeRO).
* The wire policy (``parallel.precision.collective_precision``,
  ``:412-905``): ``all_gather``, ``psum``, ``pmean``, ``pmean_``,
  ``psum_scatter`` and the hops cast float payloads to bf16 or quantize
  eligible ones to int8 around the wire (see the section below);
  ``quantized_grad_reduce_(grads, residuals, group)`` (``:705``) is the
  int8 gradient all-reduce with error feedback.

Comms accounting (``comms_accounting()``) records every forward
collective with the JAX shims' formulas, per device, on the payload it
sends: an all-gather ``(P - 1) * bytes`` (P - 1 remote shards arrive),
an all-reduce (``psum``, ``pmean``, ``pmax``) ``2 (P - 1) / P * bytes``
(the ring algorithm), a ``ppermute`` the full payload of each hop (at
P = 1 too, as the shim records it), an ``all_to_all`` and a
``psum_scatter`` ``(P - 1) / P * bytes``, each at the dtype it rides the
wire in (an int8 payload and its float32 scales are two calls). Keys are
``(op, axis)`` with the axis ``"data"``, as in the JAX package, so a
step's ``delta`` compares with the JAX step's. Backward collectives are
not recorded, as the shims do not record them either.
"""

from __future__ import annotations

import datetime
import os
import contextlib
import threading

import torch
import torch.distributed as dist

from ..utils.capability import resolve_device
from .precision import (
    collective_dtype,
    int8_scale,
    quantizable,
    quantize_int8,
)

__all__ = ["AXIS", "CommsAccounting", "all_gather", "all_reduce_",
           "all_to_all", "chunk_bounds", "comms_accounting", "copy_to_group",
           "grid_groups", "init_distributed", "init_from_env",
           "init_from_file", "local_row_gids", "pmax", "pmean", "pmean_",
           "ppermute", "ppermute_chunked", "ppermute_start", "process_info",
           "psum", "psum_scatter", "quantized_grad_reduce",
           "quantized_grad_reduce_", "rank", "reduce_from_group",
           "shutdown", "split_rows", "transpose_wire", "world_size",
           "world_topology"]

AXIS = "data"  # the accounting's axis label: the JAX mesh's data axis
_TIMEOUT = datetime.timedelta(minutes=10)


def _rank_device(device, local_rank: int) -> torch.device:
    dev = resolve_device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", local_rank)
        torch.cuda.set_device(dev)
    return dev


def _backend(dev: torch.device) -> str:
    return "nccl" if dev.type == "cuda" else "gloo"


def init_from_env(device="cuda") -> torch.device:
    """Join the process group ``torchrun`` describes in the environment;
    returns this rank's device (``cuda:LOCAL_RANK``, or the CPU). A
    process that joined a group already keeps it."""
    if dist.is_initialized():
        return _rank_device(device, int(os.environ.get("LOCAL_RANK",
                                                       dist.get_rank())))
    try:
        rank_, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    except KeyError as e:
        raise RuntimeError(f"{e.args[0]} is not set: launch with torchrun, "
                           "or call init_from_file") from None
    dev = _rank_device(device, int(os.environ.get("LOCAL_RANK", rank_)))
    dist.init_process_group(_backend(dev), init_method="env://", rank=rank_,
                            world_size=world, timeout=_TIMEOUT)
    return dev


def init_from_file(path, rank: int, world_size: int, device="cuda",
                   timeout: datetime.timedelta = _TIMEOUT) -> torch.device:
    """Join a process group of ``world_size`` ranks that meet in the
    ``FileStore`` at ``path`` (a file no rank has used before); a CUDA
    rank runs on ``cuda:rank``. A collective that waits longer than
    ``timeout`` for the other ranks fails. Returns this rank's device."""
    dev = _rank_device(device, rank)
    store = dist.FileStore(str(path), world_size)
    dist.init_process_group(_backend(dev), store=store, rank=rank,
                            world_size=world_size, timeout=timeout)
    return dev


def init_distributed(coordinator: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None,
                     device="cuda") -> torch.device | None:
    """Join the multi-process world (``mesh.py:1138``, the mpirun role):
    ``torchrun``'s environment when it sets ``RANK`` and ``WORLD_SIZE``
    (it wins over the flags), else ``coordinator`` (``host:port`` of
    process 0) with ``num_processes`` and ``process_id`` over
    ``tcp://``; returns this rank's device. Without either, and outside
    a group, a single-process run: None (``num_processes`` and
    ``process_id`` alone are ignored, as JAX's rendezvous finds no
    cluster without a coordinator). A coordinator without them raises
    ``ValueError``."""
    if dist.is_initialized() or ("RANK" in os.environ
                                 and "WORLD_SIZE" in os.environ):
        return init_from_env(device)
    if coordinator is None:  # as jax.distributed's auto-detection fails
        return None
    if num_processes is None or process_id is None:
        raise ValueError("--coordinator needs --num-processes and "
                         "--process-id")
    if not 0 <= process_id < num_processes:
        raise ValueError(f"--process-id {process_id} outside [0, "
                         f"{num_processes})")
    dev = _rank_device(device, process_id)
    dist.init_process_group(_backend(dev), init_method=f"tcp://{coordinator}",
                            rank=process_id, world_size=num_processes,
                            timeout=_TIMEOUT)
    return dev


def grid_groups(outer: int, inner: int):
    """``(strided, contiguous)`` groups of this rank on the row-major
    ``(outer, inner)`` grid of the world's ranks (rank = o * inner + i):
    ``contiguous`` holds the ``inner`` ranks of this rank's row, ``strided``
    the ``outer`` ranks of its column. Every rank makes every group, in the
    same order, as ``dist.new_group`` requires."""
    _require_group()
    world, me = dist.get_world_size(), dist.get_rank()
    if outer * inner != world:
        raise ValueError(f"a ({outer}, {inner}) grid needs {outer * inner} "
                         f"ranks, the world has {world}")
    strided = contiguous = None
    for i in range(inner):
        g = dist.new_group([o * inner + i for o in range(outer)])
        if me % inner == i:
            strided = g
    for o in range(outer):
        g = dist.new_group([o * inner + i for i in range(inner)])
        if me // inner == o:
            contiguous = g
    return strided, contiguous


def shutdown() -> None:
    if dist.is_initialized():
        dist.destroy_process_group()


def world_size(group=None) -> int:
    return dist.get_world_size(group) if dist.is_initialized() else 1


def rank(group=None) -> int:
    return dist.get_rank(group) if dist.is_initialized() else 0


def process_info() -> dict:
    """Rank/world-size style info (what MPI_Comm_rank/size reported); one
    device per process."""
    return {"process_index": rank(), "process_count": world_size(),
            "local_device_count": 1, "global_device_count": world_size()}


def world_topology() -> dict:
    """The world a checkpoint is saved in or restored into, in the layout
    of ``mesh_topology`` (``ntxent_tpu/parallel/mesh.py:1287``):
    ``device_count`` (one device a rank: the world size), ``process_count``
    and the process group's ``backend`` (None outside one). The port's
    state is replicated on every rank, so it has no mesh shape or axis
    names (None, which the JAX package reads as "no mesh"), and a save
    at world P restores at world Q by plain placement."""
    return {"device_count": world_size(), "shape": None,
            "axis_names": None, "process_count": world_size(),
            "backend": dist.get_backend() if dist.is_initialized()
            else None}


def local_row_gids(rank_: int, n_local: int, world: int,
                   device=None) -> torch.Tensor:
    """Global row ids of one rank's rows in the stacked-view layout
    ``[view 1 of every rank; view 2 of every rank]`` (the order an
    all-gather and a concatenation give): rank d's view-1 rows are
    ``d n + [0, n)``, its view-2 rows ``N + d n + [0, n)``, N = n P."""
    base = rank_ * n_local + torch.arange(n_local, dtype=torch.int32,
                                          device=device)
    return torch.cat([base, n_local * world + base])


# ---------------------------------------------------------------------------
# Comms accounting
# ---------------------------------------------------------------------------


class CommsAccounting:
    """Host-side totals of collective traffic, ``{(op, axis): (calls,
    bytes)}``; thread-safe. ``delta(mark)`` is the traffic since an
    earlier ``totals()``: bracket a step with the two. Every record also
    bumps the registry counters ``collective_calls_total`` and
    ``collective_bytes_total`` ``{op, axis}`` and, given the wire dtype,
    their ``{op, axis, dtype}`` twins (``mesh.py:225-290``): the series
    without the dtype label keep the totals, the labelled ones itemize
    them, so a sum over the whole family counts everything twice."""

    def __init__(self):
        self._lock = threading.Lock()
        self._totals: dict[tuple[str, str], list[float]] = {}
        self._paused = threading.local()

    @contextlib.contextmanager
    def paused(self):
        """Record nothing on this thread inside the block: a
        rematerialized forward repeats its collectives in the backward,
        which the JAX shims, recording at trace time, count once."""
        depth = getattr(self._paused, "depth", 0)
        self._paused.depth = depth + 1
        try:
            yield
        finally:
            self._paused.depth = depth

    @staticmethod
    def _counters(op: str, axis: str, dtype: str | None = None):
        from ..obs.registry import default_registry

        labels = {"op": op, "axis": axis}
        if dtype is not None:
            labels["dtype"] = dtype
        registry = default_registry()
        return (registry.counter(
                    "collective_calls_total",
                    "collective ops issued (forward call sites)",
                    labels=labels),
                registry.counter(
                    "collective_bytes_total",
                    "bytes moved per device by collectives (ring model)",
                    labels=labels))

    def record(self, op: str, axis: str, nbytes: float,
               calls: int = 1, dtype: str | None = None) -> None:
        if getattr(self._paused, "depth", 0):
            return
        counters = [self._counters(op, axis)]
        if dtype is not None:
            counters.append(self._counters(op, axis, dtype))
        for calls_c, bytes_c in counters:
            calls_c.inc(calls)
            bytes_c.inc(nbytes)
        with self._lock:
            entry = self._totals.setdefault((op, axis), [0, 0.0])
            entry[0] += calls
            entry[1] += nbytes

    def totals(self) -> dict[tuple[str, str], tuple[int, float]]:
        with self._lock:
            return {k: (int(v[0]), float(v[1]))
                    for k, v in self._totals.items()}

    def delta(self, mark: dict) -> dict[tuple[str, str], tuple[int, float]]:
        out = {}
        for key, (calls, nbytes) in self.totals().items():
            c0, b0 = mark.get(key, (0, 0.0))
            if calls - c0 or nbytes - b0:
                out[key] = (calls - c0, nbytes - b0)
        return out


_comms = CommsAccounting()


def comms_accounting() -> CommsAccounting:
    """The process-wide collective-traffic totals."""
    return _comms


def _record(op: str, tensors, factor: float, wire: str = "float32",
            axis: str = AXIS) -> None:
    """Record one collective of the payload ``tensors`` at ``factor``
    times their bytes as they ride the wire (float tensors as bf16 under a
    bf16 wire), labelled with that dtype (``mixed`` when they differ) and
    the mesh axis ``axis`` of its group."""
    def dtype(t: torch.Tensor) -> torch.dtype:
        return torch.bfloat16 if wire == "bf16" and t.is_floating_point() \
            else t.dtype

    nbytes = sum(t.numel() * dtype(t).itemsize for t in tensors)
    names = {str(dtype(t)).removeprefix("torch.") for t in tensors}
    _comms.record(op, axis, factor * nbytes,
                  dtype=names.pop() if len(names) == 1 else "mixed")


def _record_int8(shape, op: str, factor: float) -> None:
    """Record an int8 payload of ``shape`` and its float32 scales, one per
    row of the last axis, as two calls."""
    numel = 1
    for d in shape:
        numel *= int(d)
    rows = numel // int(shape[-1]) if numel else 0
    _comms.record(op, AXIS, factor * numel, dtype="int8")
    _comms.record(op, AXIS, factor * rows * 4, dtype="float32")


def _record_all_reduce(op: str, tensors, group, wire: str = "float32",
                       axis: str = AXIS) -> None:
    p = world_size(group)
    _record(op, tensors, 2.0 * (p - 1) / p, wire, axis)


# ---------------------------------------------------------------------------
# The wire policy (``parallel.precision``)
# ---------------------------------------------------------------------------
#
# Under ``collective_precision("bf16")`` float payloads are cast to
# bfloat16 around the wire, under ``"int8"`` eligible payloads are
# quantized (``precision.quantize_int8``). The accounting records what
# rides the wire (int8 payloads and their float32 scales, or bf16) under
# the collective's own name. The backward of a quantized gather or hop
# is the full-precision transpose of the float one (a straight-through
# estimator); that of a bf16 one is the bf16 transpose, as JAX's AD of
# the casts gives. The int8 all-reduce is the two-phase schedule
# (``mesh.py:551``): quantize the P chunks of every leaf, all-to-all,
# dequantize and sum in float32, quantize the summed chunk again,
# all-gather: four wire collectives however many leaves ride it, at the
# int8 share of a float ring all-reduce at every P. ``pmax`` never
# quantizes; small, integer and scalar payloads ride in full precision.


def _require_group() -> None:
    if not dist.is_initialized():
        raise RuntimeError("no process group: call init_from_env or "
                           "init_from_file first")


def _to_wire(x: torch.Tensor, wire: str) -> torch.Tensor:
    return x.to(torch.bfloat16) if wire == "bf16" \
        and x.is_floating_point() else x


def _int8_gather(x: torch.Tensor, group) -> torch.Tensor:
    """Every rank's ``x`` quantized per row, all-gathered with its scales
    and dequantized: ``cat([rank 0's, rank 1's, ...])`` in float32."""
    p = world_size(group)
    q, s = quantize_int8(x)
    qg, sg = [torch.empty_like(q) for _ in range(p)], \
        [torch.empty_like(s) for _ in range(p)]
    dist.all_gather(qg, q, group=group)
    dist.all_gather(sg, s, group=group)
    return torch.cat([a.float() * b for a, b in zip(qg, sg)])


def _reduce_scatter(g: torch.Tensor, group) -> torch.Tensor:
    """Sum ``g`` over ranks and keep this rank's tile of dim 0."""
    p, r = world_size(group), rank(group)
    n = g.shape[0] // p
    if dist.get_backend(group) == "nccl":
        out = torch.empty((n, *g.shape[1:]), dtype=g.dtype, device=g.device)
        dist.reduce_scatter_tensor(out, g, group=group)
        return out
    total = g.clone()
    dist.all_reduce(total, group=group)
    return total[r * n:(r + 1) * n].contiguous()


def _gather_transpose(g: torch.Tensor, group, wire: str) -> torch.Tensor:
    """The backward of a tiled all-gather: the reduce-scatter of the
    cotangent, in bf16 under a bf16 wire, else in full precision (the
    straight-through estimator of the int8 gather)."""
    if wire == "bf16":
        return _reduce_scatter(g.to(torch.bfloat16).contiguous(),
                               group).to(g.dtype)
    return _reduce_scatter(g.contiguous(), group)


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, wire):
        ctx.group, ctx.wire = group, wire
        if wire == "int8":
            return _int8_gather(x, group).to(x.dtype)
        xw = _to_wire(x, wire)
        parts = [torch.empty_like(xw) for _ in range(world_size(group))]
        dist.all_gather(parts, xw, group=group)
        return torch.cat(parts, dim=0).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        return _gather_transpose(g, ctx.group, ctx.wire), None, None


def all_gather(x: torch.Tensor, group=None) -> torch.Tensor:
    """(n, ...) per rank -> (P n, ...), ranks in order along dim 0
    (``lax.all_gather(..., tiled=True)``); differentiable. Under int8 an
    eligible ``x`` is quantized per row (``_int8_gather``,
    ``mesh.py:486``), under bf16 cast."""
    _require_group()
    wire = collective_dtype()
    factor = world_size(group) - 1
    if wire == "int8" and quantizable(x):
        _record_int8(x.shape, "all_gather", factor)
    else:
        wire = "bf16" if wire == "bf16" else "float32"
        _record("all_gather", [x], factor, wire)
    return _AllGather.apply(x.contiguous(), group, wire)


# -- all-reduces --------------------------------------------------------------


class _Plan:
    """The gather maps of the two-phase schedule for leaves of ``counts``
    elements over P ranks (``_qallreduce_leaves``, ``mesh.py:551``):
    leaf i is cut into P chunks of ``c_i = ceil(n_i / P)`` elements (the
    last padded with zeros) that sit side by side in its column block of
    a (P, C) buffer, one scale a (chunk, leaf). ``orders[i]`` (None:
    row-major) lists the elements of leaf i in the order the JAX package
    flattens its leaf, the flax layout, so the chunks hold the same
    elements. ``src`` gathers the buffer from the leaves' concatenation
    (a zero appended for the padding), ``dst`` gathers each element back
    from a (P, C) result, ``owner`` is each column's leaf."""

    def __init__(self, counts, orders, p: int, device):
        cs = [-(-n // p) for n in counts]
        total, width = sum(counts), sum(cs)
        src = torch.full((p, width), total, dtype=torch.long)
        dst = torch.empty(total, dtype=torch.long)
        if p * width > torch.iinfo(torch.int32).max:
            raise ValueError(f"{total} values do not fit the int32 indices "
                             "of the int8 all-reduce")
        off = col = 0
        for n, c, order in zip(counts, cs, orders):
            order = torch.arange(n) if order is None else order.long().cpu()
            block = torch.full((p * c,), total, dtype=torch.long)
            block[:n] = off + order
            src[:, col:col + c] = block.view(p, c)
            at = torch.empty(n, dtype=torch.long)  # element k's position
            at[order] = torch.arange(n)
            dst[off:off + n] = (at // c) * width + col + at % c
            off, col = off + n, col + c
        self.counts, self.orders, self.segments = counts, orders, len(cs)
        # int32 indices: half the bytes of int64 to hold and to read
        self.src = src.to(device=device, dtype=torch.int32)
        self.dst = dst.to(device=device, dtype=torch.int32)
        self.owner = torch.repeat_interleave(
            torch.arange(len(cs), dtype=torch.int32),
            torch.tensor(cs)).to(device)
        # each row's segment lengths, for the buffer of p rows and the
        # summed row of phase 2
        self.lengths = {rows: torch.tensor(cs * rows, device=device)
                        for rows in {1, p}}


_PLANS: dict[tuple, _Plan] = {}
_MAX_PLANS = 4  # a plan's indices take ~1.5x the gradients' bytes


def _plan(counts, orders, p: int, device) -> _Plan:
    """The cached plan of these leaves; the oldest of more than
    ``_MAX_PLANS`` is dropped (a restarted run brings new orders)."""
    orders = list(orders) if orders is not None else [None] * len(counts)
    key = (tuple(counts), tuple(map(id, orders)), p, str(device))
    if key not in _PLANS:  # the plan holds the orders, so no id is reused
        while len(_PLANS) >= _MAX_PLANS:
            _PLANS.pop(next(iter(_PLANS)))
        _PLANS[key] = _Plan(counts, orders, p, device)
    return _PLANS[key]


def _segment_quantize(buf: torch.Tensor, plan: _Plan):
    """``quantize_int8`` of each (row, leaf) segment of ``buf`` (rows, C)
    at once: the segments' amax by one ``segment_reduce`` (the segments
    are contiguous runs of the row-major buffer; NaN propagates, as in
    ``jnp.max``; a ``scatter_reduce`` into a few hundred outputs would
    serialize on its atomics), the same scale and rounding, so the bits
    equal one ``quantize_int8`` a segment. Returns (q, scales (rows,
    segments))."""
    rows = buf.shape[0]
    amax = torch.segment_reduce(buf.abs().reshape(-1), "max",
                                lengths=plan.lengths[rows], unsafe=True)
    scale = int8_scale(amax.view(rows, plan.segments))
    q = torch.clamp(torch.round(buf / scale.index_select(1, plan.owner)),
                    -127.0, 127.0).to(torch.int8)
    return q, scale


def _gather_rows(x: torch.Tensor, group) -> torch.Tensor:
    """(1, ...) per rank -> (P, ...), ranks in order."""
    if world_size(group) == 1:
        return x
    parts = [torch.empty_like(x) for _ in range(world_size(group))]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts)


def _q_allreduce(flat: torch.Tensor, counts, group, op: str, orders=None):
    """(sum over ranks, this rank's phase-1 compression error), both
    float32 in the layout of ``flat``, the concatenation of leaves of
    ``counts`` elements: the two-phase int8 all-reduce of every leaf at
    once (``_qallreduce_leaves``, ``mesh.py:551``), four wire collectives
    in all, one scale a (rank chunk, leaf) (``_Plan``). The error
    ``v - deq(q(v))`` is the term error feedback carries."""
    p = world_size(group)
    plan = _plan(counts, orders, p, flat.device)
    buf = torch.cat([flat.float(), flat.new_zeros(1, dtype=torch.float32)])
    buf = buf.index_select(0, plan.src.view(-1)).view(p, -1)  # (p, C)
    owner = plan.owner
    q, s = _segment_quantize(buf, plan)
    err = buf - q.float() * s.index_select(1, owner)
    _record(op, [q], (p - 1) / p)
    _record(op, [s], (p - 1) / p)
    qx = _all_to_all(q, 0, 0, group)      # row d: rank d's chunk for me
    sx = _all_to_all(s, 0, 0, group)
    seg = (qx.float() * sx.index_select(1, owner)).sum(dim=0)
    q2, s2 = _segment_quantize(seg[None], plan)
    _record(op, [q2[0]], p - 1)
    _record(op, [s2[0]], p - 1)
    qg, sg = _gather_rows(q2, group), _gather_rows(s2, group)
    full = qg.float() * sg.index_select(1, owner)            # (p, C)
    return (full.reshape(-1).index_select(0, plan.dst),
            err.reshape(-1).index_select(0, plan.dst))


def _all_reduce(x: torch.Tensor, group, mean: bool,
                wire: str = "float32") -> torch.Tensor:
    """Sum (or mean) over ranks of ``x`` at the wire dtype, in ``x``'s
    dtype (a bf16 mean divides in bf16, as ``lax.pmean`` of a bf16 leaf
    does)."""
    y = _to_wire(x, wire).clone(memory_format=torch.contiguous_format)
    dist.all_reduce(y, group=group)
    return (y / world_size(group) if mean else y).to(x.dtype)


class _AllReduce(torch.autograd.Function):
    """``psum``/``pmean``; the backward is the same reduction of the
    cotangent at the same wire dtype (JAX's psum transposes to a psum
    under ``shard_map``)."""

    @staticmethod
    def forward(ctx, x, group, mean, wire):
        ctx.group, ctx.mean, ctx.wire = group, mean, wire
        return _all_reduce(x, group, mean, wire)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group, ctx.mean, ctx.wire), None, None, \
            None


class _Int8AllReduce(torch.autograd.Function):
    """The int8 ``psum``/``pmean`` of one leaf (``_int8_reduce``,
    ``mesh.py:621``); its backward passes the cotangent through (divided
    by P for a mean), the rule of the JAX ``custom_vjp``."""

    @staticmethod
    def forward(ctx, x, group, mean, op):
        ctx.p, ctx.mean = world_size(group), mean
        out = _q_allreduce(x.reshape(-1), [x.numel()], group, op)[0]
        return (out / ctx.p if mean else out).view_as(x).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        return (g / ctx.p if ctx.mean else g), None, None, None


def _reduce(x: torch.Tensor, group, mean: bool, op: str) -> torch.Tensor:
    _require_group()
    wire = collective_dtype()
    if wire == "int8" and quantizable(x):
        return _Int8AllReduce.apply(x, group, mean, op)
    wire = "bf16" if wire == "bf16" else "float32"
    _record_all_reduce(op, [x], group, wire)
    return _AllReduce.apply(x, group, mean, wire)


def psum(x: torch.Tensor, group=None, op: str = "psum") -> torch.Tensor:
    """Sum over ranks; differentiable; at the policy's wire dtype. ``op``
    names it in the accounting."""
    return _reduce(x, group, False, op)


def pmean(x: torch.Tensor, group=None, op: str = "pmean") -> torch.Tensor:
    """Mean over ranks (``psum / P``); differentiable; at the policy's
    wire dtype. ``op`` names it in the accounting (cross-replica
    BatchNorm records ``"bn_pmean"`` and rides float32 under any policy:
    flax's BatchNorm calls ``lax.pmean`` itself, past the shims)."""
    return _reduce(x, group, True, op)


@torch.no_grad()
def pmax(x: torch.Tensor, group=None) -> torch.Tensor:
    """Elementwise maximum over ranks (an all-reduce with ``MAX``, which
    gloo and NCCL both run); not differentiable, never quantized."""
    _require_group()
    _record_all_reduce("pmax", [x], group)
    y = x.clone(memory_format=torch.contiguous_format)
    dist.all_reduce(y, op=dist.ReduceOp.MAX, group=group)
    return y


def _flatten(tensors) -> torch.Tensor:
    return torch.cat([t.reshape(-1) for t in tensors])


def _write_back(tensors, flat: torch.Tensor) -> None:
    """Copy the concatenation ``flat`` back into ``tensors``."""
    parts = flat.split([t.numel() for t in tensors])
    torch._foreach_copy_(tensors, [v.view_as(t)
                                   for t, v in zip(tensors, parts)])


@torch.no_grad()
def _flat_all_reduce(tensors, group, mean: bool, op: str,
                     wire: str) -> None:
    """One all-reduce of the concatenation of ``tensors``, in place."""
    flat = _to_wire(_flatten(tensors), wire)
    _record_all_reduce(op, [flat], group)
    dist.all_reduce(flat, group=group)
    if mean:
        flat /= world_size(group)
    _write_back(tensors, flat)


def _split_eligible(tensors, orders):
    """(eligible tensors, their orders, the rest): int8 takes float
    tensors of at least ``MIN_QUANT_ELEMS`` elements."""
    orders = list(orders) if orders is not None else [None] * len(tensors)
    flags = [quantizable(t) for t in tensors]
    return ([t for t, f in zip(tensors, flags) if f],
            [o for o, f in zip(orders, flags) if f],
            [t for t, f in zip(tensors, flags) if not f])


@torch.no_grad()
def pmean_(tensors, group=None, op: str = "pmean", orders=None) -> None:
    """Replace each fp32 tensor by its mean over ranks, in place, as the
    JAX shim's pmean of a pytree does, at the policy's wire dtype: one
    all-reduce of their concatenation (bf16 under bf16); under int8 the
    eligible tensors share one two-phase schedule (``orders``: each
    tensor's elements in the JAX leaf's order, see ``_Plan``) and the
    rest one float32 all-reduce."""
    tensors = list(tensors)
    _require_group()
    if any(t.dtype != torch.float32 for t in tensors):
        raise TypeError("pmean_ takes float32 tensors")
    wire = collective_dtype()
    if wire != "int8":
        _flat_all_reduce(tensors, group, True, op,
                         "bf16" if wire == "bf16" else "float32")
        return
    elig, elig_orders, rest = _split_eligible(tensors, orders)
    if rest:
        _flat_all_reduce(rest, group, True, op, "float32")
    if elig:
        red, _ = _q_allreduce(_flatten(elig), [t.numel() for t in elig],
                              group, op, elig_orders)
        _write_back(elig, red / world_size(group))


@torch.no_grad()
def quantized_grad_reduce_(grads, residuals, group=None, mean: bool = True,
                           orders=None) -> None:
    """The int8 gradient all-reduce with error feedback
    (``quantized_grad_reduce``, ``mesh.py:705``), in place: each eligible
    gradient sends ``v = g + e`` through the two-phase schedule (all of
    them at once; ``orders`` as in ``pmean_``), becomes the reduced value
    (over P with ``mean``) and its residual ``e`` becomes ``v -
    deq(q(v))``, what compression dropped this step, carried into the
    next. The other gradients take one float32 all-reduce and keep their
    residuals. ``residuals`` are float32 tensors shaped like ``grads``."""
    grads, residuals = list(grads), list(residuals)
    _require_group()
    op = "pmean" if mean else "psum"
    index = {id(g): i for i, g in enumerate(grads)}
    elig, elig_orders, rest = _split_eligible(grads, orders)
    if rest:
        _flat_all_reduce(rest, group, mean, op, "float32")
    if not elig:
        return
    kept = [residuals[index[id(g)]] for g in elig]
    v = _flatten(elig).float() + _flatten(kept)
    reduced, err = _q_allreduce(v, [g.numel() for g in elig], group, op,
                                elig_orders)
    _write_back(elig, reduced / world_size(group) if mean else reduced)
    _write_back(kept, err)


def quantized_grad_reduce(grads, residuals, group=None, mean: bool = True,
                          orders=None):
    """``(reduced, new residuals)``: ``quantized_grad_reduce_`` on copies
    (``mesh.py:705``'s signature, with lists for pytrees)."""
    out = [g.detach().clone() for g in grads]
    new_e = [e.detach().clone() for e in residuals]
    quantized_grad_reduce_(out, new_e, group, mean, orders)
    return out, new_e


class _PsumScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, wire):
        ctx.group, ctx.wire = group, wire
        p = world_size(group)
        if wire == "int8":
            chunks = x.float().reshape(p, -1)
            q, s = quantize_int8(chunks)
            qx, sx = _all_to_all(q, 0, 0, group), _all_to_all(s, 0, 0, group)
            seg = (qx.float() * sx).sum(dim=0)
            return seg.reshape((x.shape[0] // p, *x.shape[1:])).to(x.dtype)
        return _reduce_scatter(_to_wire(x, wire).contiguous(),
                               group).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        wire = "bf16" if ctx.wire == "bf16" else "float32"
        return _AllGather.apply(g.contiguous(), ctx.group, wire), None, None


def psum_scatter(x: torch.Tensor, group=None) -> torch.Tensor:
    """The sum over ranks of ``x``, this rank's tile of dim 0
    (``lax.psum_scatter(..., scatter_dimension=0, tiled=True)``,
    ``mesh.py:866``): the reduce-scatter half of an all-reduce.
    Differentiable (the backward all-gathers the cotangent). Under int8
    an eligible ``x`` whose dim 0 divides over the ranks is quantized per
    destination chunk and all-to-all'd, phase 1 of the two-phase
    all-reduce (``_int8_scatter``)."""
    _require_group()
    p = world_size(group)
    if x.shape[0] % p:
        raise ValueError(f"psum_scatter: dim 0 of {tuple(x.shape)} does "
                         f"not split over {p} ranks")
    wire = collective_dtype()
    if wire == "int8" and quantizable(x):
        _record_int8((p, x.numel() // p), "psum_scatter", (p - 1) / p)
    else:
        wire = "bf16" if wire == "bf16" else "float32"
        _record("psum_scatter", [x], (p - 1) / p, wire)
    return _PsumScatter.apply(x, group, wire)


# ---------------------------------------------------------------------------
# Ring hops and the all-to-all
# ---------------------------------------------------------------------------


def _peers(perm_or_shift, group) -> tuple[int | None, int | None]:
    """(destination, source) of this rank's hop: ``rank + shift`` and
    ``rank - shift`` modulo P for an int, else the pairs of a
    permutation ``[(source, destination), ...]`` (None: no such peer)."""
    p, r = world_size(group), rank(group)
    if isinstance(perm_or_shift, int):
        return (r + perm_or_shift) % p, (r - perm_or_shift) % p
    pairs = [(int(a), int(b)) for a, b in perm_or_shift]
    if len({a for a, _ in pairs}) != len(pairs) \
            or len({b for _, b in pairs}) != len(pairs) \
            or any(not 0 <= x < p for pair in pairs for x in pair):
        raise ValueError(f"not a permutation of {p} ranks: {pairs}")
    dst = next((b for a, b in pairs if a == r), None)
    src = next((a for a, b in pairs if b == r), None)
    return dst, src


def _inverse(perm_or_shift):
    if isinstance(perm_or_shift, int):
        return -perm_or_shift
    return [(b, a) for a, b in perm_or_shift]


class PermuteHandle:
    """A hop in flight (``ppermute_start``): ``wait()`` returns what
    arrived, one tensor for each one sent, its slices dequantized (int8)
    or cast back (bf16) and joined again."""

    def __init__(self, works, received, bounds, dim, decode):
        self._works, self._received = works, received
        self._bounds, self._dim, self._decode = bounds, dim, decode

    def wait(self) -> list[torch.Tensor]:
        for work in self._works:
            work.wait()
        parts = iter(self._decode(self._received))
        return [torch.cat([next(parts) for _ in bounds], dim=self._dim)
                if len(bounds) > 1 else next(parts)
                for bounds in self._bounds]


def chunk_bounds(n: int, chunks: int) -> list[tuple[int, int]]:
    """``[lo, hi)`` bounds splitting ``n`` rows into ``chunks`` contiguous
    pieces, the remainder riding the leading ones (sizes differ by at most
    one; every piece non-empty)."""
    c = max(1, min(int(chunks), int(n))) if n else 1
    base, rem = divmod(int(n), c)
    bounds, lo = [], 0
    for i in range(c):
        hi = lo + base + (1 if i < rem else 0)
        bounds.append((lo, hi))
        lo = hi
    return bounds


def _encode(parts: list[torch.Tensor], wire: str):
    """(what rides the wire, the function that restores the parts from
    what arrived): int8 sends each eligible part as its quantized rows and
    their scales (``_int8_permute``, ``mesh.py:514``), bf16 casts."""
    if wire == "int8":
        plan = [quantizable(t) for t in parts]
        sent = []
        for t, quant in zip(parts, plan):
            sent += list(quantize_int8(t)) if quant else [t]
        dtypes = [t.dtype for t in parts]

        def decode(received):
            it, out = iter(received), []
            for quant, dtype in zip(plan, dtypes):
                out.append((next(it).float() * next(it)).to(dtype)
                           if quant else next(it))
            return out

        return sent, decode
    if wire == "bf16":
        dtypes = [t.dtype for t in parts]
        return ([_to_wire(t, wire) for t in parts],
                lambda received: [r.to(d) for r, d in zip(received, dtypes)])
    return parts, lambda received: received


def ppermute_start(tensors, perm_or_shift=1, group=None,
                   record: bool = True, chunks: int = 1,
                   dim: int = 0, wire: str | None = None) -> PermuteHandle:
    """Issue one hop of each tensor (see ``ppermute``) and return at once;
    ``wait()`` on the handle gives the tensors that arrived. A rank that
    receives nothing gets zeros, as from ``lax.ppermute``. ``chunks``
    sends each tensor as that many contiguous slices along ``dim``
    (``chunk_bounds``). ``wire`` (None: the policy of this thread) is the
    wire dtype of every slice. ``record`` adds each slice's wire payload
    to the accounting (``"ppermute"``, one call for each tensor sent:
    an int8 slice is two, its rows and its scales)."""
    bounds = [chunk_bounds(t.shape[dim], chunks) for t in tensors]
    parts = [(t.narrow(dim, lo, hi - lo) if len(b) > 1 else t).contiguous()
             for t, b in zip(tensors, bounds) for lo, hi in b]
    sent, decode = _encode(parts, collective_dtype() if wire is None
                           else wire)
    sent = [t.contiguous() for t in sent]
    if record:
        for t in sent:
            _record("ppermute", [t], 1.0)
    dst, src = _peers(perm_or_shift, group)
    if world_size(group) == 1 or (dst == rank(group) and src == dst):
        return PermuteHandle([], sent if dst is not None else
                             [torch.zeros_like(t) for t in sent],
                             bounds, dim, decode)
    _require_group()
    received = [torch.zeros_like(t) if src is None else torch.empty_like(t)
                for t in sent]
    ops = []
    for t, out in zip(sent, received):
        if dst is not None:
            ops.append(dist.P2POp(dist.isend, t, dist.get_global_rank(
                group, dst) if group is not None else dst, group))
        if src is not None:
            ops.append(dist.P2POp(dist.irecv, out, dist.get_global_rank(
                group, src) if group is not None else src, group))
    return PermuteHandle(dist.batch_isend_irecv(ops) if ops else [],
                         received, bounds, dim, decode)


def transpose_wire(wire: str) -> str:
    """The wire of a hop's transpose: bf16 for a bf16 hop (the transpose
    of the casts), float32 for an int8 one (the straight-through
    estimator)."""
    return "bf16" if wire == "bf16" else "float32"


class _PPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, perm_or_shift, group, chunks, dim, wire):
        ctx.args = (perm_or_shift, group, chunks, dim, wire)
        return ppermute_start([x], perm_or_shift, group, chunks=chunks,
                              dim=dim, wire=wire).wait()[0]

    @staticmethod
    def backward(ctx, g):
        # the transpose of a hop is the inverse hop, not recorded (the
        # shims record no backward collective of JAX's AD)
        perm, group, chunks, dim, wire = ctx.args
        return ppermute_start([g], _inverse(perm), group, record=False,
                              chunks=chunks, dim=dim,
                              wire=transpose_wire(wire)).wait()[0], \
            None, None, None, None, None


def ppermute(x: torch.Tensor, perm_or_shift=1, group=None) -> torch.Tensor:
    """One ring hop (``lax.ppermute``): this rank's ``x`` goes to rank
    ``rank + shift`` (modulo P) and the tensor of ``rank - shift``
    arrives; or along the ``(source, destination)`` pairs of a
    permutation. At the policy's wire dtype. Differentiable: the
    cotangent makes the inverse hop (``transpose_wire``). Records the
    full payload (``"ppermute"``)."""
    return _PPermute.apply(x, perm_or_shift, group, 1, 0, collective_dtype())


def ppermute_chunked(x: torch.Tensor, perm_or_shift=1, group=None,
                     chunks: int = 1, dim: int = 0) -> torch.Tensor:
    """One hop of ``x`` as ``chunks`` independent sends of contiguous
    slices along ``dim`` (``mesh.py:850``, which slices dim 0): the same
    bytes, one recorded call per slice, each slice on the wire policy by
    itself; differentiable."""
    return _PPermute.apply(x, perm_or_shift, group, max(int(chunks or 1), 1),
                           dim, collective_dtype())


def _all_to_all(x: torch.Tensor, split_dim: int, concat_dim: int,
                group) -> torch.Tensor:
    p = world_size(group)
    if p == 1:
        return x
    _require_group()
    if x.shape[split_dim] % p:
        raise ValueError(f"all_to_all: dim {split_dim} of {tuple(x.shape)} "
                         f"does not split over {p} ranks")
    parts = [t.contiguous() for t in x.chunk(p, dim=split_dim)]
    received = [torch.empty_like(t) for t in parts]
    dist.all_to_all(received, parts, group=group)
    return torch.cat(received, dim=concat_dim)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, split_dim, concat_dim, group):
        ctx.dims, ctx.group = (split_dim, concat_dim), group
        return _all_to_all(x, split_dim, concat_dim, group)

    @staticmethod
    def backward(ctx, g):
        split_dim, concat_dim = ctx.dims
        return (_all_to_all(g, concat_dim, split_dim, ctx.group), None, None,
                None)


def all_to_all(x: torch.Tensor, split_dim: int, concat_dim: int,
               group=None) -> torch.Tensor:
    """``lax.all_to_all(..., tiled=True)``: ``x`` is cut into P equal
    pieces along ``split_dim``, piece j goes to rank j, and the pieces
    that arrive are concatenated along ``concat_dim`` in rank order.
    Differentiable (the backward is the reverse all-to-all). Records
    ``(P - 1) / P`` of the payload (``"all_to_all"``)."""
    p = world_size(group)
    _record("all_to_all", [x], (p - 1) / p)
    return _AllToAll.apply(x, split_dim, concat_dim, group)


# ---------------------------------------------------------------------------
# Megatron's conjugate operators (tensor parallelism)
# ---------------------------------------------------------------------------


def _sum(x: torch.Tensor, group) -> torch.Tensor:
    y = x.clone(memory_format=torch.contiguous_format)
    dist.all_reduce(y, group=group)
    return y


@torch.no_grad()
def all_reduce_(x: torch.Tensor, group, op: str, axis: str = AXIS) -> None:
    """Sum ``x`` over the ranks of ``group`` in place, at full precision
    whatever the wire policy (a step's bookkeeping, not a payload the
    policy casts: LARS's squared norms of a sliced parameter). Recorded
    as the all-reduce ``op`` over ``axis``."""
    _require_group()
    _record_all_reduce(op, [x], group, axis=axis)
    dist.all_reduce(x, group=group)


class _CopyToGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, axis):
        ctx.group, ctx.axis = group, axis
        return x

    @staticmethod
    def backward(ctx, g):
        # the all-reduce Megatron's f issues in the backward: recorded
        # here, where it runs (a rematerialized forward has none)
        _record_all_reduce("tp_psum", [g], ctx.group, axis=ctx.axis)
        return _sum(g, ctx.group), None, None


class _ReduceFromGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _sum(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _SplitRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, axis):
        ctx.group, ctx.axis = group, axis
        p, r = world_size(group), rank(group)
        n = x.shape[0] // p
        return x[r * n:(r + 1) * n]

    @staticmethod
    def backward(ctx, g):
        p = world_size(ctx.group)
        _record("all_gather", [g], p - 1, axis=ctx.axis)
        parts = [torch.empty_like(g) for _ in range(p)]
        dist.all_gather(parts, g.contiguous(), group=ctx.group)
        return torch.cat(parts) / p, None, None


def copy_to_group(x: torch.Tensor, group, axis: str = "model"
                  ) -> torch.Tensor:
    """Megatron's ``f``: ``x`` itself forward; backward, the sum over the
    ranks of ``group`` of the cotangent (each rank's column shard of the
    next product contributes a part of it), recorded as a ``"tp_psum"``
    all-reduce over ``axis``. A group of one is the identity both ways."""
    if world_size(group) == 1:
        return x
    return _CopyToGroup.apply(x, group, axis)


def reduce_from_group(x: torch.Tensor, group, axis: str = "model"
                      ) -> torch.Tensor:
    """Megatron's ``g``: the sum over the ranks of ``group`` forward (the
    partial outputs of a row-sharded product); the cotangent passes
    through. Recorded as a ``"tp_psum"`` all-reduce over ``axis``."""
    if world_size(group) == 1:
        return x
    _record_all_reduce("tp_psum", [x], group, axis=axis)
    return _ReduceFromGroup.apply(x, group)


def split_rows(x: torch.Tensor, group, axis: str = "model") -> torch.Tensor:
    """This rank's tile of dim 0 of a value replicated over ``group``;
    backward, the all-gather of the tiles' cotangents divided by P (rows
    the rank does not hold get the other ranks' parts, so the replicated
    producer sees the whole gradient on every rank; a loss psum'd over P
    times more ranks gives each rank P times the cotangent, which the
    division takes back), recorded over ``axis``. Not a collective
    forward."""
    p = world_size(group)
    if x.shape[0] % p:
        raise ValueError(f"split_rows: dim 0 of {tuple(x.shape)} does not "
                         f"split over {p} ranks")
    if p == 1:
        return x
    return _SplitRows.apply(x, group, axis)
