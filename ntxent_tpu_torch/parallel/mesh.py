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

Comms accounting (``comms_accounting()``) records every forward
collective with the JAX shims' formulas, per device, on the payload it
sends: an all-gather ``(P - 1) * bytes`` (P - 1 remote shards arrive),
an all-reduce (``psum``, ``pmean``, ``pmax``) ``2 (P - 1) / P * bytes``
(the ring algorithm), a ``ppermute`` the full payload of each hop (at
P = 1 too, as the shim records it), an ``all_to_all`` ``(P - 1) / P *
bytes``. Keys are
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

__all__ = ["AXIS", "CommsAccounting", "all_gather", "all_to_all",
           "chunk_bounds", "comms_accounting", "init_from_env",
           "init_from_file", "local_row_gids", "pmax", "pmean", "pmean_",
           "ppermute", "ppermute_chunked", "ppermute_start", "process_info",
           "psum", "rank", "shutdown", "world_size", "world_topology"]

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
    earlier ``totals()``: bracket a step with the two."""

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

    def record(self, op: str, axis: str, nbytes: float,
               calls: int = 1) -> None:
        if getattr(self._paused, "depth", 0):
            return
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


def _nbytes(tensors) -> float:
    return float(sum(t.numel() * t.element_size() for t in tensors))


def _record_all_reduce(op: str, tensors, group) -> None:
    p = world_size(group)
    _comms.record(op, AXIS, 2.0 * (p - 1) / p * _nbytes(tensors))


# ---------------------------------------------------------------------------
# Differentiable collectives
# ---------------------------------------------------------------------------


def _require_group() -> None:
    if not dist.is_initialized():
        raise RuntimeError("no process group: call init_from_env or "
                           "init_from_file first")


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


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        parts = [torch.empty_like(x) for _ in range(world_size(group))]
        dist.all_gather(parts, x, group=group)
        return torch.cat(parts, dim=0)

    @staticmethod
    def backward(ctx, g):
        return _reduce_scatter(g.contiguous(), ctx.group), None


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, mean):
        ctx.group, ctx.mean = group, mean
        return _all_reduce(x, group, mean)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group, ctx.mean), None, None


def _all_reduce(x: torch.Tensor, group, mean: bool) -> torch.Tensor:
    y = x.clone(memory_format=torch.contiguous_format)
    dist.all_reduce(y, group=group)
    return y / world_size(group) if mean else y


def all_gather(x: torch.Tensor, group=None) -> torch.Tensor:
    """(n, ...) per rank -> (P n, ...), ranks in order along dim 0
    (``lax.all_gather(..., tiled=True)``); differentiable."""
    _require_group()
    _comms.record("all_gather", AXIS, (world_size(group) - 1) * _nbytes([x]))
    return _AllGather.apply(x.contiguous(), group)


def psum(x: torch.Tensor, group=None, op: str = "psum") -> torch.Tensor:
    """Sum over ranks; differentiable. ``op`` names it in the accounting."""
    _require_group()
    _record_all_reduce(op, [x], group)
    return _AllReduce.apply(x, group, False)


@torch.no_grad()
def pmax(x: torch.Tensor, group=None) -> torch.Tensor:
    """Elementwise maximum over ranks (an all-reduce with ``MAX``, which
    gloo and NCCL both run); not differentiable."""
    _require_group()
    _record_all_reduce("pmax", [x], group)
    y = x.clone(memory_format=torch.contiguous_format)
    dist.all_reduce(y, op=dist.ReduceOp.MAX, group=group)
    return y


def pmean(x: torch.Tensor, group=None, op: str = "pmean") -> torch.Tensor:
    """Mean over ranks (``psum / P``); differentiable. ``op`` names it in
    the accounting (cross-replica BatchNorm records ``"bn_pmean"``:
    flax's BatchNorm calls ``lax.pmean`` itself, past the shims)."""
    _require_group()
    _record_all_reduce(op, [x], group)
    return _AllReduce.apply(x, group, True)


@torch.no_grad()
def pmean_(tensors, group=None, op: str = "pmean") -> None:
    """Replace each fp32 tensor by its mean over ranks, in place, with one
    all-reduce of their concatenation (one accounted call, as the JAX
    shim's pmean of a pytree)."""
    tensors = list(tensors)
    _require_group()
    if any(t.dtype != torch.float32 for t in tensors):
        raise TypeError("pmean_ takes float32 tensors")
    _record_all_reduce(op, tensors, group)
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat, group=group)
    flat /= world_size(group)
    offset = 0
    for t in tensors:
        t.copy_(flat[offset:offset + t.numel()].view_as(t))
        offset += t.numel()


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
    arrived, one tensor for each one sent, its slices joined again."""

    def __init__(self, works, received, bounds, dim):
        self._works, self._received = works, received
        self._bounds, self._dim = bounds, dim

    def wait(self) -> list[torch.Tensor]:
        for work in self._works:
            work.wait()
        parts = iter(self._received)
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


def ppermute_start(tensors, perm_or_shift=1, group=None,
                   record: bool = True, chunks: int = 1,
                   dim: int = 0) -> PermuteHandle:
    """Issue one hop of each tensor (see ``ppermute``) and return at once;
    ``wait()`` on the handle gives the tensors that arrived. A rank that
    receives nothing gets zeros, as from ``lax.ppermute``. ``chunks``
    sends each tensor as that many contiguous slices along ``dim``
    (``chunk_bounds``). ``record`` adds each slice's payload to the
    accounting (``"ppermute"``, one call each)."""
    bounds = [chunk_bounds(t.shape[dim], chunks) for t in tensors]
    parts = [(t.narrow(dim, lo, hi - lo) if len(b) > 1 else t).contiguous()
             for t, b in zip(tensors, bounds) for lo, hi in b]
    if record:
        for t in parts:
            _comms.record("ppermute", AXIS, _nbytes([t]))
    dst, src = _peers(perm_or_shift, group)
    if world_size(group) == 1 or (dst == rank(group) and src == dst):
        return PermuteHandle([], parts if dst is not None else
                             [torch.zeros_like(t) for t in parts],
                             bounds, dim)
    _require_group()
    received = [torch.zeros_like(t) if src is None else torch.empty_like(t)
                for t in parts]
    ops = []
    for t, out in zip(parts, received):
        if dst is not None:
            ops.append(dist.P2POp(dist.isend, t, dist.get_global_rank(
                group, dst) if group is not None else dst, group))
        if src is not None:
            ops.append(dist.P2POp(dist.irecv, out, dist.get_global_rank(
                group, src) if group is not None else src, group))
    return PermuteHandle(dist.batch_isend_irecv(ops) if ops else [],
                         received, bounds, dim)


class _PPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, perm_or_shift, group, chunks, dim):
        ctx.args = (perm_or_shift, group, chunks, dim)
        return ppermute_start([x], perm_or_shift, group, chunks=chunks,
                              dim=dim).wait()[0]

    @staticmethod
    def backward(ctx, g):
        # the transpose of a hop is the inverse hop, not recorded (the
        # shims record no backward collective of JAX's AD)
        perm, group, chunks, dim = ctx.args
        return ppermute_start([g], _inverse(perm), group, record=False,
                              chunks=chunks, dim=dim).wait()[0], \
            None, None, None, None


def ppermute(x: torch.Tensor, perm_or_shift=1, group=None) -> torch.Tensor:
    """One ring hop (``lax.ppermute``): this rank's ``x`` goes to rank
    ``rank + shift`` (modulo P) and the tensor of ``rank - shift``
    arrives; or along the ``(source, destination)`` pairs of a
    permutation. Differentiable: the cotangent makes the inverse hop.
    Records the full payload (``"ppermute"``)."""
    return _PPermute.apply(x, perm_or_shift, group, 1, 0)


def ppermute_chunked(x: torch.Tensor, perm_or_shift=1, group=None,
                     chunks: int = 1, dim: int = 0) -> torch.Tensor:
    """One hop of ``x`` as ``chunks`` independent sends of contiguous
    slices along ``dim`` (``mesh.py:850``, which slices dim 0): the same
    bytes, one recorded call per slice; differentiable."""
    return _PPermute.apply(x, perm_or_shift, group, max(int(chunks or 1), 1),
                           dim)


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
    _comms.record("all_to_all", AXIS, (p - 1) / p * _nbytes([x]))
    return _AllToAll.apply(x, split_dim, concat_dim, group)
