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

Comms accounting (``comms_accounting()``) records every forward
collective with the JAX shims' formulas, per device, on the payload it
sends: an all-gather ``(P - 1) * bytes`` (P - 1 remote shards arrive),
an all-reduce (``psum``, ``pmean``, ``pmax``) ``2 (P - 1) / P * bytes``
(the ring algorithm). Keys are
``(op, axis)`` with the axis ``"data"``, as in the JAX package, so a
step's ``delta`` compares with the JAX step's. Backward collectives are
not recorded, as the shims do not record them either.
"""

from __future__ import annotations

import datetime
import os
import threading

import torch
import torch.distributed as dist

from ..utils.capability import resolve_device

__all__ = ["AXIS", "CommsAccounting", "all_gather", "comms_accounting",
           "init_from_env", "init_from_file", "local_row_gids", "pmax",
           "pmean", "pmean_", "process_info", "psum", "rank", "shutdown",
           "world_size"]

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

    def record(self, op: str, axis: str, nbytes: float,
               calls: int = 1) -> None:
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
