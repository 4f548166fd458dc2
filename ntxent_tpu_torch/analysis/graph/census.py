"""Collective census: every collective the program RUNS, not just the
call sites the mesh helpers declare. The port's counterpart of
``ntxent_tpu/analysis/graph/census.py``.

The comms accounting (``parallel.mesh.comms_accounting``) records a
collective where a mesh helper is called, in the forward. Autograd's
collectives are invisible to it: the reduce-scatter behind an
all-gather's gradient, the all-reduce behind a ``psum``'s, the inverse
hops of a ring's backward, the second ring pass of the chunked
schedule. JAX finds those by walking the jaxpr; the port has no jaxpr,
but every ``torch.distributed`` call reaches the dispatcher as a
``torch.ops.c10d`` op, with its payload tensors, their dtypes and its
process group. ``CollectiveCensus`` is a ``TorchDispatchMode`` that
records each one while the program runs, backward included (the mode is
part of the thread-local state autograd carries to its device threads).

Each op is named by its canonical (JAX) op and priced with the same ring
formulas (``RING_FACTORS``) at the payload's real dtype and the group's
size:

* ``allreduce_`` / ``allreduce_coalesced_`` -> ``psum`` (a ``pmean`` is
  a ``psum`` on the wire), or ``pmax``/``pmin`` when its ``ReduceOp``
  argument is MAX/MIN, as JAX's census names them;
* ``allgather_`` / ``_allgather_base_`` / ``allgather_coalesced_`` /
  ``allgather_into_tensor_coalesced_`` -> ``all_gather`` (payload: the
  input shard);
* ``reduce_scatter_`` / ``_reduce_scatter_base_`` /
  ``reduce_scatter_tensor_coalesced_`` -> ``psum_scatter`` (payload: the
  full pre-scatter buffer);
* ``alltoall_`` / ``alltoall_base_`` -> ``all_to_all``;
* ``send`` -> ``ppermute``; ``recv_`` is not counted (the sender pays);
* ``barrier``, ``monitored_barrier_`` and ``broadcast_`` (the port's
  broadcasts are control plane: stop flags, ``broadcast_object_list``)
  are listed at 0 bytes.

A ``c10d`` op outside these sets is an error, never a silent skip (NCCL
and gloo spell some ops differently; a new spelling must be priced).

There is no ``hlo_census`` counterpart: no compiler inserts collectives
in the port. Its tensor-parallel and ZeRO-3 collectives are explicit
mesh helpers (``parallel/tp.py``, ``parallel/shards.py``) that the
dispatch mode sees like any other, so ``source="gspmd"`` stays at 0.

Unlike JAX's trace-only census, this one runs the callable: its
collectives really move, so every rank of the group must run it at once.
"""

from __future__ import annotations

import dataclasses
import math
import threading

__all__ = [
    "CensusEntry",
    "CensusError",
    "CollectiveCensus",
    "RING_FACTORS",
    "census_bytes",
    "census_of_callable",
    "census_totals",
    "declared_wire_totals",
    "graph_remainder",
    "publish_graph_census",
    "wire_totals",
]

# Ring-algorithm per-device byte factors, keyed by the CANONICAL op
# name. Payload B is the op's summed payload bytes; P the group size.
# Equal to the formulas of parallel/mesh.py (tests/test_torch_graph_
# audit.py holds census totals to the declared accounting).
RING_FACTORS = {
    "all_gather": lambda b, p: (p - 1) * b,
    "psum": lambda b, p: 2.0 * (p - 1) / p * b,
    "pmax": lambda b, p: 2.0 * (p - 1) / p * b,
    "pmin": lambda b, p: 2.0 * (p - 1) / p * b,
    "psum_scatter": lambda b, p: (p - 1) / p * b,
    "all_to_all": lambda b, p: (p - 1) / p * b,
    "ppermute": lambda b, p: float(b),
}

# c10d op name -> (canonical op, index of the payload argument)
_C10D_TO_OP = {
    "allreduce_": ("psum", 0),
    "allreduce_coalesced_": ("psum", 0),
    "allgather_": ("all_gather", 1),
    "_allgather_base_": ("all_gather", 1),
    "allgather_coalesced_": ("all_gather", 1),
    "allgather_into_tensor_coalesced_": ("all_gather", 1),
    "reduce_scatter_": ("psum_scatter", 1),
    "_reduce_scatter_base_": ("psum_scatter", 1),
    "reduce_scatter_tensor_coalesced_": ("psum_scatter", 1),
    "alltoall_": ("all_to_all", 1),
    "alltoall_base_": ("all_to_all", 1),
    "send": ("ppermute", 0),
}
# control plane: listed, at 0 bytes
_C10D_CONTROL = {
    "barrier": ("barrier", 0),
    "monitored_barrier_": ("barrier", 0),
    "broadcast_": ("broadcast", 0),
}
# not a collective of their own: the receive half of a send (the sender
# pays), and the NaN check NCCL may run on a payload
_C10D_UNCOUNTED = {"recv_", "recv_any_source_", "check_for_nan"}

# the mesh helpers' accounting names -> their wire op: every sum
# all-reduce is a psum on the wire (int8's two-phase schedule records its
# all-to-alls and all-gathers under the reduction's own name, so only
# totals compare there)
_DECLARED_CLASS = {"pmean": "psum", "bn_pmean": "psum", "tp_psum": "psum",
                   "lars_norms": "psum"}
# c10d's ReduceOp.RedOpType values that name their own op
_REDUCE_OPS = {4: "pmax", 3: "pmin"}


class CensusError(RuntimeError):
    """A collective the census cannot price (an unmapped ``c10d`` op)."""


@dataclasses.dataclass(frozen=True)
class CensusEntry:
    """One collective that ran: op, group label (``P=<size>``), payload
    identity, modeled per-device wire bytes and how many times it ran.
    ``thread`` is ``"caller"`` for the thread that entered the census and
    ``"autograd"`` for any other (autograd's device threads on the
    card)."""

    op: str
    axis: str
    shape: tuple[int, ...]
    dtype: str
    calls: int
    bytes_per_call: float
    thread: str = "caller"

    @property
    def nelems(self) -> int:
        n = 1
        for d in self.shape:
            n *= int(d)
        return n

    @property
    def total_bytes(self) -> float:
        return self.bytes_per_call * self.calls


def _tensors(value) -> list:
    """The tensors of an argument, nested lists flattened."""
    import torch

    if isinstance(value, torch.Tensor):
        return [value]
    if isinstance(value, (list, tuple)):
        return [t for v in value for t in _tensors(v)]
    return []


def _group_size(args) -> int:
    """The size of the op's process group (its ScriptObject argument)."""
    import torch
    from torch._C import _distributed_c10d as c10d

    for a in args:
        if isinstance(a, torch.ScriptObject):
            try:
                return int(c10d.ProcessGroup.unbox(a).size())
            except RuntimeError:
                continue  # a ReduceOp
    raise CensusError("a c10d op without a process group argument")


def _reduction(args) -> str:
    """``psum``, or ``pmax``/``pmin`` for an all-reduce whose ReduceOp
    argument is MAX/MIN."""
    import torch

    for a in args:
        if isinstance(a, torch.ScriptObject) \
                and a._type().qualified_name().endswith(".ReduceOp"):
            return _REDUCE_OPS.get(int(a.op()), "psum")
    raise CensusError("an all-reduce without a ReduceOp argument")


def _dtype_name(dtype) -> str:
    return str(dtype).removeprefix("torch.")


def _entry(name: str, args, thread: str) -> CensusEntry | None:
    if name in _C10D_UNCOUNTED:
        return None
    control = name in _C10D_CONTROL
    if not control and name not in _C10D_TO_OP:
        raise CensusError(
            f"c10d op {name!r} is not mapped to a collective: price it in "
            f"analysis/graph/census.py before running it under the census")
    op, at = (_C10D_CONTROL if control else _C10D_TO_OP)[name]
    if op == "psum":
        op = _reduction(args)
    payload = _tensors(args[at])
    p = _group_size(args)
    nbytes = float(sum(t.numel() * t.element_size() for t in payload))
    dtypes = {_dtype_name(t.dtype) for t in payload}
    dtype = dtypes.pop() if len(dtypes) == 1 else (
        "none" if not dtypes else "mixed")
    shapes = {tuple(int(d) for d in t.shape) for t in payload}
    if len(payload) == 1:
        shape = shapes.pop()
    elif len(shapes) == 1:  # a list of like parts: stacked
        shape = (len(payload),) + shapes.pop()
    else:
        shape = (sum(t.numel() for t in payload),)
    return CensusEntry(
        op=op, axis=f"P={p}", shape=shape, dtype=dtype, calls=1,
        bytes_per_call=0.0 if control else RING_FACTORS[op](nbytes, p),
        thread=thread)


class CollectiveCensus:
    """``with CollectiveCensus() as census: ...`` records every
    ``torch.ops.c10d`` op run inside the block, on this thread and on
    the autograd threads its backward runs on; ``census.entries`` after
    the block. The ops always run; an op the census cannot price is kept
    and ``entries`` raises ``CensusError`` (so a caller that must not
    fail, the train step, reads the error after the step)."""

    def __init__(self):
        from torch.utils._python_dispatch import TorchDispatchMode

        owner = self

        class _Mode(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                if func.namespace == "c10d":
                    owner._observe(func, args)
                return func(*args, **(kwargs or {}))

        self._mode = _Mode()
        self._lock = threading.Lock()
        self._entries: list[CensusEntry] = []
        self._errors: list[str] = []
        self._caller: int | None = None

    def _observe(self, func, args) -> None:
        name = func._schema.name.split("::", 1)[-1]
        thread = ("caller" if threading.get_ident() == self._caller
                  else "autograd")
        try:
            entry = _entry(name, args, thread)
        except Exception as e:  # noqa: BLE001 — the op runs; the read fails
            with self._lock:
                self._errors.append(f"{name}: {e}")
            return
        if entry is not None:
            with self._lock:
                self._entries.append(entry)

    def __enter__(self) -> "CollectiveCensus":
        self._caller = threading.get_ident()
        self._mode.__enter__()
        return self

    def __exit__(self, *exc) -> None:
        self._mode.__exit__(*exc)

    @property
    def entries(self) -> list[CensusEntry]:
        with self._lock:
            if self._errors:
                raise CensusError("; ".join(sorted(set(self._errors))))
            return list(self._entries)


# -- totals, cross-check, publication ---------------------------------------


def census_totals(entries) -> dict:
    """``{(op, axis): (calls, bytes)}``: the shape
    ``CommsAccounting.delta`` produces."""
    out: dict[tuple[str, str], list] = {}
    for e in entries:
        slot = out.setdefault((e.op, e.axis), [0, 0.0])
        slot[0] += e.calls
        slot[1] += e.total_bytes
    return {k: (int(c), float(b)) for k, (c, b) in out.items()}


def census_bytes(entries) -> float:
    return float(sum(e.total_bytes for e in entries))


def _fold(totals: dict, name_of, keep_zero: bool) -> dict:
    out: dict[str, list] = {}
    for (op, _axis), (calls, nbytes) in totals.items():
        if not nbytes and not keep_zero:
            continue
        slot = out.setdefault(name_of(op), [0, 0.0])
        slot[0] += calls
        slot[1] += nbytes
    return {k: (int(c), float(b)) for k, (c, b) in out.items()}


def wire_totals(entries, keep_zero: bool = False) -> dict:
    """``{wire op: (calls, bytes)}`` of census entries over every group
    (the census labels a group by its size, the accounting by its mesh
    axis, so the two meet per op). Control-plane entries are left out;
    ``keep_zero`` keeps the collectives that moved 0 bytes (world 1)."""
    return _fold(census_totals(e for e in entries
                               if e.op in RING_FACTORS),
                 lambda op: op, keep_zero)


def declared_wire_totals(declared: dict, keep_zero: bool = False) -> dict:
    """A ``CommsAccounting`` delta by wire op: every sum all-reduce name
    (``pmean``, ``bn_pmean``, ``tp_psum``, ``lars_norms``) folds into
    ``psum``, the others keep their names; zero-byte entries are dropped
    unless ``keep_zero``."""
    return _fold(declared, lambda op: _DECLARED_CLASS.get(op, op),
                 keep_zero)


def graph_remainder(entries, declared: dict) -> dict:
    """The census-vs-declared summary published to /metrics.

    ``ad_bytes`` is the traffic the helpers never declared (autograd's
    collectives): census minus declared, floored at zero per wire op so
    an over-declared op cannot cancel an under-declared one."""
    cen = wire_totals(entries)
    dec = declared_wire_totals(declared)
    remainder = 0.0
    for key, (_, b) in cen.items():
        remainder += max(b - dec.get(key, (0, 0.0))[1], 0.0)
    return {
        "graph_bytes": round(sum(b for _, b in cen.values()), 3),
        "declared_bytes": round(sum(b for _, b in dec.values()), 3),
        "ad_bytes": round(remainder, 3),
        "graph_calls": int(sum(c for c, _ in cen.values())),
    }


def census_of_callable(fn, *args, suppress_accounting: bool = False):
    """(entries, declared_totals) for one callable: RUN it once under the
    census, bracketing the process-wide ``CommsAccounting`` so the
    declared traffic of exactly this run comes back beside the census.

    ``suppress_accounting=True`` records nothing in the accounting for
    the run (``CommsAccounting.paused()``, on the calling thread): the
    mode for running again a program whose traffic already counted;
    declared totals are then empty by construction."""
    import contextlib

    from ...parallel.mesh import comms_accounting

    acct = comms_accounting()
    mark = acct.totals()
    scope = acct.paused() if suppress_accounting \
        else contextlib.nullcontext()
    with scope, CollectiveCensus() as census:
        fn(*args)
    declared = {} if suppress_accounting else acct.delta(mark)
    return census.entries, declared


def publish_graph_census(ad_bytes: float = 0.0, gspmd_bytes: float = 0.0,
                         registry=None) -> None:
    """Bump ``collective_graph_bytes_total{source=ad|gspmd}``: the
    traffic beyond the declared sites, itemized by who inserted it. The
    ``ad`` series is published at every census, 0 included (a world of
    one prices every collective at 0 bytes, and a scrape must still tell
    a census that ran from none); ``gspmd``, always 0 in the port, only
    when nonzero, as in the JAX package. The unlabeled
    ``collective_bytes_total`` stays the declared series."""
    if registry is None:
        from ...obs.registry import default_registry

        registry = default_registry()
    for source, nbytes in (("ad", ad_bytes), ("gspmd", gspmd_bytes)):
        if not math.isfinite(nbytes) or (source == "gspmd" and not nbytes):
            continue
        registry.counter(
            "collective_graph_bytes_total",
            "graph-level collective bytes beyond the shim-declared "
            "sites (AD duals / GSPMD-inserted), per compiled program",
            labels={"source": source}).inc(float(nbytes))
