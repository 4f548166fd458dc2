"""The ring-chunk count of the chunked data-parallel NT-Xent, counterpart
of the ring-chunk half of ``ntxent_tpu/ops/autotune.py:373-495``.

``--dp-loss chunked`` sends each ring hop as C slices of rows, so that
chunk c + 1 is on the wire while chunk c is folded. C is resolved by
``resolve_ring_chunks`` (an explicit value, clamped; then a vote cached
in this process; then one cached on disk; then the heuristic
``choose_ring_chunks``), which never measures: it runs where the loss is
built. ``autotune_ring_chunks`` measures: CUDA-event votes of the chunked
loss, forward and backward, over C in (1, 2, 4, 8, 16), within
``NTXENT_AUTOTUNE_BUDGET_S`` seconds (default 240); off the card it
returns the heuristic and measures nothing. A completed sweep's winner
goes to the disk cache (``cache_path``: ``$NTXENT_TORCH_CACHE`` or
``~/.cache/ntxent_tpu_torch``, ``autotune.json``), keyed by backend and
``torch.cuda.get_device_name()``; a sweep cut by its budget serves its
best in this process only (the JAX package keeps a progress record
instead; the port does not).

The Pallas tile autotuners (``autotune_blocks``,
``autotune_attention_blocks``) have no counterpart: the port's kernels
fix their tiles (``ops.ntxent.column_splits`` and the kernels' plans).
"""

from __future__ import annotations

import json
import logging
import os
import time
from pathlib import Path

import torch

logger = logging.getLogger(__name__)

__all__ = ["autotune_ring_chunks", "cache_path", "choose_ring_chunks",
           "clear_cache", "resolve_ring_chunks", "time_loss"]

RING_CHUNK_CANDIDATES = (1, 2, 4, 8, 16)
# ~64 KiB a circulating chunk: the first chunk's fold starts while the
# second is on the wire, and a send's fixed cost does not eat the overlap
RING_CHUNK_TARGET_BYTES = 64 * 1024
_PROTOCOL_VERSION = 1  # bumped when cached votes stop being comparable

_CACHE: dict[tuple, int] = {}
_DISK_CACHE: dict | None = None


def cache_path() -> Path:
    root = Path(os.environ.get("NTXENT_TORCH_CACHE",
                               Path.home() / ".cache" / "ntxent_tpu_torch"))
    return root / "autotune.json"


def clear_cache(disk: bool = False) -> None:
    """Forget the votes of this process (and, with ``disk``, the file)."""
    global _DISK_CACHE
    _CACHE.clear()
    _DISK_CACHE = None
    if disk:
        cache_path().unlink(missing_ok=True)


def choose_ring_chunks(rows: int, dim: int, num_devices: int,
                       itemsize: int = 4) -> int:
    """The heuristic, a pure function: one chunk per ~64 KiB of the
    circulating block (``rows`` = 2 n_local rows of ``dim`` values),
    capped at 8 and at the row count; a world of one never chunks."""
    if num_devices <= 1 or rows <= 1:
        return 1
    payload = int(rows) * int(dim) * int(itemsize)
    return int(max(1, min(payload // RING_CHUNK_TARGET_BYTES, 8, rows)))


def _device_kind() -> str:
    return torch.cuda.get_device_name() if torch.cuda.is_available() \
        else "cpu"


def _key(rows: int, dim: int, num_devices: int, dtype) -> tuple:
    return (f"v{_PROTOCOL_VERSION}", "ringchunks", int(rows), int(dim),
            int(num_devices), str(dtype).removeprefix("torch."),
            "cuda" if torch.cuda.is_available() else "cpu", _device_kind())


def _disk_key(key: tuple) -> str:
    return "|".join(str(k) for k in key)


def _load_disk() -> dict:
    global _DISK_CACHE
    if _DISK_CACHE is None:
        try:
            loaded = json.loads(cache_path().read_text())
            _DISK_CACHE = loaded if isinstance(loaded, dict) else {}
        except (OSError, ValueError):
            _DISK_CACHE = {}
    return _DISK_CACHE


def _store(key: tuple, chunks: int) -> None:
    """Merge one vote into the file: re-read just before the write, so
    another process's votes survive."""
    global _DISK_CACHE
    path = cache_path()
    try:
        fresh = json.loads(path.read_text())
        if not isinstance(fresh, dict):
            fresh = {}
    except (OSError, ValueError):
        fresh = {}
    fresh[_disk_key(key)] = int(chunks)
    _DISK_CACHE = fresh
    try:
        path.parent.mkdir(parents=True, exist_ok=True)
        tmp = path.with_suffix(".tmp")
        tmp.write_text(json.dumps(fresh, indent=1, sort_keys=True))
        tmp.replace(path)
    except OSError as e:  # a read-only home: the process cache holds
        logger.debug("autotune cache not persisted: %s", e)


def _itemsize(dtype) -> int:
    return torch.empty((), dtype=dtype).element_size()


def _cached(key: tuple) -> int | None:
    """The vote of ``key`` cached in this process, else on disk."""
    if key not in _CACHE:
        on_disk = _load_disk().get(_disk_key(key))
        if not isinstance(on_disk, int):
            return None
        _CACHE[key] = on_disk
    return _CACHE[key]


def resolve_ring_chunks(rows: int, dim: int, num_devices: int,
                        dtype=torch.float32, *,
                        chunks: int | None = None) -> int:
    """The chunk count the chunked loss runs with: ``chunks`` clamped to
    [1, rows]; else the vote cached in this process, then on disk; else
    ``choose_ring_chunks``. Never measures."""
    if chunks is not None:
        return max(1, min(int(chunks), max(int(rows), 1)))
    cached = _cached(_key(rows, dim, num_devices, dtype))
    if cached is not None:
        return cached
    return choose_ring_chunks(rows, dim, num_devices, _itemsize(dtype))


def _budget(budget_s) -> float | None:
    if budget_s == "env":
        return float(os.environ.get("NTXENT_AUTOTUNE_BUDGET_S", "240"))
    return budget_s


def time_loss(loss_fn, z1, z2, include_backward: bool = True,
              warmup: int = 2, repeats: int = 5) -> float:
    """Median ms of ``loss_fn(z1, z2)`` (and its backward when asked)
    over ``repeats`` calls after ``warmup``: on CUDA events for tensors
    on the card, on the host clock on the CPU."""
    def once():
        loss = loss_fn(z1, z2)
        if include_backward:
            loss.backward()

    for _ in range(max(int(warmup), 1)):
        once()
    samples = []
    for _ in range(max(int(repeats), 1)):
        if z1.is_cuda:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            once()
            end.record()
            end.synchronize()
            samples.append(start.elapsed_time(end))
        else:
            t0 = time.perf_counter()
            once()
            samples.append((time.perf_counter() - t0) * 1e3)
    return float(sorted(samples)[len(samples) // 2])


def autotune_ring_chunks(group, n_local: int, dim: int,
                         dtype=torch.float32, *, temperature: float = 0.1,
                         include_backward: bool = True, repeats: int = 5,
                         warmup: int = 2, budget_s: float | None | str = "env",
                         device=None) -> int:
    """The measured chunk count of the chunked loss at ``n_local`` rows a
    view and width ``dim`` over the ranks of ``group`` (a joined process
    group): every rank times each candidate (CUDA events, the median of
    ``repeats`` calls after ``warmup``), the ranks agree on the slowest
    rank's time and on stopping when rank 0's budget runs out, and the
    fastest candidate wins, cached in this process and, when the sweep
    completed, on disk (rank 0 writes). Off the card it returns the
    heuristic without measuring."""
    from ..parallel import mesh
    from ..parallel.dist_loss import make_sharded_ntxent

    p = mesh.world_size(group)
    rows = 2 * int(n_local)
    fallback = choose_ring_chunks(rows, dim, p, _itemsize(dtype))
    device = torch.device(device) if device is not None else (
        torch.device("cuda", torch.cuda.current_device())
        if torch.cuda.is_available() else torch.device("cpu"))
    if device.type != "cuda":
        return fallback
    key = _key(rows, dim, p, dtype)
    cached = _cached(key)
    if cached is not None:
        return cached
    budget = _budget(budget_s)
    deadline = None if budget is None else time.monotonic() + budget
    gen = torch.Generator(device="cpu").manual_seed(mesh.rank(group))

    def unit():
        z = torch.randn((int(n_local), int(dim)), generator=gen)
        z = (z / z.norm(dim=-1, keepdim=True)).to(device=device, dtype=dtype)
        return z.requires_grad_(include_backward)

    z1, z2 = unit(), unit()
    best, best_ms, truncated = None, float("inf"), False
    for cand in (c for c in RING_CHUNK_CANDIDATES if c <= max(rows, 1)):
        stop = torch.tensor([1.0 if deadline is not None
                             and time.monotonic() > deadline else 0.0],
                            device=device)
        if p > 1:
            # ntxent: lint-ok[collective-shim] agreement, pre-train
            torch.distributed.broadcast(stop, 0, group=group)
        if stop.item():
            logger.warning("ring-chunk autotune budget (%.0f s) spent; the "
                           "best so far wins", budget)
            truncated = True
            break
        loss_fn = make_sharded_ntxent(group, temperature, impl="chunked",
                                      ring_chunks=cand)
        with mesh.comms_accounting().paused():
            ms = time_loss(loss_fn, z1, z2, include_backward, warmup,
                           repeats)
        slowest = torch.tensor([ms], device=device)
        if p > 1:
            # ntxent: lint-ok[collective-shim] agreement, pre-train
            torch.distributed.all_reduce(
                slowest, op=torch.distributed.ReduceOp.MAX, group=group)
        ms = float(slowest.item())
        logger.info("ring-chunk autotune: %d chunks %.4f ms", cand, ms)
        if ms < best_ms:
            best, best_ms = cand, ms
    if best is None:
        best = fallback
    _CACHE[key] = best
    if not truncated and mesh.rank(group) == 0:
        _store(key, best)
    return best
