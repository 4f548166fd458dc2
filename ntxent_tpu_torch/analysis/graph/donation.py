"""Snapshot-aliasing auditor: the port's form of the incident class
``ntxent_tpu/analysis/graph/donation.py`` catches for JAX.

JAX's analyzer catches a donated buffer that XLA cannot reuse and a
donated leaf returned as a view: the shape of the incident where a
zero-copy host snapshot of step N was overwritten when the donated step
N+1 reused its buffer. The port donates nothing, but its optimizers
update the parameters IN PLACE, and ``.numpy()`` of a CPU tensor is a
view of it (``training/checkpoint.py``: "Snapshots are copies"). A
host snapshot that kept views would be written under one step's label
with a later step's bytes. Two checks, over one real in-place step:

* **snapshot-view**: a leaf of the host snapshot (a numpy array or a
  tensor) shares storage with a live tensor of the train state (the
  model's parameters and buffers, the optimizer's state, the
  error-feedback residual): the byte ranges of ``np.ndarray`` data and
  ``untyped_storage()`` overlap.
* **stale-after-step**: the snapshot's bytes change across one in-place
  train step (a CRC32 of every leaf before and after).

The analyzer keeps JAX's name, ``donation``, so ``--analyzers`` takes
the JAX list.
"""

from __future__ import annotations

import zlib

from ..framework import Finding

__all__ = ["donation_findings", "live_tensors", "snapshot_leaves",
           "snapshot_view_findings"]


def live_tensors(state) -> list:
    """Every tensor the train step may write in place: the model's
    parameters and buffers, the optimizer's state tensors (any depth of
    its attributes: LARS's trace, AdamW's moments, MultiSteps' sums), the
    error-feedback residual and the guard's kept update."""
    import torch

    out = list(state.model.parameters()) + list(state.model.buffers())

    def walk(value, depth: int) -> None:
        if isinstance(value, torch.Tensor):
            out.append(value)
        elif isinstance(value, dict):
            for v in value.values():
                walk(v, depth)
        elif isinstance(value, (list, tuple)):
            for v in value:
                walk(v, depth)
        elif depth < 4 and hasattr(value, "__dict__") \
                and not isinstance(value, (torch.nn.Module, type)):
            walk(vars(value), depth + 1)

    for value in (state.optimizer, getattr(state, "ef_residual", None),
                  getattr(state, "kept", None)):
        walk(value, 0)
    return out


def snapshot_leaves(snapshot, prefix: str = "") -> list:
    """``[(path, leaf)]`` of every array or tensor in a snapshot: a
    ``training.checkpoint.Snapshot`` (its state dict) or nested dicts and
    lists of numpy arrays and tensors."""
    import numpy as np
    import torch

    snapshot = getattr(snapshot, "state_dict", snapshot)  # a Snapshot
    out = []
    if isinstance(snapshot, dict):
        for key in sorted(snapshot, key=str):
            out += snapshot_leaves(snapshot[key], f"{prefix}/{key}")
    elif isinstance(snapshot, (list, tuple)):
        for i, value in enumerate(snapshot):
            out += snapshot_leaves(value, f"{prefix}/{i}")
    elif isinstance(snapshot, (np.ndarray, torch.Tensor)):
        out.append((prefix or "/", snapshot))
    return out


def _host_range(leaf) -> tuple[int, int] | None:
    """[start, end) of the memory holding ``leaf`` (its whole storage for
    a tensor), None for a CUDA tensor or an empty leaf."""
    import numpy as np
    import torch

    if isinstance(leaf, torch.Tensor):
        if leaf.device.type != "cpu":
            return None
        storage = leaf.untyped_storage()
        start, n = storage.data_ptr(), storage.nbytes()
    else:
        base = leaf
        while isinstance(getattr(base, "base", None), np.ndarray):
            base = base.base
        start = base.__array_interface__["data"][0]
        n = base.nbytes
    return (start, start + n) if n else None


def _crc(leaf) -> int:
    import numpy as np
    import torch

    if isinstance(leaf, torch.Tensor):
        leaf = leaf.detach().cpu().numpy()
    return zlib.crc32(np.ascontiguousarray(leaf).tobytes())


def snapshot_view_findings(snapshot, state, target: str) -> list:
    """``snapshot-view`` findings: snapshot leaves whose memory overlaps
    a live tensor of ``state``."""
    live = [r for r in map(_host_range, live_tensors(state)) if r]
    out = []
    for path, leaf in snapshot_leaves(snapshot):
        span = _host_range(leaf)
        if span is None:
            continue
        if any(lo < span[1] and span[0] < hi for lo, hi in live):
            out.append(Finding(
                rule="donation",
                path=f"graph://{target}",
                line=0,
                message=(
                    f"snapshot leaf {path} shares storage with a live "
                    f"tensor of the train state — the next in-place step "
                    f"overwrites what the snapshot is about to save (a "
                    f"view, not a copy)"),
                snippet=f"snapshot-view|{path}"))
    return out


def donation_findings(step, state, args, snapshot_fn, target: str) -> list:
    """Audit one snapshot path: ``snapshot_fn(state)`` takes the host
    snapshot, ``step(state, *args)`` runs one in-place train step; flag
    snapshot leaves that alias the live state and leaves whose bytes the
    step changed. ``target`` names the entry point for the finding's
    pseudo-path."""
    snapshot = snapshot_fn(state)
    out = snapshot_view_findings(snapshot, state, target)
    before = {path: _crc(leaf) for path, leaf in snapshot_leaves(snapshot)}
    step(state, *args)
    for path, leaf in snapshot_leaves(snapshot):
        if _crc(leaf) != before[path]:
            out.append(Finding(
                rule="donation",
                path=f"graph://{target}",
                line=0,
                message=(
                    f"snapshot leaf {path} changed across one train step "
                    f"— the snapshot of step N would be written with step "
                    f"N+1's bytes under step N's label"),
                snippet=f"stale-after-step|{path}"))
    return out
