"""Recompile-cause differ: every compile gets a WHY, not just a count. A
copy of ``ntxent_tpu/analysis/graph/recompile.py``; the port's serving
engine imports its differ from here (one copy in the port).

In the port a "compile" is a bucket's first run on the card (the kernel
libraries loaded, cuBLAS's heuristics, the allocator warmed). The
serving stack counts them (``serving_compiles_total``) but a bare count
cannot distinguish the four very different stories behind a cache miss: a new
ladder rung (healthy adaptation), a dtype change (a quantized rung
coming up), a weight reload (healthy rollout), or a structure change
(a full re-AOT of the ladder — expensive, and alarming mid-traffic).
This module records each lowering's signature per cache key and, on a
miss, diffs against the nearest prior signature so the ``compile``
event and the ``serving_compiles_by_cause_total{reason=...}`` counter
carry a *cause*.

Pure stdlib by design: the differ is imported by ``serving/engine.py``
but also by the audit CLI's event-log analysis, which must not pay a
torch import to read a JSONL file.

Cause vocabulary (priority order when several fields differ — the most
expensive explanation wins, because it is the one an operator must
react to):

* ``structure`` — the model pytree changed (new architecture): the
  whole ladder recompiles.
* ``dtype`` — same model, different wire dtype (an int8 rung ladder
  coming up next to the f32 one).
* ``weights_reload`` — same structure, new version (a checkpoint
  swap through ``update_variables``).
* ``new_shape`` — a batch-shape (bucket) never compiled before: the
  ladder growing.
* ``first_compile`` — no prior signature to diff against.
* ``recompile`` — an identical signature compiled AGAIN: cache
  thrash, the one cause that is never healthy (eviction racing, or a
  key that fails to capture something the executable depends on).
"""

from __future__ import annotations

import threading

from ..framework import Finding

__all__ = ["RecompileDiffer", "diff_signatures", "churn_findings",
           "CAUSES"]

CAUSES = ("first_compile", "new_shape", "dtype", "weights_reload",
          "structure", "recompile")

# Diff priority: first listed field that differs names the cause.
_FIELD_TO_CAUSE = (
    ("structure", "structure"),
    ("dtype", "dtype"),
    ("version", "weights_reload"),
    ("shape", "new_shape"),
    ("sharding", "structure"),
    ("static", "new_shape"),
)


def diff_signatures(new: dict, prior: dict) -> str:
    """Cause of compiling ``new`` given the nearest ``prior``."""
    for field, cause in _FIELD_TO_CAUSE:
        if new.get(field) != prior.get(field):
            return cause
    return "recompile"


def _distance(a: dict, b: dict) -> int:
    keys = set(a) | set(b)
    return sum(1 for k in keys if a.get(k) != b.get(k))


class RecompileDiffer:
    """Per-store signature history: ``observe(key, signature)`` returns
    the cause of this compile. Thread-safe (the engine compiles outside
    its own lock; two racing misses on one key both get a truthful
    answer — the second one is ``recompile``).

    History is BOUNDED (``max_history``, insertion-order eviction): a
    long-lived worker mints a fresh cache key per rollout (model_hash
    changes), and the engine prunes its executable cache on swaps but
    nothing would prune this — an unbounded dict plus an O(history)
    nearest-prior scan per compile is exactly the slow leak the audit
    exists to catch elsewhere. Recent signatures are the only useful
    diff neighbors anyway.
    """

    def __init__(self, max_history: int = 256):
        self._lock = threading.Lock()
        self._by_key: dict = {}
        self._max_history = max(int(max_history), 1)

    def _insert(self, key, signature: dict) -> None:
        self._by_key.pop(key, None)  # move-to-newest on re-observe
        self._by_key[key] = dict(signature)
        while len(self._by_key) > self._max_history:
            self._by_key.pop(next(iter(self._by_key)))

    def observe(self, key, signature: dict) -> str:
        with self._lock:
            prior = self._by_key.get(key)
            if prior is not None:
                self._insert(key, signature)
                return diff_signatures(signature, prior) \
                    if signature != prior else "recompile"
            if not self._by_key:
                self._insert(key, signature)
                return "first_compile"
            nearest = min(self._by_key.values(),
                          key=lambda s: _distance(signature, s))
            self._insert(key, signature)
            return diff_signatures(signature, nearest)


def churn_findings(events, churn_threshold: int = 3) -> list:
    """Audit a stream of ``compile`` event dicts (an ``--events`` JSONL
    already parsed, or any iterable of dicts): serving compiles (those
    carrying a ``bucket``) must carry a ``cause``, and the same
    signature compiling ``churn_threshold``+ times is cache thrash —
    the exact pathology a bare counter hides. Training compiles (no
    ``bucket`` field) are exempt: one AOT compile per attempt is their
    whole lifecycle."""
    out: list[Finding] = []
    seen: dict[tuple, int] = {}
    for ev in events:
        if ev.get("event") != "compile" or "bucket" not in ev:
            continue
        cause = ev.get("cause")
        if not cause:
            out.append(Finding(
                rule="recompile-cause",
                path="events://compile",
                line=0,
                message=(
                    f"serving compile event (bucket={ev.get('bucket')}, "
                    f"dtype={ev.get('dtype')}) carries no cause — the "
                    f"differ is unwired on this path, so this compile "
                    f"is a bare count again"),
                snippet=f"causeless|{ev.get('bucket')}|{ev.get('dtype')}"))
        if cause == "weights_reload":
            # A reload's version differs even though the event's
            # (bucket, dtype, structure) triple does not carry it —
            # counting reload recompiles here would flag every healthy
            # rollout as cache thrash.
            continue
        sig = (ev.get("bucket"), ev.get("dtype"), ev.get("structure"))
        seen[sig] = seen.get(sig, 0) + 1
    for sig, n in sorted(seen.items()):
        if n >= churn_threshold:
            bucket, dtype, structure = sig
            out.append(Finding(
                rule="recompile-cause",
                path="events://compile",
                line=0,
                message=(
                    f"signature (bucket={bucket}, dtype={dtype}, "
                    f"structure={structure}) compiled {n} times — cache "
                    f"thrash (an executable this key fails to pin, or "
                    f"eviction racing the ladder)"),
                snippet=f"churn|{bucket}|{dtype}|{structure}"))
    return out
