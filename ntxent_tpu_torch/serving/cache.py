"""Content-keyed embedding cache: the load the workers never see.
Counterpart of ``ntxent_tpu/serving/cache.py`` (stdlib and numpy).

The DLRM embedding-bag inference analysis (PAPERS.md arxiv 2512.05831)
puts a number on what production traffic looks like: most lookups
repeat, so a content-keyed cache in front of the device absorbs a large
fraction of the load before it costs any accelerator time. For this
fleet the same observation is ALSO a robustness property — warm keys
keep serving through a worker crash, because a hit never leaves the
router process.

``EmbeddingCache`` caches per ROW, not per request: the key is a
content hash of one example's bytes (+ shape/dtype so a reshaped array
can never alias), so a mixed request whose rows partially repeat still
hits on the repeated ones and forwards only the misses. Bounds are
explicit and double-layered:

* **LRU capacity** (``capacity_rows``): a hit refreshes recency; an
  insert past capacity evicts the coldest entries;
* **TTL** (``ttl_s``): an entry older than the TTL is a MISS (and is
  evicted) even when capacity has room — a rolled-out model must not
  serve pre-rollout embeddings forever. ``clear()`` is the rollout
  hook: the router flushes on a trusted-version change so a new
  checkpoint's embeddings never mix with the old one's.

Counters ride the shared ``MetricsRegistry`` per request-size bucket
(the same ladder vocabulary the engine uses): hit/miss row counts,
evictions by reason, and a current-size gauge. A lookup that fully
hits is a visible trace slice — the router emits ``fleet.cache`` with
the request id — so a cached answer explains itself in the exported
trace instead of looking like a mysteriously fast worker.
"""

from __future__ import annotations

import hashlib
import threading
import time
from collections import OrderedDict
from collections.abc import Sequence

import numpy as np

from ..obs.registry import MetricsRegistry

__all__ = ["EmbeddingCache"]


def row_key(row: np.ndarray) -> bytes:
    """Content hash of one example: bytes + shape + dtype (two arrays
    that agree here are the same input to a deterministic forward)."""
    h = hashlib.sha1(row.tobytes())
    h.update(f"{row.shape}:{row.dtype}".encode())
    return h.digest()


class EmbeddingCache:
    """TTL + LRU bounded map from row content hash to embedding row.

    Thread-safe: the router's handler threads look up and insert
    concurrently. ``buckets`` is only a labeling vocabulary (which
    ladder rung a request's row count falls in); it does not change
    behavior.
    """

    def __init__(self, capacity_rows: int = 4096, ttl_s: float = 300.0,
                 buckets: Sequence[int] = (1, 4, 16, 64, 128),
                 registry: MetricsRegistry | None = None,
                 clock=time.monotonic, hot_rows: int = 64):
        if capacity_rows < 1:
            raise ValueError(
                f"capacity_rows must be >= 1, got {capacity_rows}")
        if ttl_s <= 0:
            raise ValueError(f"ttl_s must be > 0, got {ttl_s}")
        self.capacity_rows = int(capacity_rows)
        self.ttl_s = float(ttl_s)
        self.hot_rows = int(hot_rows)
        self.buckets = tuple(sorted(set(int(b) for b in buckets)))
        self.registry = registry if registry is not None \
            else MetricsRegistry()
        self.clock = clock
        self._lock = threading.Lock()
        self._entries: OrderedDict[bytes, tuple[np.ndarray, float]] = \
            OrderedDict()
        # Bumped by clear(): a reader that captured the generation
        # before lookup() can tell whether a flush (model change)
        # landed while its misses were in flight — merged entries from
        # two generations would mix embeddings of two models.
        self._generation = 0
        # Hot-row side store: the INPUT rows
        # whose keys actually hit, bounded to the hot_rows most recent
        # distinct ones. Inputs are model-independent, so clear() — a
        # MODEL change — keeps them: they are exactly what a promote
        # replays through the new model instead of booting cold
        # (``hot_keys``). A row is copied in only on its FIRST hit.
        self._hot: OrderedDict[bytes, np.ndarray] = OrderedDict()
        r = self.registry
        self._size = r.gauge("fleet_cache_rows",
                             "embedding rows currently cached")
        self._capacity = r.gauge("fleet_cache_capacity_rows",
                                 "embedding cache row capacity")
        self._capacity.set(self.capacity_rows)
        self._hits_total = r.counter("fleet_cache_hits_total",
                                     "cached rows served")
        self._misses_total = r.counter("fleet_cache_misses_total",
                                       "rows that had to be dispatched")
        self._label_lock = threading.Lock()
        self._by_bucket: dict[tuple[str, str], object] = {}
        self._evictions: dict[str, object] = {}

    # -- labeling ---------------------------------------------------------
    def _bucket_label(self, rows: int) -> str:
        for b in self.buckets:
            if rows <= b:
                return str(b)
        return f">{self.buckets[-1]}"

    def _bucket_counter(self, kind: str, rows: int):
        label = self._bucket_label(rows)
        with self._label_lock:
            counter = self._by_bucket.get((kind, label))
            if counter is None:
                counter = self._by_bucket[(kind, label)] = \
                    self.registry.counter(
                        f"fleet_cache_{kind}_total",
                        f"cached-row {kind} by request-size bucket",
                        labels={"bucket": label})
        return counter

    def _eviction_counter(self, reason: str):
        with self._label_lock:
            counter = self._evictions.get(reason)
            if counter is None:
                counter = self._evictions[reason] = self.registry.counter(
                    "fleet_cache_evictions_total",
                    "entries dropped from the embedding cache",
                    labels={"reason": reason})
        return counter

    # -- core -------------------------------------------------------------
    def lookup(self, rows: np.ndarray) -> tuple[dict[int, np.ndarray],
                                                list[int]]:
        """Split a request into cached and to-dispatch rows.

        Returns ``(hits, miss_indices)``: ``hits`` maps row index ->
        cached embedding; ``miss_indices`` lists the rows (in request
        order) that must be forwarded. An expired entry counts as a
        miss and is evicted (reason ``ttl``) — the subsequent insert of
        the fresh result re-populates it.
        """
        now = self.clock()
        hits: dict[int, np.ndarray] = {}
        misses: list[int] = []
        # Hash outside the lock: SHA-1 over row bytes is the expensive
        # part (hundreds of KB per row at real image sizes) and needs
        # no shared state — holding the lock for it would serialize
        # every handler thread on one request's hashing.
        keys = [row_key(rows[i]) for i in range(rows.shape[0])]
        fresh_hot: list[int] = []
        with self._lock:
            for i, key in enumerate(keys):
                entry = self._entries.get(key)
                if entry is None:
                    misses.append(i)
                    continue
                value, expires_at = entry
                if now >= expires_at:
                    del self._entries[key]
                    self._eviction_counter("ttl").inc()
                    misses.append(i)
                    continue
                self._entries.move_to_end(key)
                hits[i] = value
                if key in self._hot:
                    self._hot.move_to_end(key)
                else:
                    fresh_hot.append(i)
            self._size.set(len(self._entries))
        if fresh_hot and self.hot_rows > 0:
            # Copy outside the lock (same rule as hashing), insert
            # under it; first-hit keys only, so steady repeat traffic
            # costs a move_to_end, not a memcpy.
            copies = [(keys[i], np.array(rows[i])) for i in fresh_hot]
            with self._lock:
                for key, row in copies:
                    self._hot[key] = row
                    self._hot.move_to_end(key)
                while len(self._hot) > self.hot_rows:
                    self._hot.popitem(last=False)
        n = int(rows.shape[0])
        if hits:
            self._hits_total.inc(len(hits))
            self._bucket_counter("hits", n).inc(len(hits))
        if misses:
            self._misses_total.inc(len(misses))
            self._bucket_counter("misses", n).inc(len(misses))
        return hits, misses

    def insert(self, rows: np.ndarray, embeddings: np.ndarray,
               admit=None, keys: list[bytes] | None = None) -> bool:
        """Cache ``embeddings[i]`` under ``rows[i]``'s content hash
        (``keys``, when the caller hashed the rows already); returns
        whether the rows went in.

        ``admit``: the caller's trust gate (``WorkerPool.
        allow_cache_insert`` of the step that computed the rows), asked
        under the lock, after the hashing: nothing is inserted when it
        says no. A gate asked before the hashing could pass, a promote's
        flush land while the rows are hashed, and the flushed model's
        rows then be served beside the new model's."""
        if rows.shape[0] != embeddings.shape[0]:
            raise ValueError(f"rows/embeddings mismatch: {rows.shape[0]} "
                             f"vs {embeddings.shape[0]}")
        expires_at = self.clock() + self.ttl_s
        # Hash + copy outside the lock (see lookup). The per-row copy
        # matters twice over: embeddings[i] is a VIEW into the worker's
        # whole response batch — caching the view would pin every row's
        # base array for the lifetime of one entry.
        if keys is None:
            keys = [row_key(rows[i]) for i in range(rows.shape[0])]
        values = [np.array(embeddings[i], dtype=np.float32)
                  for i in range(rows.shape[0])]
        with self._lock:
            if admit is not None and not admit():
                return False
            for key, value in zip(keys, values):
                if key in self._entries:
                    self._entries.move_to_end(key)
                self._entries[key] = (value, expires_at)
            while len(self._entries) > self.capacity_rows:
                self._entries.popitem(last=False)
                self._eviction_counter("lru").inc()
            self._size.set(len(self._entries))
        return True

    def clear(self, reason: str = "flush") -> int:
        """Drop everything (the rollout hook); returns entries dropped."""
        with self._lock:
            n = len(self._entries)
            self._entries.clear()
            self._generation += 1
            self._size.set(0)
        if n:
            self._eviction_counter(reason).inc(n)
        return n

    def hot_keys(self, n: int) -> list[np.ndarray]:
        """The hottest cached INPUT rows, most-recently-hit first.

        Returns up to ``n`` row arrays (private copies) from the
        bounded hot store — the replay set for cache warming on a
        canary promote: the router re-forwards them through the newly
        trusted model right after the flush, so the hottest traffic
        never sees a cold cache. Survives ``clear()`` by design
        (inputs carry no model state).
        """
        if n < 1:
            return []
        with self._lock:
            rows = list(self._hot.values())[-int(n):]
        return list(reversed(rows))

    @property
    def generation(self) -> int:
        """Flush epoch: changes exactly when clear() runs. Capture it
        before lookup(); a change by merge time means the hits belong
        to a model the router no longer serves."""
        with self._lock:
            return self._generation

    # -- readers ----------------------------------------------------------
    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    @property
    def hits(self) -> int:
        return int(self._hits_total.value)

    @property
    def misses(self) -> int:
        return int(self._misses_total.value)

    def hit_rate(self) -> float | None:
        total = self.hits + self.misses
        return self.hits / total if total else None

    def snapshot(self) -> dict:
        """The JSON wire shape the router's /metrics embeds."""
        with self._label_lock:
            evictions = {reason: int(c.value)
                         for reason, c in sorted(self._evictions.items())}
        with self._lock:
            hot = len(self._hot)
        return {
            "rows": len(self),
            "capacity_rows": self.capacity_rows,
            "ttl_s": self.ttl_s,
            "hot_rows": hot,
            "hits": self.hits,
            "misses": self.misses,
            "hit_rate": round(self.hit_rate(), 4)
            if self.hit_rate() is not None else None,
            "evictions": evictions,
        }
