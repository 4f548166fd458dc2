"""Fused batched-gather scan over product-quantized IVF lists.

The DLRM embedding-bag paper's core observation (PAPERS.md): at scale
the lookup loop is memory-bandwidth-bound, so the win is touching each
byte once for MANY consumers, not computing faster on bytes touched
per-consumer. The unfused loop is the per-query version — every query
re-walks its probed lists with its own small BLAS calls. This module
is the fused fix:

* ``CodedLists`` holds the PQ-coded inverted lists: per row, an int64
  id, ``m`` uint8 codes, and a ``(source, row)`` locator into a table
  of RAW float32 arrays (mmap'd sealed segments, or the live insert
  tail). The scan touches the codes; only re-rank survivors touch raw
  bytes. ``replace_source`` is the REBASE primitive — when a tail
  seals or segments compact, the owner swaps a RAM source for an mmap
  view (same rows, same order) without rewriting a single locator.

* ``batched_scan`` INVERTS the probe map: instead of "for each query,
  for each probed list", it groups queries by list and walks each
  list ONCE — one shared code-gather scoring every query that probed
  it (``m`` byte-gathers produce a ``[Qs, n]`` score block). ADC
  survivors are re-scored exactly from the raw sources, grouped by
  source so an mmap'd segment is gathered once per batch.

* ``ScanBatcher`` coalesces CONCURRENT callers with zero added
  latency: the first thread in becomes the leader and takes every
  compatible queued request; arrivals during a scan queue up and ride
  the next leader. Quiet traffic pays nothing; a burst fuses.

Lock-free reads ride the same count-before-buffers discipline as
``segments.MutableSegment`` — data lands before the visible count
bumps, growth copies the committed prefix before the pointer swap.
Numpy + stdlib only (import-boundary lint + fleet tripwire enforced).
"""

from __future__ import annotations

import threading

import numpy as np

__all__ = ["CodedLists", "ScanBatcher", "batched_scan"]


class _ListBuf:
    """One inverted list: parallel grow-buffers (ids, codes, source
    index, source row) with the lock-free view discipline."""

    __slots__ = ("m", "_ids", "_codes", "_src", "_row", "rows")

    def __init__(self, m: int, chunk_rows: int = 64):
        self.m = int(m)
        self._ids = np.empty((0,), np.int64)
        self._codes = np.empty((0, self.m), np.uint8)
        self._src = np.empty((0,), np.int32)
        self._row = np.empty((0,), np.int32)
        self.rows = 0

    def append(self, ids, codes, src, row) -> None:
        n = int(ids.shape[0])
        need = self.rows + n
        if need > self._ids.shape[0]:
            grow = max(need, int(self._ids.shape[0] * 1.5),
                       self._ids.shape[0] + 64)
            for name, dtype, shape in (("_ids", np.int64, (grow,)),
                                       ("_codes", np.uint8,
                                        (grow, self.m)),
                                       ("_src", np.int32, (grow,)),
                                       ("_row", np.int32, (grow,))):
                nb = np.empty(shape, dtype)
                nb[: self.rows] = getattr(self, name)[: self.rows]
                setattr(self, name, nb)
        self._ids[self.rows: need] = ids
        self._codes[self.rows: need] = codes
        self._src[self.rows: need] = src
        self._row[self.rows: need] = row
        self.rows = need

    def view(self):
        """``(ids, codes, src, row)`` committed-prefix snapshot —
        count read before buffers, same argument as
        ``MutableSegment.view``."""
        n = self.rows
        ids, codes = self._ids, self._codes
        src, row = self._src, self._row
        n = min(n, ids.shape[0], codes.shape[0], src.shape[0],
                row.shape[0])
        return ids[:n], codes[:n], src[:n], row[:n]


class CodedLists:
    """PQ-coded inverted lists + the raw-source table.

    Single-writer (the owning index serializes mutation under its
    lock); readers are lock-free. ``sources`` entries are float32
    ``[rows, dim]`` arrays — RAM for the live tail, mmap views for
    sealed segments; ``replace_source`` swaps one without touching
    locators (the replacement must hold the same rows in the same
    order, which is exactly what seal and compaction guarantee).
    """

    def __init__(self, centroids: np.ndarray, codec):
        self.centroids = np.ascontiguousarray(centroids, np.float32)
        self.codec = codec
        self._lists = [_ListBuf(codec.m)
                       for _ in range(self.centroids.shape[0])]
        self.sources: list[np.ndarray] = []

    @property
    def n_lists(self) -> int:
        return self.centroids.shape[0]

    @property
    def rows(self) -> int:
        return sum(lb.rows for lb in self._lists)

    def memory_bytes(self) -> int:
        """Committed bytes of the compact scan structure (ids + codes
        + locators) — what replaces raw-vector RAM residency."""
        per = 8 + self.codec.m + 4 + 4
        return self.rows * per

    # -- writes (owner-serialized) -------------------------------------------
    def add_source(self, vectors: np.ndarray) -> int:
        self.sources.append(vectors)
        return len(self.sources) - 1

    def replace_source(self, idx: int, vectors: np.ndarray) -> None:
        """Rebase locators onto a new backing array (seal: RAM tail ->
        mmap; compact: old mmap -> a row-aligned slice of the merged
        mmap). Pointer swap only — in-flight scans keep the old array
        alive and stay correct."""
        self.sources[idx] = vectors

    def append_assigned(self, assign: np.ndarray, ids: np.ndarray,
                        codes: np.ndarray, src: int,
                        rows: np.ndarray) -> None:
        """Append pre-assigned, pre-encoded rows: ``assign`` is the
        IVF list per row, ``rows`` the row index inside source
        ``src``. The caller must have made ``src`` cover the rows
        BEFORE appending (readers resolve locators immediately)."""
        ids = np.asarray(ids, np.int64)
        codes = np.asarray(codes, np.uint8)
        rows = np.asarray(rows, np.int32)
        src_arr = np.full(ids.shape[0], int(src), np.int32)
        for c in np.unique(assign):
            mask = assign == c
            self._lists[int(c)].append(ids[mask], codes[mask],
                                       src_arr[mask], rows[mask])

    def list_view(self, c: int) -> tuple[np.ndarray, np.ndarray,
                                         np.ndarray]:
        """``(ids, src, row)`` committed-prefix snapshot of one
        inverted list — the migration read: the raw vectors are
        ``sources[src][row]`` per element."""
        ids, _, src, row = self._lists[int(c)].view()
        return ids, src, row

    def drop_list(self, c: int) -> int:
        """Swap one list for an empty buffer (rebalance hand-off after
        the new owner acks). Pointer swap — in-flight scans keep the
        old buffer alive and stay consistent. Returns rows dropped."""
        old = self._lists[int(c)]
        n = old.rows
        self._lists[int(c)] = _ListBuf(self.codec.m)
        return n

    def assign(self, vectors: np.ndarray) -> np.ndarray:
        """Max-inner-product IVF list per row (same rule as
        ``ivf._nearest`` — unit-norm embeddings, dot == cosine)."""
        return np.argmax(np.asarray(vectors, np.float32)
                         @ self.centroids.T, axis=1)

    def add(self, ids: np.ndarray, vectors: np.ndarray, src: int,
            rows: np.ndarray) -> None:
        """Assign + encode + append in one step (the insert path)."""
        vecs = np.asarray(vectors, np.float32)
        self.append_assigned(self.assign(vecs), ids,
                             self.codec.encode(vecs), src, rows)


def _topk_rows(ids: np.ndarray, scores: np.ndarray, k: int,
               out_ids: np.ndarray, out_scores: np.ndarray) -> None:
    kk = min(k, ids.shape[0])
    if kk == 0:
        return
    top = np.argpartition(scores, -kk)[-kk:]
    top = top[np.argsort(scores[top])[::-1]]
    out_ids[:kk] = ids[top]
    out_scores[:kk] = scores[top]


def batched_scan(coded: CodedLists, queries: np.ndarray, k: int,
                 nprobe: int, rerank: int,
                 stats: dict | None = None) -> tuple[np.ndarray,
                                                     np.ndarray]:
    """Fused ANN top-k over the coded lists for a query BATCH.

    One pass per probed list shared by every query probing it: gather
    the list's codes once, score all those queries against them via
    their ADC tables (m byte-gathers -> a ``[Qs, n]`` block), then
    per query re-rank the ADC top-``rerank`` exactly from the raw
    sources. Returns ``(ids [Q,k], scores [Q,k])`` padded with
    -1/-inf; scores are EXACT inner products for every returned id
    (the PQ approximation only selects candidates).

    Widens like ``IVFIndex.search``: a query whose probed lists hold
    fewer than ``k`` rows re-scans every list, so short lists never
    short the answer. ``stats`` (optional dict) accumulates the
    memory-economy counters: ``code_bytes`` (unique code bytes
    gathered), ``rerank_bytes`` (raw bytes touched), ``rows_scored``
    (query-row pairs), ``list_passes``.
    """
    q = np.asarray(queries, np.float32)
    if q.ndim == 1:
        q = q[None]
    nq = q.shape[0]
    out_ids = np.full((nq, k), -1, np.int64)
    out_scores = np.full((nq, k), -np.inf, np.float32)
    if coded.rows == 0 or nq == 0:
        return out_ids, out_scores
    nprobe = max(1, min(int(nprobe), coded.n_lists))
    rerank = max(int(k), int(rerank))
    cs = q @ coded.centroids.T  # [Q, n_lists]
    if nprobe >= coded.n_lists:
        probe = np.tile(np.arange(coded.n_lists), (nq, 1))
    else:
        probe = np.argpartition(cs, -nprobe, axis=1)[:, -nprobe:]
    tables = coded.codec.adc_tables(q)  # [Q, m, ksub]
    m = coded.codec.m

    # Per-query candidate accumulators: references into shared list
    # views plus the owned ADC score rows — never a per-query copy of
    # ids/locators.
    cand: list[list] = [[] for _ in range(nq)]

    def _scan_lists(list_to_queries: dict[int, list[int]]) -> None:
        for c, qidx in list_to_queries.items():
            ids, codes, src, row = coded._lists[c].view()
            n = ids.shape[0]
            if n == 0:
                continue
            qi = np.asarray(qidx, np.int64)
            # THE fused gather+scan: one walk of this list's codes
            # scores every query that probed it — tables[qi, j] is
            # [Qs, ksub], the code gather broadcasts it to [Qs, n].
            scores = tables[qi, 0][:, codes[:, 0]].astype(
                np.float32, copy=True)
            for j in range(1, m):
                scores += tables[qi, j][:, codes[:, j]]
            for local, query in enumerate(qidx):
                cand[query].append((ids, scores[local], src, row))
            if stats is not None:
                stats["code_bytes"] = stats.get("code_bytes", 0) \
                    + n * m
                stats["rows_scored"] = stats.get("rows_scored", 0) \
                    + n * qi.shape[0]
                stats["list_passes"] = stats.get("list_passes", 0) + 1

    inverted: dict[int, list[int]] = {}
    for i in range(nq):
        for c in probe[i]:
            inverted.setdefault(int(c), []).append(i)
    _scan_lists(inverted)

    # Widen queries whose probed lists came up short (rare: barely
    # populated lists) — rescan the remaining lists for just them.
    if nprobe < coded.n_lists:
        widen: dict[int, list[int]] = {}
        for i in range(nq):
            if sum(t[0].shape[0] for t in cand[i]) < k:
                probed = set(int(c) for c in probe[i])
                for c in range(coded.n_lists):
                    if c not in probed:
                        widen.setdefault(c, []).append(i)
        if widen:
            _scan_lists(widen)

    rerank_bytes = 0
    for i in range(nq):
        parts = cand[i]
        if not parts:
            continue
        ids_cat = np.concatenate([p[0] for p in parts])
        adc_cat = np.concatenate([p[1] for p in parts])
        src_cat = np.concatenate([p[2] for p in parts])
        row_cat = np.concatenate([p[3] for p in parts])
        rr = min(rerank, ids_cat.shape[0])
        sel = np.argpartition(adc_cat, -rr)[-rr:] \
            if rr < ids_cat.shape[0] else np.arange(ids_cat.shape[0])
        # Exact re-rank: gather the survivors' raw rows, grouped by
        # source so each backing array (mmap page run) is touched in
        # one fancy-index gather.
        exact = np.empty(sel.shape[0], np.float32)
        s_sel, r_sel = src_cat[sel], row_cat[sel]
        for s in np.unique(s_sel):
            mask = s_sel == s
            raw = coded.sources[int(s)][r_sel[mask]]
            exact[mask] = np.asarray(raw, np.float32) @ q[i]
            rerank_bytes += int(raw.shape[0]) * int(raw.shape[1]) * 4
        _topk_rows(ids_cat[sel], exact, k, out_ids[i], out_scores[i])
    if stats is not None:
        stats["rerank_bytes"] = stats.get("rerank_bytes", 0) \
            + rerank_bytes
        stats["queries"] = stats.get("queries", 0) + nq
        stats["batches"] = stats.get("batches", 0) + 1
    return out_ids, out_scores


class ScanBatcher:
    """Leader-coalescing request batcher with ZERO idle latency.

    ``run(q, key)`` enqueues a query block; the first free thread
    becomes the leader, takes every queued block with the same
    ``key`` (search params must match to fuse), executes ``fn`` once
    over the stacked rows, and distributes the per-block slices.
    Requests arriving mid-scan queue and ride the next leader — under
    concurrency the fusion is automatic, when quiet a request runs
    immediately and alone. No timers, no added tail latency (a
    fixed coalescing window would tax the quiet path to help the
    busy one; the busy path batches by construction because scans
    serialize)."""

    def __init__(self, fn, max_batch: int = 256):
        # fn(stacked_queries, key) -> (ids [N,k], scores [N,k])
        self._fn = fn
        self.max_batch = max(1, int(max_batch))
        self._cond = threading.Condition()
        self._queue: list[list] = []  # [key, q, box]
        self._busy = False
        self.batches = 0
        self.fused_queries = 0

    def run(self, q: np.ndarray, key) -> tuple[np.ndarray, np.ndarray]:
        q = np.asarray(q, np.float32)
        if q.ndim == 1:
            q = q[None]
        box = {"done": False, "out": None, "err": None}
        entry = [key, q, box]
        with self._cond:
            self._queue.append(entry)
            while not box["done"] and self._busy:
                self._cond.wait()
            if box["done"]:
                if box["err"] is not None:
                    raise box["err"]
                return box["out"]
            # Leader: take every compatible queued request (ours
            # included) up to max_batch rows.
            take, rows = [], 0
            rest = []
            for item in self._queue:
                if item[0] == key and rows < self.max_batch:
                    take.append(item)
                    rows += item[1].shape[0]
                else:
                    rest.append(item)
            self._queue = rest
            self._busy = True
        try:
            stacked = np.concatenate([item[1] for item in take]) \
                if len(take) > 1 else take[0][1]
            out_ids, out_scores = self._fn(stacked, key)
            off = 0
            for item in take:
                n = item[1].shape[0]
                item[2]["out"] = (out_ids[off: off + n],
                                  out_scores[off: off + n])
                item[2]["done"] = True
                off += n
        except BaseException as e:  # noqa: BLE001 — every waiter in
            # the batch must be released with the failure, not hang.
            for item in take:
                if not item[2]["done"]:
                    item[2]["err"] = e
                    item[2]["done"] = True
            raise
        finally:
            with self._cond:
                self._busy = False
                self.batches += 1
                self.fused_queries += len(take)
                self._cond.notify_all()
        return box["out"]
