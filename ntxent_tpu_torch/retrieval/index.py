"""One searchable vector index: segments + IVF + telemetry.

Counterpart of ``ntxent_tpu/retrieval/index.py``: the same centroid and
codec snapshots, the same answers.

``VectorIndex`` ties the durable substrate (segments.py) to the search
structure (ivf.py) behind a single lock:

* inserts append to the mutable segment AND to the live search
  structure, so a row is searchable the moment ``insert`` returns;
* below ``train_rows`` total rows the search is exact brute force —
  recall is perfect while the index is small, and there is nothing to
  train centroids on yet ("exact brute-force fallback below the
  training threshold");
* at ``train_rows`` the next maintenance pass trains k-means centroids
  on everything inserted so far and switches to IVF-``nprobe`` search
  (an ``index`` event with ``action="build"`` marks the cut);
* ``maintain()`` also runs the segment lifecycle — seal the mutable
  tail past ``seal_rows``, compact past ``compact_at`` sealed segments
  — and refreshes the recall-probe gauge, so one periodic call (the
  manager's maintenance thread, or a test) drives everything
  background about the index.

Telemetry rides a shared ``RetrievalMetrics`` (one per manager — the
counters are fleet-lifetime totals across index versions, the gauges
describe the ACTIVE version) and typed ``index`` events through the
process-wide obs hub.
"""

from __future__ import annotations

import json
import logging
import os
import threading
import time
import uuid
from pathlib import Path

import numpy as np

from ..obs import events as _events
from ..obs.registry import MetricsRegistry
from .ivf import IVFIndex, brute_force_topk, kmeans
from .pq import PQCodec
from .scan import CodedLists, ScanBatcher, batched_scan
from .segments import SegmentStore, _fsync_path

logger = logging.getLogger(__name__)

__all__ = ["RetrievalMetrics", "VectorIndex"]

_STATE_DIR = "state"
_STATE_META = "state.json"
_CENTROIDS = "centroids.f32"


def _save_state(root, centroids: np.ndarray) -> None:
    """Persist trained IVF centroids under ``root/state`` with the
    stage-fsync-rename idiom (crash leaves old state or new, never a
    torn mix) — the codec persists itself the same way (pq.save)."""
    root = Path(root)
    tmp = root / f".tmp-state-{uuid.uuid4().hex[:8]}"
    tmp.mkdir(parents=True)
    arr = np.ascontiguousarray(centroids, np.float32)
    with open(tmp / _CENTROIDS, "wb") as f:
        f.write(arr.tobytes())
        f.flush()
        os.fsync(f.fileno())
    with open(tmp / _STATE_META, "w") as f:
        json.dump({"n_centroids": int(arr.shape[0]),
                   "dim": int(arr.shape[1])}, f)
        f.flush()
        os.fsync(f.fileno())
    _fsync_path(tmp)
    final = root / _STATE_DIR
    if final.exists():
        import shutil
        old = root / f".old-state-{uuid.uuid4().hex[:8]}"
        os.rename(final, old)
        os.rename(tmp, final)
        shutil.rmtree(old, ignore_errors=True)
    else:
        os.rename(tmp, final)
    _fsync_path(root)


def _load_state(root) -> np.ndarray | None:
    """Reopen persisted centroids; None when absent/unreadable (the
    caller falls back to retraining — never an exception out of an
    index open)."""
    path = Path(root) / _STATE_DIR
    try:
        meta = json.loads((path / _STATE_META).read_text())
        raw = np.fromfile(path / _CENTROIDS, dtype=np.float32)
        return raw.reshape(int(meta["n_centroids"]),
                           int(meta["dim"])).copy()
    except (OSError, ValueError, KeyError, TypeError):
        return None


class _StoreCoder:
    """The ``SegmentStore.coder`` protocol over a trained codec +
    centroids: seals and compactions call this to stamp segments with
    PQ sidecars (encode-on-seal)."""

    def __init__(self, codec: PQCodec, centroids: np.ndarray):
        self.codec = codec
        self.centroids = np.ascontiguousarray(centroids, np.float32)

    def encode(self, vecs: np.ndarray) -> np.ndarray:
        return self.codec.encode(vecs)

    def assign(self, vecs: np.ndarray) -> np.ndarray:
        return np.argmax(np.asarray(vecs, np.float32)
                         @ self.centroids.T, axis=1).astype(np.int32)

    @property
    def gen(self) -> int:
        return self.codec.gen


class RetrievalMetrics:
    """The retrieval tier's metric family on a shared registry.

    One instance serves every index version a manager retains:
    counters accumulate across versions (a promote must not zero the
    fleet's insert history), gauges are overwritten to describe the
    active version (``IndexManager.publish``).
    """

    def __init__(self, registry: MetricsRegistry | None = None):
        self.registry = registry if registry is not None \
            else MetricsRegistry()
        r = self.registry
        self.rows = r.gauge("retrieval_index_rows",
                            "vectors in the active index version")
        self.segments = r.gauge("retrieval_index_segments",
                                "segments (sealed + mutable tail) in "
                                "the active index version")
        self.version = r.gauge("retrieval_index_version",
                               "checkpoint step the active index was "
                               "built under (-1 = none)")
        self.version.set(-1)
        self.stale = r.gauge("retrieval_index_stale",
                             "1 while the active index is marked stale "
                             "(embedding-space drift) pending rebuild")
        self.versions = r.gauge("retrieval_index_versions",
                                "index versions currently retained")
        self.docstore_rows = r.gauge("retrieval_docstore_rows",
                                     "input rows retained for rebuild")
        self.recall = r.gauge("retrieval_recall_probe",
                              "last probed recall@k of ANN search vs "
                              "brute force on sampled stored rows")
        # Memory economy: what the PQ codes buy. The bytes
        # gauge is the active version's RESIDENT scan structure (codes
        # + locators + the raw insert tail), bytes_per_row its per-row
        # quotient — raw IVF-flat residency is dim*4+8 for comparison.
        self.index_bytes = r.gauge(
            "retrieval_index_bytes",
            "resident bytes of the active version's scan structure")
        self.bytes_per_row = r.gauge(
            "retrieval_index_bytes_per_row",
            "resident scan-structure bytes per stored row")
        self.inserts = r.counter("retrieval_inserts_total",
                                 "vector rows inserted")
        self.searches = r.counter("retrieval_searches_total",
                                  "query rows searched")
        self.docstore_evictions = r.counter(
            "retrieval_docstore_evictions_total",
            "input rows evicted from the rebuild store (bound hit)")
        self.rebuilt_rows = r.counter(
            "retrieval_rebuilt_rows_total",
            "rows re-embedded into a rebuilt index version")
        # The fused-scan economy counters (scan.batched_scan stats):
        # code bytes are the compact gather the ADC pass touches,
        # rerank bytes the raw rows the exact re-rank touches — their
        # ratio IS the memory-bandwidth win the DLRM analysis names.
        self.scan_bytes = {
            kind: r.counter("retrieval_scan_bytes_total",
                            "bytes touched by the fused scan by kind",
                            labels={"kind": kind})
            for kind in ("codes", "rerank")
        }
        self.scan_batches = r.counter(
            "retrieval_scan_batches_total",
            "fused scan passes executed")
        self.scan_fused_queries = r.counter(
            "retrieval_scan_queries_total",
            "query rows answered by fused scan passes")
        self._ops: dict[str, object] = {}
        self._ops_lock = threading.Lock()
        # search/insert are the index-internal scans; search_request is
        # the router's end-to-end /search (embed forward + scan).
        self.latency = {
            stage: r.histogram("retrieval_latency_ms",
                               "retrieval op latency by stage",
                               labels={"stage": stage})
            for stage in ("search", "insert", "search_request")
        }

    def op(self, kind: str) -> None:
        """Bump ``retrieval_ops_total{kind=...}`` (build/seal/compact/
        promote/rollback/stale/rebuild — the index lifecycle)."""
        with self._ops_lock:
            counter = self._ops.get(kind)
            if counter is None:
                counter = self._ops[kind] = self.registry.counter(
                    "retrieval_ops_total",
                    "index lifecycle actions by kind",
                    labels={"kind": kind})
        counter.inc()


class VectorIndex:
    """Thread-safe searchable index over one embedding space.

    ``step`` is the checkpoint step whose model produced the vectors —
    purely a label here; the version semantics live in
    ``IndexManager``.
    """

    def __init__(self, dim: int, step: int | None = None,
                 root=None, train_rows: int = 2048,
                 n_centroids: int = 64, nprobe: int = 16,
                 seal_rows: int = 4096, compact_at: int = 4,
                 seed: int = 0,
                 metrics: RetrievalMetrics | None = None,
                 pq_m: int = 8, pq_ksub: int = 256,
                 pq_rerank: int = 512, opq_iters: int = 0,
                 pq_train_rows: int = 65536):
        self.dim = int(dim)
        self.step = step
        self.train_rows = max(1, int(train_rows))
        self.n_centroids = max(1, int(n_centroids))
        self.nprobe = max(1, int(nprobe))
        self.seed = int(seed)
        self.metrics = metrics
        # PQ knobs: pq_m=0 disables the coded path and
        # keeps the IVF-flat structure. pq_rerank is the ADC
        # candidate pool re-scored exactly per query (the effective
        # pool is max(pq_rerank, 4k)) — at m=8 the ADC ordering is too
        # coarse for within-cluster fine ranking, so the pool must be
        # hundreds, not tens (measured: top-512 holds 99%+ of the true
        # top-10; top-64 barely 55%). pq_train_rows caps the codebook
        # training sample so a huge index never pays a huge k-means.
        self.pq_m = max(0, int(pq_m))
        self.pq_ksub = int(pq_ksub)
        self.pq_rerank = max(1, int(pq_rerank))
        self.opq_iters = max(0, int(opq_iters))
        self.pq_train_rows = max(256, int(pq_train_rows))
        self._lock = threading.Lock()
        # Serializes maintainers (the manager's thread, a test, an
        # eager caller) — heavy maintenance work runs OUTSIDE
        # ``_lock`` so searches never stall behind an fsync, a
        # compaction merge, or a k-means pass.
        self._maint_lock = threading.Lock()
        self.store = SegmentStore(self.dim, root=root,
                                  seal_rows=seal_rows,
                                  compact_at=compact_at)
        # Set by the manager when this instance is replaced/dropped:
        # maintenance becomes a no-op, so a deleter can barrier on
        # ``_maint_lock`` and then remove the segment directory
        # without an in-flight seal recreating it underneath.
        self.retired = False
        self._ivf: IVFIndex | None = None
        # The coded plane: a trained PQCodec, the coded inverted lists
        # over every SEALED segment (the raw insert tail stays exact-
        # scanned until it seals), and the leader-coalescing batcher
        # that fuses concurrent searches into shared list passes.
        self._codec: PQCodec | None = None
        self._coded: CodedLists | None = None
        self._batcher: ScanBatcher | None = None
        # Parallel to ``CodedLists.sources``: (segment name, start row
        # within that segment) per source — what compaction needs to
        # rebase each source onto a row-aligned slice of the merged
        # mmap without touching a single locator.
        self._src_meta: list[tuple[str, int]] = []
        # True when this instance reopened its trained state (codec +
        # centroids + sidecars) from disk — zero re-clustering.
        self.trained_from_snapshot = False
        if self._load_trained():
            self.trained_from_snapshot = True
        elif self.store.rows >= self.train_rows:
            # Reopened with enough durable rows but no usable trained
            # snapshot: train immediately so a restart serves ANN
            # search from the first query.
            self.maintain()

    # -- trained-state install / persistence -------------------------------
    def _append_segment_coded(self, coded: CodedLists, seg,
                              src: int) -> None:
        """Feed one sealed segment into the coded lists: same-gen
        sidecars are adopted verbatim (the encode already happened at
        seal); anything else re-encodes in bounded blocks so a huge
        mmap never materializes at once."""
        gen = coded.codec.gen
        if getattr(seg, "codec_gen", None) == gen \
                and seg.codes is not None and seg.assign is not None:
            coded.append_assigned(
                np.asarray(seg.assign), np.asarray(seg.ids),
                np.asarray(seg.codes), src,
                np.arange(seg.rows, dtype=np.int32))
            return
        block = 65536
        for off in range(0, seg.rows, block):
            hi = min(off + block, seg.rows)
            v = np.asarray(seg.vectors[off:hi], np.float32)
            coded.append_assigned(
                coded.assign(v), np.asarray(seg.ids[off:hi]),
                coded.codec.encode(v), src,
                np.arange(off, hi, dtype=np.int32))

    def _install_coded(self, centroids: np.ndarray,
                       codec: PQCodec) -> None:
        """Build the coded plane over the current sealed segments and
        publish it (pointer swaps under the index lock). Caller holds
        ``_maint_lock`` (or is ``__init__`` — no concurrency yet)."""
        coded = CodedLists(centroids, codec)
        src_meta: list[tuple[str, int]] = []
        for seg in list(self.store.sealed):
            src = coded.add_source(seg.vectors)
            self._append_segment_coded(coded, seg, src)
            src_meta.append((seg.name, 0))
        coder = _StoreCoder(codec, centroids)
        batcher = ScanBatcher(self._scan_fn)
        with self._lock:
            self.store.coder = coder
            self._codec = codec
            self._coded = coded
            self._src_meta = src_meta
            self._batcher = batcher

    def _load_trained(self) -> bool:
        """Reopen the persisted trained state (centroids + codec +
        sealed sidecars) — a restart must serve a trained index with
        ZERO re-clustering. False when anything is missing or stale
        (the caller falls back to retraining)."""
        root = self.store.root
        if root is None or self.pq_m <= 0 or not self.store.sealed:
            return False
        centroids = _load_state(root)
        if centroids is None or centroids.shape[1] != self.dim:
            return False
        codec = PQCodec.load(root)
        if codec is None or codec.dim != self.dim \
                or not codec.trained:
            return False
        self._install_coded(centroids, codec)
        _events.emit("index", action="reopen_trained", step=self.step,
                     rows=self.rows, centroids=int(centroids.shape[0]),
                     pq_m=codec.m, codec_gen=codec.gen)
        if self.metrics is not None:
            self.metrics.op("reopen_trained")
        logger.info("retrieval: reopened TRAINED index (%d rows, %d "
                    "centroids, pq m=%d gen=%d) — no re-clustering",
                    self.rows, centroids.shape[0], codec.m, codec.gen)
        return True

    # -- memory accounting -------------------------------------------------
    def resident_bytes(self) -> int:
        """RAM the search structure holds resident: the coded plane
        (codes + locators) plus the raw insert tail — sealed raw
        vectors live behind mmaps and only page in for re-ranks. The
        pre-PQ structure is charged at raw residency (dim*4 + id)."""
        raw_per = self.dim * 4 + 8
        tail = self.store.mutable.rows \
            + (self.store.pending.rows
               if self.store.pending is not None else 0)
        coded = self._coded
        if coded is not None:
            return coded.memory_bytes() + tail * raw_per
        return self.store.rows * raw_per

    def scan_bytes_per_row(self) -> float:
        return self.resident_bytes() / max(1, self.store.rows)

    # -- writes ------------------------------------------------------------
    def insert(self, ids, vectors, count_metrics: bool = True) -> int:
        """Append rows (searchable immediately); returns rows added.
        ``count_metrics=False`` is the rebuild path's spelling: a
        background re-embed replay must not inflate the client-facing
        insert counters/latency (it has its own
        ``retrieval_rebuilt_rows_total``)."""
        vecs = np.asarray(vectors, np.float32)
        if vecs.ndim == 1:
            vecs = vecs[None]
        if vecs.shape[1] != self.dim:
            raise ValueError(f"expected dim {self.dim}, got "
                             f"{vecs.shape[1]}")
        ids = np.asarray(ids, np.int64)
        t0 = time.monotonic()
        with self._lock:
            self.store.append(ids, vecs)
            if self._ivf is not None:
                self._ivf.add(ids, vecs)
        if self.metrics is not None and count_metrics:
            self.metrics.inserts.inc(int(vecs.shape[0]))
            self.metrics.latency["insert"].observe(
                (time.monotonic() - t0) * 1e3)
        return int(vecs.shape[0])

    # -- reads (all LOCK-FREE — see ``search`` for the argument) -----------
    @property
    def rows(self) -> int:
        return self.store.rows

    @property
    def trained(self) -> bool:
        return self._ivf is not None or self._coded is not None

    def _scan_fn(self, qs: np.ndarray, key) -> tuple[np.ndarray,
                                                     np.ndarray]:
        """The batcher's fused pass: one ``batched_scan`` over the
        coded lists for every coalesced query block sharing ``key``
        (= (k, nprobe))."""
        k, nprobe = key
        stats: dict | None = {} if self.metrics is not None else None
        out = batched_scan(self._coded, qs, k, nprobe,
                           max(self.pq_rerank, 4 * k), stats=stats)
        if stats:
            m = self.metrics
            m.scan_bytes["codes"].inc(stats.get("code_bytes", 0))
            m.scan_bytes["rerank"].inc(stats.get("rerank_bytes", 0))
            m.scan_batches.inc(stats.get("batches", 0))
            m.scan_fused_queries.inc(stats.get("queries", 0))
        return out

    def _search_coded(self, q: np.ndarray, k: int,
                      nprobe: int) -> tuple[np.ndarray, np.ndarray]:
        """Coded-plane search: fused ADC scan over the sealed rows
        (through the batcher) merged with an exact dot over the raw
        insert tail.

        The TAIL IS READ FIRST — the mirror of the seal path's write
        order (freeze → coded append → publish clears pending): a
        reader that misses the rows in pending can only do so after
        the coded append, which its later list scan then sees. The
        tolerated transient is a duplicate sighting, deduped below."""
        tparts = []
        mids, mvecs = self.store.mutable.view()
        if mids.shape[0]:
            tparts.append((mids, mvecs))
        pending = self.store.pending
        if pending is not None and pending.rows:
            tparts.append(pending.view())
        cids, cscores = self._batcher.run(q, (int(k), int(nprobe)))
        if not tparts:
            return cids, cscores
        tid = np.concatenate([np.asarray(i) for i, _ in tparts])
        tvec = np.concatenate([np.asarray(v) for _, v in tparts])
        tsc = q @ tvec.T  # exact: the tail is RAM-resident anyway
        nq = q.shape[0]
        out_ids = np.full((nq, k), -1, np.int64)
        out_scores = np.full((nq, k), -np.inf, np.float32)
        for i in range(nq):
            keep = cids[i] >= 0
            ids_cat = np.concatenate([cids[i][keep], tid])
            sc_cat = np.concatenate([cscores[i][keep], tsc[i]])
            # Dedup (seal-window double sighting): scores are exact on
            # both sides, so either copy of an id is the right one.
            uniq, first = np.unique(ids_cat, return_index=True)
            sc_u = sc_cat[first]
            kk = min(k, uniq.shape[0])
            top = np.argpartition(sc_u, -kk)[-kk:]
            top = top[np.argsort(sc_u[top])[::-1]]
            out_ids[i, :kk] = uniq[top]
            out_scores[i, :kk] = sc_u[top]
        return out_ids, out_scores

    def _ann_search(self, q: np.ndarray, k: int,
                    nprobe: int | None) -> tuple[np.ndarray,
                                                 np.ndarray]:
        """The structure-dispatch core ``search`` and the recall probe
        share (the probe must exercise the REAL ANN path, without the
        client-traffic telemetry)."""
        eff = self.nprobe if nprobe is None else int(nprobe)
        coded = self._coded
        if coded is not None:
            return self._search_coded(q, k, eff)
        ivf = self._ivf
        if ivf is None:
            ids, vecs = self.store.all_rows()
            return brute_force_topk(q, ids, vecs, k)
        return ivf.search(q, k, eff)

    def search(self, queries, k: int = 10,
               nprobe: int | None = None) -> tuple[np.ndarray,
                                                   np.ndarray]:
        """Top-k ``(ids [Q,k], scores [Q,k])``; brute force until
        trained, then the fused coded scan (or IVF-flat when PQ is
        disabled). Missing slots carry id -1; returned scores are
        exact inner products on every path (the PQ approximation only
        selects candidates).

        LOCK-FREE: searches take no lock at all — under concurrent
        insert+query a shared lock convoys with the GIL and measured
        as a ~50 ms search p99 (vs a sub-ms p50). Safety comes from
        the single-writer discipline (``_lock`` serializes all
        mutation) plus write ordering: every append writes row data
        BEFORE bumping the visible count, and buffer growth copies the
        committed prefix before the pointer swap — so any interleaving
        of attribute reads yields a valid prefix of committed rows,
        never torn data. A search may simply miss rows committed after
        it started, which is the semantics a concurrent reader expects
        anyway. (The coded path's batcher holds its own condition
        variable purely to COALESCE concurrent scans — a waiter rides
        a leader's pass instead of contending for memory bandwidth.)"""
        q = np.asarray(queries, np.float32)
        if q.ndim == 1:
            q = q[None]
        t0 = time.monotonic()
        out = self._ann_search(q, k, nprobe)
        if self.metrics is not None:
            self.metrics.searches.inc(int(q.shape[0]))
            self.metrics.latency["search"].observe(
                (time.monotonic() - t0) * 1e3)
        return out

    def search_exact(self, queries, k: int = 10) -> tuple[np.ndarray,
                                                          np.ndarray]:
        """Brute-force top-k regardless of training state (the recall
        probe's ground truth). Lock-free like ``search``."""
        q = np.asarray(queries, np.float32)
        if q.ndim == 1:
            q = q[None]
        ids, vecs = self.store.all_rows()
        return brute_force_topk(q, ids, vecs, k)

    def recall_probe(self, k: int = 10, sample: int = 32,
                     seed: int = 1) -> float | None:
        """recall@k of ANN search vs brute force on ``sample`` stored
        rows; None below 2k rows (nothing meaningful to probe). Updates
        the gauge."""
        ids, vecs = self.store.all_rows()
        n = vecs.shape[0]
        if n < 2 * k:
            return None
        rng = np.random.RandomState(seed)
        pick = rng.choice(n, size=min(int(sample), n), replace=False)
        q = np.asarray(vecs[pick], np.float32)
        # Bypass ``search``'s metrics: synthetic probe queries must
        # not inflate retrieval_searches_total or the stage=search
        # latency series a dashboard reads as client traffic. (The
        # scan-bytes counters DO tick — they meter bytes genuinely
        # touched, whoever touched them.)
        ann_ids, _ = self._ann_search(q, k, None)
        exact_ids, _ = brute_force_topk(q, ids, vecs, k)
        hit = sum(len(set(a.tolist()) & set(e.tolist()))
                  for a, e in zip(ann_ids, exact_ids))
        recall = hit / float(exact_ids.shape[0] * k)
        if self.metrics is not None:
            self.metrics.recall.set(recall)
        return recall

    # -- maintenance -------------------------------------------------------
    def maintain(self, heavy: bool = True) -> bool:
        """One maintenance pass: train at threshold, seal past
        ``seal_rows``, compact past ``compact_at``. Returns True when
        anything happened (the manager's thread backs off when idle).

        ``heavy=False`` defers the deferrable: compaction (a full
        rewrite of every sealed byte). Training and sealing always run
        — the first gates search quality, the second bounds the
        mutable tail — so the autoscaler's idle gate can push the IO-heavy work into quiet windows
        without ever compromising correctness.

        TWO-PHASE under ``_maint_lock``: every copy/IO-heavy step
        (k-means, the freeze's fsyncs, the compaction merge) runs
        OUTSIDE the index lock, which is held only for pointer swaps —
        the cost of background upkeep must never appear as a search
        p99 spike. Searches keep answering throughout: brute force
        while centroids train, the pending tail stays visible while a
        seal's bytes hit disk, old segments serve until the merged one
        swaps in."""
        did = False
        with self._maint_lock:
            if self.retired:
                # Replaced by a rebuild/rollback: no further segment
                # writes — the manager may be deleting our directory.
                return False
            # 1) training cut: k-means AND the full list build run
            #    outside the index lock over a bounded snapshot
            #    (sealed + pending + the mutable tail's first n0
            #    rows — all stable here: only this _maint_lock-
            #    serialized pass seals/compacts, and lock-free reads
            #    of committed prefixes are safe by the view
            #    discipline). Under the lock only the DELTA rows that
            #    arrived mid-training are added before the publish —
            #    a full in-lock build at a large train_rows was
            #    exactly the search-stall this two-phase contract
            #    forbids.
            if not self.trained:
                mut0 = self.store.mutable
                n0 = mut0.rows
                parts = [s.view() if hasattr(s, "view")
                         else (s.ids, s.vectors)
                         for s in list(self.store.sealed)]
                pending = self.store.pending
                if pending is not None and pending.rows:
                    parts.append(pending.view())
                mids0, mvecs0 = mut0.view()
                parts.append((mids0[:n0], mvecs0[:n0]))
                ids1 = np.concatenate([np.asarray(i)
                                       for i, _ in parts])
                vecs1 = np.concatenate([np.asarray(v)
                                        for _, v in parts])
                if ids1.shape[0] >= self.train_rows \
                        and self.pq_m > 0:
                    # The coded cut: IVF centroids + PQ codebooks in
                    # one pass, then the coded lists over every sealed
                    # segment. The raw tail (incl. any rows that land
                    # mid-training) stays exact-scanned until it
                    # seals, so no delta bookkeeping is needed here.
                    k = min(self.n_centroids, max(1, vecs1.shape[0]))
                    centroids = kmeans(vecs1, k, seed=self.seed)
                    stride = max(1,
                                 vecs1.shape[0] // self.pq_train_rows)
                    sample = vecs1[::stride][: self.pq_train_rows]
                    codec = PQCodec(self.dim, m=self.pq_m,
                                    ksub=self.pq_ksub, seed=self.seed)
                    codec.train(sample, opq_iters=self.opq_iters)
                    self._install_coded(centroids, codec)
                    if self.store.root is not None:
                        # Snapshot the trained state (same atomic
                        # idiom as the segments): a restart reopens a
                        # trained index instead of re-clustering.
                        codec.save(self.store.root)
                        _save_state(self.store.root, centroids)
                    did = True
                    _events.emit("index", action="build",
                                 step=self.step,
                                 rows=int(ids1.shape[0]),
                                 centroids=int(k),
                                 nprobe=self.nprobe,
                                 pq_m=codec.m, pq_ksub=codec.ksub,
                                 codec_gen=codec.gen)
                    _events.emit("index", action="pq_train",
                                 step=self.step,
                                 rows=int(sample.shape[0]),
                                 pq_m=codec.m, pq_ksub=codec.ksub,
                                 codec_gen=codec.gen,
                                 opq=self.opq_iters > 0)
                    if self.metrics is not None:
                        self.metrics.op("build")
                        self.metrics.op("pq_train")
                    logger.info("retrieval: trained %d centroids + "
                                "PQ m=%d/ksub=%d over %d rows "
                                "(step %s)", k, codec.m, codec.ksub,
                                ids1.shape[0], self.step)
                elif ids1.shape[0] >= self.train_rows:
                    k = min(self.n_centroids, max(1, vecs1.shape[0]))
                    centroids = kmeans(vecs1, k, seed=self.seed)
                    ivf = IVFIndex(centroids)
                    ivf.add(ids1, vecs1)
                    with self._lock:
                        # Only maintain swaps the mutable tail, and we
                        # ARE maintain — the identity check is a
                        # safety net, not an expected path.
                        if self.store.mutable is mut0:
                            mids, mvecs = mut0.view()
                            if mids.shape[0] > n0:
                                ivf.add(mids[n0:], mvecs[n0:])
                            self._ivf = ivf
                            trained_rows = int(
                                ids1.shape[0]
                                + max(0, mids.shape[0] - n0))
                        else:  # pragma: no cover — retry next pass
                            trained_rows = None
                    if trained_rows is not None:
                        did = True
                        _events.emit("index", action="build",
                                     step=self.step,
                                     rows=trained_rows,
                                     centroids=int(k),
                                     nprobe=self.nprobe)
                        if self.metrics is not None:
                            self.metrics.op("build")
                        logger.info("retrieval: trained %d centroids "
                                    "over %d rows (step %s)", k,
                                    trained_rows, self.step)
            # 2) seal: pointer-take under the lock, freeze (disk or
            #    in-memory trim) outside, publish under the lock. With
            #    the coded plane live the freshly sealed rows enter
            #    the coded lists BEFORE pending clears — a lock-free
            #    reader that misses them in pending finds them in the
            #    lists (the dup-sighting transient ``_search_coded``
            #    dedupes), never in neither.
            frozen = None
            with self._lock:
                if self.store.should_seal():
                    frozen = self.store.take_mutable()
            if frozen is not None and frozen.rows:
                seg = self.store.freeze(frozen)
                coded = self._coded
                if coded is not None:
                    src = coded.add_source(seg.vectors)
                    self._append_segment_coded(coded, seg, src)
                    self._src_meta.append((seg.name, 0))
                with self._lock:
                    self.store.publish(seg)
                did = True
                _events.emit("index", action="seal", step=self.step,
                             segment=seg.name, rows=seg.rows,
                             coded=coded is not None)
                if self.metrics is not None:
                    self.metrics.op("seal")
            # 3) compact (deferrable: a full rewrite of every sealed
            #    byte): merge outside the lock, rebase the coded
            #    sources onto row-aligned slices of the merged mmap
            #    (pointer swaps — not one locator is touched, and the
            #    sidecar concat in ``merge`` means no re-encode
            #    either), swap in, delete the inputs after no reader
            #    can pick them up.
            olds = None
            if heavy:
                with self._lock:
                    if self.store.should_compact():
                        olds = list(self.store.sealed)
            if olds:
                merged = self.store.merge(olds)
                coded = self._coded
                if coded is not None:
                    offsets: dict[str, int] = {}
                    off = 0
                    for s in olds:
                        offsets[s.name] = off
                        off += s.rows
                    for i, (name, start) in enumerate(self._src_meta):
                        if name not in offsets:
                            continue
                        base = offsets[name] + start
                        ln = int(coded.sources[i].shape[0])
                        coded.replace_source(
                            i, merged.vectors[base: base + ln])
                        self._src_meta[i] = (merged.name, base)
                with self._lock:
                    self.store.swap_sealed(olds, merged)
                self.store.delete_segments(olds)
                did = True
                _events.emit("index", action="compact", step=self.step,
                             segment=merged.name, rows=merged.rows)
                if self.metrics is not None:
                    self.metrics.op("compact")
        return did
