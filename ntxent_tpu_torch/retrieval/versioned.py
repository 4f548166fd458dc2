"""Checkpoint-step-versioned index manager: the rollout coupling.

Counterpart of ``ntxent_tpu/retrieval/versioned.py``: the same docstore
log and metadata, byte for byte.

The shadow-drift machinery (``serving/shadow.py``) exists because two checkpoints'
embedding SPACES diverge — which means an ANN index built over one
model's embeddings silently answers wrong under another. So index
versions here are keyed to checkpoint steps, and the router's rollout
state machine drives the version lifecycle:

* **adopt** — the first trusted step gets the first (empty) version;
* **promote** — searches CUT OVER atomically to a fresh version keyed
  to the newly trusted step; the prior version is retained (that is
  what a rollback restores) and the new one is rebuilt in the
  background by re-embedding the retained input rows through the now-
  trusted fleet (``set_reembed`` installs the router's forward path);
* **rollback** — the fleet reverted to an older checkpoint: the prior
  step's version is restored ATOMICALLY (same dict-pointer swap as the
  promote cut) with its vectors intact, so post-rollback searches
  answer from the space the workers actually serve again;
* **stale** — a shadow-drift breach is direct evidence the spaces
  moved; the active version is flagged stale (gauge + typed event) and
  a rebuild is forced. Until the rebuild lands, searches still answer
  (an old answer beats a 503) but carry ``stale: true`` so callers can
  tell.

Inputs, not embeddings, are what survive a model change (the cache-
warming lesson) — the manager retains up to
``docstore_rows`` inserted INPUT rows keyed by their assigned ids, and
that docstore is the rebuild source. Past the bound the oldest rows
are evicted (counted; a rebuild then covers the retained tail only —
logged, never silent).

The docstore is DURABLE when the manager is rooted: rows
append to ``docstore.log`` (flushed per insert, fsync'd on maintenance
ticks and ``stop``), evictions advance a watermark in
``docstore.json``, and the log compacts by the same stage-fsync-rename
idiom as the segments once dead records outgrow live ones. Together
with the per-version codec/centroid snapshots (index.py) a restarted
router reopens a TRAINED index with its rebuild source intact —
zero re-clustering, zero re-embedding.

Torch-free like everything under ``retrieval/``: it runs in the
router process.
"""

from __future__ import annotations

import json
import logging
import os
import struct
import threading
import time
import uuid
from collections import OrderedDict
from pathlib import Path

import numpy as np

from ..obs import events as _events
from ..obs.registry import MetricsRegistry
from .index import RetrievalMetrics, VectorIndex
from .segments import _fsync_path

logger = logging.getLogger(__name__)

__all__ = ["IndexManager"]

_DOC_LOG = "docstore.log"
_DOC_META = "docstore.json"
# One log record: id, ndim, ndim int32 dims, then the f32 payload.
_REC_HEAD = struct.Struct("<qB")


class IndexManager:
    """Versioned retrieval tier: one ``VectorIndex`` per trusted
    checkpoint step, one active at a time.

    ``root`` (optional) gives each version a ``step-<N>/`` segment
    directory; None keeps every version in memory. ``index_kw`` passes
    through to ``VectorIndex`` (train_rows/n_centroids/nprobe/
    seal_rows/compact_at).
    """

    def __init__(self, dim: int | None = None, root=None,
                 registry: MetricsRegistry | None = None,
                 docstore_rows: int = 65536,
                 keep_versions: int = 2,
                 maintain_interval_s: float = 2.0,
                 **index_kw):
        # ``dim=None`` defers to the first inserted embedding's width —
        # the router tier is torch-free and cannot ask the model; until
        # then versions are registered as placeholders (searches answer
        # empty) and materialize on first insert.
        self.dim = int(dim) if dim is not None else None
        self.root = root
        self.docstore_rows = max(1, int(docstore_rows))
        self.keep_versions = max(1, int(keep_versions))
        self.maintain_interval_s = float(maintain_interval_s)
        self.index_kw = dict(index_kw)
        self.metrics = RetrievalMetrics(registry)
        self._lock = threading.Lock()
        self._versions: OrderedDict[int, VectorIndex] = OrderedDict()
        self._active_step: int | None = None
        self._prior_step: int | None = None
        self._stale_reason: str | None = None
        self._next_id = 0
        # id -> input row (np.float32), insertion-ordered for eviction.
        self._docstore: OrderedDict[int, np.ndarray] = OrderedDict()
        # Durable docstore state (rooted managers only): the open
        # append handle, the eviction watermark (smallest retained
        # id), and the dead-record count that triggers log compaction.
        self._doc_f = None
        self._doc_watermark = 0
        self._doc_dead = 0
        # Compaction only pays off past a floor of dead records — a
        # tiny store must not rewrite its log every few evictions.
        self._doc_compact_floor = 1024
        # Installed by the router: fn(inputs [N, ...]) -> embeddings
        # [N, dim] or None on failure. Called on the rebuild thread.
        self.reembed = None
        # Installed by the fleet plane: a
        # callable -> bool consulted per maintenance tick. False
        # defers the DEFERRABLE work (compaction, docstore log
        # compaction) to an idle window — the autoscaler's idle
        # detector is the intended source. Bounded: after
        # ``heavy_defer_ticks`` consecutive deferrals the work runs
        # anyway (a permanently busy fleet must not grow segments
        # forever).
        self.heavy_gate = None
        self.heavy_defer_ticks = 30
        self._heavy_deferred = 0
        self._rebuild_thread: threading.Thread | None = None
        self._maint_thread: threading.Thread | None = None
        self._stop = threading.Event()
        # Replaced/retired index instances awaiting directory cleanup.
        self._orphans: list = []
        # Row count at the last recall probe: the probe materializes
        # every vector, so an idle index must not pay it per tick.
        self._last_probe_rows = -1
        if self.root is not None:
            self._reopen()
            self._reopen_docstore()

    def _reopen(self) -> None:
        """Adopt prior runs' persisted segments (``--index-dir`` must
        not be write-only): per step, the newest non-empty ``g-*``
        instance directory reopens as that step's version (dim read
        from its segment metadata, ids resumed past the persisted
        maximum so new inserts can never collide); every other
        ``g-*`` dir is a crash/replacement orphan and is deleted —
        without this, restarts leaked every prior instance's segments
        forever. The docstore replays separately
        (``_reopen_docstore``), so a post-restart rebuild covers the
        retained input rows, not just newly inserted ones."""
        import json as _json
        import os
        import shutil

        def _gen_dim(gen_path: str):
            """``("empty", None)`` for a segment-less dir (per-run
            debris — every instance mkdir's its root), ``("ok", dim)``
            when every segment's metadata agrees, ``("unreadable",
            None)`` on any read/parse failure — which must NEVER be
            grounds for deletion (a transient IO error or one corrupt
            meta must not amplify into losing the generation's healthy
            segments; SegmentStore skips bad segments the same way)."""
            try:
                segs = [s for s in os.listdir(gen_path)
                        if s.startswith("seg-")]
            except OSError:
                return "unreadable", None
            if not segs:
                return "empty", None
            try:
                dims = {
                    int(_json.load(open(
                        os.path.join(gen_path, seg, "meta.json")))
                        ["dim"])
                    for seg in segs
                }
            except (OSError, ValueError, KeyError, TypeError):
                return "unreadable", None
            if len(dims) != 1:
                return "unreadable", None
            return "ok", dims.pop()

        root = str(self.root)
        try:
            listing = os.listdir(root)
        except OSError:
            return
        steps: list[tuple[int, str]] = []
        for d in listing:
            if not d.startswith("step-"):
                continue
            try:
                steps.append((int(d.split("-", 1)[1]), d))
            except ValueError:
                continue
        max_id = -1
        adoptions: list[tuple[int, VectorIndex]] = []
        # NEWEST step first: the manager's dim comes from the newest
        # persisted space, so after an embedding-width change across
        # runs the obsolete OLD-dim steps are what gets dropped —
        # oldest-first resolution would pin the stale dim and delete
        # the newest, correct-space data as a "mismatch".
        for step, d in sorted(steps, reverse=True):
            step_path = os.path.join(root, d)
            try:
                gens = sorted((g for g in os.listdir(step_path)
                               if g.startswith("g-")),
                              key=lambda g: os.path.getmtime(
                                  os.path.join(step_path, g)),
                              reverse=True)  # newest first
            except OSError:
                continue
            adopted = False
            for g in gens:
                gen_path = os.path.join(step_path, g)
                verdict, dim = _gen_dim(gen_path)
                if verdict == "unreadable":
                    # Skip, never delete: not adoptable today, but a
                    # single bad meta.json must not destroy the
                    # generation's healthy segments.
                    logger.warning("retrieval: unreadable segment "
                                   "metadata under %s — left on disk, "
                                   "not adopted", gen_path)
                    continue
                if not adopted and verdict == "ok" \
                        and self.dim in (None, dim):
                    self.dim = dim
                    idx = VectorIndex(dim, step=step, root=gen_path,
                                      metrics=self.metrics,
                                      **self.index_kw)
                    if idx.rows:
                        adoptions.append((step, idx))
                        adopted = True
                        for ids_arr, _ in idx.store.blocks():
                            if len(ids_arr):
                                max_id = max(max_id,
                                             int(np.max(ids_arr)))
                        logger.info("retrieval: reopened step-%d "
                                    "index (%d rows) from %s", step,
                                    idx.rows, gen_path)
                        continue
                # Superseded generation, per-run empty debris, or an
                # obsolete-dim space (dim resolved newest-first, so
                # this can never be the newest data): delete, or every
                # restart leaks it.
                shutil.rmtree(gen_path, ignore_errors=True)
        # Register ASCENDING: the OrderedDict's insertion order is what
        # retention evicts from (oldest first) — newest-first
        # registration would make retention destroy the newest version.
        for step, idx in sorted(adoptions, key=lambda si: si[0]):
            self._versions[step] = idx
        self._next_id = max_id + 1

    # -- durable docstore --------------------------------------------------
    def _reopen_docstore(self) -> None:
        """Replay ``docstore.log`` into the in-memory docstore and open
        it for append. Records below the persisted watermark (already
        evicted) are skipped; a truncated tail (crash mid-append) is
        dropped AND truncated off the file — appending past garbage
        would poison every future replay at the same offset. Ids resume
        past the persisted maximum so restarts never re-issue one."""
        root = Path(str(self.root))
        try:
            root.mkdir(parents=True, exist_ok=True)
        except OSError:
            return
        watermark = 0
        try:
            watermark = int(json.loads(
                (root / _DOC_META).read_text()).get("watermark", 0))
        except (OSError, ValueError, TypeError, AttributeError):
            watermark = 0
        log_p = root / _DOC_LOG
        try:
            blob = log_p.read_bytes()
        except OSError:
            blob = b""
        off, n = 0, len(blob)
        replayed = dead = 0
        while off + _REC_HEAD.size <= n:
            rid, ndim = _REC_HEAD.unpack_from(blob, off)
            dims_end = off + _REC_HEAD.size + 4 * ndim
            if ndim == 0 or dims_end > n:
                break
            dims = np.frombuffer(blob, np.int32, ndim,
                                 off + _REC_HEAD.size)
            count = int(np.prod(dims))
            rec_end = dims_end + 4 * count
            if count <= 0 or rec_end > n:
                break
            if rid >= watermark:
                # Ids are monotonic and the log is append-ordered, so
                # plain assignment preserves eviction order.
                self._docstore[rid] = np.frombuffer(
                    blob, np.float32, count, dims_end).reshape(
                        tuple(int(d) for d in dims)).copy()
                replayed += 1
            else:
                dead += 1
            off = rec_end
        if off < n:
            logger.warning("retrieval: docstore.log truncated tail "
                           "dropped (%d byte(s))", n - off)
            try:
                with open(log_p, "r+b") as f:
                    f.truncate(off)
                    f.flush()
                    os.fsync(f.fileno())
            except OSError:
                pass
        while len(self._docstore) > self.docstore_rows:
            self._docstore.popitem(last=False)
            dead += 1
        self._doc_watermark = next(iter(self._docstore)) \
            if self._docstore else watermark
        self._doc_dead = dead
        if self._docstore:
            self._next_id = max(self._next_id,
                                max(self._docstore) + 1)
        try:
            self._doc_f = open(log_p, "ab")
        except OSError:
            self._doc_f = None
        if replayed:
            self.metrics.op("docstore_replay")
            _events.emit("index", action="docstore_replay",
                         rows=replayed, dead=dead)
            logger.info("retrieval: docstore replayed %d row(s) "
                        "(%d dead) from %s", replayed, dead, log_p)

    def _doc_append(self, ids, rows) -> None:
        """Append rows to the log (flushed, not fsync'd — maintenance
        ticks and ``stop`` pay the fsync). Callers hold ``_lock``, so
        appends serialize and stay id-ordered."""
        if self._doc_f is None:
            return
        try:
            buf = bytearray()
            for i, row in zip(ids, rows):
                r = np.ascontiguousarray(row, np.float32)
                buf += _REC_HEAD.pack(int(i), r.ndim)
                buf += np.asarray(r.shape, np.int32).tobytes()
                buf += r.tobytes()
            self._doc_f.write(bytes(buf))
            self._doc_f.flush()
        except (OSError, ValueError):
            logger.exception("retrieval: docstore append failed — "
                             "rows stay in memory only")

    def _doc_sync(self) -> None:
        f = self._doc_f
        if f is None:
            return
        try:
            f.flush()
            os.fsync(f.fileno())
        except (OSError, ValueError):
            pass

    def _write_doc_meta(self, watermark: int) -> None:
        root = Path(str(self.root))
        tmp = root / f".{_DOC_META}.tmp-{uuid.uuid4().hex[:8]}"
        try:
            tmp.write_text(json.dumps({"watermark": int(watermark)}))
            with open(tmp, "rb") as f:
                os.fsync(f.fileno())
            os.replace(tmp, root / _DOC_META)
            _fsync_path(root)
        except OSError:
            logger.exception("retrieval: docstore watermark write "
                             "failed")
            try:
                tmp.unlink()
            except OSError:
                pass

    def _doc_compact(self) -> None:
        """Rewrite the log with only the live rows (stage-fsync-rename,
        same idiom as the segments) and persist the watermark. Holds
        ``_lock`` for the rewrite so no insert can append to the handle
        being swapped out — the hold is bounded by ``docstore_rows``
        worth of sequential writes."""
        if self.root is None:
            return
        root = Path(str(self.root))
        tmp = root / f".{_DOC_LOG}.tmp-{uuid.uuid4().hex[:8]}"
        with self._lock:
            try:
                with open(tmp, "wb") as f:
                    for i, row in self._docstore.items():
                        r = np.ascontiguousarray(row, np.float32)
                        f.write(_REC_HEAD.pack(int(i), r.ndim))
                        f.write(np.asarray(r.shape,
                                           np.int32).tobytes())
                        f.write(r.tobytes())
                    f.flush()
                    os.fsync(f.fileno())
                if self._doc_f is not None:
                    try:
                        self._doc_f.close()
                    except OSError:
                        pass
                os.replace(tmp, root / _DOC_LOG)
                _fsync_path(root)
                self._doc_f = open(root / _DOC_LOG, "ab")
                self._doc_dead = 0
                watermark = next(iter(self._docstore)) \
                    if self._docstore else self._next_id
                self._doc_watermark = watermark
                rows = len(self._docstore)
            except OSError:
                logger.exception("retrieval: docstore compaction "
                                 "failed")
                try:
                    tmp.unlink()
                except OSError:
                    pass
                return
        self._write_doc_meta(watermark)
        self.metrics.op("docstore_compact")
        _events.emit("index", action="docstore_compact", rows=rows)
        logger.info("retrieval: docstore log compacted to %d live "
                    "row(s)", rows)

    # -- version plumbing --------------------------------------------------
    def _index_root(self, step: int):
        """A FRESH directory per index instance (``step-N/g-<nonce>``):
        a rebuild of step N must never reopen the old instance's sealed
        segments — those hold the stale-space vectors the rebuild
        exists to replace, and two instances sharing one directory
        would collide on segment names. The docstore is the rebuild
        source of truth; orphaned instance dirs are deleted by
        ``_drop_index`` once no version points at them."""
        if self.root is None:
            return None
        import os
        import uuid

        return os.path.join(str(self.root), f"step-{int(step)}",
                            f"g-{uuid.uuid4().hex[:8]}")

    def _new_index(self, step: int) -> VectorIndex:
        assert self.dim is not None
        return VectorIndex(self.dim, step=step,
                           root=self._index_root(step),
                           metrics=self.metrics, **self.index_kw)

    @staticmethod
    def _drop_index(idx: VectorIndex | None) -> None:
        """Delete a replaced/retired instance's segment directory.
        In-flight searches on the old instance keep answering — their
        np.memmaps hold the inodes (POSIX unlink semantics). The
        retire-then-barrier handshake closes the seal race: without
        it, a maintenance pass mid-seal on the old instance would
        mkdir+rename the deleted directory BACK into existence, and a
        restart's ``_reopen`` would adopt that resurrected stale-space
        segment as the step's newest generation."""
        if idx is None:
            return
        idx.retired = True
        if idx.store.root is None:
            return
        import shutil

        with idx._maint_lock:
            # Barrier: any in-flight maintain() finishes its writes;
            # retired blocks all future ones.
            pass
        shutil.rmtree(idx.store.root, ignore_errors=True)

    def _ensure_locked(self, step: int) -> VectorIndex | None:
        """Register (and, once ``dim`` is known, materialize) the
        version for ``step``; None while the dim is still unknown.
        Retention-dropped instances land in ``_orphans`` — the caller
        deletes their directories OUTSIDE the lock."""
        idx = self._versions.get(step)
        if idx is None:
            if self.dim is not None:
                idx = self._new_index(step)
            self._versions[step] = idx
            self._versions.move_to_end(step)
            while len(self._versions) > self.keep_versions + 1:
                old_step, old = self._versions.popitem(last=False)
                self._orphans.append(old)
                logger.info("retrieval: dropped index version for "
                            "step %d (retention)", old_step)
        return idx

    def _drain_orphans(self) -> None:
        """Delete retired instances' segment dirs (never under the
        lock — an rmtree must not stall version resolution)."""
        while self._orphans:
            self._drop_index(self._orphans.pop())

    @property
    def active_step(self) -> int | None:
        return self._active_step

    @property
    def stale(self) -> bool:
        return self._stale_reason is not None

    def version(self, step: int) -> VectorIndex | None:
        with self._lock:
            return self._versions.get(step)

    def active(self) -> VectorIndex | None:
        with self._lock:
            if self._active_step is None:
                return None
            return self._versions.get(self._active_step)

    # -- rollout hooks (the router's WorkerPool decisions) -----------------
    def activate(self, step: int) -> None:
        """First trusted adoption: version ``step`` becomes active."""
        step = int(step)
        with self._lock:
            if self._active_step == step:
                return
            self._ensure_locked(step)
            self._prior_step = self._active_step
            self._active_step = step
        self._drain_orphans()
        _events.emit("index", action="activate", step=step)
        self.publish()

    def promote(self, step: int) -> None:
        """Canary promote: cut searches to ``step``'s version (created
        empty if absent) and kick a background rebuild from the
        docstore. The prior version is RETAINED for rollback."""
        step = int(step)
        with self._lock:
            prior = self._active_step
            self._ensure_locked(step)
            self._prior_step = prior
            self._active_step = step
            self._stale_reason = None
        self._drain_orphans()
        self.metrics.op("promote")
        _events.emit("index", action="promote", step=step,
                     prior_step=prior)
        logger.info("retrieval: index cut over to step %d (prior %s "
                    "retained for rollback)", step, prior)
        self.publish()
        self.rebuild_async(reason="promote")

    def rollback_to(self, step: int) -> bool:
        """The fleet reverted: restore ``step``'s retained version
        atomically. Returns False when that version was not retained
        (a fresh empty one is activated instead — still the correct
        space, just cold)."""
        step = int(step)
        with self._lock:
            had = self._versions.get(step) is not None
            self._ensure_locked(step)
            self._prior_step = self._active_step
            self._active_step = step
            self._stale_reason = None
        self._drain_orphans()
        self.metrics.op("rollback")
        _events.emit("index", action="rollback", step=step,
                     retained=had)
        logger.warning("retrieval: index rolled back to step %d "
                       "(%s)", step,
                       "retained version restored" if had
                       else "version not retained — rebuilt cold")
        self.publish()
        if not had:
            self.rebuild_async(reason="rollback_cold")
        return had

    def on_canary_rollback(self, bad_step: int, reason: str) -> None:
        """A canary breached before promotion: its candidate version
        (if one was warmed) is dropped; a DRIFT-reason breach is direct
        evidence the embedding spaces moved, so the live index is
        marked stale and a rebuild is forced."""
        with self._lock:
            dropped = self._versions.pop(int(bad_step), None) \
                if int(bad_step) != self._active_step else None
        if dropped is not None:
            self._drop_index(dropped)
            _events.emit("index", action="drop", step=int(bad_step),
                         reason=reason)
        if reason == "shadow_drift":
            self.mark_stale(f"canary drift breach (step {bad_step})")

    def mark_stale(self, reason: str) -> None:
        """Flag the active index stale and force a rebuild."""
        with self._lock:
            if self._active_step is None:
                return
            self._stale_reason = reason
        self.metrics.op("stale")
        _events.emit("index", action="stale",
                     step=self._active_step, reason=reason)
        logger.warning("retrieval: active index (step %s) marked "
                       "STALE: %s — forcing rebuild",
                       self._active_step, reason)
        self.publish()
        self.rebuild_async(reason="stale")

    # -- data path ---------------------------------------------------------
    def insert(self, inputs, vectors,
               step: int | None = None) -> list[int]:
        """Store input rows + their embeddings under the active
        version; returns assigned ids. ``step`` is the checkpoint step
        that PRODUCED the vectors — a mismatch with the active version
        rejects the insert (empty list): wrong-space vectors must
        never enter the index."""
        x = np.asarray(inputs, np.float32)
        if x.ndim == 1:
            x = x[None]
        vecs = np.asarray(vectors, np.float32)
        if vecs.ndim == 1:
            vecs = vecs[None]
        with self._lock:
            if self.dim is None:
                self.dim = int(vecs.shape[1])
            elif int(vecs.shape[1]) != self.dim:
                # Wrong-width vectors (a worker serving a changed
                # --proj-dim, a foreign payload): rejected BEFORE any
                # state mutates — same graceful empty answer as a
                # wrong-step insert, never a ValueError escaping into
                # the router's handler thread.
                logger.warning("retrieval: insert rejected — dim %d "
                               "!= index dim %d", vecs.shape[1],
                               self.dim)
                return []
            if self._active_step is None and step is not None:
                # Inserts arriving before any rollout decision adopt
                # the producing step — an index must exist to be
                # versioned.
                self._ensure_locked(int(step))
                self._active_step = int(step)
            if self._active_step is None:
                if step is None:
                    # No versioning signal anywhere (stepless smoke
                    # fleets): a single unversioned index under step -1.
                    self._ensure_locked(-1)
                    self._active_step = -1
            elif step is not None and int(step) != self._active_step:
                return []
            idx = self._versions.get(self._active_step)
            if idx is None:
                # The version was registered before the dim was known
                # (activate/promote ahead of the first insert) —
                # materialize it now.
                idx = self._versions[self._active_step] = \
                    self._new_index(self._active_step)
            ids = list(range(self._next_id,
                             self._next_id + x.shape[0]))
            self._next_id += x.shape[0]
            for i, row in zip(ids, x):
                self._docstore[i] = np.array(row, np.float32)
            self._doc_append(ids, x)
            evicted = 0
            while len(self._docstore) > self.docstore_rows:
                self._docstore.popitem(last=False)
                evicted += 1
            if evicted:
                # Evicted rows become dead log records; the watermark
                # (smallest retained id) filters them out of a replay
                # even before the next compaction rewrites the log.
                self._doc_dead += evicted
                self._doc_watermark = next(iter(self._docstore)) \
                    if self._docstore else self._next_id
            # Under the lock: a rebuild's version swap racing this
            # insert would otherwise receive the rows into the
            # about-to-be-orphaned instance — 200 with ids that never
            # answer a search. The hold is the append cost (ms), and
            # searches only touch this lock for version resolution,
            # never for the scan.
            idx.insert(np.asarray(ids, np.int64), vecs)
        self._drain_orphans()
        if evicted:
            self.metrics.docstore_evictions.inc(evicted)
        self.publish()
        return ids

    def search(self, queries, k: int = 10,
               prefer_step: int | None = None) -> dict:
        """Search the version matching ``prefer_step`` (the step that
        embedded the queries) when retained, else the active version —
        query and index must share an embedding space, and during a
        rollout window a laggard worker's embeddings legitimately
        belong to the PRIOR version. Returns ``{ids, scores, step,
        stale, rows}``; ids/scores are lists (JSON-ready)."""
        with self._lock:
            step = self._active_step
            if prefer_step is not None \
                    and self._versions.get(int(prefer_step)) is not None:
                step = int(prefer_step)
            idx = self._versions.get(step) if step is not None else None
            stale = self._stale_reason is not None \
                and step == self._active_step
        if idx is None:
            return {"ids": [], "scores": [], "step": None,
                    "stale": False, "rows": 0}
        ids, scores = idx.search(queries, k)
        return {"ids": ids.tolist(),
                "scores": [[float(s) if np.isfinite(s) else None
                            for s in row] for row in scores],
                "step": step, "stale": stale, "rows": idx.rows}

    def docstore_inputs(self) -> tuple[list[int], np.ndarray | None]:
        """(ids, stacked input rows) currently retained for rebuild."""
        with self._lock:
            if not self._docstore:
                return [], None
            ids = list(self._docstore.keys())
            rows = np.stack([self._docstore[i] for i in ids])
        return ids, rows

    # -- rebuild -----------------------------------------------------------
    def rebuild_async(self, reason: str) -> bool:
        """Re-embed the docstore through ``reembed`` into a FRESH index
        for the active step on a background thread, then swap it in
        atomically. One rebuild at a time; returns False when skipped
        (no reembed fn, nothing stored, or one already running)."""
        if self.reembed is None:
            return False
        with self._lock:
            if not self._docstore or self._active_step is None:
                return False
            if self._rebuild_thread is not None \
                    and self._rebuild_thread.is_alive():
                return False
            self._rebuild_thread = threading.Thread(
                target=self._rebuild, args=(reason,), daemon=True,
                name="retrieval-rebuild")
            self._rebuild_thread.start()
        return True

    def _rebuild(self, reason: str) -> None:
        """One rebuild incarnation. Runs in passes: rows inserted
        while a pass was re-embedding land in the THEN-active instance
        (which the swap replaces) — but they are in the docstore, so
        the next pass replays them; the loop converges the moment a
        pass completes with no concurrent inserts (``_next_id``
        unmoved). Bounded: a pathological sustained-insert storm gets
        a loud warning instead of an unbounded loop."""
        t0 = time.monotonic()
        total_rows = 0
        for attempt in range(4):
            target_step = self._active_step
            with self._lock:
                next_id0 = self._next_id
            ids, rows = self.docstore_inputs()
            if rows is None or target_step is None:
                return
            vecs = None
            try:
                vecs = self.reembed(rows)
            except Exception:  # noqa: BLE001 — a rebuild failure
                # leaves the old (possibly stale) index serving; it
                # must never take down the router thread pool.
                logger.exception("retrieval: rebuild re-embedding "
                                 "failed")
            if vecs is None:
                logger.warning("retrieval: rebuild(%s) aborted — "
                               "re-embed returned nothing (old index "
                               "keeps serving)", reason)
                return
            vecs = np.asarray(vecs, np.float32)
            if vecs.ndim != 2 or int(vecs.shape[1]) != self.dim:
                # A changed embedding width mid-rebuild must abort
                # loudly, not kill the rebuild thread with a
                # ValueError out of fresh.insert.
                logger.warning("retrieval: rebuild(%s) aborted — "
                               "re-embedded width %s != index dim %d",
                               reason, getattr(vecs, "shape", "?"),
                               self.dim)
                return
            fresh = self._new_index(int(target_step))
            fresh.insert(np.asarray(ids, np.int64),
                         np.asarray(vecs, np.float32),
                         count_metrics=False)
            fresh.maintain()
            with self._lock:
                if self._active_step != target_step:
                    # A promote/rollback raced the rebuild: this
                    # result is for a version nobody serves — drop it.
                    logger.warning("retrieval: rebuild(%s) for step "
                                   "%d discarded (active moved to %s)",
                                   reason, target_step,
                                   self._active_step)
                    replaced, settled = fresh, True
                else:
                    replaced = self._versions.get(target_step)
                    self._versions[target_step] = fresh
                    self._stale_reason = None
                    total_rows = len(ids)
                    # Converged only if nothing was inserted while
                    # this pass re-embedded (those rows went to the
                    # instance just replaced).
                    settled = self._next_id == next_id0
            self._drop_index(replaced)
            if replaced is fresh:
                return
            if settled:
                break
        else:
            logger.warning("retrieval: rebuild(%s) still catching up "
                           "after %d passes (sustained inserts) — "
                           "rows inserted in the last pass arrive on "
                           "the next rebuild", reason, attempt + 1)
        self.metrics.op("rebuild")
        self.metrics.rebuilt_rows.inc(total_rows)
        _events.emit("index", action="rebuild",
                     step=int(self._active_step
                              if self._active_step is not None else -1),
                     rows=total_rows, reason=reason,
                     duration_ms=round((time.monotonic() - t0) * 1e3, 3))
        logger.info("retrieval: rebuilt step index from %d stored "
                    "row(s) (%s)", total_rows, reason)
        self.publish()

    def wait_rebuild(self, timeout_s: float = 30.0) -> bool:
        """Block until any in-flight rebuild finishes (tests, smoke runs)."""
        t = self._rebuild_thread
        if t is None:
            return True
        t.join(timeout_s)
        return not t.is_alive()

    # -- maintenance / publishing -----------------------------------------
    def maintain(self) -> bool:
        # Heavy work (segment compaction, docstore log compaction) is
        # deferrable: when the fleet plane installed ``heavy_gate`` and
        # it reports busy, defer — bounded by ``heavy_defer_ticks``, so
        # a permanently busy fleet still compacts eventually. Seals and
        # training are NOT gated: they bound the exact-scan tail and
        # must track the insert rate.
        heavy = True
        if self.heavy_gate is not None:
            try:
                idle = bool(self.heavy_gate())
            except Exception:  # noqa: BLE001 — a broken gate must not
                # stall maintenance forever.
                idle = True
            if idle:
                self._heavy_deferred = 0
            elif self._heavy_deferred < self.heavy_defer_ticks:
                self._heavy_deferred += 1
                heavy = False
                self.metrics.op("heavy_defer")
            else:
                logger.info("retrieval: heavy maintenance forced "
                            "through after %d deferred tick(s)",
                            self._heavy_deferred)
                self.metrics.op("heavy_forced")
                self._heavy_deferred = 0
        idx = self.active()
        did = idx.maintain(heavy=heavy) if idx is not None else False
        if idx is not None and idx.trained:
            # The probe materializes every stored vector for its
            # brute-force ground truth — neither an idle index nor a
            # steady insert stream may pay that per tick. Probe on the
            # first trained pass, then only when rows moved >= 10 %
            # (or shrank — a rebuild swapped the instance).
            rows = idx.rows
            last = self._last_probe_rows
            if last < 0 or rows < last \
                    or rows - last >= max(1, last // 10):
                idx.recall_probe()
                self._last_probe_rows = rows
        if heavy and self._doc_f is not None:
            self._doc_sync()
            with self._lock:
                live = len(self._docstore)
                dead = self._doc_dead
            if dead > max(live, self._doc_compact_floor):
                self._doc_compact()
        self.publish()
        return did

    def publish(self) -> None:
        """Refresh the active-version gauges."""
        with self._lock:
            step = self._active_step
            idx = self._versions.get(step) if step is not None else None
            n_versions = len(self._versions)
            stale = self._stale_reason is not None
            doc = len(self._docstore)
        m = self.metrics
        m.version.set(step if step is not None else -1)
        m.stale.set(1 if stale else 0)
        m.versions.set(n_versions)
        m.docstore_rows.set(doc)
        if idx is not None:
            m.rows.set(idx.rows)
            m.segments.set(idx.store.segment_count)
            m.index_bytes.set(idx.resident_bytes())
            m.bytes_per_row.set(idx.scan_bytes_per_row())

    def _maint_loop(self) -> None:
        while not self._stop.wait(self.maintain_interval_s):
            try:
                self.maintain()
            except Exception:  # noqa: BLE001 — background upkeep must
                # survive any single bad pass.
                logger.exception("retrieval: maintenance pass failed")

    def start(self) -> "IndexManager":
        if self._maint_thread is not None:
            raise RuntimeError("index manager already started")
        self._stop.clear()
        self._maint_thread = threading.Thread(
            target=self._maint_loop, daemon=True,
            name="retrieval-maintain")
        self._maint_thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._maint_thread is not None:
            self._maint_thread.join(self.maintain_interval_s * 4 + 5.0)
            self._maint_thread = None
        # Close out the docstore log: fsync what the last flush left
        # in the page cache and persist the eviction watermark so the
        # next replay skips the dead prefix.
        if self._doc_f is not None:
            self._doc_sync()
            try:
                self._doc_f.close()
            except OSError:
                pass
            self._doc_f = None
            self._write_doc_meta(self._doc_watermark)

    def snapshot(self) -> dict:
        with self._lock:
            versions = {
                str(step): ({"rows": idx.rows, "trained": idx.trained,
                             "segments": idx.store.segment_count,
                             "bytes": int(idx.resident_bytes()),
                             "bytes_per_row":
                                 round(idx.scan_bytes_per_row(), 2),
                             "pq_m": (idx._codec.m
                                      if idx._codec is not None else 0),
                             "from_snapshot":
                                 bool(idx.trained_from_snapshot)}
                            if idx is not None
                            else {"rows": 0, "trained": False,
                                  "segments": 0})
                for step, idx in self._versions.items()
            }
            return {"active_step": self._active_step,
                    "prior_step": self._prior_step,
                    "stale": self._stale_reason,
                    "docstore_rows": len(self._docstore),
                    "docstore_durable": self._doc_f is not None,
                    "docstore_watermark": self._doc_watermark,
                    "next_id": self._next_id,
                    "versions": versions}
