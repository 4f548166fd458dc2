"""Append-only vector segments: a mutable tail, sealed memory-maps.

Counterpart of ``ntxent_tpu/retrieval/segments.py``: the same files,
byte for byte. The retrieval tier's durable substrate. Inserts land in a
plain in-memory ``MutableSegment``; once it crosses ``seal_rows`` the
maintenance pass SEALS it — the rows are staged under a ``.tmp-*``
directory, every file and the directory fsync'd, then the directory
``rename``d into place and the parent fsync'd. That is the checkpoint
tier's stage-fsync-rename idiom (training/checkpoint.py): a SIGKILL at
any instant leaves either no segment or a complete one, never a torn
file, and leftover staging debris is purged at open. Sealed segments
are read back as ``np.memmap`` views, so a large index costs the page
cache, not the heap, and reopening a store is O(metadata).

Compaction keeps the segment count bounded: when sealed segments
exceed ``compact_at``, one pass merges them all into a single new
segment (same atomic staging), publishes it, then deletes the inputs —
a reader that opened the old segments keeps its mmaps alive (POSIX
unlink semantics), a crash mid-compaction leaves the originals
untouched.

Everything here is numpy + stdlib: the router and shard processes
that run it load no torch.
"""

from __future__ import annotations

import json
import logging
import os
import shutil
import threading
import uuid
from pathlib import Path

import numpy as np

logger = logging.getLogger(__name__)

__all__ = ["MutableSegment", "SealedSegment", "SegmentStore"]

_META = "meta.json"
_VECS = "vectors.f32"
_IDS = "ids.i64"
_CODES = "codes.u8"
_ASSIGN = "assign.i32"


def _fsync_path(path: Path) -> None:
    """fsync a file or directory (directory fsync persists the entry);
    same tolerance contract as the checkpoint tier's copy."""
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


class MutableSegment:
    """The in-memory insert tail: grows by chunks, never reallocates
    per row. Single-writer (the index holds its own lock)."""

    def __init__(self, dim: int, chunk_rows: int = 1024):
        self.dim = int(dim)
        self.chunk_rows = max(1, int(chunk_rows))
        self._vecs = np.empty((0, self.dim), np.float32)
        self._ids = np.empty((0,), np.int64)
        self.rows = 0

    def append(self, ids: np.ndarray, vecs: np.ndarray) -> None:
        n = int(vecs.shape[0])
        need = self.rows + n
        if need > self._vecs.shape[0]:
            # Geometric growth: the copy-everything reallocation must
            # amortize to O(1)/row — with linear growth a large
            # unsealed tail paid a full-array copy every chunk_rows
            # inserts, and that copy runs under the index lock where
            # it read as a concurrent-search p99 spike.
            grow = max(need, int(self._vecs.shape[0] * 1.5),
                       self._vecs.shape[0] + self.chunk_rows)
            nv = np.empty((grow, self.dim), np.float32)
            nv[: self.rows] = self._vecs[: self.rows]
            self._vecs = nv
            ni = np.empty((grow,), np.int64)
            ni[: self.rows] = self._ids[: self.rows]
            self._ids = ni
        self._vecs[self.rows: need] = vecs
        self._ids[self.rows: need] = ids
        self.rows = need

    def view(self) -> tuple[np.ndarray, np.ndarray]:
        """Consistent ``(ids, vectors)`` snapshot for LOCK-FREE
        readers: the committed count is read before the buffers (data
        is written before the count bumps; growth copies the prefix
        before the swap), so the slice can never expose uninitialized
        rows or mismatched lengths."""
        n = self.rows
        ids, vecs = self._ids, self._vecs
        n = min(n, ids.shape[0], vecs.shape[0])
        return ids[:n], vecs[:n]

    @property
    def vectors(self) -> np.ndarray:
        return self.view()[1]

    @property
    def ids(self) -> np.ndarray:
        return self.view()[0]


class SealedSegment:
    """One on-disk segment: raw little-endian f32 rows + int64 ids,
    described by ``meta.json``, mapped read-only."""

    def __init__(self, path: Path):
        self.path = Path(path)
        meta = json.loads((self.path / _META).read_text())
        self.rows = int(meta["rows"])
        self.dim = int(meta["dim"])
        self.vectors = np.memmap(self.path / _VECS, dtype=np.float32,
                                 mode="r", shape=(self.rows, self.dim))
        self.ids = np.memmap(self.path / _IDS, dtype=np.int64,
                             mode="r", shape=(self.rows,))
        # PQ sidecars (encode-on-seal): compact codes + IVF
        # assignments stamped with the codec generation that produced
        # them. Optional — pre-PQ segments stay readable, and a
        # missing/mismatched sidecar means "recompute", never "fail".
        self.codec_gen = meta.get("codec_gen")
        self.codes = self.assign = None
        if self.codec_gen is not None:
            m = int(meta.get("pq_m", 0))
            try:
                if m > 0:
                    self.codes = np.memmap(
                        self.path / _CODES, dtype=np.uint8, mode="r",
                        shape=(self.rows, m))
                self.assign = np.memmap(
                    self.path / _ASSIGN, dtype=np.int32, mode="r",
                    shape=(self.rows,))
            except (OSError, ValueError):
                self.codes = self.assign = None
                self.codec_gen = None

    @property
    def name(self) -> str:
        return self.path.name


class FrozenSegment:
    """An in-memory sealed segment (``root=None`` stores): same read
    surface as ``SealedSegment``, no durability. Freezing still
    matters without a disk — it bounds the mutable tail, so the
    geometric-growth copy can never grow past ``seal_rows`` (an
    unbounded tail's reallocation measured as a multi-10-ms search
    stall under the index lock)."""

    def __init__(self, name: str, ids: np.ndarray, vecs: np.ndarray,
                 codes: np.ndarray | None = None,
                 assign: np.ndarray | None = None,
                 codec_gen: int | None = None):
        self.name = name
        self.ids = np.ascontiguousarray(ids, np.int64)
        self.vectors = np.ascontiguousarray(vecs, np.float32)
        self.rows = int(self.vectors.shape[0])
        self.dim = int(self.vectors.shape[1])
        self.codes = codes
        self.assign = assign
        self.codec_gen = codec_gen


def _write_segment(parent: Path, name: str, ids: np.ndarray,
                   vecs: np.ndarray,
                   codes: np.ndarray | None = None,
                   assign: np.ndarray | None = None,
                   codec_gen: int | None = None) -> Path:
    """Stage + fsync + rename one complete segment directory.
    ``codes``/``assign`` (with their ``codec_gen`` stamp) ride the
    same atomic commit — a segment either carries a complete PQ
    sidecar or none."""
    tmp = parent / f".tmp-{name}-{uuid.uuid4().hex[:8]}"
    tmp.mkdir(parents=True)
    vecs = np.ascontiguousarray(vecs, np.float32)
    ids = np.ascontiguousarray(ids, np.int64)
    blobs = [(_VECS, vecs), (_IDS, ids)]
    meta = {"rows": int(vecs.shape[0]), "dim": int(vecs.shape[1])}
    if assign is not None and codec_gen is not None:
        blobs.append((_ASSIGN,
                      np.ascontiguousarray(assign, np.int32)))
        meta["codec_gen"] = int(codec_gen)
        meta["pq_m"] = 0
        if codes is not None:
            codes = np.ascontiguousarray(codes, np.uint8)
            blobs.append((_CODES, codes))
            meta["pq_m"] = int(codes.shape[1])
    for fname, arr in blobs:
        with open(tmp / fname, "wb") as f:
            f.write(arr.tobytes())
            f.flush()
            os.fsync(f.fileno())
    with open(tmp / _META, "w") as f:
        json.dump(meta, f)
        f.flush()
        os.fsync(f.fileno())
    _fsync_path(tmp)
    final = parent / name
    os.rename(tmp, final)
    _fsync_path(parent)
    return final


class SegmentStore:
    """Mutable tail + sealed mmaps under one directory (or fully
    in-memory with ``root=None`` — tests and ephemeral indexes).

    Not itself thread-safe: the owning ``VectorIndex`` serializes
    mutation; readers go through ``blocks()`` snapshots.
    """

    def __init__(self, dim: int, root: str | os.PathLike | None = None,
                 seal_rows: int = 4096, compact_at: int = 4):
        self.dim = int(dim)
        self.seal_rows = max(1, int(seal_rows))
        self.compact_at = max(2, int(compact_at))
        self.root = Path(root) if root is not None else None
        self.mutable = MutableSegment(self.dim)
        self.sealed: list = []
        # Optional PQ coder (set by the owning index once trained):
        # an object with encode(vecs)->uint8 codes, assign(vecs)->
        # int32 IVF lists, and a ``gen`` stamp. When present, freeze
        # and merge write the sidecars — encode-on-seal is what makes
        # the trained state rebuildable without touching raw floats.
        self.coder = None
        # A taken-but-not-yet-published tail (mid-freeze): still part
        # of every read view — a brute-force search during the freeze
        # window must not miss its rows.
        self.pending: MutableSegment | None = None
        self._seq = 0
        if self.root is not None:
            self.root.mkdir(parents=True, exist_ok=True)
            for debris in self.root.glob(".tmp-*"):
                # A crash mid-seal/compact left staging: incomplete by
                # definition (the rename IS the commit) — purge.
                shutil.rmtree(debris, ignore_errors=True)
            for seg in sorted(self.root.glob("seg-*")):
                try:
                    self.sealed.append(SealedSegment(seg))
                except (OSError, ValueError, KeyError) as e:
                    logger.warning("retrieval: unreadable segment %s "
                                   "(%s) — skipped", seg, e)
            if self.sealed:
                self._seq = 1 + max(int(s.name.split("-")[1])
                                    for s in self.sealed)

    # -- writes ------------------------------------------------------------
    def append(self, ids: np.ndarray, vecs: np.ndarray) -> None:
        self.mutable.append(ids, vecs)

    def should_seal(self) -> bool:
        return self.mutable.rows >= self.seal_rows

    # The two-phase maintenance primitives (VectorIndex.maintain): the
    # POINTER operations (take/publish/swap) run under the index lock
    # in microseconds, the COPY/IO operations (freeze/merge) run
    # outside it — a seal's fsync or a compaction's merge must never
    # stall a concurrent search.
    def take_mutable(self) -> MutableSegment:
        """Swap the mutable tail for a fresh one (pointer-only); the
        taken tail stays visible via ``pending`` until published.

        Write ORDER matters for the lock-free readers: ``pending`` is
        set BEFORE the mutable swap (and ``publish`` appends to
        ``sealed`` before clearing ``pending``), while ``blocks()``
        reads mutable → pending → sealed. Any interleaving then shows
        the taken rows in at least one place — the tolerated transient
        is a DUPLICATE sighting (both pending and its published copy),
        never a loss."""
        taken = self.mutable
        self.pending = taken
        self.mutable = MutableSegment(self.dim)
        return taken

    def _code(self, vecs: np.ndarray):
        """``(codes, assign, gen)`` for rows about to seal — or
        ``(None, None, None)`` without a trained coder."""
        coder = self.coder
        if coder is None or vecs.shape[0] == 0:
            return None, None, None
        return coder.encode(vecs), coder.assign(vecs), coder.gen

    def freeze(self, mutable: MutableSegment):
        """Materialize a taken tail as a sealed segment (disk when
        rooted, in-memory otherwise). Copy/IO only — no store state
        is touched; ``publish`` it afterwards."""
        name = f"seg-{self._seq:06d}"
        self._seq += 1
        ids, vecs = mutable.view()
        codes, assign, gen = self._code(vecs)
        if self.root is None:
            return FrozenSegment(name, ids, vecs, codes=codes,
                                 assign=assign, codec_gen=gen)
        path = _write_segment(self.root, name, ids, vecs,
                              codes=codes, assign=assign,
                              codec_gen=gen)
        return SealedSegment(path)

    def publish(self, segment) -> None:
        self.sealed.append(segment)
        self.pending = None

    def seal(self):
        """Single-threaded convenience: take + freeze + publish."""
        if self.mutable.rows == 0:
            return None
        seg = self.freeze(self.take_mutable())
        self.publish(seg)
        return seg

    def should_compact(self) -> bool:
        return len(self.sealed) > self.compact_at

    def merge(self, segments: list):
        """Merge sealed segments into one new segment (copy/IO only;
        ``swap_sealed`` it in afterwards). Input sidecars of the
        current codec generation are CONCATENATED, never recomputed —
        a compaction is an IO pass, not an encode pass; any stale or
        missing sidecar re-encodes that segment only."""
        ids = np.concatenate([np.asarray(s.ids) for s in segments])
        vecs = np.concatenate([np.asarray(s.vectors)
                               for s in segments])
        codes = assign = gen = None
        coder = self.coder
        if coder is not None and vecs.shape[0]:
            gen = coder.gen
            code_parts, assign_parts = [], []
            for s in segments:
                if getattr(s, "codec_gen", None) == gen \
                        and s.assign is not None:
                    assign_parts.append(np.asarray(s.assign))
                    code_parts.append(
                        np.asarray(s.codes) if s.codes is not None
                        else coder.encode(np.asarray(s.vectors)))
                else:
                    sv = np.asarray(s.vectors)
                    code_parts.append(coder.encode(sv))
                    assign_parts.append(coder.assign(sv))
            codes = np.concatenate(code_parts)
            assign = np.concatenate(assign_parts)
        name = f"seg-{self._seq:06d}"
        self._seq += 1
        if self.root is None:
            return FrozenSegment(name, ids, vecs, codes=codes,
                                 assign=assign, codec_gen=gen)
        return SealedSegment(_write_segment(
            self.root, name, ids, vecs, codes=codes, assign=assign,
            codec_gen=gen))

    def swap_sealed(self, olds: list, merged) -> None:
        """Replace ``olds`` (a prefix snapshot of ``sealed``) with
        ``merged`` (pointer-only; the caller deletes old dirs after)."""
        assert self.sealed[: len(olds)] == olds
        self.sealed = [merged] + self.sealed[len(olds):]

    @staticmethod
    def delete_segments(segments: list) -> None:
        for s in segments:
            path = getattr(s, "path", None)
            if path is not None:
                shutil.rmtree(path, ignore_errors=True)

    def compact(self):
        """Single-threaded convenience: merge every sealed segment and
        delete the inputs. Returns the merged segment."""
        if len(self.sealed) < 2:
            return None
        olds = list(self.sealed)
        merged = self.merge(olds)
        self.swap_sealed(olds, merged)
        self.delete_segments(olds)
        return merged

    # -- reads -------------------------------------------------------------
    @property
    def rows(self) -> int:
        pending = self.pending.rows if self.pending is not None else 0
        return self.mutable.rows + pending \
            + sum(s.rows for s in self.sealed)

    @property
    def segment_count(self) -> int:
        """Sealed segments + pending + the mutable tail (non-empty)."""
        return len(self.sealed) \
            + (1 if self.pending is not None else 0) \
            + (1 if self.mutable.rows else 0)

    def blocks(self):
        """Yield ``(ids, vectors)`` per segment.

        READ order (mutable → pending → sealed) is the mirror of the
        seal path's write order (see ``take_mutable``): a lock-free
        reader racing a seal may see the taken rows twice (pending +
        published), never zero times. Duplicates are a nanosecond-
        window transient on the pre-training brute-force path only;
        loss would be silent wrong answers."""
        mutable = self.mutable
        pending = self.pending
        sealed = list(self.sealed)
        for s in sealed:
            yield s.ids, s.vectors
        if pending is not None and pending.rows:
            yield pending.view()
        if mutable.rows:
            yield mutable.view()

    def all_rows(self) -> tuple[np.ndarray, np.ndarray]:
        """Materialize ``(ids, vectors)`` across every segment."""
        parts = list(self.blocks())
        if not parts:
            return (np.empty((0,), np.int64),
                    np.empty((0, self.dim), np.float32))
        return (np.concatenate([np.asarray(i) for i, _ in parts]),
                np.concatenate([np.asarray(v) for _, v in parts]))
