"""Durable per-shard insert journal: the write-ahead log that turns
"a dead shard drops rows forever" into "a dead shard delays rows".

Every batch the fan-out routes to a shard is appended HERE first
(flush-per-append), then pushed over HTTP. The journal keeps two
numbers per shard: the total rows ever appended and the acked prefix
the shard has confirmed. ``depth = total - acked`` is the repair debt
— rows that were routed while the owner was dead (or that a restarted
owner lost with its memory). A background repair replays the unacked
tail — or the FULL history, when the shard comes back empty — through
the fan-out's normal insert path, so redelivered rows re-route under
the CURRENT ring and version (a row whose list migrated lands on its
new owner; a row embedded under a rolled-back model version is dropped
at the trust gate, never replayed into the wrong plane).

File discipline is the docstore log's (``versioned.py``): one
append-only file per shard, flush on append, fsync on sync/compact,
torn-tail truncation on reopen, watermark meta via
tmp-fsync-``os.replace``, compaction by stage-fsync-rename. Replay is
idempotent end to end because ``IndexShard.insert`` dedups by id —
a crash between delivery and watermark write redelivers, never
duplicates.

Record format (one record per routed batch)::

    <qii>  version (int64, -1 = unversioned), n_rows, dim
    n_rows * int64   ids
    n_rows * dim * float32  vectors

``root=None`` gives the same API in memory (tests, journal-less
planes). Numpy + stdlib only, as the rest of ``retrieval/``.
Counterpart of ``ntxent_tpu/retrieval/journal.py``: the same records.
"""

from __future__ import annotations

import json
import logging
import os
import struct
import threading
import uuid
from pathlib import Path

import numpy as np

logger = logging.getLogger(__name__)

__all__ = ["ShardJournal"]

_HDR = struct.Struct("<qii")  # version, n_rows, dim
_MAX_ROWS = 10_000_000  # per-record sanity bound for replay
_MAX_DIM = 65_536


def _fsync_path(path) -> None:
    """Best-effort fsync of a file or directory (durability of the
    rename, not just the bytes)."""
    try:
        fd = os.open(str(path), os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


class _Log:
    """One shard's journal: file handle + counters. All mutation under
    the owning journal's lock."""

    __slots__ = ("path", "meta_path", "fh", "total_batches",
                 "total_rows", "acked_batches", "acked_rows", "mem",
                 "pending")

    def __init__(self, path: Path | None, meta_path: Path | None):
        self.path = path
        self.meta_path = meta_path
        self.fh = None
        self.total_batches = 0
        self.total_rows = 0
        self.acked_batches = 0
        self.acked_rows = 0
        # Delivered batches above the watermark (ordinal -> rows):
        # the watermark only advances over a CONTIGUOUS delivered
        # prefix, so a failed batch holds it (and the depth) until
        # repair redelivers the range.
        self.pending: dict[int, int] = {}
        # In-memory mode: list of (version, ids, vecs) batches.
        self.mem: list | None = [] if path is None else None

    def advance(self) -> None:
        while self.acked_batches in self.pending:
            self.acked_rows += self.pending.pop(self.acked_batches)
            self.acked_batches += 1


class ShardJournal:
    """Append-only per-shard insert WAL with an acked watermark.

    ``append`` before the HTTP push, ``ack`` on delivery, ``replay``
    to redeliver (tail or full history), ``compact`` to fold a long
    delivered history down to one live batch per shard.
    """

    def __init__(self, root: str | Path | None = None,
                 compact_rows: int = 100_000):
        self.root = Path(root) if root is not None else None
        self.compact_rows = max(1, int(compact_rows))
        self._lock = threading.Lock()
        self._logs: dict[int, _Log] = {}
        if self.root is not None:
            self.root.mkdir(parents=True, exist_ok=True)
            # Purge staged compactions that never renamed.
            for debris in self.root.glob(".tmp-*"):
                try:
                    debris.unlink()
                except OSError:
                    pass
            for p in sorted(self.root.glob("shard-*.log")):
                try:
                    sid = int(p.stem.split("-", 1)[1])
                except (IndexError, ValueError):
                    continue
                self._reopen(sid)

    # -- per-shard log plumbing ----------------------------------------------
    def _log(self, sid: int) -> _Log:
        log = self._logs.get(sid)
        if log is None:
            if self.root is None:
                log = _Log(None, None)
            else:
                log = _Log(self.root / f"shard-{sid}.log",
                           self.root / f"shard-{sid}.meta.json")
                log.fh = open(log.path, "ab")
            self._logs[sid] = log
        return log

    def _reopen(self, sid: int) -> None:
        """Replay an existing file: count intact records, truncate the
        torn tail (a kill mid-append leaves a partial record — the
        prefix is the truth), clamp the watermark to what survived."""
        log = _Log(self.root / f"shard-{sid}.log",
                   self.root / f"shard-{sid}.meta.json")
        acked_b = acked_r = 0
        try:
            meta = json.loads(log.meta_path.read_text())
            acked_b = int(meta.get("acked_batches", 0))
            acked_r = int(meta.get("acked_rows", 0))
        except (OSError, ValueError):
            pass
        with open(log.path, "r+b") as f:
            f.seek(0, os.SEEK_END)
            size = f.tell()
            off = batches = rows = 0
            while off + _HDR.size <= size:
                f.seek(off)
                _, n, d = _HDR.unpack(f.read(_HDR.size))
                end = off + _HDR.size + n * 8 + n * d * 4
                if (n <= 0 or n > _MAX_ROWS or d <= 0 or d > _MAX_DIM
                        or end > size):
                    break
                batches += 1
                rows += n
                off = end
            if off < size:
                logger.warning(
                    "shard journal %s: torn tail truncated at byte %d "
                    "(%d bytes dropped)", log.path, off, size - off)
                f.truncate(off)
                f.flush()
                os.fsync(f.fileno())
        log.total_batches, log.total_rows = batches, rows
        # A watermark ahead of the surviving records is impossible
        # (acks follow appends); behind is fine — replay redelivers
        # and the shard dedups by id.
        log.acked_batches = min(acked_b, batches)
        log.acked_rows = min(acked_r, rows)
        if log.acked_batches < acked_b:
            log.acked_rows = 0
            log.acked_batches = 0
        log.fh = open(log.path, "ab")
        self._logs[sid] = log

    def _write_meta(self, log: _Log) -> None:
        if log.meta_path is None:
            return
        tmp = log.meta_path.with_suffix(f".tmp-{uuid.uuid4().hex[:8]}")
        payload = json.dumps({"acked_batches": log.acked_batches,
                              "acked_rows": log.acked_rows})
        try:
            with open(tmp, "w") as f:
                f.write(payload)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, log.meta_path)
            _fsync_path(self.root)
        except OSError as e:
            logger.warning("shard journal meta write failed: %s", e)
            try:
                tmp.unlink()
            except OSError:
                pass

    # -- the WAL surface -----------------------------------------------------
    def append(self, sid: int, ids, vecs,
               version: int | None) -> int | None:
        """Journal one routed batch BEFORE the push. Returns the batch
        ordinal (the ``ack`` handle), or None when the disk write
        failed — the caller counts those rows as truly dropped."""
        ids = np.ascontiguousarray(ids, np.int64)
        vecs = np.ascontiguousarray(vecs, np.float32)
        if vecs.ndim == 1:
            vecs = vecs[None]
        n, d = vecs.shape
        ver = -1 if version is None else int(version)
        with self._lock:
            log = self._log(sid)
            if n == 0:
                return log.total_batches
            if log.mem is not None:
                log.mem.append((ver, ids.copy(), vecs.copy()))
            else:
                try:
                    buf = bytearray(_HDR.pack(ver, n, d))
                    buf += ids.tobytes()
                    buf += vecs.tobytes()
                    log.fh.write(buf)
                    log.fh.flush()
                except OSError as e:
                    logger.error("shard journal append failed for "
                                 "shard %d: %s", sid, e)
                    return None
            ordinal = log.total_batches
            log.total_batches += 1
            log.total_rows += n
            return ordinal

    def ack(self, sid: int, ordinal: int, rows: int) -> None:
        """Confirm delivery of one appended batch. The watermark
        advances over the contiguous delivered prefix — a failed
        earlier batch holds it (and the depth) until repair redelivers
        the range (shard-side id dedup makes redelivery free)."""
        with self._lock:
            log = self._logs.get(sid)
            if log is None or ordinal < log.acked_batches:
                return
            log.pending[int(ordinal)] = int(rows)
            log.advance()

    def set_acked(self, sid: int, batches: int, rows: int) -> None:
        """Move the watermark to a replay snapshot boundary (every
        record below it was redelivered or version-dropped)."""
        with self._lock:
            log = self._logs.get(sid)
            if log is None:
                return
            if int(batches) > log.acked_batches:
                log.acked_batches = min(int(batches),
                                        log.total_batches)
                log.acked_rows = max(log.acked_rows,
                                     min(int(rows), log.total_rows))
            for done in [b for b in log.pending
                         if b < log.acked_batches]:
                del log.pending[done]
            log.advance()
            self._write_meta(log)

    def depth(self, sid: int) -> int:
        with self._lock:
            log = self._logs.get(sid)
            return 0 if log is None else log.total_rows - log.acked_rows

    def depths(self) -> dict:
        with self._lock:
            return {sid: log.total_rows - log.acked_rows
                    for sid, log in self._logs.items()}

    def totals(self, sid: int) -> tuple[int, int]:
        """(total_batches, total_rows) — the replay snapshot bound."""
        with self._lock:
            log = self._logs.get(sid)
            return (0, 0) if log is None else (log.total_batches,
                                               log.total_rows)

    def shards(self) -> list[int]:
        with self._lock:
            return sorted(self._logs)

    def replay(self, sid: int, from_start: bool = False,
               upto_batches: int | None = None):
        """Yield ``(version, ids, vecs)`` batches from the watermark
        (or from record 0 for a restarted-empty shard) up to a
        snapshot bound. Reads a private handle — appends during replay
        land past the bound and are untouched."""
        with self._lock:
            log = self._logs.get(sid)
            if log is None:
                return
            start = 0 if from_start else log.acked_batches
            stop = (log.total_batches if upto_batches is None
                    else min(int(upto_batches), log.total_batches))
            mem = None if log.mem is None else list(log.mem)
            path = log.path
        if mem is not None:
            for ver, ids, vecs in mem[start:stop]:
                yield (None if ver == -1 else ver), ids, vecs
            return
        with open(path, "rb") as f:
            for i in range(stop):
                head = f.read(_HDR.size)
                if len(head) < _HDR.size:
                    return
                ver, n, d = _HDR.unpack(head)
                body = f.read(n * 8 + n * d * 4)
                if len(body) < n * 8 + n * d * 4:
                    return
                if i < start:
                    continue
                ids = np.frombuffer(body[: n * 8], np.int64).copy()
                vecs = np.frombuffer(body[n * 8:], np.float32).reshape(
                    n, d).copy()
                yield (None if ver == -1 else ver), ids, vecs

    def maybe_compact(self, sid: int, live_version: int | None) -> bool:
        """When the delivered history has grown past ``compact_rows``,
        fold it: keep the LAST record per id at the live version (the
        row a full replay would leave standing), rewrite by
        stage-fsync-rename, watermark = everything. Only runs with a
        clean watermark (depth 0) — compacting an undelivered tail
        would launder the debt."""
        with self._lock:
            log = self._logs.get(sid)
            if (log is None or log.total_rows - log.acked_rows != 0
                    or log.total_rows <= self.compact_rows):
                return False
        live_ids: dict[int, np.ndarray] = {}
        dim = 0
        for ver, ids, vecs in self.replay(sid, from_start=True):
            if live_version is not None and ver != live_version:
                continue
            dim = vecs.shape[1]
            for j, rid in enumerate(ids.tolist()):
                live_ids[rid] = vecs[j]
        with self._lock:
            log = self._logs.get(sid)
            if log is None or log.total_rows != log.acked_rows:
                return False  # raced an append; next maintenance
            if live_ids:
                ids = np.fromiter(live_ids, np.int64,
                                  count=len(live_ids))
                vecs = np.stack([live_ids[i] for i in ids.tolist()]
                                ).astype(np.float32)
            else:
                ids = np.empty((0,), np.int64)
                vecs = np.empty((0, max(1, dim)), np.float32)
            n = int(ids.shape[0])
            if log.mem is not None:
                log.mem = ([] if n == 0
                           else [(-1 if live_version is None
                                  else int(live_version), ids, vecs)])
            else:
                tmp = self.root / f".tmp-{uuid.uuid4().hex[:8]}"
                try:
                    with open(tmp, "wb") as f:
                        if n:
                            ver = (-1 if live_version is None
                                   else int(live_version))
                            f.write(_HDR.pack(ver, n, vecs.shape[1]))
                            f.write(ids.tobytes())
                            f.write(vecs.tobytes())
                        f.flush()
                        os.fsync(f.fileno())
                    log.fh.close()
                    os.rename(tmp, log.path)
                    _fsync_path(self.root)
                    log.fh = open(log.path, "ab")
                except OSError as e:
                    logger.warning("shard journal compact failed: %s",
                                   e)
                    try:
                        tmp.unlink()
                    except OSError:
                        pass
                    log.fh = open(log.path, "ab")
                    return False
            log.total_batches = log.acked_batches = 1 if n else 0
            log.total_rows = log.acked_rows = n
            log.pending.clear()
            self._write_meta(log)
        logger.info("shard journal %d compacted to %d live row(s)",
                    sid, n)
        return True

    def sync(self) -> None:
        """fsync every log + persist watermarks (maintenance cadence —
        appends only flush)."""
        with self._lock:
            for log in self._logs.values():
                if log.fh is not None:
                    try:
                        log.fh.flush()
                        os.fsync(log.fh.fileno())
                    except OSError:
                        pass
                self._write_meta(log)

    def close(self) -> None:
        self.sync()
        with self._lock:
            for log in self._logs.values():
                if log.fh is not None:
                    try:
                        log.fh.close()
                    except OSError:
                        pass
                    log.fh = None
