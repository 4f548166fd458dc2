"""Sharded index plane: IVF lists partitioned across worker processes.

At millions of rows a single process's scan is bounded by one memory
bus. The shard plane splits the CODED structure, not the query: each
IVF list has one owning shard (rendezvous hashing — see
``shard_owner``), every shard keeps the full centroid table, and a
query probes the same global top-``nprobe`` lists on EVERY shard —
shard ``s`` contributes exactly the probed lists it holds, so the
union across shards equals the unsharded probe set row-for-row.
Scores are exact re-ranked inner products (scan.py), hence directly
comparable, and the router-side merge is a per-query top-k that
dedups by id (a list mid-migration briefly lives on two shards; the
duplicate carries the identical exact score). Three consequences:

* recall is IDENTICAL to the unsharded index when every shard answers
  (same candidate rows, same exact scores);
* a dead shard subtracts only the rows of the lists it holds — the
  merge runs over whoever answered, the response carries
  ``shards: {ok, total, degraded}``, and availability never depends
  on any single shard. Degraded recall, never a 503;
* changing ``n_shards`` N→N±1 moves only ~1/N of the lists
  (``ShardFanout.rebalance`` streams each moving list row-by-row
  under a two-phase cutover — no re-clustering, ever).

The plane is VERSIONED: every shard carries the checkpoint-step-keyed
generation of the index it serves (the ``retrieval/versioned.py``
contract), echoes it on every response, and retains ONE prior
generation so a rollout rollback restores the previous plane without
a rebuild. The fan-out stamps inserts with the plane version and
rejects search responses from a shard on the wrong generation —
mixed-model neighbors across shards are impossible by construction.

Dropped rows are REPAIRED, not counted: every routed batch lands in a
durable per-shard journal (``journal.py``) before the push; a dead or
version-drifted shard's debt drains back through the normal insert
path when it returns (``repair_tick``), and a shard that comes back
EMPTY (restart) is resurrected from its full journal history.

Training stays CENTRAL: the coordinator (``ShardFanout``) buffers the
first ``train_rows`` inserts, fits IVF centroids + the PQ codec once,
pushes both to every shard (``POST /shard/init``), then flushes the
buffered rows to their owners. Until that point searches brute-force
the coordinator's buffer — cold behavior matches ``VectorIndex``.

Wire format: vectors ride as base64 float32 blobs (``_pack``), ~3x
denser than JSON float lists and loss-free. Everything here is numpy
+ stdlib (http.server / urllib): a shard process loads no torch.
``main()`` is the subprocess entry (``python -m
ntxent_tpu_torch.retrieval.shard``) so shard workers ride the fleet's
supervision path (``serving/fleet.py``): port-file handshake,
``/readyz`` probe, SIGTERM-clean shutdown.

Counterpart of ``ntxent_tpu/retrieval/shard.py``: the same HTTP wire.
"""

from __future__ import annotations

import base64
import json
import logging
import os
import signal
import socket
import sys
import threading
import time
import urllib.error
import urllib.request
from concurrent.futures import ThreadPoolExecutor
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from .ivf import brute_force_topk, kmeans
from .journal import ShardJournal
from .pq import PQCodec
from .scan import CodedLists, batched_scan

logger = logging.getLogger(__name__)

__all__ = ["IndexShard", "ShardClient", "ShardFanout", "ShardServer",
           "main", "shard_owner"]

_MAX_BODY = 64 * 1024 * 1024  # b64 f32 rows are bulky; cap, don't trust


def _mix64(x: np.ndarray) -> np.ndarray:
    """splitmix64 finalizer — the avalanche mixing both rendezvous
    keys ride. Pure uint64 numpy, wraps mod 2^64 by construction."""
    x = np.asarray(x, np.uint64)
    x = (x ^ (x >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
    x = (x ^ (x >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    return x ^ (x >> np.uint64(31))


def shard_owner(lists: np.ndarray, n_shards: int) -> np.ndarray:
    """IVF list -> owning shard via rendezvous (HRW) hashing.

    Owner = argmax over shards of ``mix(mix(list) ^ mix(shard))``:
    deterministic, derivable anywhere from ``(list, n_shards)`` with
    no ring state to replicate, and — the property the old ``c % N``
    placement lacked — growing or shrinking the plane by one shard
    remaps only ~1/N of the lists (each list's argmax survives unless
    the new shard wins it), so a rebalance streams a fraction of the
    rows instead of rebuilding the plane.
    """
    arr = np.asarray(lists, np.int64)
    n = int(n_shards)
    if n <= 1:
        return np.zeros(np.shape(arr), np.int64)
    with np.errstate(over="ignore"):
        lk = _mix64(arr.astype(np.uint64)
                    + np.uint64(0x9E3779B97F4A7C15))
        sk = _mix64((np.arange(1, n + 1, dtype=np.uint64))
                    * np.uint64(0xD1B54A32D192ED03))
        w = _mix64(lk[..., None] ^ sk)
    return np.argmax(w, axis=-1).astype(np.int64)


def _pack(arr: np.ndarray) -> dict:
    a = np.ascontiguousarray(arr, np.float32)
    return {"shape": list(a.shape),
            "f32": base64.b64encode(a.tobytes()).decode("ascii")}


def _unpack(obj: dict) -> np.ndarray:
    shape = tuple(int(s) for s in obj["shape"])
    raw = base64.b64decode(obj["f32"])
    return np.frombuffer(raw, np.float32).reshape(shape).copy()


class _Gen:
    """One plane generation on one shard: the coded lists, the raw
    re-rank buffer backing them, the version stamp, and the id-dedup
    set that makes journal replay idempotent."""

    __slots__ = ("step", "coded", "raw", "raw_rows", "seen")

    def __init__(self, dim: int, step: int | None = None):
        self.step = step
        self.coded: CodedLists | None = None
        self.raw = np.empty((0, dim), np.float32)
        self.raw_rows = 0
        self.seen: set[int] = set()


class IndexShard:
    """One worker's slice of the plane: the coded lists it owns plus a
    raw grow-buffer source for exact re-rank — now two-generational.

    Single-writer per shard (the HTTP handler serializes under
    ``_lock``); searches ride the lock-free coded-list views. ``cut``
    retains the current generation and opens a fresh empty one at the
    new step (same trained structure — versions share centroids);
    ``rollback`` swaps the retained generation back. Rows for lists
    this shard does NOT own under the current ring are rejected
    loudly; rows whose id the generation already holds are skipped
    silently (replay idempotency).
    """

    def __init__(self, dim: int, shard_id: int = 0, n_shards: int = 1):
        self.dim = int(dim)
        self.shard_id = int(shard_id)
        self.n_shards = max(1, int(n_shards))
        self._lock = threading.Lock()
        self._gen = _Gen(self.dim)
        self._retained: _Gen | None = None
        self.nprobe = 8
        self.misrouted = 0
        self.duplicates = 0

    @property
    def trained(self) -> bool:
        return self._gen.coded is not None

    @property
    def rows(self) -> int:
        coded = self._gen.coded
        return coded.rows if coded is not None else 0

    @property
    def version(self) -> int | None:
        return self._gen.step

    def init_plane(self, centroids: np.ndarray, codec: PQCodec,
                   shard_id: int, n_shards: int, nprobe: int = 8,
                   step: int | None = None) -> None:
        """Install the centrally trained structure. Re-init replaces
        the current generation wholesale (a retrain invalidates old
        codes); in-flight searches keep the old arrays alive and stay
        consistent. The retained generation is dropped too — a
        re-init is a new plane, not a cut."""
        with self._lock:
            self.shard_id = int(shard_id)
            self.n_shards = max(1, int(n_shards))
            self.nprobe = max(1, int(nprobe))
            gen = _Gen(self.dim,
                       None if step is None else int(step))
            coded = CodedLists(centroids, codec)
            coded.add_source(gen.raw)  # source 0: the raw grow buffer
            gen.coded = coded
            self._gen = gen
            self._retained = None

    def set_ring(self, n_shards: int,
                 shard_id: int | None = None) -> None:
        """Adopt a new ring size (rebalance phase 1). Ownership checks
        switch immediately; lists this shard no longer owns keep
        serving reads until the new owner acks them (``drop_list``)."""
        with self._lock:
            self.n_shards = max(1, int(n_shards))
            if shard_id is not None:
                self.shard_id = int(shard_id)

    def cut(self, step: int) -> int | None:
        """Open a fresh empty generation at ``step``, retaining the
        current one for rollback. Same centroids/codec — a version cut
        changes which MODEL's vectors the plane holds, not the trained
        scan structure. No-op when already at ``step``."""
        step = int(step)
        with self._lock:
            if self._gen.step == step:
                return self._gen.step
            retained = self._gen
            gen = _Gen(self.dim, step)
            if retained.coded is not None:
                coded = CodedLists(retained.coded.centroids,
                                   retained.coded.codec)
                coded.add_source(gen.raw)
                gen.coded = coded
            self._retained = retained
            self._gen = gen
            return gen.step

    def rollback(self, step: int) -> bool:
        """Restore the retained generation when it carries ``step``
        (True). A shard restarted since the cut has nothing to restore
        — it reports False and the fan-out resurrects it from the
        journal instead."""
        step = int(step)
        with self._lock:
            if self._gen.step == step:
                return True
            if (self._retained is not None
                    and self._retained.step == step):
                self._gen, self._retained = self._retained, self._gen
                return True
            # Cold at the target version: keep the trained structure
            # (if any) but start empty — journal replay refills.
            retained = self._gen
            gen = _Gen(self.dim, step)
            if retained.coded is not None:
                coded = CodedLists(retained.coded.centroids,
                                   retained.coded.codec)
                coded.add_source(gen.raw)
                gen.coded = coded
            self._retained = retained
            self._gen = gen
            return False

    def insert(self, ids: np.ndarray, vectors: np.ndarray) -> int:
        """Index owned rows; returns how many were accepted (dedup
        skips don't count — they are already served)."""
        vecs = np.asarray(vectors, np.float32)
        if vecs.ndim == 1:
            vecs = vecs[None]
        ids = np.asarray(ids, np.int64)
        with self._lock:
            gen = self._gen
            coded = gen.coded
            if coded is None:
                raise RuntimeError("shard not initialized")
            assign = coded.assign(vecs)
            owned = shard_owner(assign, self.n_shards) == self.shard_id
            if not bool(np.all(owned)):
                self.misrouted += int((~owned).sum())
                logger.warning("shard %d: %d misrouted row(s) rejected",
                               self.shard_id, int((~owned).sum()))
                vecs, ids = vecs[owned], ids[owned]
                assign = assign[owned]
            if ids.shape[0]:
                fresh = np.fromiter((int(i) not in gen.seen
                                     for i in ids), bool,
                                    count=ids.shape[0])
                ndup = int((~fresh).sum())
                if ndup:
                    self.duplicates += ndup
                    vecs, ids = vecs[fresh], ids[fresh]
                    assign = assign[fresh]
            n = vecs.shape[0]
            if not n:
                return 0
            need = gen.raw_rows + n
            if need > gen.raw.shape[0]:
                grow = max(need, int(gen.raw.shape[0] * 1.5),
                           gen.raw.shape[0] + 1024)
                nb = np.empty((grow, self.dim), np.float32)
                nb[: gen.raw_rows] = gen.raw[: gen.raw_rows]
                gen.raw = nb
                # Locators live in the coded lists; rebase them onto
                # the grown array BEFORE the new rows publish.
                coded.replace_source(0, gen.raw)
            start = gen.raw_rows
            gen.raw[start: need] = vecs
            gen.raw_rows = need
            coded.append_assigned(
                assign, ids, coded.codec.encode(vecs), 0,
                np.arange(start, need, dtype=np.int32))
            gen.seen.update(int(i) for i in ids)
            return n

    def search(self, queries: np.ndarray, k: int,
               nprobe: int | None = None) -> tuple[np.ndarray,
                                                   np.ndarray]:
        coded = self._gen.coded
        if coded is None or coded.rows == 0:
            q = np.asarray(queries, np.float32)
            nq = q.shape[0] if q.ndim > 1 else 1
            return (np.full((nq, k), -1, np.int64),
                    np.full((nq, k), -np.inf, np.float32))
        return batched_scan(coded, queries, int(k),
                            int(nprobe or self.nprobe),
                            rerank=max(512, 4 * int(k)))

    def extract_list(self, c: int) -> tuple[np.ndarray, np.ndarray]:
        """``(ids, vectors)`` snapshot of one inverted list — the
        migration read (the list keeps serving until ``drop_list``)."""
        with self._lock:
            coded = self._gen.coded
            if coded is None:
                return (np.empty((0,), np.int64),
                        np.empty((0, self.dim), np.float32))
            ids, _, row = coded.list_view(int(c))
            return ids.copy(), self._gen.raw[row.astype(np.int64)].copy()

    def drop_list(self, c: int) -> int:
        """Release one list after the new owner acked it. The raw
        buffer keeps the bytes (compaction is a coordinator-side
        concern); the ids leave the dedup set so a migrate-back can
        re-insert them."""
        with self._lock:
            coded = self._gen.coded
            if coded is None:
                return 0
            ids, _, _ = coded.list_view(int(c))
            self._gen.seen.difference_update(int(i) for i in ids)
            return coded.drop_list(int(c))


class ShardServer:
    """Stdlib HTTP front end over one ``IndexShard``.

    ``POST /shard/init`` installs centroids+codec (+ ring + version),
    ``/shard/insert`` indexes owned rows (version-gated),
    ``/shard/search`` answers ``{ids, scores, version}``;
    ``/shard/cut``, ``/shard/rollback``, ``/shard/ring``,
    ``/shard/extract``, ``/shard/drop_list`` drive the lifecycle; GET
    ``/healthz`` reports liveness+rows+version and ``/readyz`` is the
    supervision probe (the ``ServingFleet`` port-file protocol). One
    process per shard in production (``main()``); tests run several
    in-process."""

    def __init__(self, dim: int, host: str = "127.0.0.1",
                 port: int = 0):
        self.shard = IndexShard(dim)
        self.host, self.port = host, int(port)
        self._httpd: ThreadingHTTPServer | None = None
        self._thread: threading.Thread | None = None

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    def start(self) -> "ShardServer":
        shard = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # noqa: N802 — stdlib name
                pass

            def _reply(self, code: int, payload: dict) -> None:
                body = json.dumps(payload).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                try:
                    self.wfile.write(body)
                except (BrokenPipeError, ConnectionResetError):
                    pass

            def do_GET(self):  # noqa: N802
                s = shard.shard
                if self.path == "/healthz":
                    self._reply(200, {"ok": True, "rows": s.rows,
                                      "trained": s.trained,
                                      "shard": s.shard_id,
                                      "version": s.version,
                                      "misrouted": s.misrouted,
                                      "duplicates": s.duplicates})
                elif self.path == "/readyz":
                    # Supervision probe: ready as soon as the socket
                    # answers — an untrained shard is JOINABLE (the
                    # fan-out inits it), which is what ready means.
                    self._reply(200, {"ok": True, "shard": s.shard_id,
                                      "version": s.version,
                                      "checkpoint_step": s.version})
                else:
                    self._reply(404, {"error": "not found"})

            def do_POST(self):  # noqa: N802
                try:
                    n = int(self.headers.get("Content-Length", 0))
                    if n > _MAX_BODY:
                        self._reply(413, {"error": "body too large"})
                        return
                    req = json.loads(self.rfile.read(n) or b"{}")
                    s = shard.shard
                    if self.path == "/shard/init":
                        step = req.get("step")
                        s.init_plane(
                            _unpack(req["centroids"]),
                            PQCodec.from_wire(req["codec"]),
                            int(req["shard_id"]),
                            int(req["n_shards"]),
                            int(req.get("nprobe", 8)),
                            None if step is None else int(step))
                        self._reply(200, {"ok": True,
                                          "version": s.version})
                    elif self.path == "/shard/insert":
                        want = req.get("version")
                        if want != s.version:
                            # Wrong plane generation: refusing keeps a
                            # lagging shard from serving another
                            # model's vectors; the fan-out journals
                            # the rows and resyncs us.
                            self._reply(200, {"stored": 0,
                                              "version_mismatch": True,
                                              "version": s.version})
                            return
                        before = s.misrouted
                        took = s.insert(
                            np.asarray(req["ids"], np.int64),
                            _unpack(req["vectors"]))
                        # `rejected` lets the fan-out tell a silent
                        # ring disagreement (rows dropped, must NOT
                        # ack) from a dedup skip (rows already served,
                        # safe to ack).
                        self._reply(200, {"stored": took,
                                          "rejected": int(s.misrouted
                                                          - before),
                                          "rows": s.rows,
                                          "version": s.version})
                    elif self.path == "/shard/search":
                        ids, scores = s.search(
                            _unpack(req["queries"]),
                            int(req.get("k", 10)),
                            req.get("nprobe"))
                        self._reply(200, {
                            "ids": ids.tolist(),
                            "scores": [[float(v) if np.isfinite(v)
                                        else None for v in row]
                                       for row in scores],
                            "version": s.version})
                    elif self.path == "/shard/cut":
                        ver = s.cut(int(req["step"]))
                        self._reply(200, {"ok": True, "version": ver})
                    elif self.path == "/shard/rollback":
                        restored = s.rollback(int(req["step"]))
                        self._reply(200, {"ok": True,
                                          "restored": restored,
                                          "version": s.version,
                                          "rows": s.rows})
                    elif self.path == "/shard/ring":
                        s.set_ring(int(req["n_shards"]),
                                   req.get("shard_id"))
                        self._reply(200, {"ok": True})
                    elif self.path == "/shard/extract":
                        ids, vecs = s.extract_list(int(req["list"]))
                        self._reply(200, {"ids": ids.tolist(),
                                          "vectors": _pack(vecs),
                                          "rows": int(ids.shape[0])})
                    elif self.path == "/shard/drop_list":
                        dropped = s.drop_list(int(req["list"]))
                        self._reply(200, {"dropped": dropped})
                    else:
                        self._reply(404, {"error": "not found"})
                except Exception as e:  # noqa: BLE001 — a bad payload
                    # must answer 400, never drop the connection.
                    self._reply(400, {"error": str(e)})

        self._httpd = ThreadingHTTPServer((self.host, self.port),
                                          Handler)
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True,
            name=f"shard-{self.port}")
        self._thread.start()
        return self

    def stop(self) -> None:
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
        if self._thread is not None:
            self._thread.join(5.0)
            self._thread = None


def _is_timeout(e: Exception) -> bool:
    if isinstance(e, TimeoutError):  # socket.timeout is an alias
        return True
    if isinstance(e, urllib.error.URLError):
        reason = getattr(e, "reason", None)
        if isinstance(reason, (TimeoutError, socket.timeout)):
            return True
        return "timed out" in str(reason).lower()
    return False


class ShardClient:
    """One shard endpoint with failure memory — now failure-MODE
    aware. A connect-refused shard (process gone) cools down for the
    full ``cooldown_s``; a TIMED-OUT shard (alive but paused — GC, a
    SIGSTOP lag fault) gets ``timeout_cooldown_s`` plus ONE free retry
    on the next call, so a transient stall doesn't bench a healthy
    shard for the long window. After the free retry also fails, the
    short cooldown holds until expiry."""

    def __init__(self, url: str, timeout_s: float = 5.0,
                 cooldown_s: float = 2.0,
                 timeout_cooldown_s: float = 0.25):
        self.url = url.rstrip("/")
        self.timeout_s = float(timeout_s)
        self.cooldown_s = float(cooldown_s)
        self.timeout_cooldown_s = float(timeout_cooldown_s)
        self._dead_until = 0.0
        self._retry_pass = False
        self.failures = 0
        self.timeouts = 0

    @property
    def available(self) -> bool:
        return self._retry_pass or time.monotonic() >= self._dead_until

    def call(self, path: str, payload: dict | None = None,
             timeout_s: float | None = None,
             force: bool = False) -> dict | None:
        """POST (or GET when ``payload`` is None); None on any
        transport/HTTP failure — the caller degrades, never raises.
        ``force`` skips the cooldown gate (the repair loop's probe —
        cooldowns protect the query hot path, not a 1 Hz healer)."""
        if not force and not self.available:
            return None
        retrying = (self._retry_pass
                    and time.monotonic() < self._dead_until)
        self._retry_pass = False
        try:
            if payload is None:
                req = urllib.request.Request(self.url + path)
            else:
                req = urllib.request.Request(
                    self.url + path,
                    data=json.dumps(payload).encode(),
                    headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(
                    req, timeout=timeout_s or self.timeout_s) as resp:
                out = json.loads(resp.read())
            self._dead_until = 0.0
            return out
        except (urllib.error.URLError, OSError, ValueError) as e:
            self.failures += 1
            if _is_timeout(e):
                self.timeouts += 1
                self._dead_until = (time.monotonic()
                                    + self.timeout_cooldown_s)
                # One free retry — unless THIS call was it.
                self._retry_pass = not retrying
                logger.warning("shard %s timed out — short cooldown "
                               "%.2fs%s", self.url,
                               self.timeout_cooldown_s,
                               "" if retrying
                               else " (one retry allowed)")
            else:
                self._dead_until = time.monotonic() + self.cooldown_s
                self._retry_pass = False
                logger.warning("shard %s unreachable (%s) — cooling "
                               "down %.1fs", self.url, e,
                               self.cooldown_s)
            return None


class ShardFanout:
    """Coordinator: central training, owner-routed WAL-backed inserts,
    merged fan-out searches, plane-wide version lifecycle, journal
    repair, and live rebalancing.

    ``registry`` (optional MetricsRegistry) exports the plane's
    health: alive/total gauges, per-shard ``retrieval_shard_up``
    gauges (the anomaly detector's shard-death signal), degraded and
    version-mismatch counters, and the journal's depth/journaled/
    repaired set — the difference between "recall quietly sagged" and
    a page."""

    def __init__(self, urls, dim: int | None = None,
                 train_rows: int = 4096, n_centroids: int = 64,
                 nprobe: int = 8, pq_m: int = 8,
                 registry=None, seed: int = 0,
                 timeout_s: float = 5.0,
                 cooldown_s: float = 2.0,
                 timeout_cooldown_s: float = 0.25,
                 journal_dir=None, compact_rows: int = 100_000):
        self._client_opts = {"timeout_s": float(timeout_s),
                             "cooldown_s": float(cooldown_s),
                             "timeout_cooldown_s":
                                 float(timeout_cooldown_s)}
        self.clients = [ShardClient(u, **self._client_opts)
                        for u in urls]
        self.dim = int(dim) if dim is not None else None
        self.train_rows = max(1, int(train_rows))
        self.n_centroids = max(1, int(n_centroids))
        self.nprobe = max(1, int(nprobe))
        self.pq_m = max(1, int(pq_m))
        self.seed = int(seed)
        self._lock = threading.Lock()
        self._pool = ThreadPoolExecutor(
            max_workers=max(2, len(self.clients)),
            thread_name_prefix="shard-fanout")
        self.centroids: np.ndarray | None = None
        self.codec: PQCodec | None = None
        # Plane version: checkpoint step of the generation every shard
        # serves. None until the rollout machinery adopts a step.
        self.version: int | None = None
        self._prior_version: int | None = None
        self.journal = ShardJournal(journal_dir,
                                    compact_rows=compact_rows)
        # Rows acked at the CURRENT version per shard — the restart
        # detector (healthz rows < acked means the shard lost state).
        self._acked: dict[int, int] = {}
        # Shards flagged for a full re-init + journal resurrection.
        self._resync: set[int] = set()
        # Pre-training buffer: (ids, rows) pairs, brute-forced by
        # searches until the plane trains.
        self._buf_ids: list[np.ndarray] = []
        self._buf_rows: list[np.ndarray] = []
        self._buf_n = 0
        self.inserted = 0
        self.dropped = 0          # journal write failed: truly lost
        self.journaled = 0        # rows parked for repair
        self.repaired = 0         # rows redelivered by repair
        self.stale_dropped = 0    # journal rows version-gated away
        self.degraded_searches = 0
        self.version_mismatches = 0
        # Standalone id allocator (no IndexManager in front): plane-
        # local monotonic ids. NOT durable — a bare shard plane is a
        # cache of the fleet's embeddings, not a system of record.
        self._next_id = 0
        self._registry = registry
        self._m = None
        self._up: dict[int, object] = {}
        if registry is not None:
            self._m = {
                "alive": registry.gauge(
                    "retrieval_shards_alive",
                    "shard endpoints answering"),
                "total": registry.gauge(
                    "retrieval_shards_total",
                    "shard endpoints configured"),
                "degraded": registry.counter(
                    "retrieval_shard_degraded_searches_total",
                    "searches answered with >=1 shard missing"),
                "dropped": registry.counter(
                    "retrieval_shard_dropped_rows_total",
                    "insert rows lost (journal write failed)"),
                "journaled": registry.counter(
                    "retrieval_shard_journaled_rows_total",
                    "insert rows parked in the repair journal"),
                "repaired": registry.counter(
                    "retrieval_shard_repaired_rows_total",
                    "journal rows redelivered by repair"),
                "jdepth": registry.gauge(
                    "retrieval_shard_journal_depth",
                    "journal rows awaiting redelivery"),
                "vmismatch": registry.counter(
                    "retrieval_shard_version_mismatch_total",
                    "shard responses rejected on plane version"),
            }
            self._m["total"].set(len(self.clients))
        self._repair_thread: threading.Thread | None = None
        self._repair_stop = threading.Event()

    @property
    def trained(self) -> bool:
        return self.centroids is not None

    def _set_up(self, sid: int, value: float) -> None:
        if self._registry is None:
            return
        g = self._up.get(sid)
        if g is None:
            g = self._up[sid] = self._registry.gauge(
                "retrieval_shard_up",
                "1 when the shard answers, 0 when dark",
                labels={"shard": str(sid)})
        g.set(value)

    def _gauge_depth(self) -> None:
        if self._m:
            self._m["jdepth"].set(
                float(sum(self.journal.depths().values())))

    # -- training ------------------------------------------------------------
    def _init_wire_locked(self) -> dict:
        return {"centroids": _pack(self.centroids),
                "codec": self.codec.to_wire(),
                "n_shards": len(self.clients),
                "nprobe": self.nprobe,
                "step": self.version}

    def _train_and_flush_locked(self) -> None:
        rows = np.concatenate(self._buf_rows)
        ids = np.concatenate(self._buf_ids)
        self.centroids = kmeans(rows, self.n_centroids, seed=self.seed)
        self.codec = PQCodec(self.dim, m=self.pq_m,
                             seed=self.seed).train(rows)
        wire = self._init_wire_locked()
        inited = []
        for sid, cl in enumerate(self.clients):
            got = cl.call("/shard/init", dict(wire, shard_id=sid))
            if got is not None and got.get("ok"):
                inited.append(sid)
                self._acked[sid] = 0
            else:
                self._resync.add(sid)
        logger.info("shard plane trained: %d centroids, pq m=%d, "
                    "%d/%d shard(s) initialized",
                    self.centroids.shape[0], self.codec.m,
                    len(inited), len(self.clients))
        self._buf_ids, self._buf_rows, self._buf_n = [], [], 0
        self._route_locked(ids, rows)

    def _route_locked(self, ids: np.ndarray, vecs: np.ndarray) -> None:
        """Owner-routed insert push: rows grouped per shard, journaled
        FIRST (write-ahead), then one ``/shard/insert`` each
        (parallel). A dead or version-drifted owner's rows stay in the
        journal as repair debt — visible in ``_journal_depth``, never
        lost. Rows are only DROPPED when the journal write itself
        fails (disk error) — that counter should read zero."""
        assign = np.argmax(vecs @ self.centroids.T, axis=1)
        owner = shard_owner(assign, len(self.clients))
        futs = []
        for sid in np.unique(owner):
            mask = owner == sid
            bids, bvecs = ids[mask], vecs[mask]
            n = int(mask.sum())
            ordinal = self.journal.append(int(sid), bids, bvecs,
                                          self.version)
            cl = self.clients[int(sid)]
            payload = {"ids": bids.tolist(), "vectors": _pack(bvecs),
                       "version": self.version}
            futs.append((int(sid), n, ordinal, self._pool.submit(
                cl.call, "/shard/insert", payload)))
        for sid, n, ordinal, fut in futs:
            got = fut.result()
            delivered = (got is not None
                         and not got.get("version_mismatch")
                         and not int(got.get("rejected", 0)))
            if delivered:
                if ordinal is not None:
                    self.journal.ack(sid, ordinal, n)
                # Advance the ledger by the shard's STORED count, not
                # the delivered batch size: a duplicate redelivery
                # (client timeout on a push the server completed, then
                # a tail drain) stores 0 — counting it as n inflates
                # `_acked` past the shard's real rows until the repair
                # loop reads `rows < acked` as a phantom restart and
                # wipes a healthy shard.
                self._acked[sid] = (self._acked.get(sid, 0)
                                    + int(got.get("stored", n)))
                self.inserted += int(got.get("stored", 0))
                continue
            if got is not None:
                # Alive but on the wrong generation (version mismatch)
                # or the wrong ring (rows rejected as misrouted):
                # resync re-installs both before the journal debt is
                # redelivered. Never ack a partially-rejected batch.
                self._resync.add(sid)
            if ordinal is not None:
                self.journaled += n
                if self._m:
                    self._m["journaled"].inc(n)
            else:
                self.dropped += n
                if self._m:
                    self._m["dropped"].inc(n)
        self._gauge_depth()

    # -- data path -----------------------------------------------------------
    def insert(self, ids, vectors) -> int:
        vecs = np.asarray(vectors, np.float32)
        if vecs.ndim == 1:
            vecs = vecs[None]
        ids = np.asarray(ids, np.int64)
        with self._lock:
            if self.dim is None:
                self.dim = int(vecs.shape[1])
            elif int(vecs.shape[1]) != self.dim:
                logger.warning("shard fanout: insert rejected — dim %d "
                               "!= plane dim %d", vecs.shape[1],
                               self.dim)
                return 0
            if self.centroids is None:
                self._buf_ids.append(ids)
                self._buf_rows.append(vecs)
                self._buf_n += vecs.shape[0]
                if self._buf_n >= self.train_rows:
                    self._train_and_flush_locked()
                return int(vecs.shape[0])
            self._route_locked(ids, vecs)
        return int(vecs.shape[0])

    def insert_auto(self, vectors) -> list[int]:
        """Insert with plane-allocated ids (routers without a local
        ``IndexManager``); returns the assigned ids."""
        vecs = np.asarray(vectors, np.float32)
        if vecs.ndim == 1:
            vecs = vecs[None]
        with self._lock:
            ids = list(range(self._next_id,
                             self._next_id + vecs.shape[0]))
            self._next_id += vecs.shape[0]
        got = self.insert(np.asarray(ids, np.int64), vecs)
        return ids if got else []

    def search(self, queries, k: int = 10) -> dict:
        """Fan out + merge. ``{ids, scores, shards: {ok, total,
        degraded}, rows, version}`` — ids/scores numpy ``[Q, k]``
        padded with -1/-inf like every scan in this package. A shard
        answering on the WRONG plane version is rejected (counted
        degraded) — merged results can never mix model generations."""
        q = np.asarray(queries, np.float32)
        if q.ndim == 1:
            q = q[None]
        nq = q.shape[0]
        with self._lock:
            trained = self.centroids is not None
            version = self.version
            if not trained and self._buf_n:
                ids_cat = np.concatenate(self._buf_ids)
                rows_cat = np.concatenate(self._buf_rows)
            else:
                ids_cat = rows_cat = None
        total = len(self.clients)
        if not trained:
            if rows_cat is None:
                return {"ids": np.full((nq, k), -1, np.int64),
                        "scores": np.full((nq, k), -np.inf,
                                          np.float32),
                        "shards": {"ok": total, "total": total,
                                   "degraded": False},
                        "rows": 0, "version": version}
            ids_out, scores_out = brute_force_topk(
                q, ids_cat, rows_cat, k)
            return {"ids": ids_out, "scores": scores_out,
                    "shards": {"ok": total, "total": total,
                               "degraded": False},
                    "rows": int(rows_cat.shape[0]),
                    "version": version}
        payload = {"queries": _pack(q), "k": int(k),
                   "nprobe": self.nprobe}
        futs = [self._pool.submit(cl.call, "/shard/search", payload)
                for cl in self.clients]
        per_shard = [f.result() for f in futs]
        ok = 0
        # Per-query candidate merge, deduped by id keeping the max
        # score: a list mid-migration answers from BOTH owners with
        # identical exact scores, so the window is invisible.
        cand: list[dict] = [{} for _ in range(nq)]
        for sid, r in enumerate(per_shard):
            self._set_up(sid, 0.0 if r is None else 1.0)
            if r is None:
                continue
            if r.get("version") != version:
                self.version_mismatches += 1
                self._resync.add(sid)
                if self._m:
                    self._m["vmismatch"].inc()
                logger.warning(
                    "shard %d answered version %r != plane %r — "
                    "response rejected", sid, r.get("version"),
                    version)
                continue
            ok += 1
            for i, (row_ids, row_scores) in enumerate(
                    zip(r["ids"], r["scores"])):
                ci = cand[i]
                for rid, rs in zip(row_ids, row_scores):
                    if rid >= 0 and rs is not None:
                        prev = ci.get(rid)
                        if prev is None or rs > prev:
                            ci[rid] = rs
        degraded = ok < total
        out_ids = np.full((nq, k), -1, np.int64)
        out_scores = np.full((nq, k), -np.inf, np.float32)
        for i in range(nq):
            if not cand[i]:
                continue
            ids_arr = np.fromiter(cand[i], np.int64,
                                  count=len(cand[i]))
            sc_arr = np.fromiter(cand[i].values(), np.float32,
                                 count=len(cand[i]))
            kk = min(k, ids_arr.shape[0])
            top = np.argpartition(sc_arr, -kk)[-kk:]
            top = top[np.argsort(sc_arr[top])[::-1]]
            out_ids[i, :kk] = ids_arr[top]
            out_scores[i, :kk] = sc_arr[top]
        if degraded:
            self.degraded_searches += 1
            if self._m:
                self._m["degraded"].inc()
        if self._m:
            self._m["alive"].set(ok)
        return {"ids": out_ids, "scores": out_scores,
                "shards": {"ok": ok, "total": total,
                           "degraded": degraded},
                "rows": self.inserted, "version": version}

    # -- plane version lifecycle (rollout state machine) ---------------------
    def _cut_all(self, step: int, op: str) -> None:
        with self._lock:
            if self.version == step:
                return
            self._prior_version = self.version
            self.version = int(step)
            if self.centroids is None:
                return  # untrained: the stamp rides future inits
            clients = list(enumerate(self.clients))
        for sid, cl in clients:
            got = cl.call("/shard/cut", {"step": int(step)})
            if got is not None and got.get("ok"):
                self._acked[sid] = 0
            else:
                self._resync.add(sid)
        logger.info("shard plane %s: every shard cut to step %d "
                    "(%d flagged for resync)", op, step,
                    len(self._resync))

    def activate(self, step: int | None) -> None:
        """First trusted adoption: stamp the plane (and cut any
        pre-version rows — they were embedded by an untrusted or
        unknown model)."""
        if step is None:
            return
        self._cut_all(int(step), op="activate")

    def promote(self, step: int) -> None:
        """Rollout promote: cut EVERY shard to the new generation.
        The prior generation stays retained shard-side for
        rollback."""
        self._cut_all(int(step), op="promote")

    def rollback_to(self, step: int | None) -> bool:
        """Restore the prior generation fleet-wide. Shards that
        retained it swap back instantly; a shard restarted since the
        cut reports cold and is resurrected from its journal history
        by the repair loop. True when every shard restored warm."""
        if step is None:
            return False
        step = int(step)
        with self._lock:
            self.version = step
            clients = list(enumerate(self.clients))
            trained = self.centroids is not None
        if not trained:
            return True
        warm = True
        for sid, cl in clients:
            got = cl.call("/shard/rollback", {"step": step})
            if got is None:
                self._resync.add(sid)
                warm = False
                continue
            self._acked[sid] = int(got.get("rows", 0))
            if not got.get("restored"):
                self._resync.add(sid)
                warm = False
        logger.warning("shard plane rollback to step %d: %s", step,
                       "warm on all shards" if warm
                       else f"{len(self._resync)} shard(s) need "
                            "journal resurrection")
        return warm

    def on_canary_rollback(self, bad_step: int, reason: str = "",
                           ) -> None:
        """Canary verdicts normally precede promote, so the plane was
        never cut to the bad step — only act if it WAS (first
        adoption landed on a lemon)."""
        with self._lock:
            hit = self.version == bad_step
            prior = self._prior_version
        if hit and prior is not None:
            logger.warning("shard plane: canary rollback of step %d "
                           "(%s) — restoring %d", bad_step, reason,
                           prior)
            self.rollback_to(prior)

    # -- repair --------------------------------------------------------------
    def _drain(self, sid: int, from_start: bool) -> tuple[int, int]:
        """Redeliver one shard's journal through the NORMAL insert
        path — rows re-route under the current ring (a migrated list's
        rows land on their new owner) and re-journal at their
        destination, so a failure mid-drain just leaves fresh debt.
        Rows from another plane version are version-gated away (the
        trust gate: a rolled-back model's vectors must not enter the
        current plane)."""
        batches, rows = self.journal.totals(sid)
        repaired = stale = 0
        for ver, ids, vecs in self.journal.replay(
                sid, from_start=from_start, upto_batches=batches):
            if ver != self.version:
                stale += int(ids.shape[0])
                continue
            self.insert(ids, vecs)
            repaired += int(ids.shape[0])
        self.journal.set_acked(sid, batches, rows)
        if repaired:
            self.repaired += repaired
            if self._m:
                self._m["repaired"].inc(repaired)
        if stale:
            self.stale_dropped += stale
        return repaired, stale

    def _resync_shard(self, sid: int, cl: ShardClient) -> bool:
        """Full recovery: re-init the shard's plane structure (ring,
        version, centroids, codec), then resurrect its rows from the
        complete journal history."""
        with self._lock:
            if self.centroids is None:
                return False
            wire = dict(self._init_wire_locked(), shard_id=sid)
        got = cl.call("/shard/init", wire)
        if got is None or not got.get("ok"):
            return False
        self._acked[sid] = 0
        self._resync.discard(sid)
        repaired, stale = self._drain(sid, from_start=True)
        logger.info("shard %d resynced: %d row(s) resurrected, %d "
                    "stale row(s) version-gated", sid, repaired, stale)
        return True

    def repair_tick(self) -> dict:
        """One pass of the self-healing loop (the background thread's
        body; tests call it directly): probe every shard, refresh the
        per-shard ``up`` gauges, resync/resurrect returned shards,
        drain journal debt, compact delivered history."""
        with self._lock:
            clients = list(enumerate(self.clients))
            trained = self.centroids is not None
            version = self.version
        out = {"repaired": 0, "stale": 0, "resynced": []}
        for sid, cl in clients:
            # Snapshot the ledger BEFORE the probe: `_acked` only
            # grows under live traffic, so comparing the probe's row
            # count against a LATER ledger read flags a healthy shard
            # as restarted whenever an insert lands between the two.
            acked = self._acked.get(sid, 0)
            got = cl.call("/healthz", force=True)
            self._set_up(sid, 0.0 if got is None else 1.0)
            if got is None or not trained:
                continue
            needs_resync = (sid in self._resync
                            or not got.get("trained")
                            or got.get("version") != version
                            or int(got.get("rows", 0)) < acked)
            if needs_resync:
                if self._resync_shard(sid, cl):
                    out["resynced"].append(sid)
            elif self.journal.depth(sid) > 0:
                repaired, stale = self._drain(sid, from_start=False)
                out["repaired"] += repaired
                out["stale"] += stale
            self.journal.maybe_compact(sid, version)
        self._gauge_depth()
        return out

    def start(self, interval_s: float = 1.0) -> "ShardFanout":
        """Run ``repair_tick`` on a background thread (the production
        wiring; the CLI starts it next to the fleet loop)."""
        if self._repair_thread is not None:
            return self
        self._repair_stop.clear()

        def _loop():
            while not self._repair_stop.wait(interval_s):
                try:
                    self.repair_tick()
                except Exception:  # noqa: BLE001 — repair must not die
                    logger.exception("shard repair tick failed")

        self._repair_thread = threading.Thread(
            target=_loop, daemon=True, name="shard-repair")
        self._repair_thread.start()
        return self

    def stop(self) -> None:
        self._repair_stop.set()
        if self._repair_thread is not None:
            self._repair_thread.join(5.0)
            self._repair_thread = None

    # -- live rebalancing ----------------------------------------------------
    def rebalance(self, urls) -> dict:
        """Resize the plane to ``urls`` under traffic.

        Two-phase per-list cutover: (0) init genuinely new shards with
        the trained structure at the current version; (1) broadcast
        the new ring and swap the fan-out's client list — inserts now
        route under the new ring, reads fan to the union; (2) stream
        each list whose rendezvous owner changed: extract from the old
        owner (which keeps serving it), journal + insert to the new
        owner, and only on ack ``drop_list`` on the old owner. The
        merge's id-dedup makes the both-owners window row-identical to
        unsharded. Kept shards must keep their position in ``urls``
        (rendezvous identity is the index).
        """
        urls = [u.rstrip("/") for u in urls]
        stats = {"n_old": 0, "n_new": len(urls), "lists_moved": 0,
                 "rows_moved": 0, "rows_total": 0, "lists_skipped": 0}
        with self._lock:
            old_clients = list(self.clients)
            stats["n_old"] = len(old_clients)
            by_url = {c.url: c for c in old_clients}
            new_clients = [by_url.get(u)
                           or ShardClient(u, **self._client_opts)
                           for u in urls]
            trained = self.centroids is not None
            if not trained:
                self.clients = new_clients
                if self._m:
                    self._m["total"].set(len(new_clients))
                return stats
            wire = {"centroids": _pack(self.centroids),
                    "codec": self.codec.to_wire(),
                    "n_shards": len(urls),
                    "nprobe": self.nprobe,
                    "step": self.version}
            n_lists = int(self.centroids.shape[0])
        old_n, new_n = len(old_clients), len(new_clients)
        # Phase 0: bring genuinely new shards onto the plane.
        for sid, cl in enumerate(new_clients):
            if cl.url not in by_url:
                got = cl.call("/shard/init", dict(wire, shard_id=sid))
                if got is None or not got.get("ok"):
                    self._resync.add(sid)
                self._acked[sid] = 0
        lists = np.arange(n_lists)
        old_owner = shard_owner(lists, old_n)
        new_owner = shard_owner(lists, new_n)
        rows_before = 0
        for cl in old_clients:
            got = cl.call("/healthz")
            if got is not None:
                rows_before += int(got.get("rows", 0))
        stats["rows_total"] = rows_before
        # Phase 1: new ring everywhere, then swap the client list —
        # from here inserts route under the new ring and searches fan
        # to the union; old owners keep serving their moving lists.
        for sid, cl in enumerate(new_clients):
            got = cl.call("/shard/ring", {"n_shards": new_n,
                                          "shard_id": sid})
            if got is None:
                self._resync.add(sid)
        with self._lock:
            self.clients = new_clients
            if self._m:
                self._m["total"].set(new_n)
        # Phase 2: stream each moving list old-owner -> new-owner.
        moving = [int(c) for c in lists
                  if old_owner[c] < old_n
                  and (old_owner[c] >= new_n
                       or int(old_owner[c]) != int(new_owner[c]))]
        for c in moving:
            src_sid = int(old_owner[c])
            dst_sid = int(new_owner[c])
            src, dst = old_clients[src_sid], new_clients[dst_sid]
            got = src.call("/shard/extract", {"list": c})
            if got is None:
                # Old owner dark: its rows are journal debt already —
                # repair will land them on the NEW owner.
                stats["lists_skipped"] += 1
                continue
            n = int(got.get("rows", 0))
            if n == 0:
                src.call("/shard/drop_list", {"list": c})
                stats["lists_moved"] += 1
                continue
            ids = np.asarray(got["ids"], np.int64)
            vecs = _unpack(got["vectors"])
            ordinal = self.journal.append(dst_sid, ids, vecs,
                                          self.version)
            ack = dst.call("/shard/insert",
                           {"ids": ids.tolist(),
                            "vectors": _pack(vecs),
                            "version": self.version})
            if (ack is not None and not ack.get("version_mismatch")
                    and not int(ack.get("rejected", 0))):
                if ordinal is not None:
                    self.journal.ack(dst_sid, ordinal, n)
                self._acked[dst_sid] = (self._acked.get(dst_sid, 0)
                                        + int(ack.get("stored", n)))
                src.call("/shard/drop_list", {"list": c})
                stats["lists_moved"] += 1
                stats["rows_moved"] += n
            else:
                # New owner unavailable: rows are journaled (repair
                # finishes the move); old owner keeps serving reads.
                stats["lists_skipped"] += 1
                if ordinal is not None:
                    self.journaled += n
                    if self._m:
                        self._m["journaled"].inc(n)
        self._gauge_depth()
        logger.info("shard plane rebalanced %d -> %d: %d/%d list(s) "
                    "moved, %d row(s) streamed (%d total), %d "
                    "deferred to repair", old_n, new_n,
                    stats["lists_moved"], len(moving),
                    stats["rows_moved"], rows_before,
                    stats["lists_skipped"])
        return stats

    def snapshot(self) -> dict:
        health = []
        for cl in self.clients:
            got = cl.call("/healthz")
            health.append({"url": cl.url,
                           "alive": got is not None,
                           **({k: got[k] for k in
                               ("rows", "trained", "shard", "version")
                               if k in got}
                              if got else {})})
        return {"trained": self.trained,
                "n_shards": len(self.clients),
                "version": self.version,
                "inserted": self.inserted,
                "dropped": self.dropped,
                "journaled": self.journaled,
                "repaired": self.repaired,
                "journal_depth": sum(self.journal.depths().values()),
                "degraded_searches": self.degraded_searches,
                "version_mismatches": self.version_mismatches,
                "buffered": self._buf_n,
                "shards": health}

    def close(self) -> None:
        self.stop()
        self.journal.close()
        self._pool.shutdown(wait=False)


def main(argv=None) -> int:
    """Shard worker subprocess entry: serve one ``IndexShard`` until
    SIGTERM/SIGINT. Publishes the bound port via ``--port-file``
    (atomic tmp+rename) — the ``ServingFleet`` handshake — and
    answers its ``/readyz`` probes. Loads no torch."""
    import argparse

    parser = argparse.ArgumentParser(
        prog="ntxent-shard",
        description="one retrieval shard worker (supervised)")
    parser.add_argument("--dim", type=int, required=True,
                        help="embedding dimension of the plane")
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", type=int, default=0,
                        help="bind port (0 = ephemeral)")
    parser.add_argument("--port-file", default=None,
                        help="publish the bound port here (the "
                             "supervisor handshake)")
    args = parser.parse_args(argv)

    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s %(levelname)s shard %(message)s")
    server = ShardServer(args.dim, host=args.host,
                         port=args.port).start()
    if args.port_file:
        tmp = f"{args.port_file}.tmp-{os.getpid()}"
        with open(tmp, "w") as f:
            f.write(str(server.port))
        os.replace(tmp, args.port_file)
    stop = threading.Event()

    def _handle(signum, frame):  # noqa: ARG001
        stop.set()

    signal.signal(signal.SIGTERM, _handle)
    signal.signal(signal.SIGINT, _handle)
    logger.info("shard worker up on %s (pid %d)", server.url,
                os.getpid())
    stop.wait()
    server.stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())
