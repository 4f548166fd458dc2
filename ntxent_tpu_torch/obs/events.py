"""Structured event log: typed JSONL records with run/attempt identity.
Counterpart of ``ntxent_tpu/obs/events.py`` (stdlib; the flight-recorder
dump is not ported yet: ROADMAP.md Queue A 11(b)).

Record shape (one JSON object per line)::

    {"event": "span", "t": 12.345678, "wall": 1791234567.123,
     "run_id": "a1b2c3d4", "attempt": 0, ...event-specific fields}

* ``t`` is a monotonic offset (seconds since the log opened), so
  ordering and intervals survive wall-clock jumps; ``wall`` is epoch
  time for cross-run correlation.
* ``run_id`` is fixed per EventLog; ``attempt`` is bumped at restart
  boundaries (``set_attempt``).
* ``EVENT_TYPES`` is the core vocabulary; unknown types are accepted (the
  stream is extensible).

Each record is one ``write()`` of a complete line onto a line-buffered
handle, so concurrent writers never interleave bytes and a reader can
tail the file mid-run. ``async_io=True`` moves the serialization and the
write onto one daemon writer thread (the serving stack's span emits ride
the micro-batcher's dispatch loop, which must not wait for a disk).

A process-wide hub (``install``/``get_event_log``/``emit``) lets deep
instrumentation sites publish without plumbing a handle through every
constructor; with nothing installed, ``emit`` is a cheap no-op.
"""

from __future__ import annotations

import json
import logging
import math
import os
import threading
import time
import uuid
from collections import deque

logger = logging.getLogger(__name__)

__all__ = ["EVENT_TYPES", "EventLog", "emit", "get_event_log", "install",
           "read_events", "set_attempt"]

# span: one timed interval (obs/trace.py); compile: a serving bucket's
# first run (serving/engine.py); rollout: a serving worker's checkpoint
# swap or rollback (serving/worker.py); the rest are the reference's
# training and fleet vocabulary, kept so one reader handles both streams.
EVENT_TYPES = ("step", "retry", "divergence", "restart", "checkpoint",
               "compile", "trace", "span", "rollout", "fleet", "alert",
               "comms_profile", "bench", "index", "autoscale",
               "anomaly", "forecast", "comms_overlap")


class EventLog:
    """Append-only typed JSONL writer.

    ``path=None`` keeps records in a bounded in-memory tail only. With
    ``async_io=True`` one daemon writer drains a bounded queue of record
    dicts, serializes them and writes them (a single consumer: records
    never interleave; bursts past 64 queued records wake it at once,
    otherwise it polls every 0.2 s). Overflow drops the oldest queued
    record and counts it (``dropped_writes``): a slow disk throttles
    telemetry, never requests. ``close()`` drains the queue first.
    """

    def __init__(self, path: str | None = None, run_id: str | None = None,
                 tail: int = 256, async_io: bool = False,
                 write_queue_max: int = 4096):
        self.path = path
        self.run_id = run_id or uuid.uuid4().hex[:8]
        self.dropped_writes = 0
        self._attempt = 0
        self._lock = threading.Lock()
        self._t0 = time.monotonic()
        self._counts: dict[str, int] = {}
        self._tail: deque[dict] = deque(maxlen=tail)
        self._fh = None
        self._write_queue: deque[dict] | None = None
        self._write_queue_max = int(write_queue_max)
        self._writer: threading.Thread | None = None
        self._writer_wake = threading.Event()
        self._inflight = 0
        self._closing = False
        if path is not None:
            parent = os.path.dirname(os.path.abspath(path))
            os.makedirs(parent, exist_ok=True)
            self._fh = open(path, "a", buffering=1)
            if async_io:
                self._write_queue = deque()
                self._writer = threading.Thread(
                    target=self._drain_writes, daemon=True,
                    name="ntxent-torch-eventlog-writer")
                self._writer.start()

    # -- identity --------------------------------------------------------
    def set_attempt(self, attempt: int) -> None:
        """Stamp subsequent records with a supervisor attempt ordinal."""
        with self._lock:
            self._attempt = int(attempt)

    @property
    def attempt(self) -> int:
        return self._attempt

    # -- writing ---------------------------------------------------------
    def emit(self, event: str, **fields) -> dict:
        """Append one record; returns it."""
        record = {
            "event": str(event),
            "t": round(time.monotonic() - self._t0, 6),
            "wall": round(time.time(), 6),
            "run_id": self.run_id,
            "attempt": self._attempt,
            **fields,
        }
        # serialized here only in the synchronous mode with a file; the
        # async writer serializes off the emitting thread
        line = (json.dumps(_sanitize(record), default=_jsonable)
                if self._fh is not None and self._write_queue is None
                else None)
        with self._lock:
            self._counts[record["event"]] = \
                self._counts.get(record["event"], 0) + 1
            self._tail.append(record)
            if self._write_queue is not None and self._fh is not None:
                if len(self._write_queue) >= self._write_queue_max:
                    self._write_queue.popleft()
                    self.dropped_writes += 1
                self._write_queue.append(record)
                if len(self._write_queue) >= 64:
                    self._writer_wake.set()
            elif line is not None:
                try:
                    self._fh.write(line + "\n")
                except OSError as e:  # a full disk must not end the run
                    logger.error("event log write failed (%s); record "
                                 "dropped: %s", e, line[:200])
        return record

    def counts(self) -> dict[str, int]:
        with self._lock:
            return dict(self._counts)

    def tail(self, n: int = 20) -> list[dict]:
        with self._lock:
            return list(self._tail)[-n:]

    def _drain_writes(self) -> None:
        """The async writer: batch-drain the queue onto the handle. A
        record that does not serialize is dropped and counted; a failed
        write requeues its batch (bounded) and retries after a short
        backoff, unless ``close()`` has begun, which drops and counts."""
        while True:
            self._writer_wake.wait(0.2)
            self._writer_wake.clear()
            with self._lock:
                raw = list(self._write_queue)
                self._write_queue.clear()
                self._inflight = len(raw)
                fh, closing = self._fh, self._closing
            lines, ok_raw = [], []
            for rec in raw:
                try:
                    lines.append(json.dumps(_sanitize(rec),
                                            default=_jsonable))
                    ok_raw.append(rec)
                except Exception as e:  # noqa: BLE001 — one bad record
                    # must not end the writer
                    with self._lock:
                        self.dropped_writes += 1
                    logger.error("event log record unserializable (%s); "
                                 "dropped", e)
            failed = False
            if lines and fh is not None:
                try:
                    fh.write("\n".join(lines) + "\n")
                except (OSError, ValueError) as e:
                    failed = True
                    with self._lock:
                        closing = closing or self._closing
                        if closing:
                            self.dropped_writes += len(lines)
                        else:
                            self._write_queue.extendleft(reversed(ok_raw))
                            while (len(self._write_queue)
                                   > self._write_queue_max):
                                self._write_queue.popleft()
                                self.dropped_writes += 1
                    logger.error("event log async write failed (%s); %d "
                                 "record(s) %s", e, len(lines),
                                 "dropped" if closing else "requeued")
            with self._lock:
                self._inflight = 0
            if closing and not lines:
                return
            if failed and not closing:
                time.sleep(0.05)

    def flush(self, timeout_s: float = 5.0) -> bool:
        """Block until queued async writes reached the file (True), or
        the timeout passed or nothing can drain them (False)."""
        deadline = time.monotonic() + timeout_s
        while True:
            with self._lock:
                pending = bool(self._write_queue) or self._inflight > 0
            if not pending:
                return True
            writer = self._writer
            if writer is None or not writer.is_alive() \
                    or time.monotonic() >= deadline:
                return False
            self._writer_wake.set()
            time.sleep(0.005)

    def close(self) -> None:
        writer = self._writer
        if writer is not None:
            with self._lock:
                self._closing = True
            self._writer_wake.set()
            writer.join(5.0)  # drains the queue before the handle closes
            self._writer = None
        with self._lock:
            if self._fh is not None:
                try:
                    self._fh.close()
                finally:
                    self._fh = None

    def __enter__(self) -> "EventLog":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def _sanitize(obj):
    """Strict JSON: non-finite floats become their repr strings."""
    if isinstance(obj, float):
        return obj if math.isfinite(obj) else repr(obj)
    if isinstance(obj, dict):
        return {k: _sanitize(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_sanitize(v) for v in obj]
    return obj


def _jsonable(value):
    """Last-resort coercion: numpy or torch scalars to a finite float,
    anything else to its repr."""
    try:
        f = float(value)
    except (TypeError, ValueError):
        return repr(value)
    return f if math.isfinite(f) else repr(f)


def read_events(path: str, event: str | None = None) -> list[dict]:
    """Parse a JSONL event file (optionally one event type), skipping
    corrupt lines."""
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                record = json.loads(line)
            except ValueError:
                continue
            if event is None or record.get("event") == event:
                out.append(record)
    return out


# -- process-wide hub ----------------------------------------------------
_hub_lock = threading.Lock()
_event_log: EventLog | None = None


def install(event_log: EventLog | None) -> EventLog | None:
    """Install (or clear, with None) the process-wide event log; returns
    the previous one."""
    global _event_log
    with _hub_lock:
        previous, _event_log = _event_log, event_log
    return previous


def get_event_log() -> EventLog | None:
    return _event_log


def emit(event: str, **fields) -> None:
    """Publish to the installed event log, if any (a no-op otherwise)."""
    log = _event_log
    if log is not None:
        log.emit(event, **fields)


def set_attempt(attempt: int) -> None:
    log = _event_log
    if log is not None:
        log.set_attempt(attempt)
