"""HTTP front end: /embed, /healthz, /readyz, /metrics, /rollback.

Counterpart of ``ntxent_tpu/serving/server.py`` with the same wire
contract. Stdlib ``ThreadingHTTPServer``: one thread per connection,
each blocking in ``MicroBatcher.submit`` while the batcher's single
worker coalesces their requests into device calls.

Supervision reuses the resilience layer: ``serve_forever`` runs attempts
under ``resilience.supervisor.Supervisor``, each with a fresh
``MicroBatcher`` wired to the attempt's ``StallWatchdog``. The batcher
beats the watchdog every iteration, idle ones included, so a silence is
a wedged device call: the watchdog dumps the thread stacks, the
supervisor ends the attempt, the batcher drains and a fresh one starts
after a backoff, while the listener stays up and answers 503 (/healthz
``"stalled"``) between attempts.

* ``POST /embed`` body ``{"inputs": [...], "timeout_ms": t}``: one
  request of ``(n,) + example_shape`` rows (a single example may omit the
  leading dim). Replies ``{"embeddings": [...], "dim": D, "rows": n}``;
  400 on malformed input, 413 over the body or row cap, 429 +
  Retry-After on a full queue, 503 while warming or not serving, 504 on
  deadline, 500 on a failed device call.
* ``GET /healthz``: ``{"status": "serving"|"stalled"|"unavailable",
  "ready": ..., "checkpoint_step": ...}``.
* ``GET /readyz``: 200 once warm and serving, else 503 + Retry-After.
* ``GET /metrics``: ``ServingMetrics.to_dict()`` as JSON; Prometheus text
  with ``?format=prometheus`` or ``Accept: text/plain``; the registry's
  raw state with ``?format=state``.
* ``POST /rollback`` body ``{"step": s}`` (with a checkpoint watcher,
  ``serving.worker.CheckpointWatcher``): revert to the previous weights
  and block the step.

Every POST response echoes ``X-Request-Id`` (the client's, or one minted
at ingest) and, when the served checkpoint step is known, carries it as
``X-Checkpoint-Step``. ``/embed`` emits a ``serve.request`` span.
"""

from __future__ import annotations

import json
import logging
import threading
import time
from dataclasses import dataclass
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import urlparse

import numpy as np

from ..obs import events as _events
from ..obs import trace as _trace
from ..obs.exporters import PROMETHEUS_CONTENT_TYPE, choose_format
from ..resilience.retry import RetryPolicy
from ..resilience.supervisor import Supervisor
from .batcher import (
    BatcherClosed,
    DeadlineExceededError,
    MicroBatcher,
    QueueFullError,
)
from .engine import InferenceEngine
from .limits import MAX_BODY_BYTES

logger = logging.getLogger(__name__)

__all__ = ["EmbeddingServer"]

# A client asking for a multi-minute wait would hold a handler thread.
MAX_TIMEOUT_S = 60.0
MAX_REQUEST_ROWS_BUCKETS = 8  # rows cap = this many max-size buckets


@dataclass
class _AttemptState:
    """What ``Supervisor`` reads of an attempt (``state.step >=
    num_steps``): step 1 is an operator's shutdown (complete), 0 a fault
    exit (restart)."""

    step: int


class EmbeddingServer:
    """HTTP front end over InferenceEngine + MicroBatcher, supervised.

    ``start()`` binds the listener and starts one batcher, then returns;
    ``serve_forever()`` runs supervised attempts in the calling thread
    until ``shutdown()``.
    """

    def __init__(self, engine: InferenceEngine, host: str = "127.0.0.1",
                 port: int = 8080, max_batch: int | None = None,
                 max_delay_s: float = 0.005, queue_size: int = 64,
                 retry_policy: RetryPolicy | None = None,
                 stall_timeout_s: float | None = None,
                 max_restarts: int = 0,
                 default_timeout_s: float = 10.0,
                 max_body_bytes: int = MAX_BODY_BYTES,
                 max_request_rows: int | None = None):
        self.engine = engine
        self.metrics = engine.metrics
        self.host, self.port = host, int(port)
        self._batcher_kwargs = dict(
            max_batch=max_batch, max_delay_s=max_delay_s,
            queue_size=queue_size, retry_policy=retry_policy)
        self.stall_timeout_s = stall_timeout_s
        self.max_restarts = int(max_restarts)
        self.default_timeout_s = float(default_timeout_s)
        self.max_body_bytes = int(max_body_bytes)
        self.max_request_rows = int(
            max_request_rows if max_request_rows is not None
            else MAX_REQUEST_ROWS_BUCKETS * engine.max_bucket)
        self.batcher: MicroBatcher | None = None
        self._watchdog = None
        self._shutdown = threading.Event()
        self._terminated_clean = False
        self._httpd: ThreadingHTTPServer | None = None
        self._http_thread: threading.Thread | None = None
        # Readiness is distinct from liveness: while the ladder warms up
        # /readyz stays 503 and /embed sheds with Retry-After.
        self._warming = threading.Event()
        self.warmup_retry_after_s = 2.0
        # a checkpoint watcher (serving.worker.CheckpointWatcher): its
        # step labels replies and POST /rollback reaches it
        self.reloader = None
        # the installed obs.events.EventLog of this server, if any
        self.event_log = None
        self._stack_closed = False

    # -- status ----------------------------------------------------------
    @property
    def serving(self) -> bool:
        return (self.batcher is not None and not self.batcher.closed
                and not self._shutdown.is_set())

    @property
    def listening(self) -> bool:
        return self._httpd is not None

    @property
    def ready(self) -> bool:
        return self.serving and not self._warming.is_set()

    def begin_warmup(self) -> None:
        self._warming.set()

    def end_warmup(self) -> None:
        self._warming.clear()

    def checkpoint_step(self) -> int | None:
        if self.reloader is not None:
            return self.reloader.current_step
        step = self.metrics.checkpoint_step
        return step if step >= 0 else None

    def status(self) -> str:
        dog = self._watchdog
        if dog is not None and dog.stalled.is_set():
            return "stalled"
        return "serving" if self.serving else "unavailable"

    # -- lifecycle -------------------------------------------------------
    def start(self) -> "EmbeddingServer":
        """Bind the listener (port 0 picks a free one) and start the
        batcher."""
        if self._httpd is not None:
            raise RuntimeError("server already started")
        self._httpd = ThreadingHTTPServer((self.host, self.port),
                                          _make_handler(self))
        self.port = self._httpd.server_address[1]
        self._http_thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True,
            name="ntxent-torch-serve-http")
        self._http_thread.start()
        if self.batcher is None:
            self.batcher = MicroBatcher(self.engine, **self._batcher_kwargs)
        logger.info("serving on http://%s:%d (buckets %s, device %s)",
                    self.host, self.port, list(self.engine.buckets),
                    self.engine.device)
        return self

    def serve_forever(self) -> bool:
        """Supervised serve loop; True on a clean shutdown.

        A stall escalation (or SIGTERM, from the main thread) ends the
        attempt, its batcher drains and a fresh one starts after a
        backoff, up to ``max_restarts`` times; a SIGTERM without a stall
        shuts down. The listener spans the attempts."""
        if self._httpd is None:
            self.start()

        def run_attempt(attempt, stop_fn, watchdog):
            self._watchdog = watchdog
            # attempts own their batcher; start()'s is replaced, not
            # closed first, so /embed always finds one
            previous, self.batcher = self.batcher, MicroBatcher(
                self.engine, watchdog=watchdog, **self._batcher_kwargs)
            if previous is not None:
                previous.close()
            try:
                while not stop_fn() and not self._shutdown.is_set():
                    time.sleep(0.05)
            finally:
                batcher, self.batcher = self.batcher, None
                batcher.close()
            stalled = watchdog is not None and watchdog.fired.is_set()
            if stop_fn() and not stalled and not self._shutdown.is_set():
                logger.warning("serving: termination signal; draining and "
                               "shutting down")
                self._shutdown.set()
            if self._shutdown.is_set() and not stalled:
                self._terminated_clean = True
            return _AttemptState(
                step=1 if self._shutdown.is_set() and not stalled else 0), []

        supervisor = Supervisor(
            run_attempt, num_steps=1, max_restarts=self.max_restarts,
            stall_timeout_s=self.stall_timeout_s)
        try:
            result = supervisor.run()
        finally:
            self.close()
        return result.completed or self._terminated_clean

    def shutdown(self) -> None:
        """Ask ``serve_forever`` to return (thread-safe)."""
        self._shutdown.set()

    def close(self) -> None:
        """Stop the batcher and the listener, then what the server owns:
        the checkpoint watcher, the engine's ladder worker and the event
        log (uninstalled and drained)."""
        self._shutdown.set()
        if self.batcher is not None:
            self.batcher.close()
            self.batcher = None
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
            self._http_thread = None
        if self._stack_closed:
            return
        self._stack_closed = True
        if self.reloader is not None:
            self.reloader.stop()
        engine_close = getattr(self.engine, "close", None)
        if engine_close is not None:
            engine_close()
        if self.event_log is not None:
            if _events.get_event_log() is self.event_log:
                _events.install(None)
            self.event_log.close()


def _make_handler(server: EmbeddingServer):
    """Handler class closed over the server (one instance per request)."""

    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, fmt, *args):  # route access logs to logging
            logger.debug("%s " + fmt, self.address_string(), *args)

        def _send(self, code: int, content_type: str, body: bytes,
                  headers: dict | None = None) -> None:
            self.send_response(code)
            self.send_header("Content-Type", content_type)
            self.send_header("Content-Length", str(len(body)))
            for k, v in (headers or {}).items():
                self.send_header(k, v)
            self.end_headers()
            self.wfile.write(body)

        def _reply(self, code: int, payload: dict,
                   headers: dict | None = None) -> None:
            self._send(code, "application/json", json.dumps(payload).encode(),
                       headers)

        def do_GET(self):  # noqa: N802
            route = urlparse(self.path).path
            if route == "/healthz":
                status = server.status()
                self._reply(200 if status == "serving" else 503,
                            {"status": status, "ready": server.ready,
                             "checkpoint_step": server.checkpoint_step()})
            elif route == "/readyz":
                if server.ready:
                    self._reply(200, {
                        "status": "ready",
                        "checkpoint_step": server.checkpoint_step()})
                else:
                    retry = server.warmup_retry_after_s
                    self._reply(503, {
                        "status": ("warming" if server._warming.is_set()
                                   else server.status()),
                        "retry_after_s": retry,
                        "checkpoint_step": server.checkpoint_step()},
                        {"Retry-After": f"{retry:.3f}"})
            elif route == "/metrics":
                # process gauges refresh at scrape time, never on the
                # request path
                server.metrics.update_vertical(
                    compile_cache_entries=getattr(
                        server.engine, "compile_cache_size", None))
                fmt = choose_format(self.path, self.headers.get("Accept"),
                                    default="json")
                if fmt == "prometheus":
                    self._send(200, PROMETHEUS_CONTENT_TYPE,
                               server.metrics.render_prometheus().encode())
                elif fmt == "state":
                    self._reply(200, server.metrics.registry.dump_state())
                else:
                    self._reply(200, server.metrics.to_dict())
            else:
                self._reply(404, {"error": f"no route {self.path!r}"})

        def do_POST(self):  # noqa: N802
            # a request keeps the id it arrives with (a router mints at
            # its edge), else one is minted here
            rid = (self.headers.get("X-Request-Id")
                   or _trace.new_request_id())
            t_ingest = time.monotonic()
            status = {"code": None, "rows": None}

            def reply(code, payload, headers=None):
                status["code"] = code
                merged = {"X-Request-Id": rid}
                # the step that served THIS reply: a health probe lags a
                # hot swap
                step = server.checkpoint_step()
                if step is not None:
                    merged["X-Checkpoint-Step"] = str(step)
                merged.update(headers or {})
                self._reply(code, payload, merged)

            try:
                self._do_post(reply, rid, status)
            finally:
                if urlparse(self.path).path == "/embed" \
                        and status["code"] is not None:
                    _trace.emit_span(
                        "serve.request", (time.monotonic() - t_ingest) * 1e3,
                        request_id=rid, status=status["code"],
                        rows=status["rows"])

        def _do_rollback(self, reply, body: bytes) -> None:
            """Revert to the previous weights and block the named step
            (the current one without a step)."""
            if server.reloader is None:
                reply(404, {"error": "no checkpoint reloader on this "
                                     "server (start with --watch-ckpt)"})
                return
            try:
                step = json.loads(body or b"{}").get("step")
                step = int(step) if step is not None else None
            except (ValueError, TypeError, AttributeError) as e:
                reply(400, {"error": f"bad request: {e}"})
                return
            rolled = server.reloader.rollback(step)
            reply(200, {"rolled_back": rolled,
                        "checkpoint_step": server.reloader.current_step,
                        "blocked_steps":
                            sorted(server.reloader.blocked_steps)})

        def _do_post(self, reply, rid, status) -> None:
            # Drain the body before any early reply: with keep-alive an
            # unread body would be parsed as the next request.
            try:
                length = int(self.headers.get("Content-Length", 0))
            except ValueError:
                length = 0
            if length > server.max_body_bytes:
                self.close_connection = True
                reply(413, {"error": f"body of {length} bytes exceeds the "
                                     f"{server.max_body_bytes}-byte cap"},
                      {"Connection": "close"})
                return
            body = self.rfile.read(length) if length > 0 else b""
            route = urlparse(self.path).path
            if route == "/rollback":
                self._do_rollback(reply, body)
                return
            if route != "/embed":
                reply(404, {"error": f"no route {self.path!r}"})
                return
            if server._warming.is_set():
                retry = server.warmup_retry_after_s
                reply(503, {"error": "warming up", "retry_after_s": retry},
                      {"Retry-After": f"{retry:.3f}"})
                return
            batcher = server.batcher
            if batcher is None or batcher.closed:
                reply(503, {"error": "not serving (restarting or "
                                     "draining)"})
                return
            shape = server.engine.example_shape
            try:
                req = json.loads(body or b"{}")
                x = np.asarray(req["inputs"], dtype=np.float32)
                if x.shape == shape:
                    x = x[None]  # one example without the batch dim
                if x.ndim != 1 + len(shape):
                    raise ValueError(f"inputs must be shaped (n,) + {shape}, "
                                     f"got {x.shape}")
                timeout_s = min(float(req.get(
                    "timeout_ms", server.default_timeout_s * 1e3)) / 1e3,
                    MAX_TIMEOUT_S)
            except (KeyError, TypeError, ValueError) as e:
                reply(400, {"error": f"bad request: {e}"})
                return
            status["rows"] = int(x.shape[0])
            if x.shape[0] > server.max_request_rows:
                reply(413, {"error": f"{x.shape[0]} rows exceed the "
                                     "per-request cap of "
                                     f"{server.max_request_rows}; split "
                                     "the batch client-side"})
                return
            try:
                out = batcher.submit(x, timeout_s=timeout_s, request_id=rid)
            except QueueFullError as e:
                reply(429, {"error": str(e),
                            "retry_after_s": e.retry_after_s},
                      {"Retry-After": f"{e.retry_after_s:.3f}"})
            except DeadlineExceededError as e:
                reply(504, {"error": str(e)})
            except ValueError as e:  # wrong trailing shape
                reply(400, {"error": str(e)})
            except BatcherClosed:
                reply(503, {"error": "not serving (draining)"})
            except Exception as e:  # noqa: BLE001 — device-call failure
                logger.exception("serving: /embed failed")
                reply(500, {"error": f"{type(e).__name__}: {e}"})
            else:
                reply(200, {"embeddings": out.tolist(),
                            "dim": int(out.shape[-1]),
                            "rows": int(out.shape[0])})

    return Handler
