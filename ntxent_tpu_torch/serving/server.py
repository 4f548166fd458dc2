"""HTTP front end: /embed, /healthz, /readyz, /metrics.

Counterpart of ``ntxent_tpu/serving/server.py`` with the same wire
contract. Stdlib ``ThreadingHTTPServer``: one thread per connection,
each blocking in ``MicroBatcher.submit`` while the batcher's single
worker coalesces their requests into device calls.

* ``POST /embed`` body ``{"inputs": [...], "timeout_ms": t}``: one
  request of ``(n,) + example_shape`` rows (a single example may omit the
  leading dim). Replies ``{"embeddings": [...], "dim": D, "rows": n}``;
  400 on malformed input, 413 over the body or row cap, 429 +
  Retry-After on a full queue, 503 while warming or not serving, 504 on
  deadline, 500 on a failed device call.
* ``GET /healthz``: ``{"status": "serving"|"unavailable", "ready": ...}``.
* ``GET /readyz``: 200 once warm and serving, else 503 + Retry-After.
* ``GET /metrics``: ``ServingMetrics.to_dict()`` as JSON.

Every POST response echoes ``X-Request-Id`` (the client's, or a new one).
"""

from __future__ import annotations

import json
import logging
import threading
import uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import urlparse

import numpy as np

from ..resilience.retry import RetryPolicy
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


class EmbeddingServer:
    """HTTP front end over InferenceEngine + MicroBatcher.

    ``start()`` binds the listener and starts the batcher, then returns;
    ``serve_forever()`` starts and blocks until ``shutdown()``.
    """

    def __init__(self, engine: InferenceEngine, host: str = "127.0.0.1",
                 port: int = 8080, max_batch: int | None = None,
                 max_delay_s: float = 0.005, queue_size: int = 64,
                 retry_policy: RetryPolicy | None = None,
                 default_timeout_s: float = 10.0,
                 max_body_bytes: int = MAX_BODY_BYTES,
                 max_request_rows: int | None = None):
        self.engine = engine
        self.metrics = engine.metrics
        self.host, self.port = host, int(port)
        self._batcher_kwargs = dict(
            max_batch=max_batch, max_delay_s=max_delay_s,
            queue_size=queue_size, retry_policy=retry_policy)
        self.default_timeout_s = float(default_timeout_s)
        self.max_body_bytes = int(max_body_bytes)
        self.max_request_rows = int(
            max_request_rows if max_request_rows is not None
            else MAX_REQUEST_ROWS_BUCKETS * engine.max_bucket)
        self.batcher: MicroBatcher | None = None
        self._shutdown = threading.Event()
        self._httpd: ThreadingHTTPServer | None = None
        self._http_thread: threading.Thread | None = None
        # Readiness is distinct from liveness: while the ladder warms up
        # /readyz stays 503 and /embed sheds with Retry-After.
        self._warming = threading.Event()
        self.warmup_retry_after_s = 2.0

    # -- status ----------------------------------------------------------
    @property
    def serving(self) -> bool:
        return (self.batcher is not None and not self.batcher.closed
                and not self._shutdown.is_set())

    @property
    def ready(self) -> bool:
        return self.serving and not self._warming.is_set()

    def begin_warmup(self) -> None:
        self._warming.set()

    def end_warmup(self) -> None:
        self._warming.clear()

    def status(self) -> str:
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
        self.batcher = MicroBatcher(self.engine, **self._batcher_kwargs)
        logger.info("serving on http://%s:%d (buckets %s, device %s)",
                    self.host, self.port, list(self.engine.buckets),
                    self.engine.device)
        return self

    def serve_forever(self) -> None:
        if self._httpd is None:
            self.start()
        try:
            self._shutdown.wait()
        finally:
            self.close()

    def shutdown(self) -> None:
        """Ask ``serve_forever`` to return (thread-safe)."""
        self._shutdown.set()

    def close(self) -> None:
        self._shutdown.set()
        if self.batcher is not None:
            self.batcher.close()
            self.batcher = None
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
            self._http_thread = None


def _make_handler(server: EmbeddingServer):
    """Handler class closed over the server (one instance per request)."""

    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, fmt, *args):  # route access logs to logging
            logger.debug("%s " + fmt, self.address_string(), *args)

        def _reply(self, code: int, payload: dict,
                   headers: dict | None = None) -> None:
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            for k, v in (headers or {}).items():
                self.send_header(k, v)
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):  # noqa: N802
            route = urlparse(self.path).path
            if route == "/healthz":
                status = server.status()
                self._reply(200 if status == "serving" else 503,
                            {"status": status, "ready": server.ready})
            elif route == "/readyz":
                if server.ready:
                    self._reply(200, {"status": "ready"})
                else:
                    retry = server.warmup_retry_after_s
                    self._reply(503, {
                        "status": ("warming" if server._warming.is_set()
                                   else server.status()),
                        "retry_after_s": retry},
                        {"Retry-After": f"{retry:.3f}"})
            elif route == "/metrics":
                self._reply(200, server.metrics.to_dict())
            else:
                self._reply(404, {"error": f"no route {self.path!r}"})

        def do_POST(self):  # noqa: N802
            rid = self.headers.get("X-Request-Id") or uuid.uuid4().hex

            def reply(code, payload, headers=None):
                self._reply(code, payload,
                            {"X-Request-Id": rid, **(headers or {})})

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
            if urlparse(self.path).path != "/embed":
                reply(404, {"error": f"no route {self.path!r}"})
                return
            if server._warming.is_set():
                retry = server.warmup_retry_after_s
                reply(503, {"error": "warming up", "retry_after_s": retry},
                      {"Retry-After": f"{retry:.3f}"})
                return
            batcher = server.batcher
            if batcher is None or batcher.closed:
                reply(503, {"error": "not serving (draining)"})
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
            if x.shape[0] > server.max_request_rows:
                reply(413, {"error": f"{x.shape[0]} rows exceed the "
                                     "per-request cap of "
                                     f"{server.max_request_rows}; split "
                                     "the batch client-side"})
                return
            try:
                out = batcher.submit(x, timeout_s=timeout_s)
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
