"""Metric exporters, counterpart of ``ntxent_tpu/obs/exporters.py``
(stdlib).

* ``MetricsServer``: the training-side scrape endpoint (``ntxent-train
  --metrics-port``), a daemon ``ThreadingHTTPServer`` whose ``/metrics``
  answers Prometheus text by default, the ``collect()`` JSON with
  ``?format=json`` (or ``Accept: application/json``) and the raw
  ``dump_state`` view with ``?format=state``; and ``/healthz``.
* ``choose_format`` / ``PROMETHEUS_CONTENT_TYPE``: the negotiation the
  serving stack's ``/metrics`` shares (JSON by default there): an
  explicit ``format=`` query wins, then the Accept header, then the
  endpoint's default.
"""

from __future__ import annotations

import json
import logging
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

from .registry import MetricsRegistry, default_registry

logger = logging.getLogger(__name__)

__all__ = ["MetricsServer", "PROMETHEUS_CONTENT_TYPE", "choose_format"]

PROMETHEUS_CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"


def choose_format(path: str, accept: str | None,
                  default: str = "json") -> str:
    """'json', 'prometheus' or 'state' for a /metrics request.

    Priority: ``?format=prometheus|json|state``, then the Accept header
    (``application/json`` against ``text/plain`` or ``openmetrics``),
    then ``default``. Unknown values fall back to the default (a scrape
    endpoint never answers 400 over a header); ``state`` is reachable
    only by the explicit query.
    """
    query = parse_qs(urlparse(path).query)
    explicit = (query.get("format") or [None])[0]
    if explicit in ("prometheus", "json", "state"):
        return explicit
    accept = (accept or "").lower()
    if "application/json" in accept:
        return "json"
    if "openmetrics" in accept or "text/plain" in accept:
        return "prometheus"
    return default


class MetricsServer:
    """A scrape endpoint over a ``MetricsRegistry`` (the process-wide one
    by default). ``port=0`` binds an ephemeral port, resolved by
    ``start()`` and logged."""

    def __init__(self, registry: MetricsRegistry | None = None,
                 host: str = "127.0.0.1", port: int = 0):
        self.registry = registry or default_registry()
        self.host, self.port = host, int(port)
        self._httpd: ThreadingHTTPServer | None = None
        self._thread: threading.Thread | None = None

    def start(self) -> "MetricsServer":
        if self._httpd is not None:
            raise RuntimeError("metrics server already started")
        self._httpd = ThreadingHTTPServer(
            (self.host, self.port), _make_handler(self.registry))
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True,
            name="ntxent-torch-metrics-http")
        self._thread.start()
        logger.info("metrics endpoint: http://%s:%d/metrics "
                    "(prometheus; ?format=json for JSON)",
                    self.host, self.port)
        return self

    def close(self) -> None:
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
            self._thread = None

    def __enter__(self) -> "MetricsServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.close()


def _make_handler(registry: MetricsRegistry):
    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, fmt, *args):  # noqa: N802
            logger.debug("%s " + fmt, self.address_string(), *args)

        def _reply(self, code: int, content_type: str,
                   body: bytes) -> None:
            self.send_response(code)
            self.send_header("Content-Type", content_type)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):  # noqa: N802
            route = urlparse(self.path).path
            if route == "/metrics":
                fmt = choose_format(self.path, self.headers.get("Accept"),
                                    default="prometheus")
                if fmt == "json":
                    self._reply(200, "application/json",
                                json.dumps(registry.collect()).encode())
                elif fmt == "state":
                    self._reply(200, "application/json",
                                json.dumps(registry.dump_state()).encode())
                else:
                    self._reply(200, PROMETHEUS_CONTENT_TYPE,
                                registry.render_prometheus().encode())
            elif route == "/healthz":
                self._reply(200, "application/json", b'{"status": "ok"}')
            else:
                self._reply(404, "application/json", json.dumps(
                    {"error": f"no route {route!r}"}).encode())

    return Handler
