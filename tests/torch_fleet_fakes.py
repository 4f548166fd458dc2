"""Stdlib fakes the fleet tests of the port share: a scriptable HTTP worker
that both packages' routers forward to, the same worker as a subprocess
for ``ServingFleet``, a fake clock, and the small HTTP helpers.

Nothing here imports torch or JAX: the fleet's router tier in either
package runs on the stdlib and numpy, and so do its fakes.
"""

from __future__ import annotations

import json
import sys
import textwrap
import threading
import time
import urllib.error
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer


class FakeClock:
    def __init__(self, t: float = 1000.0):
        self.t = t

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> None:
        self.t += dt


class FakeWorker:
    """One scriptable worker replica: answers ``/embed`` per ``mode`` with
    rows of its step (``[sign * step] * dim``), records the calls, accepts
    ``/rollback`` and answers ``/readyz``."""

    def __init__(self, dim: int = 4, step: int | None = 1):
        self.dim = dim
        self.step = step
        self.sign = 1.0  # -1.0: the step's embeddings point the other way
        self.step_header: int | None = None  # X-Checkpoint-Step on replies
        self.mode = "ok"
        self.embed_calls: list[int] = []
        self.rollbacks: list[dict] = []
        self.request_ids: list[str] = []
        worker = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, fmt, *args):  # noqa: N802
                pass

            def _reply_raw(self, code, body: bytes, headers=None):
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                if worker.step_header is not None:
                    self.send_header("X-Checkpoint-Step",
                                     str(worker.step_header))
                for k, v in (headers or {}).items():
                    self.send_header(k, v)
                self.end_headers()
                self.wfile.write(body)

            def _reply(self, code, payload, headers=None):
                self._reply_raw(code, json.dumps(payload).encode(), headers)

            def do_GET(self):  # noqa: N802
                self._reply(200, {"status": "ready",
                                  "checkpoint_step": worker.step})

            def do_POST(self):  # noqa: N802
                length = int(self.headers.get("Content-Length", 0))
                body = self.rfile.read(length) if length else b""
                req = json.loads(body or b"{}")
                if self.path == "/rollback":
                    worker.rollbacks.append(req)
                    self._reply(200, {"rolled_back": True})
                    return
                worker.request_ids.append(self.headers.get("X-Request-Id"))
                rows = len(req.get("inputs", []))
                worker.embed_calls.append(rows)
                if worker.mode == "err500":
                    self._reply(500, {"error": "injected worker error"})
                elif worker.mode == "busy429":
                    self._reply(429, {"error": "queue full",
                                      "retry_after_s": 0.25},
                                {"Retry-After": "0.250"})
                elif worker.mode == "bad400":
                    self._reply(400, {"error": "injected bad request"})
                elif worker.mode == "garbage200":
                    self._reply_raw(200, b"not json {")
                elif worker.mode == "scalar500":
                    self._reply_raw(500, b'"busy"')
                else:
                    emb = [[worker.sign * float(worker.step or 0)]
                           * worker.dim for _ in range(rows)]
                    self._reply(200, {"embeddings": emb, "dim": worker.dim,
                                      "rows": rows})

        self.httpd = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self.port = self.httpd.server_address[1]
        self.url = f"http://127.0.0.1:{self.port}"
        self._thread = threading.Thread(target=self.httpd.serve_forever,
                                        daemon=True)
        self._thread.start()

    def close(self):
        self.httpd.shutdown()
        self.httpd.server_close()


def pool_with(pool_cls, workers: dict, **kw):
    """A ``WorkerPool`` of either package over ready fake workers."""
    pool = pool_cls(**kw)
    for wid, w in workers.items():
        pool.upsert(wid, w.url)
        pool.set_health(wid, alive=True, ready=True, checkpoint_step=w.step)
    return pool


def post(url: str, payload, headers=None, timeout: float = 30.0):
    """POST JSON; returns ``(status, body as parsed JSON, headers)``."""
    req = urllib.request.Request(
        url, data=json.dumps(payload).encode(), method="POST",
        headers={"Content-Type": "application/json", **(headers or {})})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read()), dict(r.headers)
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read()), dict(e.headers)


def get(url: str, timeout: float = 30.0):
    """GET; returns ``(status, content type, body bytes)``."""
    try:
        with urllib.request.urlopen(url, timeout=timeout) as r:
            return r.status, r.headers.get("Content-Type", ""), r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers.get("Content-Type", ""), e.read()


# The worker as a process: answers /readyz at step 1 (or the step named
# by its second argument) and publishes its port through the port file,
# as the port's serve does under --port-file.
FAKE_WORKER = textwrap.dedent("""
    import json, os, sys
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    port_file = sys.argv[1]
    step = int(sys.argv[2]) if len(sys.argv) > 2 else 1

    class H(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"
        def log_message(self, *a):
            pass
        def do_GET(self):
            body = json.dumps({"status": "ready",
                               "checkpoint_step": step}).encode()
            self.send_response(200)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

    httpd = ThreadingHTTPServer(("127.0.0.1", 0), H)
    with open(port_file + ".tmp", "w") as f:
        f.write(str(httpd.server_address[1]))
    os.replace(port_file + ".tmp", port_file)
    httpd.serve_forever()
""")


def fake_worker_cmd(worker_id, port_file):
    return [sys.executable, "-c", FAKE_WORKER, str(port_file)]


def tick_until(fleet, predicate, timeout_s: float = 15.0,
               sleep_s: float = 0.05) -> bool:
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        fleet.tick()
        if predicate():
            return True
        time.sleep(sleep_s)
    return False


class FakeWorkerRec:
    def __init__(self, worker_id: str):
        self.worker_id = worker_id


class FakeFleet:
    """Membership and spawn/retire bookkeeping for an autoscaler, no
    processes."""

    def __init__(self, ids):
        self.members = list(ids)
        self.retired: list[str] = []
        self.autoscaler = None
        self.on_spike = None

    def workers_snapshot(self):
        return [FakeWorkerRec(i) for i in self.members]

    def add_worker(self):
        wid = f"w{len(self.members) + len(self.retired)}"
        self.members.append(wid)
        return FakeWorkerRec(wid)

    def retire_worker(self, worker_id, grace_s: float = 5.0) -> bool:
        if worker_id not in self.members:
            return False
        self.members.remove(worker_id)
        self.retired.append(worker_id)
        return True
