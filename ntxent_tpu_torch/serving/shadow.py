"""Shadow routing: mirror trusted traffic to the canary, diff embeddings.
Counterpart of ``ntxent_tpu/serving/shadow.py`` (stdlib and numpy).

The canary machinery judges a new checkpoint by ERROR RATE —
a model that answers 200 with subtly wrong embeddings promotes cleanly.
This module closes that hole: while a canary is undecided, a configured fraction of
TRUSTED-cohort requests is mirrored to a canary-step worker OFF the
client's critical path, the two embedding sets are diffed per row
(cosine distance), and the drift distribution feeds the same verdict
the error rate does — promote now requires drift-p99 under
``--shadow-max-drift`` on top of the error-rate bar, and a drift
breach rolls the fleet back exactly like an error breach.

Why mirroring (vs just routing more canary traffic): the mirrored
request has a KNOWN-GOOD answer to compare against — the trusted
response the client already received. Live canary traffic can only be
judged pass/fail; mirrored traffic is judged numerically. And because
the mirror rides a background queue, the client pays nothing: a slow
or crashing canary shows up in drift/error accounting, never in
client latency.

Mechanics:

* the router calls ``offer()`` after every successful trusted-cohort
  response (body + request id + the embeddings it just returned);
* ``offer`` applies the fraction (every Nth eligible request) and a
  bounded queue — overflow drops the OLDEST offer and counts it
  (telemetry backpressure must shed telemetry, never requests);
* one daemon worker drains the queue: pick a ready canary-step worker,
  POST the identical body (``X-Shadow-Of`` names the mirrored request
  so worker logs can tell mirrors from client traffic), diff, publish
  ``fleet_shadow_drift`` + a ``fleet.shadow`` span carrying the
  per-request drift, and report BOTH signals into the pool's verdict
  (drift samples via ``observe_drift``, outcome via ``observe``);
* verdict side effects (promote/rollback) are handed back to the
  router's ``on_decision`` — the same path a live canary outcome takes.

Torch-free (router-process rule); numpy only for the row math.
"""

from __future__ import annotations

import json
import logging
import threading
import time
import urllib.error
import urllib.request
from collections import deque

import numpy as np

from ..obs import trace as _trace

logger = logging.getLogger(__name__)

__all__ = ["cosine_drift", "ShadowMirror"]


def cosine_drift(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Per-row cosine distance ``1 - cos(a_i, b_i)`` of two equally
    shaped embedding batches, in [0, 2]. Zero-norm rows (a degenerate
    model output) diff at the maximum distance rather than NaN — a
    collapsed canary must look MAXIMALLY drifted, not unmeasurable."""
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    if a.shape != b.shape:
        raise ValueError(f"shape mismatch: {a.shape} vs {b.shape}")
    na = np.linalg.norm(a, axis=-1)
    nb = np.linalg.norm(b, axis=-1)
    denom = na * nb
    cos = np.zeros(a.shape[0], np.float32)
    ok = denom > 0
    cos[ok] = np.einsum("ij,ij->i", a[ok], b[ok]) / denom[ok]
    cos[~ok] = -1.0
    return np.clip(1.0 - cos, 0.0, 2.0)


class ShadowMirror:
    """Mirror a fraction of trusted traffic to the undecided canary.

    ``pool`` is the router's ``WorkerPool`` (canary state + drift
    accounting live there — the verdict must be one state machine, not
    two); ``on_decision`` receives any promote/rollback verdict a
    mirrored outcome triggers (the router passes its
    ``_handle_decision``).
    """

    def __init__(self, pool, fraction: float = 0.1,
                 forward_timeout_s: float = 30.0,
                 queue_max: int = 64,
                 on_decision=None):
        if not 0.0 < fraction <= 1.0:
            raise ValueError(f"shadow fraction must be in (0, 1], got "
                             f"{fraction}")
        self.pool = pool
        self.fraction = float(fraction)
        self.forward_timeout_s = float(forward_timeout_s)
        self.queue_max = int(queue_max)
        self.on_decision = on_decision
        r = pool.registry
        self.drift = r.histogram(
            "fleet_shadow_drift",
            "per-row cosine distance between trusted and canary "
            "embeddings for mirrored requests")
        self._mirrored = r.counter(
            "fleet_shadow_mirrored_total",
            "requests mirrored to a canary-step worker")
        self._errors = r.counter(
            "fleet_shadow_errors_total",
            "mirrored requests the canary failed to answer")
        self._dropped = r.counter(
            "fleet_shadow_dropped_total",
            "mirror offers shed (queue full / no canary worker ready)")
        self._drift_p99 = r.gauge(
            "fleet_shadow_drift_p99",
            "rolling drift p99 over the histogram window")
        self._rr = 0
        self._lock = threading.Lock()
        self._queue: deque[tuple] = deque()
        self._wake = threading.Event()
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    # -- producer side (request threads) -----------------------------------
    def offer(self, body: bytes, rid: str, served_step: int | None,
              embeddings) -> bool:
        """Called by the router after a successful forward. Enqueues a
        mirror when (a) a canary is undecided, (b) THIS response came
        from the trusted cohort (a canary-served response has nothing
        trusted to diff against), and (c) the fraction counter elects
        it. Returns True when enqueued. Never blocks."""
        step = self.pool.canary_step()
        if step is None:
            return False
        trusted = self.pool.trusted_step
        if trusted is None or served_step != trusted:
            return False
        if embeddings is None:
            return False
        with self._lock:
            self._rr += 1
            period = max(1, round(1.0 / self.fraction))
            if self._rr % period != 0:
                return False
            if len(self._queue) >= self.queue_max:
                self._queue.popleft()
                self._dropped.inc()
            self._queue.append((body, rid, step, embeddings))
        self._wake.set()
        return True

    # -- consumer side (the mirror thread) ---------------------------------
    def _mirror_one(self, body: bytes, rid: str, step: int,
                    primary) -> None:
        entry = self.pool.pick_step(step)
        if entry is None:
            self._dropped.inc()
            return
        t0 = time.monotonic()
        drift_max = drift_mean = None
        ok = False
        status = 0
        try:
            req = urllib.request.Request(
                entry.url + "/embed", data=body, method="POST",
                headers={"Content-Type": "application/json",
                         "X-Request-Id": _trace.new_request_id(),
                         "X-Shadow-Of": rid})
            with urllib.request.urlopen(
                    req, timeout=self.forward_timeout_s) as resp:
                status = resp.status
                payload = json.loads(resp.read())
            shadow = np.asarray(payload["embeddings"], np.float32)
            primary = np.asarray(primary, np.float32)
            if shadow.shape != primary.shape:
                raise ValueError(f"row mismatch: {shadow.shape} vs "
                                 f"{primary.shape}")
            drifts = cosine_drift(primary, shadow)
            for d in drifts:
                self.drift.observe(float(d))
            pcts = self.drift.percentiles()
            if pcts:
                self._drift_p99.set(pcts.get(0.99, 0.0))
            drift_max = float(drifts.max())
            drift_mean = float(drifts.mean())
            ok = True
        except urllib.error.HTTPError as e:
            e.read()
            status = e.code
            if e.code in (429, 504):
                # Saturation/deadline on the MIRROR is not model
                # quality — drop this sample, feed nothing.
                self._dropped.inc()
                return
            self._errors.inc()
        except (urllib.error.URLError, OSError, ValueError, KeyError,
                TypeError) as e:
            status = -1
            logger.debug("shadow mirror of %s failed: %r", rid, e)
            self._errors.inc()
        finally:
            self.pool.done(entry.worker_id)
        self._mirrored.inc()
        decision = None
        if ok:
            decision = self.pool.observe_drift(
                step, [float(d) for d in drifts])
            if decision is None:
                decision = self.pool.observe(entry.worker_id, step,
                                             ok=True)
        else:
            # A canary that cannot answer its mirror is error-rate
            # evidence, same as a failed live forward.
            self.pool.report_failure(entry.worker_id,
                                     f"shadow http {status}")
            decision = self.pool.observe(entry.worker_id, step,
                                         ok=False)
        _trace.emit_span("fleet.shadow",
                         (time.monotonic() - t0) * 1e3,
                         request_id=rid, worker=entry.worker_id,
                         step=step, status=status, ok=ok,
                         drift=drift_max, drift_mean=drift_mean)
        if decision is not None and self.on_decision is not None:
            self.on_decision(decision)

    def _run(self) -> None:
        while True:
            self._wake.wait(0.2)
            self._wake.clear()
            while True:
                with self._lock:
                    if not self._queue:
                        break
                    body, rid, step, primary = self._queue.popleft()
                try:
                    self._mirror_one(body, rid, step, primary)
                except Exception:  # noqa: BLE001 — the mirror must
                    # never die to one bad sample.
                    logger.exception("shadow mirror failed")
            if self._stop.is_set():
                return

    # -- readers / lifecycle -----------------------------------------------
    def snapshot(self) -> dict:
        with self._lock:
            depth = len(self._queue)
        return {"fraction": self.fraction,
                "mirrored": int(self._mirrored.value),
                "errors": int(self._errors.value),
                "dropped": int(self._dropped.value),
                "queue_depth": depth,
                "drift": self.drift.snapshot()}

    def start(self) -> "ShadowMirror":
        if self._thread is not None:
            raise RuntimeError("shadow mirror already started")
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="ntxent-shadow-mirror")
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        self._wake.set()
        if self._thread is not None:
            self._thread.join(5.0)
            self._thread = None
