"""Serving scoreboard: a subset of ``ntxent_tpu/serving/metrics.py``.

Same JSON keys for what it keeps: request/response/error and rejection
counts, dispatches and device calls, ``batch_fill_ratio`` (requests per
dispatch), ``padding_waste`` (padded share of device rows), per-bucket
calls and real/padded rows, queue depth and capacity, and p50/p95/p99
of the total, queue-wait and device latencies over a bounded window
(nearest-rank quantiles, as the JAX package computes them). Prometheus
exposition is later work.
"""

from __future__ import annotations

import threading
import time
from collections import deque

__all__ = ["LatencyWindow", "ServingMetrics", "quantile"]

_QUANTILES = (0.5, 0.95, 0.99)


def quantile(ordered: list[float], q: float) -> float:
    """Nearest-rank quantile of a sorted sample: index min(n-1, q*n)."""
    if not ordered:
        raise ValueError("quantile of an empty sample")
    return ordered[min(len(ordered) - 1, int(q * len(ordered)))]


class LatencyWindow:
    """Cumulative count/sum plus a bounded window for exact percentiles."""

    def __init__(self, window: int = 2048):
        if window < 1:
            raise ValueError(f"window must be >= 1, got {window}")
        self._lock = threading.Lock()
        self.count = 0
        self.total = 0.0
        self._window: deque[float] = deque(maxlen=window)

    def observe(self, value: float) -> None:
        with self._lock:
            self.count += 1
            self.total += float(value)
            self._window.append(float(value))

    def snapshot_ms(self) -> dict:
        with self._lock:
            ordered = sorted(self._window)
            count, total = self.count, self.total
        if not ordered:
            return {"count": count}
        out = {"count": count, "mean_ms": round(total / count, 4)}
        for q in _QUANTILES:
            out[f"p{int(q * 100)}_ms"] = round(quantile(ordered, q), 4)
        out["max_ms"] = round(ordered[-1], 4)
        out["window"] = len(ordered)
        return out


class ServingMetrics:
    """Counters written by the engine, batcher and server; ``to_dict()``
    is the ``/metrics`` JSON."""

    _COUNTERS = ("requests", "responses", "errors", "rejected_queue_full",
                 "rejected_deadline", "dispatches", "requests_coalesced",
                 "device_calls", "rows_real", "rows_padded")

    def __init__(self, latency_window: int = 2048):
        self._lock = threading.Lock()
        self.started_at = time.time()
        for name in self._COUNTERS:
            setattr(self, name, 0)
        self.queue_depth = 0
        self.queue_capacity = 0
        self._buckets: dict[int, list[int]] = {}  # calls, real, padded
        self.latency = {name: LatencyWindow(latency_window)
                        for name in ("total", "queue_wait", "device")}

    def _add(self, **deltas: int) -> None:
        with self._lock:
            for name, delta in deltas.items():
                setattr(self, name, getattr(self, name) + delta)

    # -- writers ---------------------------------------------------------
    def request_accepted(self) -> None:
        self._add(requests=1)

    def request_done(self, total_ms: float, ok: bool = True) -> None:
        self._add(**({"responses": 1} if ok else {"errors": 1}))
        self.latency["total"].observe(total_ms)

    def request_rejected(self, reason: str) -> None:
        self._add(**({"rejected_queue_full": 1} if reason == "queue_full"
                     else {"rejected_deadline": 1}))

    def dispatch(self, n_requests: int) -> None:
        self._add(dispatches=1, requests_coalesced=n_requests)

    def device_call(self, bucket: int, rows_real: int, rows_padded: int,
                    device_ms: float) -> None:
        with self._lock:
            self.device_calls += 1
            self.rows_real += rows_real
            self.rows_padded += rows_padded
            counts = self._buckets.setdefault(int(bucket), [0, 0, 0])
            counts[0] += 1
            counts[1] += rows_real
            counts[2] += rows_padded
        self.latency["device"].observe(device_ms)

    def queue_wait(self, ms: float) -> None:
        self.latency["queue_wait"].observe(ms)

    def set_queue_depth(self, depth: int) -> None:
        self.queue_depth = int(depth)

    # -- readers ---------------------------------------------------------
    def to_dict(self) -> dict:
        with self._lock:
            counters = {name: getattr(self, name) for name in self._COUNTERS}
            buckets = {b: list(c) for b, c in sorted(self._buckets.items())}
        dispatches = counters["dispatches"]
        device_rows = counters["rows_real"] + counters["rows_padded"]
        return {
            "uptime_s": round(time.time() - self.started_at, 3),
            **{k: v for k, v in counters.items()
               if k not in ("requests_coalesced", "rows_real",
                            "rows_padded")},
            "batch_fill_ratio": round(
                counters["requests_coalesced"] / dispatches, 4)
            if dispatches else None,
            "padding_waste": round(counters["rows_padded"] / device_rows, 4)
            if device_rows else None,
            "queue_depth": self.queue_depth,
            "queue_capacity": self.queue_capacity,
            "buckets": {
                str(b): {"calls": calls, "rows_real": real,
                         "rows_padded": padded,
                         "padding_waste": round(padded / (real + padded), 4)
                         if real + padded else None}
                for b, (calls, real, padded) in buckets.items()},
            "latency_ms": {name: win.snapshot_ms()
                           for name, win in self.latency.items()},
        }
