"""Serving observability over the port's ``obs.MetricsRegistry``,
counterpart of ``ntxent_tpu/serving/metrics.py``: the same series names,
the same ``to_dict`` keys.

Every series lives in a registry, so JSON (``to_dict``), Prometheus text
(``render_prometheus``) and the raw federation view
(``registry.dump_state``) are views of the same objects. Each metric
guards only itself, so a scrape reads them one at a time. The vocabulary:
queue depth, batch-fill ratio, padding waste, exact-window latency
percentiles, per-bucket calls and padding, the request-size histogram,
the adaptive ladder, bucket first runs ("compiles") by cause, weight
swaps by mode, the checkpoint step served and rollbacks, the worker's
resident memory and cache size, and the run id.

The latency histograms' JSON view is the serving wire shape (count /
mean_ms / p50_ms / p95_ms / p99_ms / max_ms / window).
"""

from __future__ import annotations

import os
import threading
import time

from ..obs.registry import Histogram, MetricsRegistry

__all__ = ["LatencyWindow", "ServingMetrics", "read_rss_bytes"]


def read_rss_bytes() -> int | None:
    """This process's resident set size from ``/proc/self/statm``
    (resident pages x page size); None where procfs (or the sysconf key)
    is unavailable."""
    try:
        with open("/proc/self/statm") as f:
            fields = f.read().split()
        return int(fields[1]) * os.sysconf("SC_PAGE_SIZE")
    except (OSError, IndexError, ValueError):
        return None


class LatencyWindow(Histogram):
    """Millisecond-unit ``Histogram`` with the serving snapshot shape
    (``metrics.py:50``). Its ``snapshot`` is ``snapshot_ms``'s keys built
    from the base ``snapshot`` (JAX's calls ``snapshot_ms``, which calls
    ``snapshot`` again and recurses without end)."""

    def __init__(self, window: int = 2048, name: str = "latency_ms",
                 labels: dict | None = None):
        super().__init__(name, labels=labels, window=window)

    @property
    def total_ms(self) -> float:
        return self.total

    def snapshot(self) -> dict:
        return {(k if k in ("count", "window") else f"{k}_ms"): v
                for k, v in super().snapshot().items()}

    snapshot_ms = snapshot


class ServingMetrics:
    """The serving stack's shared scoreboard, registry-backed.

    Engine, batcher, and server all write here (each holds a reference
    to the same instance); ``/metrics`` reads ``to_dict()`` (JSON) or
    renders ``self.registry`` (Prometheus). Writer methods are a few
    per-metric counter bumps — contention is noise next to a device
    call.

    Each instance keeps a registry of its own, so several stacks can
    coexist in one process without cross-counting.
    """

    def __init__(self, latency_window: int = 2048):
        self.registry = MetricsRegistry()
        self.started_at = time.time()
        r = self.registry
        self._requests = r.counter(
            "serving_requests_total", "requests accepted into the queue")
        self._responses = r.counter(
            "serving_responses_total", "requests completed ok")
        self._errors = r.counter(
            "serving_errors_total", "requests failed after acceptance")
        self._rejected_queue_full = r.counter(
            "serving_rejected_queue_full_total",
            "backpressure rejections (429)")
        self._rejected_deadline = r.counter(
            "serving_rejected_deadline_total",
            "requests expired before reaching the device (504)")
        # Coalescing (batcher level: one dispatch = one engine.embed)
        # against device calls (engine level: one padded bucket; an
        # oversized dispatch chunks into several). batch_fill_ratio is
        # requests per DISPATCH, so chunking cannot dilute it below 1.
        self._dispatches = r.counter(
            "serving_dispatches_total", "engine.embed invocations")
        self._requests_coalesced = r.counter(
            "serving_requests_coalesced_total",
            "requests riding those dispatches")
        self._device_calls = r.counter(
            "serving_device_calls_total",
            "bucketed executable calls (chunks)")
        self._rows_real = r.counter(
            "serving_rows_real_total", "rows of actual payload sent")
        self._rows_padded = r.counter(
            "serving_rows_padded_total",
            "zero rows added to reach a bucket")
        # A "compile" of the port is a (bucket, dtype, weights) key's
        # first run (serving/engine.py): eager PyTorch builds nothing per
        # bucket, but a first run pays the allocator's growth, the
        # library plans and, once per process, the kernels' build.
        self._compiles = r.counter(
            "serving_compiles_total", "bucket executable compiles")
        self._compile_cache_hits = r.counter(
            "serving_compile_cache_hits_total",
            "bucket executable cache hits")
        self._queue_depth = r.gauge(
            "serving_queue_depth", "requests waiting in the queue")
        self._queue_capacity = r.gauge(
            "serving_queue_capacity", "bounded queue capacity")
        # Derived gauges kept current at write time so the Prometheus
        # rendering carries them too.
        self._fill_ratio = r.gauge(
            "serving_batch_fill_ratio",
            "requests per dispatch (coalescing factor)")
        self._padding_waste = r.gauge(
            "serving_padding_waste", "padded-row fraction of device rows")
        self.latency = {
            name: r.histogram("serving_latency_ms",
                              "request latency by stage",
                              labels={"stage": name},
                              window=latency_window)
            for name in ("total", "queue_wait", "device")
        }
        # Zero-downtime rollout: weight swaps by mode ("reused" = same
        # structure, warm ladder kept; "warmed" = structure changed, the
        # new ladder run BEFORE the swap) plus the checkpoint step
        # currently served.
        self._swap_lock = threading.Lock()
        self._swaps: dict[str, object] = {}
        self._ckpt_step = r.gauge(
            "serving_checkpoint_step",
            "training step of the checkpoint currently served "
            "(-1 = random init)")
        self._ckpt_step.set(-1)
        self._rollbacks = r.counter(
            "serving_rollbacks_total",
            "weight rollbacks after a canary breach")
        # bucket -> (calls, rows_real, rows_padded, waste-gauge) labeled
        # series, created on first use: the padding bill by rung.
        self._bucket_lock = threading.Lock()
        self._buckets: dict[int, tuple] = {}
        # Request-size histogram: device-chunk row counts as labeled
        # cumulative counters (cardinality bounded by the max bucket).
        # This is the OBSERVABLE view; the decayed optimizer histogram
        # lives in the engine (serving/ladder.py).
        self._size_lock = threading.Lock()
        self._sizes: dict[int, object] = {}
        # Adaptive bucket ladder: generation 0 is the configured prior;
        # every atomic swap bumps it. Membership renders as
        # serving_ladder_bucket{bucket=...} 1|0 gauges.
        self._ladder_lock = threading.Lock()
        self._ladder_buckets: list[int] = []
        self._ladder_rungs: dict[int, object] = {}
        self._ladder_gen = r.gauge(
            "serving_ladder_generation",
            "adaptive bucket-ladder generation (0 = configured prior)")
        self._ladder_swaps = r.counter(
            "serving_ladder_swaps_total",
            "atomic ladder swaps published by the re-AOT worker")
        self._ladder_compiles = r.counter(
            "serving_ladder_compiles_total",
            "background bucket compiles for ladder re-AOT "
            "(never on a request's hot path)")
        self._ladder_failures = r.counter(
            "serving_ladder_refresh_failures_total",
            "ladder re-AOT attempts that failed (old ladder kept)")
        # Per-cause compile counters, created lazily.
        self._compile_cause_lock = threading.Lock()
        self._compile_causes: dict[str, object] = {}
        # Per-process memory and cache pressure, refreshed at scrape
        # time (/metrics), not on a writer path.
        self._worker_rss = r.gauge(
            "serving_worker_rss_bytes",
            "resident set size of this worker process "
            "(0 where procfs is unavailable)")
        self._compile_cache_entries = r.gauge(
            "serving_compile_cache_entries",
            "entries in the engine's bucket-executable cache")
        # Run identity, stamped by set_run_id (None until one is known).
        self.run_id: str | None = None

    def update_vertical(self,
                        compile_cache_entries: int | None = None) -> None:
        """Refresh the per-process gauges (at scrape time: the server's
        /metrics handler). A failed RSS read leaves the gauge as it
        was."""
        rss = read_rss_bytes()
        if rss is not None:
            self._worker_rss.set(rss)
        if compile_cache_entries is not None:
            self._compile_cache_entries.set(int(compile_cache_entries))

    def set_run_id(self, run_id: str | None) -> None:
        """Label this serving process's metrics with a run id: the
        info-metric ``serving_run_info{run_id="..."} 1`` plus a ``run_id``
        key in the JSON wire shape."""
        if not run_id:
            return
        self.run_id = str(run_id)
        self.registry.gauge(
            "serving_run_info",
            "serving process identity (join key for cross-process "
            "correlation)", labels={"run_id": self.run_id}).set(1)

    # -- readers of single values ---------------------------------------
    @property
    def requests(self) -> int:
        return int(self._requests.value)

    @property
    def responses(self) -> int:
        return int(self._responses.value)

    @property
    def errors(self) -> int:
        return int(self._errors.value)

    @property
    def rejected_queue_full(self) -> int:
        return int(self._rejected_queue_full.value)

    @property
    def rejected_deadline(self) -> int:
        return int(self._rejected_deadline.value)

    @property
    def dispatches(self) -> int:
        return int(self._dispatches.value)

    @property
    def requests_coalesced(self) -> int:
        return int(self._requests_coalesced.value)

    @property
    def device_calls(self) -> int:
        return int(self._device_calls.value)

    @property
    def rows_real(self) -> int:
        return int(self._rows_real.value)

    @property
    def rows_padded(self) -> int:
        return int(self._rows_padded.value)

    @property
    def compiles(self) -> int:
        return int(self._compiles.value)

    @property
    def compile_cache_hits(self) -> int:
        return int(self._compile_cache_hits.value)

    @property
    def queue_depth(self) -> int:
        return int(self._queue_depth.value)

    @property
    def queue_capacity(self) -> int:
        return int(self._queue_capacity.value)

    @queue_capacity.setter
    def queue_capacity(self, value: int) -> None:
        # The batcher assigns this as a plain attribute at wiring time.
        self._queue_capacity.set(int(value))

    # -- writers ---------------------------------------------------------
    def request_accepted(self) -> None:
        self._requests.inc()

    def request_done(self, total_ms: float, ok: bool = True) -> None:
        (self._responses if ok else self._errors).inc()
        self.latency["total"].observe(total_ms)

    def request_rejected(self, reason: str) -> None:
        if reason == "queue_full":
            self._rejected_queue_full.inc()
        else:
            self._rejected_deadline.inc()

    def dispatch(self, n_requests: int) -> None:
        self._dispatches.inc()
        self._requests_coalesced.inc(n_requests)
        self._fill_ratio.set(
            self._requests_coalesced.value / self._dispatches.value)

    def _bucket_counters(self, bucket: int) -> tuple:
        with self._bucket_lock:
            counters = self._buckets.get(bucket)
            if counters is None:
                labels = {"bucket": str(int(bucket))}
                counters = (
                    self.registry.counter(
                        "serving_bucket_calls_total",
                        "device calls per ladder bucket", labels=labels),
                    self.registry.counter(
                        "serving_bucket_rows_real_total",
                        "real rows per ladder bucket", labels=labels),
                    self.registry.counter(
                        "serving_bucket_rows_padded_total",
                        "padded rows per ladder bucket", labels=labels),
                    self.registry.gauge(
                        "serving_bucket_padding_waste",
                        "padded-row fraction of this bucket's device "
                        "rows", labels=labels),
                )
                self._buckets[bucket] = counters
            return counters

    def device_call(self, bucket: int, rows_real: int, rows_padded: int,
                    device_ms: float) -> None:
        self._device_calls.inc()
        self._rows_real.inc(rows_real)
        self._rows_padded.inc(rows_padded)
        calls, real, padded, waste = self._bucket_counters(int(bucket))
        calls.inc()
        real.inc(rows_real)
        padded.inc(rows_padded)
        bucket_total = real.value + padded.value
        if bucket_total:
            waste.set(padded.value / bucket_total)
        self.latency["device"].observe(device_ms)
        total = self._rows_real.value + self._rows_padded.value
        if total:
            self._padding_waste.set(self._rows_padded.value / total)

    def observe_request_size(self, rows: int) -> None:
        """One device-chunk row count into the request-size histogram
        (labeled cumulative counters — the Prometheus/JSON-visible view
        of the distribution the adaptive ladder optimizes against).

        The ``rows`` label is the power-of-two ceiling of the real
        count, which caps the series at log2(max rows); the optimizer's
        own decayed histogram (serving/ladder.py) sees exact sizes.
        """
        bucket = 1 << max(0, int(rows) - 1).bit_length()
        with self._size_lock:
            counter = self._sizes.get(bucket)
            if counter is None:
                counter = self._sizes[bucket] = self.registry.counter(
                    "serving_request_size_total",
                    "device chunks by real row count "
                    "(pow2-ceiling buckets)",
                    labels={"rows": str(bucket)})
        counter.inc()

    # -- adaptive ladder -------------------------------------------------
    def set_ladder(self, buckets, generation: int) -> None:
        """Publish the live ladder: membership gauges (removed rungs go
        to 0, never vanish mid-scrape) + the generation gauge."""
        rungs = sorted(int(b) for b in buckets)
        with self._ladder_lock:
            self._ladder_buckets = rungs
            for b in rungs:
                if b not in self._ladder_rungs:
                    self._ladder_rungs[b] = self.registry.gauge(
                        "serving_ladder_bucket",
                        "1 = rung currently in the live ladder",
                        labels={"bucket": str(b)})
            for b, gauge in self._ladder_rungs.items():
                gauge.set(1 if b in rungs else 0)
        self._ladder_gen.set(int(generation))

    def ladder_swap(self, buckets, generation: int) -> None:
        self._ladder_swaps.inc()
        self.set_ladder(buckets, generation)

    def ladder_compiled(self, cause: str | None = None) -> None:
        self._ladder_compiles.inc()
        if cause:
            self.compile_cause(cause)

    def ladder_refresh_failed(self) -> None:
        self._ladder_failures.inc()

    @property
    def ladder_generation(self) -> int:
        return int(self._ladder_gen.value)

    @property
    def ladder_swaps(self) -> int:
        return int(self._ladder_swaps.value)

    @property
    def ladder_compiles(self) -> int:
        return int(self._ladder_compiles.value)

    def queue_wait(self, ms: float) -> None:
        self.latency["queue_wait"].observe(ms)

    def compiled(self, cause: str | None = None) -> None:
        self._compiles.inc()
        if cause:
            self.compile_cause(cause)

    def compile_cause(self, cause: str) -> None:
        """Itemize one compile by its cause (analysis/graph/recompile.py: a
        closed set, so the ``reason`` label is bounded). The bare
        ``serving_compiles_total`` / ``serving_ladder_compiles_total``
        stay the request-visible against background split."""
        with self._compile_cause_lock:
            counter = self._compile_causes.get(cause)
            if counter is None:
                counter = self._compile_causes[cause] = \
                    self.registry.counter(
                        "serving_compiles_by_cause_total",
                        "executable compiles by recompile-differ cause",
                        labels={"reason": str(cause)})
        counter.inc()

    def compile_cache_hit(self) -> None:
        self._compile_cache_hits.inc()

    def set_queue_depth(self, depth: int) -> None:
        self._queue_depth.set(int(depth))

    def model_swap(self, mode: str) -> None:
        with self._swap_lock:
            counter = self._swaps.get(mode)
            if counter is None:
                counter = self._swaps[mode] = self.registry.counter(
                    "serving_model_swaps_total",
                    "live weight swaps by mode", labels={"mode": mode})
        counter.inc()

    def set_checkpoint_step(self, step: int) -> None:
        self._ckpt_step.set(int(step))

    def rollback(self) -> None:
        self._rollbacks.inc()

    @property
    def checkpoint_step(self) -> int:
        return int(self._ckpt_step.value)

    @property
    def model_swaps(self) -> int:
        with self._swap_lock:
            return int(sum(c.value for c in self._swaps.values()))

    # -- readers ---------------------------------------------------------
    def to_dict(self) -> dict:
        """The JSON wire shape (unchanged keys), assembled metric by
        metric — no single scrape-wide lock."""
        rows_real, rows_padded = self.rows_real, self.rows_padded
        dispatches = self.dispatches
        padded_total = rows_real + rows_padded
        with self._bucket_lock:
            bucket_items = sorted(self._buckets.items())
        with self._size_lock:
            size_items = sorted(self._sizes.items())
        with self._ladder_lock:
            ladder_buckets = list(self._ladder_buckets)
        return {
            "uptime_s": round(time.time() - self.started_at, 3),
            "run_id": self.run_id,
            "requests": self.requests,
            "responses": self.responses,
            "errors": self.errors,
            "rejected_queue_full": self.rejected_queue_full,
            "rejected_deadline": self.rejected_deadline,
            "dispatches": dispatches,
            "device_calls": self.device_calls,
            "batch_fill_ratio": round(
                self.requests_coalesced / dispatches, 4)
            if dispatches else None,
            "padding_waste": round(rows_padded / padded_total, 4)
            if padded_total else None,
            "queue_depth": self.queue_depth,
            "queue_capacity": self.queue_capacity,
            "compile": {
                "compiles": self.compiles,
                "cache_hits": self.compile_cache_hits,
            },
            "checkpoint_step": self.checkpoint_step,
            "model_swaps": self.model_swaps,
            "ladder": {
                "buckets": ladder_buckets,
                "generation": self.ladder_generation,
                "swaps": self.ladder_swaps,
                "compiles": self.ladder_compiles,
                "refresh_failures": int(self._ladder_failures.value),
            },
            "request_sizes": {str(rows): int(c.value)
                              for rows, c in size_items},
            "buckets": {
                str(b): {"calls": int(calls.value),
                         "rows_real": int(real.value),
                         "rows_padded": int(padded.value),
                         "padding_waste": round(
                             padded.value / (real.value + padded.value),
                             4)
                         if (real.value + padded.value) else None}
                for b, (calls, real, padded, _waste) in bucket_items
            },
            "latency_ms": {name: win.snapshot_ms()
                           for name, win in self.latency.items()},
        }

    def render_prometheus(self) -> str:
        """Exposition-format text for everything in this stack's
        registry (the serving /metrics content-negotiation target)."""
        return self.registry.render_prometheus()
