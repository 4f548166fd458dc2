"""Metric federation: N per-process registries -> one fleet view.
Counterpart of ``ntxent_tpu/obs/aggregate.py``, a stdlib copy.

The fleet (serving/fleet.py + serving/router.py) runs N worker
processes and a router, each publishing its own ``MetricsRegistry``
over its own ``/metrics``. No single scrape can answer "is the fleet
healthy" — the router's counters say nothing about worker queue
depths, and a worker's padding waste says nothing about its siblings.
This module is the missing layer: a ``FleetAggregator``
scrapes every target's raw-state view (``/metrics?format=state`` —
``MetricsRegistry.dump_state``) each tick and merges them into ONE
registry published on the router's ``/metrics/fleet``.

Merge rules (one rule per metric kind):

* **counters sum** — ``serving_requests_total`` across workers is the
  fleet's request count; same (name, labels) series accumulate;
* **gauges label** — a queue depth is per-process state; summing two
  queue depths answers nothing, so each instance's gauge re-exports
  with an ``instance`` label (``serving_queue_depth{instance="w0"}``);
* **histograms pool** — count/sum add, and the bounded sample windows
  CONCATENATE so fleet percentiles come from the one exact-window
  quantile rule (obs/registry.quantile) applied to the pooled samples.
  The p99 of a fleet is not the mean of its workers' p99s; pooling the
  raw windows is what keeps the serving stack's "percentiles are
  exact" property true one level up.

Failure model: a worker dying mid-scrape (the killworker chaos case)
must yield a PARTIAL-but-valid federated view, never a 500 — the
failed target's last-good state is kept, marked stale via
``fleet_fed_instance_up{instance=...} 0``, and dropped entirely only
after ``stale_after`` consecutive failures (a restarted worker's
counters restart from zero; carrying a dead incarnation's totals
forever would double-count its replacement).

Everything here is stdlib + urllib (the obs-package rule): the
aggregator runs in the router process, which never imports torch.
"""

from __future__ import annotations

import json
import logging
import threading
import time
import urllib.error
import urllib.request

from .registry import Histogram, MetricsRegistry

logger = logging.getLogger(__name__)

__all__ = ["merge_states", "FleetAggregator"]

# Meta-series the merged view carries about the federation itself.
_UP_GAUGE = "fleet_fed_instance_up"
_SCRAPES = "fleet_fed_scrapes_total"
_FAILURES = "fleet_fed_scrape_failures_total"
_INSTANCES = "fleet_fed_instances"


def merge_states(states: dict[str, dict],
                 stale: set[str] | None = None) -> MetricsRegistry:
    """Merge per-instance ``dump_state`` dicts into a fresh registry.

    ``states``: instance name -> the dict its ``/metrics?format=state``
    returned. ``stale``: instances whose state is a retained last-good
    copy (scrape failed this tick) — included in the merge (partial
    beats absent) but marked down in ``fleet_fed_instance_up``.

    Malformed entries (a worker answering mid-restart with garbage)
    are skipped per-metric, never fatal: a federated scrape must stay
    valid when one worker is not.
    """
    merged = MetricsRegistry()
    stale = stale or set()
    for instance in sorted(states):
        merged.gauge(_UP_GAUGE,
                     "1 = instance scraped this tick, 0 = stale "
                     "(last-good state retained)",
                     labels={"instance": instance}).set(
            0 if instance in stale else 1)
        metrics = (states[instance] or {}).get("metrics")
        if not isinstance(metrics, list):
            continue
        for entry in metrics:
            try:
                _merge_entry(merged, instance, entry)
            except (KeyError, TypeError, ValueError) as e:
                logger.debug("federation: skipping malformed metric "
                             "from %s: %r (%s)", instance, entry, e)
    merged.gauge(_INSTANCES,
                 "instances contributing to this federated view").set(
        len(states))
    return merged


def _merge_entry(merged: MetricsRegistry, instance: str,
                 entry: dict) -> None:
    name = str(entry["name"])
    kind = entry.get("kind")
    labels = {str(k): str(v)
              for k, v in (entry.get("labels") or {}).items()}
    if kind == "counter":
        merged.counter(name, labels=labels).inc(float(entry["value"]))
    elif kind == "gauge":
        # Per-process state: re-label, never sum. The instance label is
        # appended (it must not collide with a real label the metric
        # already carries — 'instance' is reserved for federation).
        merged.gauge(name, labels={**labels, "instance": instance}).set(
            float(entry["value"]))
    elif kind == "summary":
        window = [float(v) for v in (entry.get("window") or [])]
        h = merged.histogram(name, labels=labels,
                             window=max(1, _POOL_WINDOW))
        _pool_histogram(h, int(entry.get("count", len(window))),
                        float(entry.get("sum", 0.0)), window)
    # Unknown kinds are dropped (forward compatibility: an older router
    # federating a newer worker must not crash on a new metric kind).


# Pooled-window bound: large enough that every contributor's full
# default window (2048) survives for a handful of workers; bounded so
# a huge fleet cannot make one scrape quadratic.
_POOL_WINDOW = 8192


def _pool_histogram(h: Histogram, count: int, total: float,
                    window: list[float]) -> None:
    """Accumulate one contributor into a merged histogram: cumulative
    count/sum add; the recent-sample windows concatenate (deque bound
    applies — the pooled window stays bounded by _POOL_WINDOW)."""
    with h._lock:
        h.count += max(0, count)
        h.total += total
        h._window.extend(window)


class FleetAggregator:
    """Scrape every target each tick; publish one merged registry.

    ``targets_fn() -> dict[instance, base_url]`` resolves the live
    scrape set per tick (the router passes a closure over its
    ``WorkerPool``, so membership tracks restarts without re-wiring).
    ``local()`` states (e.g. the router's own registry) merge in
    without an HTTP hop.

    The merged view is rebuilt from scratch each tick — counters in the
    SOURCE registries are cumulative, so rebuilding (not accumulating)
    is what makes the federated counter equal the sum of the current
    per-worker values instead of a sum over history.
    """

    def __init__(self, targets_fn, local: dict | None = None,
                 interval_s: float = 2.0, timeout_s: float = 2.0,
                 stale_after: int = 5):
        self.targets_fn = targets_fn
        # instance -> MetricsRegistry scraped in-process (no HTTP).
        self.local = dict(local or {})
        self.interval_s = float(interval_s)
        self.timeout_s = float(timeout_s)
        self.stale_after = int(stale_after)
        self.scrapes = 0
        self.failures = 0
        # _lock guards the published view; _scrape_lock serializes
        # whole ticks — merged()'s cold path runs on HTTP request
        # threads concurrently with the background tick, and a tick
        # mutates the last-good/streak tables and re-enters on_merge
        # hooks (the SLOEngine's burn-rate rings are single-evaluator
        # state: two interleaved evaluations would append out-of-order
        # timestamps and double-count breach streaks).
        self._lock = threading.Lock()
        self._scrape_lock = threading.Lock()
        self._last_good: dict[str, dict] = {}
        self._fail_streak: dict[str, int] = {}
        self._merged: MetricsRegistry = MetricsRegistry()
        self._merged_at: float | None = None
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        # SLO engines (obs/slo.py) subscribe here: called with the
        # freshly merged registry after every tick, on the aggregator
        # thread (evaluations must never ride a request handler).
        self.on_merge = []

    # -- scraping ----------------------------------------------------------
    def _scrape(self, url: str) -> dict | None:
        req = urllib.request.Request(
            url.rstrip("/") + "/metrics?format=state")
        try:
            with urllib.request.urlopen(
                    req, timeout=self.timeout_s) as resp:
                state = json.loads(resp.read())
            return state if isinstance(state, dict) else None
        except (urllib.error.URLError, OSError, ValueError):
            return None

    def scrape_once(self) -> MetricsRegistry:
        """One federation tick: scrape, merge, publish; returns the
        merged registry (tests and /metrics/fleet's cold path drive
        this directly). Ticks are serialized — concurrent callers
        queue on the scrape lock and the late ones return the view the
        first one just published instead of re-scraping."""
        entered_at = time.monotonic()
        with self._scrape_lock:
            with self._lock:
                at, merged = self._merged_at, self._merged
            if at is not None and at >= entered_at:
                # A tick completed while we waited for the lock: its
                # view is fresher than our intent — serve it.
                return merged
            return self._scrape_once_locked()

    def _scrape_once_locked(self) -> MetricsRegistry:
        targets = dict(self.targets_fn() or {})
        states: dict[str, dict] = {}
        stale: set[str] = set()
        for instance, url in sorted(targets.items()):
            self.scrapes += 1
            state = self._scrape(url)
            if state is not None:
                states[instance] = state
                self._last_good[instance] = state
                self._fail_streak[instance] = 0
                continue
            self.failures += 1
            streak = self._fail_streak.get(instance, 0) + 1
            self._fail_streak[instance] = streak
            last = self._last_good.get(instance)
            if last is not None and streak < self.stale_after:
                # Partial-but-valid: the dead worker's last-good state
                # stays in the view, visibly stale — a mid-scrape
                # SIGKILL must not blank the fleet's history of it.
                states[instance] = last
                stale.add(instance)
            else:
                self._last_good.pop(instance, None)
        # Instances that left the target set entirely (removed from the
        # pool) drop out of _last_good so a scaled-down fleet's view
        # shrinks with it.
        for gone in set(self._last_good) - set(targets):
            self._last_good.pop(gone, None)
            self._fail_streak.pop(gone, None)
        for instance, registry in sorted(self.local.items()):
            states[instance] = registry.dump_state()
        merged = merge_states(states, stale=stale)
        merged.counter(_SCRAPES, "federation scrape attempts").inc(
            self.scrapes)
        merged.counter(_FAILURES,
                       "federation scrapes that failed").inc(
            self.failures)
        with self._lock:
            self._merged = merged
            self._merged_at = time.monotonic()
        for hook in list(self.on_merge):
            try:
                hook(merged)
            except Exception:  # noqa: BLE001 — a bad SLO evaluation
                # must not kill federation.
                logger.exception("federation: on_merge hook failed")
        return merged

    # -- readers -----------------------------------------------------------
    def merged(self, max_age_s: float | None = None) -> MetricsRegistry:
        """Latest merged registry; scrapes on demand when nothing has
        been published yet or the view is older than ``max_age_s``
        (the /metrics/fleet cold path — a scraper must get data, not
        an empty registry, before the first background tick)."""
        with self._lock:
            at, merged = self._merged_at, self._merged
        if at is None or (max_age_s is not None
                          and time.monotonic() - at > max_age_s):
            return self.scrape_once()
        return merged

    def snapshot(self) -> dict:
        with self._lock:
            age = (time.monotonic() - self._merged_at
                   if self._merged_at is not None else None)
        return {"scrapes": self.scrapes, "failures": self.failures,
                "age_s": round(age, 3) if age is not None else None,
                "stale": sorted(i for i, s in self._fail_streak.items()
                                if s > 0 and i in self._last_good)}

    # -- lifecycle ---------------------------------------------------------
    def start(self) -> "FleetAggregator":
        if self._thread is not None:
            raise RuntimeError("aggregator already started")
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="ntxent-fed-scraper")
        self._thread.start()
        return self

    def _run(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self.scrape_once()
            except Exception:  # noqa: BLE001 — federation must survive
                # any single bad tick.
                logger.exception("federation: scrape tick failed")

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(self.interval_s * 2 + 5.0)
            self._thread = None
