"""Fleet time-series plane: retained metrics history + its consumers.
Counterpart of ``ntxent_tpu/obs/history.py``, a stdlib copy whose spill
is the JAX module's byte for byte, so either package reopens the
other's ``--history-dir``.

Every federation tick (obs/aggregate.py) builds a rich merged view of
the fleet — and forgets it the moment the next tick lands. Nothing in
the stack could answer "what did queue depth look like over the last
ten minutes", so trajectory questions (is the diurnal ramp coming? did
cache hit rate start sagging an hour ago?) were structurally
unanswerable. This module is the retained plane:

* ``MetricHistory`` — an embedded per-series time-series store:
  append-only ring buffers with STAGED DOWNSAMPLING (raw samples →
  10 s rollups → 1 m rollups of min/max/mean/last/n), so memory stays
  bounded while the retained horizon grows with coarseness. Optional
  durable spill reuses the checkpoint tier's stage-fsync-rename idiom
  (training/checkpoint.py): a router restart reopens with history
  intact. Served as ``GET /metrics/history`` on the fleet router.
* ``HistoryRecorder`` — the ``FleetAggregator.on_merge`` hook that
  reduces each merged registry into scalar series samples
  (gauge sums/maxes, windowed counter rates, pooled histogram
  quantiles via the one exact-window quantile rule, delta ratios like
  cache hit rate) and records them.
* ``AnomalyDetector`` — the ProfilerTrigger rule generalized: a
  rolling median + MAD per watched series, armed only after a warmup
  sample count, anomalous samples excluded from their own baseline.
  A breach fires a typed ``anomaly`` event, an ``AlertStore`` entry,
  and ONE flight-recorder dump per incident — the same alert path SLO
  breaches ride.
* ``Forecaster`` — Holt-Winters-style double (optionally triple, with
  an additive seasonal term) exponential smoothing over an
  irregularly-ticked series. ``AutoscaleController`` feeds it the
  request-rate and queue-depth series and reads a ``--predict-horizon``
  lead-time forecast, so scale-up can fire BEFORE a diurnal ramp
  breaches; the forecast is hard-bounded (``bound_min``/``bound_max``)
  so a wild model can never demand absurd capacity, and the
  controller's cooldowns/max_workers still gate every action.

Stdlib only (the obs-package rule): the store runs in the router
process, which never imports torch.
"""

from __future__ import annotations

import json
import logging
import math
import os
import statistics
import threading
import time
import uuid
from collections import deque
from dataclasses import dataclass, field

from . import events
from .registry import MetricsRegistry
from .slo import AlertStore, counter_total, histogram_quantile

logger = logging.getLogger(__name__)

__all__ = ["MetricHistory", "HistoryRecorder", "SeriesSpec",
           "AnomalyDetector", "Forecaster", "DEFAULT_SERIES",
           "gauge_reduce", "ingest_timeline"]

# The two rollup resolutions, coarsest-retained last. Names are the
# query vocabulary (``?step=raw|10s|1m``); seconds are the bucket
# widths the rollup accumulators seal on.
ROLLUP_STEPS = (("10s", 10.0), ("1m", 60.0))
_SPILL_FILE = "history.json"
_SPILL_VERSION = 1


def _fsync_path(path: str) -> None:
    """fsync a file or directory (same contract as the checkpoint
    tier's helper, re-spelled here because training/checkpoint.py
    imports torch and obs must not; ``NTXENT_CKPT_NO_FSYNC=1`` is the
    same bench-only skip)."""
    if os.environ.get("NTXENT_CKPT_NO_FSYNC") == "1":
        return
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _new_bucket(t_start: float, value: float) -> dict:
    return {"t": t_start, "n": 1, "sum": value, "min": value,
            "max": value, "last": value}


def _bucket_add(bucket: dict, value: float) -> None:
    bucket["n"] += 1
    bucket["sum"] += value
    if value < bucket["min"]:
        bucket["min"] = value
    if value > bucket["max"]:
        bucket["max"] = value
    bucket["last"] = value


def _bucket_view(bucket: dict) -> dict:
    """The query shape of one rollup point (mean derived, sum kept
    internal so repeated queries can't drift it)."""
    return {"t": bucket["t"], "n": bucket["n"],
            "min": bucket["min"], "max": bucket["max"],
            "mean": bucket["sum"] / bucket["n"],
            "last": bucket["last"]}


class _Series:
    """One series' staged storage: raw ring + one sealed ring and one
    open accumulator per rollup resolution."""

    __slots__ = ("raw", "rings", "open")

    def __init__(self, raw_len: int, rollup_len: int):
        self.raw: deque = deque(maxlen=raw_len)
        self.rings: dict[str, deque] = {
            name: deque(maxlen=rollup_len) for name, _ in ROLLUP_STEPS}
        self.open: dict[str, dict | None] = {
            name: None for name, _ in ROLLUP_STEPS}

    def append(self, t: float, value: float) -> None:
        self.raw.append((t, value))
        for name, step_s in ROLLUP_STEPS:
            start = math.floor(t / step_s) * step_s
            bucket = self.open[name]
            if bucket is None:
                self.open[name] = _new_bucket(start, value)
            elif start > bucket["t"]:
                self.rings[name].append(bucket)
                self.open[name] = _new_bucket(start, value)
            else:
                # Same bucket — or a clock regression, which folds into
                # the open bucket rather than rewriting sealed history.
                _bucket_add(bucket, value)

    def points(self, step: str) -> list[dict]:
        if step == "raw":
            return [{"t": t, "value": v} for t, v in self.raw]
        out = [_bucket_view(b) for b in self.rings[step]]
        if self.open[step] is not None:
            # The open bucket is part of the truth: a query must see
            # every recorded sample, sealed or not.
            out.append(_bucket_view(self.open[step]))
        return out

    def dump(self) -> dict:
        return {"raw": [[t, v] for t, v in self.raw],
                "rings": {name: list(ring)
                          for name, ring in self.rings.items()},
                "open": {name: b for name, b in self.open.items()}}

    def load(self, state: dict) -> None:
        for t, v in state.get("raw") or []:
            self.raw.append((float(t), float(v)))
        for name, _ in ROLLUP_STEPS:
            for b in (state.get("rings") or {}).get(name) or []:
                self.rings[name].append(dict(b))
            open_b = (state.get("open") or {}).get(name)
            self.open[name] = dict(open_b) if open_b else None


class MetricHistory:
    """Bounded embedded time-series store with staged downsampling.

    Memory is bounded by construction: ``max_series`` series, each
    holding ``raw_len`` raw samples + ``rollup_len`` sealed buckets
    per rollup resolution (new series past the cap are dropped and
    counted — an unbounded series vocabulary must degrade the history,
    never the process).

    ``spill_dir`` arms durability: ``maybe_spill`` (called by the
    recorder once per ``spill_interval_s``) stages the full store as
    JSON, fsyncs, and renames into place — the checkpoint tier's
    crash-atomicity idiom — and a fresh ``MetricHistory`` over the same
    directory reopens with everything the last spill saw.
    """

    def __init__(self, raw_len: int = 720, rollup_len: int = 720,
                 max_series: int = 256, spill_dir: str | None = None,
                 spill_interval_s: float = 30.0,
                 registry: MetricsRegistry | None = None,
                 clock=time.time):
        if raw_len < 1 or rollup_len < 1:
            raise ValueError("raw_len and rollup_len must be >= 1")
        if max_series < 1:
            raise ValueError(f"max_series must be >= 1, got {max_series}")
        self.raw_len = int(raw_len)
        self.rollup_len = int(rollup_len)
        self.max_series = int(max_series)
        self.spill_dir = spill_dir
        self.spill_interval_s = float(spill_interval_s)
        self.clock = clock
        self._lock = threading.Lock()
        self._series: dict[str, _Series] = {}
        self._last_spill: float | None = None
        r = registry
        self._g_series = r.gauge(
            "obs_history_series", "series retained in the history "
            "store") if r is not None else None
        self._c_samples = r.counter(
            "obs_history_samples_total",
            "samples recorded into the history store") \
            if r is not None else None
        self._c_dropped = r.counter(
            "obs_history_dropped_series_total",
            "series refused at the max_series cap") \
            if r is not None else None
        self._c_spills = r.counter(
            "obs_history_spills_total",
            "durable spills written") if r is not None else None
        if spill_dir is not None:
            os.makedirs(spill_dir, exist_ok=True)
            self._reopen()

    # -- writing ---------------------------------------------------------
    def record(self, series: str, value: float,
               t: float | None = None) -> bool:
        """Append one sample; returns False when the series was refused
        at the cap or the value is not a finite number."""
        try:
            value = float(value)
        except (TypeError, ValueError):
            return False
        if not math.isfinite(value):
            return False
        t = self.clock() if t is None else float(t)
        with self._lock:
            state = self._series.get(series)
            if state is None:
                if len(self._series) >= self.max_series:
                    if self._c_dropped is not None:
                        self._c_dropped.inc()
                    return False
                state = self._series[series] = _Series(
                    self.raw_len, self.rollup_len)
                if self._g_series is not None:
                    self._g_series.set(len(self._series))
            state.append(t, value)
        if self._c_samples is not None:
            self._c_samples.inc()
        return True

    # -- reading ---------------------------------------------------------
    def series_names(self) -> list[str]:
        with self._lock:
            return sorted(self._series)

    def query(self, series: str, step: str = "raw",
              window_s: float | None = None) -> dict:
        """Points for one series at one resolution, newest-last.

        ``step``: ``"raw"`` | ``"10s"`` | ``"1m"`` (numeric spellings
        ``10``/``60`` accepted). ``window_s`` keeps only points whose
        timestamp is within that many seconds of the newest point —
        relative to the DATA, not the wall clock, so a replayed
        timeline queries the same way a live fleet does. Raises
        ``KeyError`` on an unknown series, ``ValueError`` on a bad
        step/window.
        """
        step = _canonical_step(step)
        if window_s is not None:
            window_s = float(window_s)
            if not math.isfinite(window_s) or window_s <= 0:
                raise ValueError(f"window must be > 0, got {window_s}")
        with self._lock:
            state = self._series.get(series)
            if state is None:
                raise KeyError(series)
            points = state.points(step)
        if window_s is not None and points:
            edge = points[-1]["t"] - window_s
            points = [p for p in points if p["t"] >= edge]
        return {"series": series, "step": step, "points": points}

    def snapshot(self) -> dict:
        """Store-level stats for the router's metrics_dict."""
        with self._lock:
            n_series = len(self._series)
            n_raw = sum(len(s.raw) for s in self._series.values())
        return {"series": n_series, "raw_samples": n_raw,
                "max_series": self.max_series,
                "spill_dir": self.spill_dir}

    # -- durability ------------------------------------------------------
    def spill(self) -> str | None:
        """Stage-fsync-rename the whole store into ``spill_dir``;
        returns the final path (None when durability is off or the
        write failed — history durability must never take the router
        down on a full disk)."""
        if self.spill_dir is None:
            return None
        with self._lock:
            payload = {"version": _SPILL_VERSION,
                       "saved_at": self.clock(),
                       "series": {name: s.dump()
                                  for name, s in self._series.items()}}
        final = os.path.join(self.spill_dir, _SPILL_FILE)
        tmp = os.path.join(
            self.spill_dir,
            f".tmp-{os.getpid()}-{uuid.uuid4().hex[:8]}")
        try:
            with open(tmp, "w") as f:
                json.dump(payload, f)
            _fsync_path(tmp)
            os.replace(tmp, final)
            _fsync_path(self.spill_dir)
        except OSError as e:
            logger.error("history spill to %s failed: %s", final, e)
            try:
                os.unlink(tmp)
            except OSError:
                pass
            return None
        self._last_spill = self.clock()
        if self._c_spills is not None:
            self._c_spills.inc()
        return final

    def maybe_spill(self) -> str | None:
        """Spill when the interval elapsed (the recorder's per-tick
        call site — cheap no-op in between)."""
        if self.spill_dir is None:
            return None
        now = self.clock()
        if self._last_spill is not None \
                and now - self._last_spill < self.spill_interval_s:
            return None
        return self.spill()

    def close(self) -> None:
        """Final spill (teardown path)."""
        self.spill()

    def _reopen(self) -> None:
        path = os.path.join(self.spill_dir, _SPILL_FILE)
        if not os.path.exists(path):
            return
        try:
            with open(path) as f:
                payload = json.load(f)
            series = payload.get("series") or {}
        except (OSError, ValueError) as e:
            logger.warning("history spill at %s unreadable (%s) — "
                           "starting empty", path, e)
            return
        with self._lock:
            for name in sorted(series)[:self.max_series]:
                state = _Series(self.raw_len, self.rollup_len)
                try:
                    state.load(series[name])
                except (TypeError, ValueError, KeyError):
                    continue  # one bad series must not void the rest
                self._series[name] = state
            if self._g_series is not None:
                self._g_series.set(len(self._series))
        logger.info("history reopened from %s: %d series", path,
                    len(series))


def _canonical_step(step) -> str:
    if step in (None, "", "raw"):
        return "raw"
    for name, step_s in ROLLUP_STEPS:
        if step == name:
            return name
        try:
            if float(step) == step_s:
                return name
        except (TypeError, ValueError):
            pass
    valid = ["raw"] + [name for name, _ in ROLLUP_STEPS]
    raise ValueError(f"unknown step {step!r} (want one of {valid})")


# -- reducing a merged registry into scalar series -----------------------


def gauge_reduce(registry: MetricsRegistry, name: str,
                 mode: str = "sum") -> float | None:
    """Reduce every label-set of a gauge (the federated per-instance
    view) to one scalar: ``sum`` (additive state like queue depth) or
    ``max`` (per-process ceilings like RSS). None when absent."""
    values = [float(e.get("value", 0.0))
              for e in registry.dump_state()["metrics"]
              if e["name"] == name and e["kind"] == "gauge"]
    if not values:
        return None
    return sum(values) if mode == "sum" else max(values)


@dataclass
class SeriesSpec:
    """How one history series is extracted from a merged registry.

    ``mode``:

    * ``gauge_sum`` / ``gauge_max`` — reduce the gauge's label-sets;
    * ``counter_rate`` — per-second delta of a cumulative counter
      between successive ticks (the request-rate series);
    * ``quantile`` — pooled exact-window quantile ``q`` of a histogram
      (optionally label-filtered);
    * ``ratio`` — ``d(metric) / (d(metric) + d(denom))`` per tick —
      the hit-rate shape (hits vs misses);
    * ``per`` — ``d(metric) / d(denom)`` per tick — the unit-economy
      shape (bytes per query);
    * ``gauge_labeled`` — one history series PER value of
      ``label_key`` (named ``{name}.{label_value}``), so per-instance
      state like ``retrieval_shard_up{shard=N}`` stays per-instance:
      a sum would hide one dead shard among N-1 live ones, exactly the
      signal the anomaly detector exists to catch.
    """

    name: str
    metric: str
    mode: str = "gauge_sum"
    labels: dict = field(default_factory=dict)
    q: float = 0.99
    denom: str | None = None
    label_key: str | None = None

    def __post_init__(self):
        if self.mode not in ("gauge_sum", "gauge_max", "counter_rate",
                             "quantile", "ratio", "per",
                             "gauge_labeled"):
            raise ValueError(f"unknown series mode {self.mode!r}")
        if self.mode in ("ratio", "per") and not self.denom:
            raise ValueError(f"series {self.name!r} mode {self.mode!r} "
                             "needs a denom metric")
        if self.mode == "gauge_labeled" and not self.label_key:
            raise ValueError(f"series {self.name!r} mode gauge_labeled "
                             "needs a label_key")


# The default watch set: the series the detector/forecaster consumers
# are specified over. Extraction is skip-on-absent, so a
# fleet without (say) retrieval attached simply never grows those
# series.
DEFAULT_SERIES = (
    SeriesSpec("fleet_request_rate", "fleet_requests_total",
               mode="counter_rate"),
    SeriesSpec("serving_queue_depth", "serving_queue_depth",
               mode="gauge_sum"),
    SeriesSpec("fleet_p99_ms", "fleet_latency_ms", mode="quantile",
               labels={"stage": "total"}, q=0.99),
    # q=1.0 is the pooled window MAX under the exact-window quantile
    # rule — the series a short stall actually moves (a 3 s wedge hangs
    # a handful of requests: invisible to p99 over hundreds of samples,
    # unmissable here). Matches loadgen's per-second timeline key.
    SeriesSpec("fleet_latency_max_ms", "fleet_latency_ms",
               mode="quantile", labels={"stage": "total"}, q=1.0),
    SeriesSpec("fleet_cache_hit_rate", "fleet_cache_hits_total",
               mode="ratio", denom="fleet_cache_misses_total"),
    SeriesSpec("fleet_shadow_drift_p99", "fleet_shadow_drift",
               mode="quantile", q=0.99),
    SeriesSpec("retrieval_recall_probe", "retrieval_recall_probe",
               mode="gauge_max"),
    SeriesSpec("retrieval_scan_bytes_per_query",
               "retrieval_scan_bytes_total", mode="per",
               denom="retrieval_scan_queries_total"),
    SeriesSpec("serving_worker_rss_bytes", "serving_worker_rss_bytes",
               mode="gauge_max"),
    SeriesSpec("serving_compile_cache_entries",
               "serving_compile_cache_entries", mode="gauge_max"),
    # Per-shard liveness (the retrieval tier's shard plane): one series
    # per shard id, so a single shard dropping 1.0 -> 0.0 is a step the
    # detector flags
    # even while the plane as a whole keeps answering.
    SeriesSpec("retrieval_shard_up", "retrieval_shard_up",
               mode="gauge_labeled", label_key="shard"),
)


class HistoryRecorder:
    """The ``FleetAggregator.on_merge`` hook feeding the store.

    Each tick: reduce the merged registry through every ``SeriesSpec``,
    record the resulting samples, hand each to the detector (when
    armed), and let the store spill if its interval elapsed. Never
    raises — a history bug must not poison federation (the aggregator
    guards hooks too; this is belt and braces for direct callers).
    """

    def __init__(self, history: MetricHistory,
                 series: tuple[SeriesSpec, ...] = DEFAULT_SERIES,
                 detector: "AnomalyDetector | None" = None,
                 clock=time.time):
        self.history = history
        self.series = tuple(series)
        self.detector = detector
        self.clock = clock
        # (t, value) per counter-shaped metric, for rates and deltas.
        self._prev: dict[str, tuple[float, float]] = {}

    def on_merge(self, merged: MetricsRegistry) -> dict[str, float]:
        try:
            return self._tick(merged)
        except Exception:  # noqa: BLE001 — see class docstring.
            logger.exception("history recorder tick failed")
            return {}

    def _tick(self, merged: MetricsRegistry) -> dict[str, float]:
        now = self.clock()
        out: dict[str, float] = {}
        for spec in self.series:
            if spec.mode == "gauge_labeled":
                for name, value in self._extract_labeled(spec, merged):
                    out[name] = value
                    self.history.record(name, value, t=now)
                    if self.detector is not None:
                        self.detector.observe(name, value, t=now)
                continue
            value = self._extract(spec, merged, now)
            if value is None:
                continue
            out[spec.name] = value
            self.history.record(spec.name, value, t=now)
            if self.detector is not None:
                self.detector.observe(spec.name, value, t=now)
        self.history.maybe_spill()
        return out

    def _delta(self, key: str, total: float, now: float,
               ) -> tuple[float, float] | None:
        prev = self._prev.get(key)
        self._prev[key] = (now, total)
        if prev is None:
            return None
        dt = now - prev[0]
        if dt <= 0:
            return None
        return total - prev[1], dt

    def _extract_labeled(self, spec: SeriesSpec,
                         merged: MetricsRegistry,
                         ) -> list[tuple[str, float]]:
        """Expand a ``gauge_labeled`` spec: one ``(series_name,
        value)`` per distinct ``label_key`` value of the gauge, named
        ``{spec.name}.{label_value}``. Label-sets missing the key are
        skipped (they belong to some other instrumentation)."""
        out: list[tuple[str, float]] = []
        for e in merged.dump_state()["metrics"]:
            if e["name"] != spec.metric or e["kind"] != "gauge":
                continue
            lv = e.get("labels", {}).get(spec.label_key)
            if lv is None:
                continue
            out.append((f"{spec.name}.{lv}",
                        float(e.get("value", 0.0))))
        return out

    def _extract(self, spec: SeriesSpec, merged: MetricsRegistry,
                 now: float) -> float | None:
        if spec.mode in ("gauge_sum", "gauge_max"):
            return gauge_reduce(merged, spec.metric,
                                "sum" if spec.mode == "gauge_sum"
                                else "max")
        if spec.mode == "quantile":
            value, n = histogram_quantile(merged, spec.metric, spec.q,
                                          labels=spec.labels)
            return value if n else None
        total = counter_total(merged, spec.metric)
        if spec.mode == "counter_rate":
            d = self._delta(spec.name, total, now)
            return None if d is None else max(0.0, d[0]) / d[1]
        denom_total = counter_total(merged, spec.denom)
        d_num = self._delta(f"{spec.name}:num", total, now)
        d_den = self._delta(f"{spec.name}:den", denom_total, now)
        if d_num is None or d_den is None:
            return None
        if spec.mode == "ratio":
            events_n = d_num[0] + d_den[0]
            return None if events_n <= 0 else d_num[0] / events_n
        return None if d_den[0] <= 0 else d_num[0] / d_den[0]


def ingest_timeline(history: MetricHistory, timeline: list[dict],
                    t0: float = 0.0) -> int:
    """Round-trip a ``scripts/loadgen.py --timeline`` summary into the
    store: each per-second bucket is keyed by history series names
    (one schema), so a captured replay can be loaded
    and queried exactly like a live fleet's history. Returns the
    number of samples recorded."""
    n = 0
    for bucket in timeline:
        t = t0 + float(bucket.get("t", 0))
        for key, value in bucket.items():
            if key == "t":
                continue
            if history.record(str(key), value, t=t):
                n += 1
    return n


class AnomalyDetector:
    """Rolling median + MAD changepoint watch over history series.

    The ProfilerTrigger rule generalized (obs/profiler.py): per watched
    series, keep a bounded window of NORMAL samples; a sample further
    than ``mad_factor`` scaled deviations from the rolling median is
    anomalous and stays OUT of the window (an incident must not shift
    the baseline it is judged against). Arming waits for ``warmup``
    samples so a cold start's ramp can never fire it. The deviation
    scale is ``max(MAD, rel_floor*|median|, abs_floor)`` — a perfectly
    flat series (MAD 0) still needs a materially sized spike to page.

    Breach side effects mirror the SLO engine's: ``AlertStore.fire``
    (alert name ``anomaly:<series>``), a typed ``anomaly`` event, and
    ONE flight dump per incident; ``clear_ticks`` consecutive normal
    samples resolve it.
    """

    def __init__(self, store: AlertStore | None = None,
                 window: int = 64, warmup: int = 20,
                 mad_factor: float = 6.0, rel_floor: float = 0.05,
                 abs_floor: float = 1e-9, clear_ticks: int = 8,
                 watch: set[str] | None = None,
                 registry: MetricsRegistry | None = None):
        if warmup < 2:
            raise ValueError(f"warmup must be >= 2, got {warmup}")
        if mad_factor <= 0:
            raise ValueError("mad_factor must be > 0")
        self.store = store
        # None = judge every series the recorder feeds; a set restricts
        # the watch to the configured names (an operator scoping the
        # pager to the series that matter on their rig).
        self.watch = set(watch) if watch is not None else None
        self.window = int(window)
        self.warmup = int(warmup)
        self.mad_factor = float(mad_factor)
        self.rel_floor = float(rel_floor)
        self.abs_floor = float(abs_floor)
        self.clear_ticks = int(clear_ticks)
        self.registry = registry
        self._lock = threading.Lock()
        self._windows: dict[str, deque] = {}
        self._clear_streak: dict[str, int] = {}
        self._firing: set[str] = set()
        self._counters: dict[str, object] = {}

    def _count(self, series: str) -> None:
        if self.registry is None:
            return
        counter = self._counters.get(series)
        if counter is None:
            counter = self._counters[series] = self.registry.counter(
                "obs_anomalies_total",
                "anomaly incidents fired, by series",
                labels={"series": series})
        counter.inc()

    def firing(self) -> list[str]:
        with self._lock:
            return sorted(self._firing)

    def observe(self, series: str, value: float,
                t: float | None = None) -> bool:
        """Judge one sample; returns True when it OPENED an incident
        (refreshes and normal samples return False)."""
        if self.watch is not None and series not in self.watch:
            return False
        try:
            value = float(value)
        except (TypeError, ValueError):
            return False
        if not math.isfinite(value):
            return False
        with self._lock:
            win = self._windows.get(series)
            if win is None:
                win = self._windows[series] = deque(maxlen=self.window)
            if len(win) < self.warmup:
                win.append(value)
                return False
            med = statistics.median(win)
            mad = statistics.median(abs(x - med) for x in win)
            scale = max(mad, self.rel_floor * abs(med), self.abs_floor)
            threshold = self.mad_factor * scale
            breach = abs(value - med) > threshold
            if not breach:
                win.append(value)
                streak = self._clear_streak.get(series, 0) + 1
                self._clear_streak[series] = streak
                resolved = (series in self._firing
                            and streak >= self.clear_ticks)
                if resolved:
                    self._firing.discard(series)
            else:
                self._clear_streak[series] = 0
                opened = series not in self._firing
                if opened:
                    self._firing.add(series)
        if breach:
            if opened:
                self._fire(series, value, med, threshold)
            return opened
        if resolved:
            self._resolve(series)
        return False

    def _fire(self, series: str, value: float, median: float,
              threshold: float) -> None:
        name = f"anomaly:{series}"
        if self.store is not None:
            self.store.fire(name, reason="series anomaly",
                            value=round(value, 6),
                            threshold=round(median + threshold, 6),
                            kind="anomaly", series=series,
                            median=round(median, 6))
        events.emit("anomaly", series=series, state="firing",
                    value=round(value, 6), median=round(median, 6),
                    threshold=round(threshold, 6))
        events.dump_flight(reason=f"anomaly:{series}")
        self._count(series)
        logger.warning("ANOMALY %s: value=%.6g median=%.6g "
                       "(threshold ±%.6g)", series, value, median,
                       threshold)

    def _resolve(self, series: str) -> None:
        if self.store is not None:
            self.store.resolve(f"anomaly:{series}")
        events.emit("anomaly", series=series, state="resolved")
        logger.info("anomaly resolved: %s", series)


class Forecaster:
    """Holt-Winters exponential smoothing over an irregular tick stream.

    Double smoothing (level + per-second trend) by default; passing
    ``season_s`` adds an additive seasonal term over ``season_buckets``
    phase buckets (triple smoothing — the diurnal shape). Updates are
    dt-normalized so federation-tick jitter doesn't masquerade as
    trend. Pure stdlib, O(1) per observation.

    ``forecast(horizon_s)`` is HARD-BOUNDED to ``[bound_min,
    bound_max]`` — the controller consuming it additionally keeps its
    own cooldowns and ``max_workers`` gates, so a wild forecast can
    propose, never command.
    """

    def __init__(self, alpha: float = 0.5, beta: float = 0.1,
                 gamma: float = 0.3, season_s: float | None = None,
                 season_buckets: int = 24, min_samples: int = 8,
                 bound_min: float = 0.0,
                 bound_max: float | None = None):
        for name, v in (("alpha", alpha), ("beta", beta),
                        ("gamma", gamma)):
            if not 0.0 < v <= 1.0:
                raise ValueError(f"{name} must be in (0, 1], got {v}")
        if season_s is not None and season_s <= 0:
            raise ValueError("season_s must be > 0")
        self.alpha = float(alpha)
        self.beta = float(beta)
        self.gamma = float(gamma)
        self.season_s = float(season_s) if season_s is not None else None
        self.season_buckets = int(season_buckets)
        self.min_samples = int(min_samples)
        self.bound_min = float(bound_min)
        self.bound_max = (float(bound_max) if bound_max is not None
                          else None)
        self.n = 0
        self._level = 0.0
        self._trend = 0.0  # value units per second
        self._last_t: float | None = None
        self._season = ([0.0] * self.season_buckets
                        if self.season_s is not None else None)

    def _bucket(self, t: float) -> int:
        phase = (t % self.season_s) / self.season_s
        return min(self.season_buckets - 1,
                   int(phase * self.season_buckets))

    def observe(self, t: float, value: float) -> None:
        try:
            value = float(value)
        except (TypeError, ValueError):
            return
        if not math.isfinite(value):
            return
        t = float(t)
        if self._last_t is None:
            self._level = value
            self._trend = 0.0
            self._last_t = t
            self.n = 1
            return
        dt = t - self._last_t
        if dt <= 0:
            return  # out-of-order tick: ignore, never rewind
        s = self._season[self._bucket(t)] if self._season is not None \
            else 0.0
        predicted = self._level + self._trend * dt
        level = (self.alpha * (value - s)
                 + (1.0 - self.alpha) * predicted)
        self._trend = (self.beta * ((level - self._level) / dt)
                       + (1.0 - self.beta) * self._trend)
        self._level = level
        if self._season is not None:
            i = self._bucket(t)
            self._season[i] = (self.gamma * (value - level)
                               + (1.0 - self.gamma) * s)
        self._last_t = t
        self.n += 1

    def forecast(self, horizon_s: float) -> float | None:
        """Projected value ``horizon_s`` past the last observation;
        None until ``min_samples`` observations have landed (an unfed
        forecaster must read as 'no opinion', not as zero)."""
        if self.n < self.min_samples or self._last_t is None:
            return None
        value = self._level + self._trend * float(horizon_s)
        if self._season is not None:
            value += self._season[self._bucket(
                self._last_t + float(horizon_s))]
        if value < self.bound_min:
            value = self.bound_min
        if self.bound_max is not None and value > self.bound_max:
            value = self.bound_max
        return value
