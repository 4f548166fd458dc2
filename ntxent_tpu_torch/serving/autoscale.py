"""SLO-driven fleet sizing: the closed loop over supervision + signals.
Counterpart of ``ntxent_tpu/serving/autoscale.py`` (stdlib).

Every part of an autoscaler exists loose in the fleet — the
fleet spawns/supervises workers through port files and /readyz probes
(``fleet.ServingFleet``), the router federates per-worker telemetry
into one registry every tick (``obs.FleetAggregator``), and the SLO
engine reads burn rates and latency quantiles out of that merged view
(``obs/slo.py``). ``AutoscaleController`` closes the loop: it rides the aggregator's ``on_merge`` hook, extracts
the scaling signals from the SAME merged registry the SLO engine
judges, and drives pool size between ``min_workers`` and
``max_workers`` through policies with hysteresis (consecutive-tick
streaks) and per-direction cooldowns.

Scale-up is the existing supervision path: ``fleet.add_worker()``
spawns a fresh ordinal that publishes its port, warms its ladder, and
only enters routing once /readyz passes — the controller never routes,
it only asks for capacity.

Scale-down is **zero-5xx by construction**: the victim is marked
``draining`` in the ``WorkerPool`` (selection skips it instantly; its
in-flight requests keep completing), and only when its in-flight count
hits zero — or the drain deadline passes — does the controller retire
it through ``fleet.retire_worker`` (membership out first, THEN
SIGTERM, so the monitor never mistakes the exit for a crash). A client
can therefore never observe a connection reset from a scale-down: no
new request is ever routed to a worker that might disappear.

The decision core (``step_signals``) is a pure-ish state machine over
a signal snapshot — tests drive it with synthetic streams and pin the
hysteresis/cooldown boundaries without any fleet, HTTP, or clock.

Everything here is stdlib + obs — the router process imports it, so it
must stay torch-free (``tests/test_torch_fleet_e2e.py`` holds it so).
"""

from __future__ import annotations

import json
import logging
import threading
import time
import urllib.error
import urllib.request
from collections import deque

from ..obs import events as obs_events
from ..obs.history import Forecaster, gauge_reduce
from ..obs.registry import MetricsRegistry
from ..obs.slo import counter_total, histogram_quantile

logger = logging.getLogger(__name__)

__all__ = ["AutoscaleController", "flash_crowd", "parse_tenant_quotas"]


def gauge_total(registry: MetricsRegistry, name: str) -> float:
    """Sum every label-set of a gauge in a merged registry (the
    federated ``serving_queue_depth{instance=...}`` view: one value
    per worker, their sum is the fleet's queued backlog)."""
    total = 0.0
    for entry in registry.dump_state()["metrics"]:
        if entry["name"] == name and entry["kind"] == "gauge":
            total += float(entry.get("value", 0.0))
    return total


def parse_tenant_quotas(spec: str) -> dict[str, tuple[float,
                                                      float | None]]:
    """Parse the CLI's ``--tenant-quota`` grammar:
    ``name=rate[:burst],name=rate...`` (rate in rows/s; burst defaults
    to one second of rate). The tenant named ``default`` pins the
    quota bare requests get."""
    quotas: dict[str, tuple[float, float | None]] = {}
    for part in (spec or "").split(","):
        part = part.strip()
        if not part:
            continue
        name, sep, value = part.partition("=")
        name = name.strip()
        if not sep or not name:
            raise ValueError(f"bad tenant quota {part!r} "
                             "(want name=rate[:burst])")
        rate_s, _, burst_s = value.partition(":")
        try:
            rate = float(rate_s)
            burst = float(burst_s) if burst_s else None
        except ValueError:
            raise ValueError(f"bad tenant quota {part!r}: rate/burst "
                             "must be numbers") from None
        if rate <= 0 or (burst is not None and burst <= 0):
            raise ValueError(f"bad tenant quota {part!r}: rate/burst "
                             "must be > 0")
        quotas[name] = (rate, burst)
    return quotas


class AutoscaleController:
    """Closed-loop pool sizing over ``ServingFleet`` + ``WorkerPool``.

    Wire ``controller.observe`` onto ``FleetAggregator.on_merge``;
    every federation tick then (1) extracts the signal snapshot from
    the merged registry, (2) runs the scale policy, (3) acts through
    the fleet's supervision surface, and (4) advances any in-progress
    drains. All four run on the aggregator thread — the controller
    needs no thread of its own.

    Scale-up pressure (ANY source counts, per tick):
    ``queue_depth / routable >= up_queue_depth`` · ``inflight /
    routable >= up_inflight`` · ``p99 >= up_p99_ms`` (when configured)
    · availability burn rate ``>= up_burn`` (shed/error fraction over
    ``burn_window_s`` against the ``slo_target`` budget; tenant-quota
    429s are EXCLUDED — a tenant over its own quota must not buy the
    fleet more capacity). ``up_ticks`` consecutive pressure ticks +
    an expired up-cooldown adds ONE worker. A pool under
    ``min_workers`` (a forced drain, a worker that ran out of restart
    budget) repairs immediately, streaks and cooldowns notwithstanding.

    Scale-down: ``idle_ticks`` consecutive ticks of zero queue, no
    burn, and enough headroom that one fewer worker stays under half
    the up-pressure in-flight bound + an expired down-cooldown marks
    ONE victim draining (highest ordinal first — the elastic workers
    retire in LIFO order, the seed workers stay put).

    Predictive scale-up: with ``predict_horizon_s`` set,
    the controller feeds Holt-Winters forecasters (obs/history.py)
    the request-rate and fleet queue-depth series every tick and adds
    one more pressure source — ``forecast`` — that trips when the
    PROJECTED value at ``now + predict_horizon_s`` would breach the
    queue bound (or, with ``predict_capacity`` req/s-per-worker set,
    the fleet's rated throughput). The forecast only ever proposes:
    it rides the same streak, cooldown, and ``max_workers`` gates as
    every reactive source, and scale-DOWN stays purely reactive — a
    forecast can buy lead time, never shed capacity. ``up_rss_bytes``
    (off by default) adds the worker vertical memory signal the same
    way: federated max RSS at/over the bound is pressure.
    """

    def __init__(self, fleet, pool,
                 registry: MetricsRegistry | None = None,
                 min_workers: int = 1,
                 max_workers: int = 4,
                 up_queue_depth: float = 8.0,
                 up_inflight: float = 4.0,
                 up_p99_ms: float | None = None,
                 up_burn: float | None = 1.0,
                 up_ticks: int = 2,
                 idle_ticks: int = 6,
                 up_cooldown_s: float = 15.0,
                 down_cooldown_s: float = 30.0,
                 drain_deadline_s: float = 30.0,
                 burn_window_s: float = 30.0,
                 slo_target: float = 0.999,
                 predict_horizon_s: float | None = None,
                 predict_capacity: float | None = None,
                 predict_season_s: float | None = None,
                 up_rss_bytes: float | None = None,
                 history=None,
                 clock=time.monotonic):
        if min_workers < 1:
            raise ValueError(f"min_workers must be >= 1, got "
                             f"{min_workers}")
        if max_workers < min_workers:
            raise ValueError(f"max_workers {max_workers} < min_workers "
                             f"{min_workers}")
        self.fleet = fleet
        self.pool = pool
        self.registry = registry if registry is not None \
            else (pool.registry if pool is not None
                  else MetricsRegistry())
        self.min_workers = int(min_workers)
        self.max_workers = int(max_workers)
        self.up_queue_depth = float(up_queue_depth)
        self.up_inflight = float(up_inflight)
        self.up_p99_ms = (float(up_p99_ms) if up_p99_ms is not None
                          else None)
        self.up_burn = float(up_burn) if up_burn is not None else None
        self.up_ticks = int(up_ticks)
        self.idle_ticks = int(idle_ticks)
        self.up_cooldown_s = float(up_cooldown_s)
        self.down_cooldown_s = float(down_cooldown_s)
        self.drain_deadline_s = float(drain_deadline_s)
        self.burn_window_s = float(burn_window_s)
        self.budget = 1.0 - float(slo_target)
        if predict_horizon_s is not None and predict_horizon_s <= 0:
            raise ValueError(f"predict_horizon_s must be > 0, got "
                             f"{predict_horizon_s}")
        if predict_capacity is not None and predict_capacity <= 0:
            raise ValueError(f"predict_capacity must be > 0, got "
                             f"{predict_capacity}")
        if up_rss_bytes is not None and up_rss_bytes <= 0:
            raise ValueError(f"up_rss_bytes must be > 0, got "
                             f"{up_rss_bytes}")
        self.predict_horizon_s = (float(predict_horizon_s)
                                  if predict_horizon_s is not None
                                  else None)
        self.predict_capacity = (float(predict_capacity)
                                 if predict_capacity is not None
                                 else None)
        self.up_rss_bytes = (float(up_rss_bytes)
                             if up_rss_bytes is not None else None)
        # The metrics-history store (obs/history.py), when attached:
        # forecasts are recorded back into it as *_forecast series so
        # /metrics/history can show prediction against reality.
        self.history = history
        # Forecast hard bounds: a wild model may propose at most 10x
        # the capacity the fleet could ever field — beyond that the
        # clamp holds, and the action gates (streaks, cooldowns,
        # max_workers) still apply to whatever survives.
        if self.predict_horizon_s is not None:
            self._rate_forecaster = Forecaster(
                season_s=predict_season_s,
                bound_max=(self.predict_capacity * max_workers * 10.0
                           if self.predict_capacity is not None
                           else None))
            self._queue_forecaster = Forecaster(
                season_s=predict_season_s,
                bound_max=float(up_queue_depth) * max_workers * 10.0)
        else:
            self._rate_forecaster = None
            self._queue_forecaster = None
        # no_routable is a REPAIR signal (all workers wedged), so it
        # only arms once the fleet has ever fielded a routable worker —
        # a cold boot's not-ready-yet seed must not scale the pool to
        # max before the first worker even finishes warming.
        self._seen_routable = False
        self.clock = clock
        self._lock = threading.Lock()
        # (now, total, bad) samples for the windowed burn rate — the
        # same ring idiom SLOEngine uses for its availability burn.
        self._burn_ring: deque = deque()
        self._up_streak = 0
        self._idle_streak = 0
        self._last_up_at: float | None = None
        self._last_down_at: float | None = None
        # worker_id -> {"since": t, "deadline": t, "reason": str}
        self._draining: dict[str, dict] = {}
        self.ticks = 0
        # Last signal snapshot: the retrieval tier's ``heavy_gate`` reads
        # fleet idleness from here instead of guessing from a fixed
        # worker count.
        self.last_signals: dict | None = None
        r = self.registry
        self._pool_size = r.gauge(
            "fleet_pool_size",
            "workers the autoscaler currently counts as capacity "
            "(ready or booting; draining excluded)")
        self._drain_ms = r.histogram(
            "fleet_drain_ms",
            "scale-down drain duration: draining mark to retirement")
        self._scale_counters: dict[tuple[str, str], object] = {}

    # -- metrics -----------------------------------------------------------
    def _count_scale(self, direction: str, reason: str) -> None:
        key = (direction, reason)
        counter = self._scale_counters.get(key)
        if counter is None:
            counter = self._scale_counters[key] = self.registry.counter(
                f"fleet_scale_{direction}_total",
                f"autoscaler {direction}-scales by triggering signal",
                labels={"reason": reason})
        counter.inc()

    # -- signal extraction -------------------------------------------------
    def signals(self, merged: MetricsRegistry) -> dict:
        """One signal snapshot from a freshly merged fleet registry +
        the pool's live routing state."""
        now = self.clock()
        total = counter_total(merged, "fleet_requests_total")
        bad = counter_total(merged, "fleet_rejected_total",
                            exclude={"reason": "tenant_quota"})
        ring = self._burn_ring
        # Instantaneous request rate from the previous tick's sample —
        # read BEFORE this tick joins the ring. The forecasters smooth
        # over it, so tick-to-tick jitter is fine.
        rate = None
        if ring:
            prev_t, prev_total, _ = ring[-1]
            if now > prev_t:
                rate = max(0.0, (total - prev_total) / (now - prev_t))
        ring.append((now, total, bad))
        while ring and now - ring[0][0] > self.burn_window_s:
            ring.popleft()
        burn = None
        if len(ring) >= 2:
            t0, total0, bad0 = ring[0]
            d_total = total - total0
            d_bad = bad - bad0
            if d_total > 0 and now - t0 >= self.burn_window_s * 0.25:
                burn = (d_bad / d_total) / self.budget
        p99, samples = histogram_quantile(merged, "fleet_latency_ms",
                                          0.99, labels={"stage": "total"})
        workers = self.pool.workers()
        draining_ids = set(self._draining)
        routable = [w for w in workers
                    if w.ready and w.worker_id not in draining_ids]
        queue_depth = gauge_total(merged, "serving_queue_depth")
        rss = (gauge_reduce(merged, "serving_worker_rss_bytes", "max")
               if self.up_rss_bytes is not None else None)
        forecast_rate = forecast_queue = None
        if self.predict_horizon_s is not None:
            if rate is not None:
                self._rate_forecaster.observe(now, rate)
            self._queue_forecaster.observe(now, queue_depth)
            forecast_rate = self._rate_forecaster.forecast(
                self.predict_horizon_s)
            forecast_queue = self._queue_forecaster.forecast(
                self.predict_horizon_s)
            if self.history is not None:
                if forecast_rate is not None:
                    self.history.record("fleet_request_rate_forecast",
                                        forecast_rate)
                if forecast_queue is not None:
                    self.history.record("serving_queue_depth_forecast",
                                        forecast_queue)
        return {
            "queue_depth": queue_depth,
            "inflight": float(sum(w.inflight for w in routable)),
            "routable": len(routable),
            "size": self.pool_size(),
            "p99_ms": p99 if samples else None,
            "burn": burn,
            "rate": rate,
            "rss_bytes": rss,
            "forecast_rate": forecast_rate,
            "forecast_queue_depth": forecast_queue,
        }

    def pool_size(self) -> int:
        """Capacity the controller reasons about: fleet membership
        (ready or booting) minus in-progress drains."""
        members = {w.worker_id for w in self.fleet.workers_snapshot()}
        return len(members - set(self._draining))

    # -- the decision core (pure over a signal snapshot) -------------------
    def step_signals(self, signals: dict,
                     now: float | None = None) -> tuple[str, str]:
        """Advance the policy state machine one tick. Returns
        ``(action, reason)`` with action in ``{"up", "down", "hold"}``
        — the caller acts; this only decides (tests pin the
        hysteresis/cooldown boundaries on synthetic streams)."""
        now = self.clock() if now is None else now
        size = int(signals["size"])
        routable = int(signals["routable"])
        if size < self.min_workers:
            # Below the floor (forced drain, restart budget exhausted):
            # repair NOW — hysteresis exists to damp oscillation, not
            # to slow-walk a capacity hole.
            self._up_streak = 0
            self._idle_streak = 0
            self._last_up_at = now
            return "up", "below_min"
        per_worker = max(1, routable)
        if routable > 0:
            self._seen_routable = True
        pressure: str | None = None
        if (routable == 0 and self._seen_routable
                and size < self.max_workers):
            pressure = "no_routable"
        elif signals["queue_depth"] / per_worker >= self.up_queue_depth:
            pressure = "queue_depth"
        elif signals["inflight"] / per_worker >= self.up_inflight:
            pressure = "inflight"
        elif (self.up_p99_ms is not None
              and signals.get("p99_ms") is not None
              and signals["p99_ms"] >= self.up_p99_ms):
            pressure = "p99"
        elif (self.up_burn is not None
              and signals.get("burn") is not None
              and signals["burn"] >= self.up_burn):
            pressure = "burn"
        elif (self.up_rss_bytes is not None
              and signals.get("rss_bytes") is not None
              and signals["rss_bytes"] >= self.up_rss_bytes):
            pressure = "rss"
        elif (self.predict_horizon_s is not None
              and signals.get("forecast_queue_depth") is not None
              and signals["forecast_queue_depth"] / per_worker
              >= self.up_queue_depth):
            pressure = "forecast"
        elif (self.predict_horizon_s is not None
              and self.predict_capacity is not None
              and signals.get("forecast_rate") is not None
              and signals["forecast_rate"]
              >= self.predict_capacity * per_worker):
            pressure = "forecast"
        if pressure is not None:
            self._idle_streak = 0
            self._up_streak += 1
            if size >= self.max_workers:
                return "hold", f"{pressure}:at_max"
            if self._up_streak < self.up_ticks:
                return "hold", f"{pressure}:streak"
            if self._last_up_at is not None \
                    and now - self._last_up_at < self.up_cooldown_s:
                return "hold", f"{pressure}:cooldown"
            self._up_streak = 0
            self._last_up_at = now
            return "up", pressure
        self._up_streak = 0
        idle = (signals["queue_depth"] <= 0.0
                and (signals.get("burn") is None
                     or signals["burn"] < 1.0)
                and routable > 1
                and signals["inflight"] / (routable - 1)
                <= self.up_inflight * 0.5)
        if not idle or size <= self.min_workers:
            self._idle_streak = 0
            return "hold", "steady"
        self._idle_streak += 1
        if self._idle_streak < self.idle_ticks:
            return "hold", "idle:streak"
        if self._last_down_at is not None \
                and now - self._last_down_at < self.down_cooldown_s:
            return "hold", "idle:cooldown"
        if self._last_up_at is not None \
                and now - self._last_up_at < self.down_cooldown_s:
            # A freshly added worker must get a full window to absorb
            # load before the controller reads the resulting calm as
            # over-provisioning.
            return "hold", "idle:recent_up"
        self._idle_streak = 0
        self._last_down_at = now
        return "down", "idle"

    # -- acting ------------------------------------------------------------
    def observe(self, merged: MetricsRegistry) -> dict:
        """The ``FleetAggregator.on_merge`` hook: one full control
        tick. Returns the signal snapshot (handy for tests/debugging);
        never raises — a controller bug must not poison federation."""
        with self._lock:
            try:
                self.ticks += 1
                now = self.clock()
                signals = self.signals(merged)
                self.last_signals = signals
                action, reason = self.step_signals(signals, now)
                if action == "up":
                    self._scale_up(reason, signals)
                elif action == "down":
                    self._start_drain(reason, signals, now)
                self._advance_drains(now)
                self._pool_size.set(self.pool_size())
                return signals
            except Exception:  # noqa: BLE001 — the federation tick
                # must survive any controller bug.
                logger.exception("autoscale: control tick failed")
                return {}

    def maintenance_ok(self) -> bool:
        """Is the fleet idle enough for heavy background work? The
        retrieval tier's ``heavy_gate`` (segment compaction, docstore
        log compaction — big sequential IO + CPU) calls this per
        maintenance tick. Idle here is the scale-down predicate MINUS
        the ``routable > 1`` term: a quiet one-worker fleet can't
        shed capacity but can absolutely afford a compaction. Before
        federation produces a first snapshot there is no evidence of
        load, so maintenance proceeds (True) — deferring on ignorance
        would starve single-process rigs forever."""
        s = self.last_signals
        if not s:
            return True
        per_worker = max(1, int(s.get("routable", 0)))
        return (float(s.get("queue_depth", 0.0)) <= 0.0
                and (s.get("burn") is None
                     or float(s["burn"]) < 1.0)
                and float(s.get("inflight", 0.0)) / per_worker
                <= self.up_inflight * 0.5)

    def _scale_up(self, reason: str, signals: dict) -> None:
        worker = self.fleet.add_worker()
        if worker is None:
            return
        self._count_scale("up", reason)
        if reason == "forecast":
            # The predictive trigger gets its own typed event: the
            # smoke harness and post-mortems tell lead-time capacity
            # apart from reactive repairs by this record alone.
            obs_events.emit("forecast",
                            horizon_s=self.predict_horizon_s,
                            forecast_rate=signals.get("forecast_rate"),
                            forecast_queue_depth=signals.get(
                                "forecast_queue_depth"),
                            rate=signals.get("rate"),
                            queue_depth=signals.get("queue_depth"))
        obs_events.emit("autoscale", action="scale_up", reason=reason,
                        worker=worker.worker_id,
                        size=self.pool_size(), **_sig_fields(signals))
        logger.info("autoscale: +1 worker %s (%s)", worker.worker_id,
                    reason)

    def _pick_victim(self) -> str | None:
        draining_ids = set(self._draining)
        candidates = [w for w in self.pool.workers()
                      if w.ready and w.worker_id not in draining_ids]
        if not candidates:
            return None
        # Highest ordinal = the most recently added elastic worker;
        # ties in readiness broken toward the LEAST loaded (cheapest
        # drain). worker_id sorts "w10" after "w9" via the numeric tail.
        def key(w):
            try:
                ordinal = int(w.worker_id.lstrip("w"))
            except ValueError:
                ordinal = -1
            return (ordinal, -w.inflight)
        return max(candidates, key=key).worker_id

    def _start_drain(self, reason: str, signals: dict,
                     now: float) -> bool:
        victim = self._pick_victim()
        if victim is None:
            return False
        if not self.pool.set_draining(victim, True):
            return False
        self._draining[victim] = {
            "since": now,
            "deadline": now + self.drain_deadline_s,
            "reason": reason,
        }
        self._count_scale("down", reason)
        obs_events.emit("autoscale", action="drain_start", reason=reason,
                        worker=victim, size=self.pool_size(),
                        **_sig_fields(signals))
        logger.info("autoscale: draining %s (%s)", victim, reason)
        return True

    def _advance_drains(self, now: float) -> None:
        for worker_id in list(self._draining):
            state = self._draining[worker_id]
            inflight = self.pool.inflight_of(worker_id)
            if inflight == 0:
                self._finish_drain(worker_id, state, now, timed_out=False)
            elif now >= state["deadline"]:
                # Deadline kill path: the victim is wedged or a client
                # holds a request forever. Retiring now can surface at
                # most the requests still on it — bounded, logged, and
                # the deadline is the operator's explicit choice.
                logger.warning("autoscale: drain of %s timed out with "
                               "%d in flight — retiring anyway",
                               worker_id, inflight)
                self._finish_drain(worker_id, state, now, timed_out=True)

    def _finish_drain(self, worker_id: str, state: dict, now: float,
                      timed_out: bool) -> None:
        drain_ms = (now - state["since"]) * 1e3
        self._drain_ms.observe(drain_ms)
        self.fleet.retire_worker(worker_id)
        self._draining.pop(worker_id, None)
        obs_events.emit("autoscale",
                        action="drain_deadline" if timed_out
                        else "drain_done",
                        worker=worker_id, reason=state["reason"],
                        drain_ms=round(drain_ms, 3),
                        size=self.pool_size())
        logger.info("autoscale: retired %s after %.0fms drain%s",
                    worker_id, drain_ms,
                    " (deadline)" if timed_out else "")

    def force_drain(self, reason: str = "forced") -> str | None:
        """Start a drain-down NOW, outside the idle policy (the
        ``drainworker@T`` chaos action, operator intervention). Skips
        hysteresis and cooldowns but never drains the last routable
        worker; the next control tick repairs the pool if it fell
        under ``min_workers``. Returns the victim id (None = no
        eligible victim)."""
        with self._lock:
            now = self.clock()
            draining_ids = set(self._draining)
            routable = [w for w in self.pool.workers()
                        if w.ready and w.worker_id not in draining_ids]
            if len(routable) < 2:
                logger.warning("autoscale: force_drain(%s) skipped — "
                               "%d routable worker(s)", reason,
                               len(routable))
                return None
            victim = self._pick_victim()
            if victim is None or not self._start_drain(
                    reason, {"queue_depth": None, "inflight": None,
                             "routable": len(routable),
                             "size": self.pool_size()}, now):
                return None
            return victim

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "ticks": self.ticks,
                "size": self.pool_size(),
                "min_workers": self.min_workers,
                "max_workers": self.max_workers,
                "up_streak": self._up_streak,
                "idle_streak": self._idle_streak,
                "draining": {w: {"reason": s["reason"]}
                             for w, s in self._draining.items()},
            }


def _sig_fields(signals: dict) -> dict:
    """The signal snapshot as flat event fields (rounded; None kept —
    an autoscale event must record what the controller actually saw,
    including 'no data')."""
    out = {}
    for key in ("queue_depth", "inflight", "routable", "p99_ms", "burn",
                "rate", "forecast_rate", "forecast_queue_depth",
                "rss_bytes"):
        v = signals.get(key)
        out[f"sig_{key}"] = round(v, 4) if isinstance(v, float) else v
    return out


def flash_crowd(url: str, body: bytes, duration_s: float = 2.0,
                concurrency: int = 8, tenant: str | None = None,
                timeout_s: float = 10.0) -> dict:
    """Blast one request body at a router for ``duration_s`` from
    ``concurrency`` closed-loop threads — the ``spike@T`` chaos
    action's payload (a deliberately rude burst; the OPEN-loop replay
    discipline lives in scripts/loadgen.py). Returns status counts.
    Blocking — chaos callers run it on a thread."""
    counts: dict[str, int] = {}
    lock = threading.Lock()
    deadline = time.monotonic() + float(duration_s)
    headers = {"Content-Type": "application/json"}
    if tenant:
        headers["X-Tenant"] = tenant

    def _one() -> str:
        req = urllib.request.Request(url.rstrip("/") + "/embed",
                                     data=body, method="POST",
                                     headers=headers)
        try:
            with urllib.request.urlopen(req, timeout=timeout_s) as resp:
                return str(resp.status)
        except urllib.error.HTTPError as e:
            return str(e.code)
        except (urllib.error.URLError, OSError):
            return "unreachable"

    def _worker() -> None:
        while time.monotonic() < deadline:
            outcome = _one()
            with lock:
                counts[outcome] = counts.get(outcome, 0) + 1

    threads = [threading.Thread(target=_worker, daemon=True,
                                name=f"ntxent-spike-{i}")
               for i in range(int(concurrency))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=duration_s + timeout_s + 5.0)
    logger.info("flash crowd done: %s", json.dumps(counts, sort_keys=True))
    return counts
