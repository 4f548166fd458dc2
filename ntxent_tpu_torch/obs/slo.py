"""SLO engine: declarative objectives, burn-rate windows, typed alerts.
Counterpart of ``ntxent_tpu/obs/slo.py``, a stdlib copy (the port
imports nothing of the JAX package).

Metrics say what IS; nothing in the stack said what is ACCEPTABLE. This
module closes the loop: objectives are declared once
(availability, tail latency, embedding drift), evaluated every
federation tick against the merged fleet registry (obs/aggregate.py),
and a breach becomes a typed ``alert`` event on the JSONL stream, a
flight-recorder dump (the postmortem is captured AT the breach, not
reconstructed after), and an entry on the router's ``/alerts``
endpoint.

Objective kinds:

* ``availability`` — ratio of a bad-outcome counter to a total
  counter, judged as a BURN RATE over two windows (the
  multi-window rule SRE practice converged on): with an error budget
  of ``1 - target``, the alert fires only when the windowed error rate
  exceeds ``burn_factor x budget`` in BOTH the fast window (catches
  the onset quickly) and the slow window (confirms it is sustained,
  not a blip). Counter series are cumulative, so windowed rates come
  from a ring of (t, value) snapshots the engine keeps per objective.
* ``quantile`` — a histogram's exact-window percentile against a
  bound (serving p99 latency, shadow drift p99). Fires after
  ``breach_ticks`` consecutive breaching evaluations (one slow scrape
  must not page), resolves after ``clear_ticks`` clean ones.

Alert lifecycle: ``firing`` -> (condition clears) -> ``resolved``;
both transitions emit an ``alert`` event; only the firing transition
trips the flight recorder. The ``AlertStore`` is the bounded
process-local ledger ``/alerts`` serves — active alerts plus a recent
history ring.

Stdlib only (the obs-package rule): the engine runs in the router
process, which never imports torch.
"""

from __future__ import annotations

import logging
import threading
import time
from collections import deque
from dataclasses import dataclass, field

from . import events
from .registry import MetricsRegistry, quantile

logger = logging.getLogger(__name__)

__all__ = ["Objective", "AlertStore", "SLOEngine"]


@dataclass
class Objective:
    """One declarative service-level objective."""

    name: str
    kind: str                      # "availability" | "quantile"
    target: float                  # availability: good fraction (e.g.
    #                                0.99); quantile: the bound itself
    # availability inputs: cumulative counter names in the federated
    # registry. All label-sets of the name are summed; ``bad_exclude``
    # drops label-sets whose label value matches (e.g. saturation
    # rejections are not availability failures — the client was told
    # to retry, not failed).
    total_metric: str | None = None
    bad_metric: str | None = None
    bad_exclude: dict = field(default_factory=dict)
    fast_window_s: float = 60.0
    slow_window_s: float = 300.0
    burn_factor: float = 2.0
    # quantile inputs: histogram name (+ optional label filter) and q.
    metric: str | None = None
    labels: dict = field(default_factory=dict)
    q: float = 0.99
    breach_ticks: int = 2
    clear_ticks: int = 2
    min_samples: int = 1

    def __post_init__(self):
        if self.kind not in ("availability", "quantile"):
            raise ValueError(f"unknown objective kind {self.kind!r}")
        if self.kind == "availability":
            if not (self.total_metric and self.bad_metric):
                raise ValueError(f"availability objective {self.name!r} "
                                 "needs total_metric and bad_metric")
            if not 0.0 < self.target < 1.0:
                raise ValueError(f"availability target must be in "
                                 f"(0, 1), got {self.target}")
        elif self.metric is None:
            raise ValueError(f"quantile objective {self.name!r} needs "
                             "a metric name")


class AlertStore:
    """Bounded alert ledger: active alerts + a recent-history ring.

    Thread-safe; written by the SLO engine (aggregator thread) and the
    router's canary-verdict path (request threads), read by
    ``/alerts``.
    """

    def __init__(self, history: int = 128,
                 registry: MetricsRegistry | None = None):
        self._lock = threading.Lock()
        self._active: dict[str, dict] = {}
        self._history: deque[dict] = deque(maxlen=history)
        self._registry = registry
        self._counters: dict[str, object] = {}

    def _count(self, name: str) -> None:
        if self._registry is None:
            return
        counter = self._counters.get(name)
        if counter is None:
            counter = self._counters[name] = self._registry.counter(
                "slo_alerts_total", "alerts fired, by objective",
                labels={"slo": name})
        counter.inc()

    def fire(self, name: str, reason: str, value: float | None = None,
             threshold: float | None = None, **extra) -> dict:
        """Raise (or refresh) an active alert; returns the record."""
        record = {"name": name, "state": "firing", "reason": reason,
                  "value": value, "threshold": threshold,
                  "since": round(time.time(), 3), **extra}
        with self._lock:
            previous = self._active.get(name)
            if previous is not None:
                # Refresh keeps the original onset time: an alert that
                # keeps breaching is ONE incident, not many.
                record["since"] = previous["since"]
                record["refreshed"] = round(time.time(), 3)
            self._active[name] = record
            if previous is None:
                self._history.append(dict(record))
                self._count(name)
        return record

    def resolve(self, name: str, reason: str = "recovered",
                **extra) -> dict | None:
        with self._lock:
            active = self._active.pop(name, None)
            if active is None:
                return None
            record = {**active, "state": "resolved", "reason": reason,
                      "resolved_at": round(time.time(), 3), **extra}
            self._history.append(record)
        return record

    def active(self) -> list[dict]:
        with self._lock:
            return [dict(r) for r in self._active.values()]

    def snapshot(self) -> dict:
        with self._lock:
            return {"firing": sorted(self._active),
                    "active": [dict(r) for r in self._active.values()],
                    "history": [dict(r) for r in self._history]}


# -- federated-registry readers ------------------------------------------


def _iter_metrics(registry: MetricsRegistry):
    for entry in registry.dump_state()["metrics"]:
        yield entry


def counter_total(registry: MetricsRegistry, name: str,
                  exclude: dict | None = None) -> float:
    """Sum every label-set of a counter in ``registry``; label-sets
    matching ``exclude`` (key -> value) are dropped."""
    total = 0.0
    exclude = exclude or {}
    for entry in _iter_metrics(registry):
        if entry["name"] != name or entry["kind"] != "counter":
            continue
        labels = entry.get("labels") or {}
        if any(labels.get(k) == v for k, v in exclude.items()):
            continue
        total += float(entry.get("value", 0.0))
    return total


def histogram_quantile(registry: MetricsRegistry, name: str, q: float,
                       labels: dict | None = None,
                       ) -> tuple[float | None, int]:
    """(q-quantile, pooled sample count) of a histogram across every
    label-set matching ``labels`` (subset match), via the one
    exact-window rule. (None, 0) when no samples exist."""
    pooled: list[float] = []
    want = labels or {}
    for entry in _iter_metrics(registry):
        if entry["name"] != name or entry["kind"] != "summary":
            continue
        have = entry.get("labels") or {}
        if any(have.get(k) != v for k, v in want.items()):
            continue
        pooled.extend(float(v) for v in entry.get("window") or [])
    if not pooled:
        return None, 0
    pooled.sort()
    return quantile(pooled, q), len(pooled)


class SLOEngine:
    """Evaluate objectives against successive merged registries.

    Wire ``engine.evaluate`` onto ``FleetAggregator.on_merge``; every
    federation tick then judges every objective. Breach side effects:
    a typed ``alert`` event (events hub), an ``AlertStore.fire``, and
    ONE flight-recorder dump per incident (the dump captures the event
    tail AT the breach; re-dumping per tick would bury it).
    """

    def __init__(self, objectives: list[Objective],
                 store: AlertStore | None = None,
                 registry: MetricsRegistry | None = None,
                 clock=time.monotonic):
        self.objectives = list(objectives)
        names = [o.name for o in self.objectives]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate objective names: {names}")
        self.store = store if store is not None \
            else AlertStore(registry=registry)
        self.clock = clock
        self.evaluations = 0
        # Per-objective evaluation state.
        self._rings: dict[str, deque] = {
            o.name: deque() for o in self.objectives}
        self._breach_streak: dict[str, int] = {}
        self._clear_streak: dict[str, int] = {}

    # -- evaluation --------------------------------------------------------
    def evaluate(self, registry: MetricsRegistry) -> list[dict]:
        """Judge every objective against one merged registry; returns
        the alert records that fired or resolved this tick."""
        self.evaluations += 1
        now = self.clock()
        transitions: list[dict] = []
        for obj in self.objectives:
            if obj.kind == "availability":
                breach, value, detail = self._eval_availability(
                    obj, registry, now)
            else:
                breach, value, detail = self._eval_quantile(
                    obj, registry)
            transitions.extend(
                self._transition(obj, breach, value, detail))
        return transitions

    def _eval_availability(self, obj: Objective,
                           registry: MetricsRegistry,
                           now: float):
        total = counter_total(registry, obj.total_metric)
        bad = counter_total(registry, obj.bad_metric,
                            exclude=obj.bad_exclude)
        ring = self._rings[obj.name]
        ring.append((now, total, bad))
        while ring and now - ring[0][0] > obj.slow_window_s:
            ring.popleft()
        budget = 1.0 - obj.target

        def burn(window_s: float) -> float | None:
            """Windowed error rate / budget; None without enough
            history or traffic (no traffic is not an outage)."""
            cutoff = now - window_s
            base = None
            for t, tot, b in ring:
                if t <= cutoff:
                    base = (t, tot, b)
                else:
                    break
            if base is None:
                base = ring[0]
                if now - base[0] < window_s * 0.5:
                    return None  # too little history to judge
            d_total = total - base[1]
            d_bad = bad - base[2]
            if d_total <= 0:
                return None
            return (d_bad / d_total) / budget

        fast = burn(obj.fast_window_s)
        slow = burn(obj.slow_window_s)
        breach = (fast is not None and slow is not None
                  and fast >= obj.burn_factor
                  and slow >= obj.burn_factor)
        detail = {"fast_burn": round(fast, 4) if fast is not None
                  else None,
                  "slow_burn": round(slow, 4) if slow is not None
                  else None,
                  "budget": round(budget, 6)}
        value = fast if fast is not None else 0.0
        return breach, value, detail

    def _eval_quantile(self, obj: Objective,
                       registry: MetricsRegistry):
        value, n = histogram_quantile(registry, obj.metric, obj.q,
                                      labels=obj.labels)
        detail = {"q": obj.q, "samples": n}
        if value is None or n < obj.min_samples:
            return False, value, detail
        return value > obj.target, value, detail

    def _transition(self, obj: Objective, breach: bool,
                    value, detail: dict) -> list[dict]:
        out: list[dict] = []
        name = obj.name
        if breach:
            self._clear_streak[name] = 0
            streak = self._breach_streak.get(name, 0) + 1
            self._breach_streak[name] = streak
            already = any(a["name"] == name
                          for a in self.store.active())
            if streak >= obj.breach_ticks and not already:
                record = self.store.fire(
                    name, reason=f"{obj.kind} objective breached",
                    value=round(float(value), 6)
                    if value is not None else None,
                    threshold=obj.target, kind=obj.kind, **detail)
                events.emit("alert", slo=name, state="firing",
                            kind=obj.kind, value=record["value"],
                            threshold=obj.target, **detail)
                events.dump_flight(reason=f"slo_breach:{name}")
                logger.warning("SLO BREACH %s: value=%s threshold=%s "
                               "%s", name, record["value"], obj.target,
                               detail)
                out.append(record)
        else:
            self._breach_streak[name] = 0
            streak = self._clear_streak.get(name, 0) + 1
            self._clear_streak[name] = streak
            if streak >= obj.clear_ticks:
                record = self.store.resolve(name)
                if record is not None:
                    events.emit("alert", slo=name, state="resolved",
                                kind=obj.kind)
                    logger.info("SLO recovered: %s", name)
                    out.append(record)
        return out
