"""Process-wide metrics registry: counters, gauges, exact-window
histograms. Counterpart of ``ntxent_tpu/obs/registry.py``, a stdlib copy
(the port imports nothing of the JAX package).

* **Get-or-create identity.** ``registry.counter("x", labels={...})``
  returns the same object for the same (name, labels) pair, so
  instrumentation sites never need to coordinate creation order.
* **Per-metric locks.** Each metric guards its own few fields; the
  registry lock covers only the name->metric dict, so a scrape never
  holds one global lock while it rebuilds the whole export.
* **Exact-window histograms.** Cumulative count/sum never reset (rates
  stay computable from deltas) while percentiles are exact over a
  bounded sliding window. ``quantile`` is the one p50/p95/p99 rule.
* **Prometheus text + JSON.** ``render_prometheus`` emits the exposition
  format (histograms as summaries with exact quantiles); ``collect``
  returns the same values as a JSON-able dict and ``dump_state`` the raw
  state (histogram windows included) a federator pools: three views of
  one store, never parallel bookkeeping.
"""

from __future__ import annotations

import math
import re
import threading
from collections import deque

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry",
           "default_registry", "quantile", "prometheus_name"]

_NAME_OK = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_LABEL_OK = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_]*$")
_NAME_FIX = re.compile(r"[^a-zA-Z0-9_:]")

DEFAULT_QUANTILES = (0.5, 0.95, 0.99)


def prometheus_name(name: str) -> str:
    """A legal exposition-format metric name (invalid chars -> '_')."""
    fixed = _NAME_FIX.sub("_", name)
    if not fixed or not _NAME_OK.match(fixed):
        fixed = "_" + fixed
    return fixed


def _escape_label_value(value: str) -> str:
    return (value.replace("\\", r"\\").replace("\n", r"\n")
            .replace('"', r'\"'))


def _label_suffix(labels: dict[str, str]) -> str:
    if not labels:
        return ""
    inner = ",".join(f'{k}="{_escape_label_value(v)}"'
                     for k, v in sorted(labels.items()))
    return "{" + inner + "}"


def quantile(ordered: list[float], q: float) -> float:
    """Exact nearest-rank quantile over a SORTED sample: index
    ``min(n-1, floor(q*n))``, the one percentile rule of serving latency
    and step timings alike."""
    n = len(ordered)
    if n == 0:
        raise ValueError("quantile of an empty sample")
    return ordered[min(n - 1, int(q * n))]


class _Metric:
    """Shared identity/rendering plumbing for the three metric kinds."""

    kind = "untyped"

    def __init__(self, name: str, help: str = "",
                 labels: dict[str, str] | None = None):
        self.name = prometheus_name(name)
        self.help = help
        self.labels = {str(k): str(v) for k, v in (labels or {}).items()}
        for k in self.labels:
            if not _LABEL_OK.match(k):
                raise ValueError(f"illegal Prometheus label name {k!r}")
        self._lock = threading.Lock()

    def label_suffix(self) -> str:
        return _label_suffix(self.labels)


class Counter(_Metric):
    """Monotone float counter (``inc`` only; negative increments refused)."""

    kind = "counter"

    def __init__(self, name, help="", labels=None):
        super().__init__(name, help, labels)
        self._value = 0.0

    def inc(self, amount: float = 1.0) -> None:
        if amount < 0:
            raise ValueError(f"counter {self.name} cannot decrease "
                             f"(inc {amount})")
        with self._lock:
            self._value += amount

    @property
    def value(self) -> float:
        with self._lock:
            return self._value


class Gauge(_Metric):
    """Set/add instantaneous value."""

    kind = "gauge"

    def __init__(self, name, help="", labels=None):
        super().__init__(name, help, labels)
        self._value = 0.0

    def set(self, value: float) -> None:
        with self._lock:
            self._value = float(value)

    def inc(self, amount: float = 1.0) -> None:
        with self._lock:
            self._value += amount

    def dec(self, amount: float = 1.0) -> None:
        self.inc(-amount)

    @property
    def value(self) -> float:
        with self._lock:
            return self._value


class Histogram(_Metric):
    """Cumulative count/sum + bounded window for exact percentiles:
    ``observe`` appends to a ``maxlen``-bounded deque so memory stays
    fixed on long-lived processes, while count/sum accumulate forever."""

    kind = "summary"

    def __init__(self, name, help="", labels=None, window: int = 2048,
                 quantiles: tuple[float, ...] = DEFAULT_QUANTILES):
        super().__init__(name, help, labels)
        if window < 1:
            raise ValueError(f"window must be >= 1, got {window}")
        self.quantiles = tuple(quantiles)
        self.count = 0
        self.total = 0.0
        self._window: deque[float] = deque(maxlen=window)

    def observe(self, value: float) -> None:
        value = float(value)
        with self._lock:
            self.count += 1
            self.total += value
            self._window.append(value)

    def percentiles(self) -> dict[float, float]:
        """{q: exact value} over the current window ({} when empty)."""
        with self._lock:
            ordered = sorted(self._window)
        if not ordered:
            return {}
        return {q: quantile(ordered, q) for q in self.quantiles}

    def snapshot(self) -> dict:
        """JSON view: count, mean, p50/p95/p99, max, window (unit-neutral
        keys; ``snapshot_ms`` spells them with ``_ms``)."""
        with self._lock:
            ordered = sorted(self._window)
            count, total = self.count, self.total
        if not ordered:
            return {"count": count}
        out = {"count": count,
               "mean": round(total / count, 4)}
        for q in self.quantiles:
            out[f"p{int(q * 100)}"] = round(quantile(ordered, q), 4)
        out["max"] = round(ordered[-1], 4)
        out["window"] = len(ordered)
        return out

    def snapshot_ms(self) -> dict:
        """The serving wire shape: millisecond-suffixed keys."""
        snap = self.snapshot()
        return {(k if k in ("count", "window") else f"{k}_ms"): v
                for k, v in snap.items()}


class MetricsRegistry:
    """Name -> metric store with get-or-create semantics.

    ``counter``/``gauge``/``histogram`` return the existing metric when
    the (name, labels) pair is already registered — re-registering with
    a DIFFERENT kind is a programming error and raises. ``collect`` and
    ``render_prometheus`` are consistent views of the same objects.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: dict[tuple, _Metric] = {}

    def _get_or_create(self, cls, name, help, labels, **kwargs):
        key = (prometheus_name(name),
               tuple(sorted((labels or {}).items())))
        with self._lock:
            existing = self._metrics.get(key)
            if existing is not None:
                if not isinstance(existing, cls):
                    raise ValueError(
                        f"metric {name!r} already registered as "
                        f"{existing.kind}, not {cls.kind}")
                return existing
            metric = cls(name, help=help, labels=labels, **kwargs)
            self._metrics[key] = metric
            return metric

    def counter(self, name: str, help: str = "",
                labels: dict | None = None) -> Counter:
        return self._get_or_create(Counter, name, help, labels)

    def gauge(self, name: str, help: str = "",
              labels: dict | None = None) -> Gauge:
        return self._get_or_create(Gauge, name, help, labels)

    def histogram(self, name: str, help: str = "",
                  labels: dict | None = None, window: int = 2048,
                  quantiles: tuple[float, ...] = DEFAULT_QUANTILES,
                  ) -> Histogram:
        return self._get_or_create(Histogram, name, help, labels,
                                   window=window, quantiles=quantiles)

    def _sorted_metrics(self) -> list[_Metric]:
        with self._lock:
            return [self._metrics[k] for k in sorted(self._metrics)]

    def collect(self) -> dict:
        """JSON-able snapshot: name -> value (labeled series nest under
        a ``{label=value,...}`` key; histograms export their summary)."""
        out: dict = {}
        for m in self._sorted_metrics():
            value = (m.snapshot() if isinstance(m, Histogram)
                     else m.value)
            if m.labels:
                series = out.setdefault(m.name, {})
                if not isinstance(series, dict) or "count" in series:
                    # A bare metric already claimed the name; nest it.
                    series = out[m.name] = {"": series}
                series[m.label_suffix()] = value
            else:
                out[m.name] = value
        return out

    def dump_state(self) -> dict:
        """Raw-state view for cross-process federation.

        ``collect``/``render_prometheus`` are presentation views; a
        federator needs the underlying state, histogram windows
        included, because a fleet's percentile must come from the one
        exact-window quantile rule applied to the pooled samples, not
        from averaging per-worker percentiles. Shape::

            {"metrics": [{"name", "kind", "labels", ...state...}]}

        where counters/gauges carry ``value`` and histograms carry
        ``count``/``sum``/``window`` (the bounded recent-sample list)
        + ``quantiles``. Served over HTTP as
        ``/metrics?format=state``.
        """
        out: list[dict] = []
        for m in self._sorted_metrics():
            entry = {"name": m.name, "kind": m.kind,
                     "labels": dict(m.labels)}
            if isinstance(m, Histogram):
                with m._lock:
                    entry["count"] = m.count
                    entry["sum"] = m.total
                    entry["window"] = list(m._window)
                entry["quantiles"] = list(m.quantiles)
            else:
                entry["value"] = m.value
            out.append(entry)
        return {"metrics": out}

    def render_prometheus(self) -> str:
        """Exposition-format text (version 0.0.4). Histograms render as
        summaries with their exact-window quantiles plus _sum/_count."""
        lines: list[str] = []
        seen_headers: set[str] = set()
        for m in self._sorted_metrics():
            if m.name not in seen_headers:
                seen_headers.add(m.name)
                if m.help:
                    esc = m.help.replace("\\", r"\\").replace("\n", r"\n")
                    lines.append(f"# HELP {m.name} {esc}")
                lines.append(f"# TYPE {m.name} {m.kind}")
            if isinstance(m, Histogram):
                pcts = m.percentiles()
                base = dict(m.labels)
                for q, v in pcts.items():
                    suffix = _label_suffix({**base, "quantile": str(q)})
                    lines.append(f"{m.name}{suffix} {_fmt(v)}")
                suffix = m.label_suffix()
                with m._lock:
                    count, total = m.count, m.total
                lines.append(f"{m.name}_sum{suffix} {_fmt(total)}")
                lines.append(f"{m.name}_count{suffix} {count}")
            else:
                lines.append(f"{m.name}{m.label_suffix()} "
                             f"{_fmt(m.value)}")
        return "\n".join(lines) + ("\n" if lines else "")


def _fmt(value: float) -> str:
    if math.isnan(value):
        return "NaN"
    if math.isinf(value):
        return "+Inf" if value > 0 else "-Inf"
    if float(value).is_integer() and abs(value) < 2 ** 53:
        return str(int(value))
    return repr(float(value))


_DEFAULT = MetricsRegistry()


def default_registry() -> MetricsRegistry:
    """The process-wide registry the collectives' counters publish to
    (``ntxent_tpu/obs/registry.py:353``)."""
    return _DEFAULT
