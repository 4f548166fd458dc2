"""Telemetry of the port, counterpart of ``ntxent_tpu/obs`` (stdlib):

* ``registry.MetricsRegistry``: counters, gauges and exact-window
  histograms, rendered as JSON (``collect``), Prometheus text
  (``render_prometheus``) and raw state (``dump_state``);
* ``events.EventLog``: typed JSONL records with run/attempt identity;
  ``install``/``emit`` is the process-wide hub;
* ``trace``: ``span``/``emit_span`` over the event stream and the
  Chrome-trace exporter (``python -m ntxent_tpu_torch.obs.trace``);
* ``exporters.choose_format``: the ``/metrics`` format negotiation.

The timeline, SLO, history, aggregation and profiler modules and the
training-side metrics server are not ported yet (ROADMAP.md Queue A
11(b)).
"""

from .events import (
    EVENT_TYPES,
    EventLog,
    emit,
    get_event_log,
    install,
    read_events,
    set_attempt,
)
from .exporters import PROMETHEUS_CONTENT_TYPE, choose_format
from .registry import (
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    prometheus_name,
    quantile,
)
from .trace import (
    emit_span,
    export_chrome_trace,
    new_request_id,
    span,
    validate_chrome_trace,
)

__all__ = ["Counter", "EVENT_TYPES", "EventLog", "Gauge", "Histogram",
           "MetricsRegistry", "PROMETHEUS_CONTENT_TYPE", "choose_format",
           "emit", "emit_span", "export_chrome_trace",
           "get_event_log", "install",
           "new_request_id", "prometheus_name", "quantile", "read_events",
           "set_attempt", "span", "validate_chrome_trace"]
