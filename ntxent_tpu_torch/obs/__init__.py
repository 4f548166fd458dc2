"""Telemetry of the port, counterpart of ``ntxent_tpu/obs`` (stdlib but
for the profiler, which imports torch when it captures):

* ``registry.MetricsRegistry``: counters, gauges and exact-window
  histograms, rendered as JSON (``collect``), Prometheus text
  (``render_prometheus``) and raw state (``dump_state``); training,
  resilience and serving publish to ``default_registry()``;
* ``events.EventLog``: typed JSONL records with run/attempt identity;
  ``install``/``emit`` is the process-wide hub, ``dump_flight`` the
  flight recorder;
* ``timeline.StepTimeline``: the per-step training breakdown (data wait,
  device and checkpoint ms, steps/s, MFU, the comms gauges);
* ``profiler.ProfilerTrigger``: on-demand ``torch.profiler`` capture
  (slow-step trigger, trigger file, SIGUSR2);
* ``trace``: ``span``/``emit_span`` over the event stream and the
  Chrome-trace exporter (``python -m ntxent_tpu_torch.obs.trace``);
* ``exporters.MetricsServer``: Prometheus text and JSON over stdlib HTTP
  (``ntxent-train --metrics-port``); ``choose_format`` is the ``/metrics``
  format negotiation serving shares.

The SLO, history and aggregation modules are the serving fleet's
(ROADMAP.md Queue A 12(a)).
"""

from .events import (
    EVENT_TYPES,
    EventLog,
    dump_flight,
    emit,
    get_event_log,
    install,
    read_events,
    set_attempt,
)
from .exporters import PROMETHEUS_CONTENT_TYPE, MetricsServer, choose_format
from .profiler import ProfilerTrigger
from .registry import (
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    default_registry,
    prometheus_name,
    quantile,
)
from .timeline import StepTimeline
from .trace import (
    emit_span,
    export_chrome_trace,
    new_request_id,
    span,
    validate_chrome_trace,
)

__all__ = ["Counter", "EVENT_TYPES", "EventLog", "Gauge", "Histogram",
           "MetricsRegistry", "MetricsServer", "PROMETHEUS_CONTENT_TYPE",
           "ProfilerTrigger", "StepTimeline", "choose_format",
           "default_registry", "dump_flight", "emit", "emit_span",
           "export_chrome_trace", "get_event_log", "install",
           "new_request_id", "prometheus_name", "quantile", "read_events",
           "set_attempt", "span", "validate_chrome_trace"]
