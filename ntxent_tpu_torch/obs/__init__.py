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
  device and checkpoint ms, steps/s, MFU, the comms gauges), recorded
  into a ``MetricHistory`` when given one;
* ``profiler.ProfilerTrigger``: on-demand ``torch.profiler`` capture
  (slow-step trigger, trigger file, SIGUSR2);
* ``trace``: ``span``/``emit_span`` over the event stream, the Chrome-trace
  exporter and its merge of many processes' streams
  (``python -m ntxent_tpu_torch.obs.trace [--merge]``);
* ``exporters.MetricsServer``: Prometheus text and JSON over stdlib HTTP
  (``ntxent-train --metrics-port``); ``choose_format`` is the ``/metrics``
  format negotiation serving shares;
* the serving fleet's planes: ``aggregate.FleetAggregator`` (federation of
  the workers' ``?format=state`` dumps, ``merge_states``), ``slo``
  (``Objective``, ``SLOEngine``, ``AlertStore``: multi-window burn-rate
  alerts) and ``history`` (``MetricHistory`` with its durable spill,
  ``HistoryRecorder``, ``AnomalyDetector``, the Holt-Winters
  ``Forecaster``).

Exports resolve lazily (PEP 562): the fleet's router process imports this
package and must not load the profiler's torch.
"""

import importlib

# name -> defining submodule; resolved on first attribute access.
_EXPORTS = {
    "FleetAggregator": "aggregate",
    "merge_states": "aggregate",
    "EVENT_TYPES": "events",
    "EventLog": "events",
    "dump_flight": "events",
    "emit": "events",
    "get_event_log": "events",
    "install": "events",
    "read_events": "events",
    "set_attempt": "events",
    "MetricsServer": "exporters",
    "PROMETHEUS_CONTENT_TYPE": "exporters",
    "choose_format": "exporters",
    "AnomalyDetector": "history",
    "DEFAULT_SERIES": "history",
    "Forecaster": "history",
    "HistoryRecorder": "history",
    "MetricHistory": "history",
    "SeriesSpec": "history",
    "gauge_reduce": "history",
    "ingest_timeline": "history",
    "ProfilerTrigger": "profiler",
    "Counter": "registry",
    "Gauge": "registry",
    "Histogram": "registry",
    "MetricsRegistry": "registry",
    "default_registry": "registry",
    "prometheus_name": "registry",
    "quantile": "registry",
    "AlertStore": "slo",
    "Objective": "slo",
    "SLOEngine": "slo",
    "StepTimeline": "timeline",
    "current_span_id": "trace",
    "emit_span": "trace",
    "export_chrome_trace": "trace",
    "export_merged_chrome_trace": "trace",
    "new_request_id": "trace",
    "span": "trace",
    "validate_chrome_trace": "trace",
}


def __getattr__(name):
    module = _EXPORTS.get(name)
    if module is None:
        raise AttributeError(
            f"module {__name__!r} has no attribute {name!r}")
    value = getattr(importlib.import_module(f".{module}", __name__), name)
    globals()[name] = value  # later access skips __getattr__
    return value


def __dir__():
    return sorted(set(globals()) | set(_EXPORTS))


__all__ = sorted(_EXPORTS)
