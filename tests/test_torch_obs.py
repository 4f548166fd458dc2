"""The port's telemetry (``ntxent_tpu_torch.obs``) against the JAX
package's ``ntxent_tpu.obs`` on the CPU: both are stdlib, so the same
operations must give the same text and the same dicts exactly.

* ``MetricsRegistry``: counters, gauges (labelled and bare) and
  exact-window histograms after the same writes render the same
  Prometheus text, ``collect`` and ``dump_state``.
* ``choose_format``: the same answer for every (query, Accept, default).
* Spans: nesting on one thread, explicit parents across threads,
  ``emit_span``, no-ops without an event log.
* ``EventLog`` (sync and ``async_io``): the JSONL a run writes, read back,
  exported by the port's ``export_chrome_trace`` (equal to the JAX
  exporter's on the same file) and accepted by ``validate_chrome_trace``;
  ``python -m ntxent_tpu_torch.obs.trace`` writes it.
"""

import json
import math
import subprocess
import sys
import threading

import pytest

from ntxent_tpu.obs import events as jax_events
from ntxent_tpu.obs import exporters as jax_exporters
from ntxent_tpu.obs import registry as jax_registry
from ntxent_tpu.obs import trace as jax_trace
from ntxent_tpu_torch.obs import events, exporters, registry, trace


def _drive(reg) -> None:
    """The same writes on either package's registry."""
    c = reg.counter("serving_requests_total", "requests accepted")
    c.inc()
    c.inc(2.5)
    for b in ("4", "16"):
        reg.counter("bucket_calls_total", "calls per bucket",
                    labels={"bucket": b}).inc(int(b))
    g = reg.gauge("queue_depth", "waiting")
    g.set(7)
    g.dec(2)
    reg.gauge("run_info", "identity", labels={"run_id": 'a"b\\c'}).set(1)
    h = reg.histogram("latency_ms", "latency", labels={"stage": "total"},
                      window=5)
    for v in (3.0, 1.0, 4.0, 1.5, 9.0, 2.6, 5.0):
        h.observe(v)
    reg.histogram("empty_ms", "never observed")
    reg.gauge("odd name-with.dots").set(float("inf"))
    reg.counter("serving_requests_total").inc()  # get-or-create identity


def test_registry_views_equal_the_jax_registry():
    ours, theirs = registry.MetricsRegistry(), jax_registry.MetricsRegistry()
    _drive(ours)
    _drive(theirs)
    assert ours.render_prometheus() == theirs.render_prometheus()
    assert ours.collect() == theirs.collect()
    assert ours.dump_state() == theirs.dump_state()
    text = ours.render_prometheus()
    assert "serving_requests_total 4.5" in text
    assert 'latency_ms{quantile="0.99",stage="total"} 9' in text
    assert "odd_name_with_dots +Inf" in text


def test_registry_refuses_what_the_jax_registry_refuses():
    for reg in (registry.MetricsRegistry(), jax_registry.MetricsRegistry()):
        reg.counter("x")
        with pytest.raises(ValueError):
            reg.gauge("x")
        with pytest.raises(ValueError):
            reg.counter("y").inc(-1)
        with pytest.raises(ValueError):
            reg.counter("z", labels={"bad-label": "1"})
    ordered = sorted([5.0, 1.0, 3.0, 2.0])
    for q in (0.0, 0.5, 0.95, 0.99, 1.0):
        assert registry.quantile(ordered, q) == jax_registry.quantile(
            ordered, q)


@pytest.mark.parametrize("path,accept,default", [
    ("/metrics", None, "json"), ("/metrics", None, "prometheus"),
    ("/metrics?format=prometheus", "application/json", "json"),
    ("/metrics?format=state", None, "json"),
    ("/metrics?format=bogus", "text/plain", "json"),
    ("/metrics", "application/openmetrics-text", "json"),
    ("/metrics", "application/json", "prometheus"),
    ("/metrics?format=json", "text/plain", "prometheus")])
def test_choose_format_equals_the_jax_rule(path, accept, default):
    got = exporters.choose_format(path, accept, default)
    assert got == jax_exporters.choose_format(path, accept, default)
    assert exporters.PROMETHEUS_CONTENT_TYPE == \
        jax_exporters.PROMETHEUS_CONTENT_TYPE


@pytest.fixture
def installed(tmp_path):
    log = events.EventLog(str(tmp_path / "run.jsonl"), run_id="r1")
    previous = events.install(log)
    try:
        yield log
    finally:
        events.install(previous)
        log.close()


def test_spans_nest_on_a_thread_and_link_across_threads(installed):
    with trace.span("outer", request_id="q1", kind="a") as outer:
        assert trace.current_span_id() == outer.span_id
        with trace.span("inner") as inner:
            pass
        box = {}

        def other():
            with trace.span("remote", parent_id=outer.span_id) as s:
                box["span"] = s

        t = threading.Thread(target=other, name="worker-x")
        t.start()
        t.join(10)
    trace.emit_span("measured", 12.5, request_id="q1", status=200)
    assert trace.current_span_id() is None
    spans = {r["name"]: r for r in installed.tail(10)
             if r["event"] == "span"}
    assert spans["inner"]["parent_id"] == outer.span_id
    assert "parent_id" not in spans["outer"]
    assert spans["remote"]["parent_id"] == outer.span_id
    assert spans["remote"]["thread"] == "worker-x"
    assert spans["outer"]["kind"] == "a"
    assert spans["outer"]["request_id"] == "q1"
    assert spans["measured"]["dur_ms"] == 12.5
    assert spans["measured"]["status"] == 200
    assert installed.counts()["span"] == 4
    with pytest.raises(RuntimeError):
        with trace.span("failing"):
            raise RuntimeError("boom")
    assert installed.tail(1)[0]["error"] == "RuntimeError"


def test_spans_without_an_event_log_are_no_ops():
    previous = events.install(None)
    try:
        with trace.span("nothing"):
            trace.emit_span("nothing either", 1.0)
        events.emit("compile", bucket=4)
    finally:
        events.install(previous)
    assert len(trace.new_request_id()) == 16


@pytest.mark.parametrize("async_io", [False, True], ids=["sync", "async"])
def test_a_jsonl_the_port_writes_exports_and_validates(tmp_path, async_io):
    path = str(tmp_path / "serve.jsonl")
    log = events.EventLog(path, run_id="smoke", async_io=async_io)
    previous = events.install(log)
    try:
        for i in range(3):
            rid = f"req{i}"
            with trace.span("serve.batch", request_ids=[rid]):
                with trace.span("serve.device_chunk", bucket=4, rows=3):
                    pass
            trace.emit_span("serve.queue_wait", 0.5, request_id=rid)
            trace.emit_span("serve.request", 3.0, request_id=rid,
                            status=200, rows=3)
        events.emit("compile", bucket=4, cause="first_compile",
                    loss=float("nan"))
        events.emit("step", step=1, data_wait_ms=1.0, device_ms=5.0,
                    loss=0.5)
        assert log.flush()
    finally:
        events.install(previous)
        log.close()
    records = events.read_events(path)
    assert len(records) == 3 * 4 + 2
    assert {r["run_id"] for r in records} == {"smoke"}
    assert events.read_events(path, "compile")[0]["loss"] == "nan"
    ours = trace.export_chrome_trace(path)
    theirs = jax_trace.export_chrome_trace(path)
    assert trace.validate_chrome_trace(ours) == \
        jax_trace.validate_chrome_trace(theirs) == 3 * 4 + 1 + 3
    ours["otherData"].pop("exporter")
    theirs["otherData"].pop("exporter")
    assert ours == theirs
    assert jax_events.read_events(path) == records
    out = tmp_path / "trace.json"
    done = subprocess.run(
        [sys.executable, "-m", "ntxent_tpu_torch.obs.trace", path, "-o",
         str(out)], capture_output=True, text=True, timeout=120)
    assert done.returncode == 0, done.stderr
    assert trace.validate_chrome_trace(json.loads(out.read_text())) > 0


def test_async_writer_drops_the_oldest_past_its_bound_and_drains(tmp_path):
    path = str(tmp_path / "bounded.jsonl")
    log = events.EventLog(path, async_io=True, write_queue_max=2)
    for i in range(5):
        log.emit("bench", i=i)
    log.close()  # drains what is queued before the handle closes
    written = [r["i"] for r in events.read_events(path)]
    # whatever the writer did not take in time was dropped oldest first
    assert written == list(range(5 - len(written), 5))
    assert log.dropped_writes + len(written) == 5 and len(written) >= 2
    full = events.EventLog(None, tail=2)
    for i in range(5):
        full.emit("bench", i=i, x=math.inf)
    assert [r["i"] for r in full.tail(5)] == [3, 4]
    assert full.counts() == {"bench": 5}
    full.set_attempt(2)
    assert full.emit("retry")["attempt"] == 2
