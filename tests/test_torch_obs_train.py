"""Train-side telemetry of the port (``ntxent_tpu_torch/obs``: the step
timeline, the profiler trigger, the metrics server, the flight recorder;
the registry series and events of training's layers; the FLOP count and
MFU; ``train_loop(timeline=)`` and the CLI's telemetry flags) against the
JAX package's, on the CPU at small sizes, at one torch thread. Nothing is
built at import.

Tolerances:

* the timeline's series and events, the flight dumps, the guard's, the
  retry policy's, the supervisor's and the checkpoint manager's series
  and events: equal to the JAX package's for the same inputs, with the
  time fields dropped (``t``, ``wall``, ``duration_ms``; a histogram of
  milliseconds by its count). Steps/s and MFU come from the wall clock,
  so both timelines read one fake clock; both use the CPU's placeholder
  peak (100e12);
* each kernel's FLOP tally against ``FlopCounterMode`` over its plain
  version: equal, but #2 and #3, which count the upper triangle as the
  JAX ``pl.CostEstimate`` does (#2 half the plain square's s; #3 that
  half and both products, three quarters of the plain version's);
* a tiny ViT step's FLOPs against XLA's cost analysis of the JAX step
  (``compiled_step_flops``): 0.75 to 1.0 of it. XLA also counts the
  element-wise work (softmax, LayerNorm, GELU, the loss, LARS), which
  ``FlopCounterMode`` does not; at width 32 it is 7-15% of the step.
"""

import contextlib
import json
import logging
import os
import subprocess
import sys
import threading
import time
import types
import urllib.error
import urllib.request
from collections import Counter
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from ntxent_tpu import obs as jobs
from ntxent_tpu.obs import timeline as jtimeline
from ntxent_tpu.resilience import crashsim as jcrashsim
from ntxent_tpu.resilience.guard import DivergenceError as JaxDivergenceError
from ntxent_tpu.resilience.guard import DivergenceGuard as JaxGuard
from ntxent_tpu.resilience.retry import RetryPolicy as JaxRetry
from ntxent_tpu.resilience.supervisor import Supervisor as JaxSupervisor
from ntxent_tpu.training.checkpoint import AsyncCheckpointer as JaxAsync
from ntxent_tpu.training.checkpoint import CheckpointManager as JaxManager
from ntxent_tpu.training.trainer import StepOutcome as JaxOutcome
from ntxent_tpu.utils import logging_utils as jlogging
from ntxent_tpu_torch import cli, obs
from ntxent_tpu_torch.models import init_weights
from ntxent_tpu_torch.obs import timeline as ttimeline
from ntxent_tpu_torch.ops import attention, flops, infonce, ntxent
from ntxent_tpu_torch.resilience import crashsim
from ntxent_tpu_torch.resilience.guard import DivergenceError
from ntxent_tpu_torch.resilience.guard import DivergenceGuard
from ntxent_tpu_torch.resilience.retry import RetryPolicy
from ntxent_tpu_torch.resilience.supervisor import Supervisor
from ntxent_tpu_torch.training import trainer as ttrain
from ntxent_tpu_torch.training.checkpoint import (
    AsyncCheckpointer,
    CheckpointManager,
)
from ntxent_tpu_torch.training.preemption import PreemptionGuard
from ntxent_tpu_torch.utils import logging_utils, memory
from ntxent_tpu_torch.utils.watchdog import StallWatchdog
from ntxent_tpu_torch.weights import load_flax_variables

from test_torch_training import (
    BATCH,
    IMAGE,
    _tiny_jax_simclr,
    _tiny_port_simclr,
)

torch.set_num_threads(1)  # one torch thread a test worker

REPO = Path(__file__).resolve().parents[1]
TIME_FIELDS = ("t", "wall", "duration_ms")


def _strip(record: dict) -> dict:
    """A record without its time fields, non-finite floats as their repr
    (as the file holds them), so records compare with ``==``."""
    return obs.events._sanitize({k: v for k, v in record.items()
                                 if k not in TIME_FIELDS})


@contextlib.contextmanager
def _installed(events_module, log):
    previous = events_module.install(log)
    try:
        yield log
    finally:
        events_module.install(previous)


def _both_logs(run_id="parity", **kwargs):
    """An in-memory event log of each package with one run id."""
    return (jobs.EventLog(None, run_id=run_id, **kwargs),
            obs.EventLog(None, run_id=run_id, **kwargs))


def _series(registry, names) -> dict:
    """The named series of a registry's collect(); a histogram by count."""
    snap = registry.collect()
    out = {}
    for name in names:
        value = snap.get(name, 0)
        out[name] = value["count"] if isinstance(value, dict) else value
    return out


def _delta(before: dict, after: dict) -> dict:
    return {k: after[k] - before[k] for k in before}


# ---------------------------------------------------------------------------
# StepTimeline against the JAX package's
# ---------------------------------------------------------------------------

class _Clock:
    """A perf_counter that advances 50 ms a read: both timelines see the
    same wall times, so their steps/s and MFU are equal."""

    def __init__(self):
        self.now = 1000.0

    def perf_counter(self):
        self.now += 0.05
        return self.now


STEPS = [
    dict(step=1, loss=4.5, data_wait_s=0.002, device_s=0.2, hook_s=0.0),
    dict(step=2, loss=4.25, data_wait_s=0.001, device_s=0.03,
         hook_s=0.004, host_fetch_s=0.0005, transfer_s=0.0002),
    dict(step=3, loss=float("nan"), data_wait_s=0.001, device_s=0.03),
    dict(step=4, loss=float("nan"), data_wait_s=0.0, device_s=0.031,
         ok=False, grad_norm=float("inf")),
    dict(step=5, loss=4.0, data_wait_s=0.0, device_s=0.029, ok=True,
         grad_norm=1.5),
]


def _drive_timeline(obs_module, log, clock_module, monkeypatch):
    monkeypatch.setattr(clock_module, "time", _Clock())
    registry = obs_module.MetricsRegistry()
    with _installed(obs_module, log):
        tl = obs_module.StepTimeline(registry=registry, event_every=2)
        tl.set_comms_per_step({})  # world 1: the series stay untouched
        tl.set_flops_per_step(3.0e9)
        tl.record_compile(1234.5, 3.0e9)
        tl.set_comms_per_step({("all_gather", "data"): (2, 4096.0),
                               ("psum", "data"): (1, 4.0)})
        for kwargs in STEPS:
            tl.record_step(**kwargs)
        tl.new_attempt()
        tl.record_step(step=6, loss=3.5, data_wait_s=0.01, device_s=0.02,
                       hook_s=0.03)
        tl.set_comms_overlap(1.5, monolithic_ms=10.0, chunked_ms=8.5,
                             chunks=4)
        tl.set_comms_overlap(-2.0)  # clamped; the fraction stays
    return registry.collect(), [_strip(r) for r in log.tail(100)]


def test_timeline_series_and_events_equal_the_jax_timelines(monkeypatch):
    jlog, tlog = _both_logs()
    want = _drive_timeline(jobs, jlog, jtimeline, monkeypatch)
    got = _drive_timeline(obs, tlog, ttimeline, monkeypatch)
    assert got[0] == want[0]
    assert got[1] == want[1]
    names = [r["event"] for r in got[1]]
    # every second step, and a divergent step whatever the cadence
    assert [r["step"] for r in got[1] if r["event"] == "step"] \
        == [2, 3, 4, 6] and "compile" in names
    assert got[0]["train_mfu"] > 0 and got[0]["train_steps_total"] == 6


class TestStepTimeline:
    """``tests/test_obs.py``'s ``TestStepTimeline`` on the port."""

    def test_step_events_and_registry(self):
        r = obs.MetricsRegistry()
        with _installed(obs, obs.EventLog(None)) as log:
            tl = obs.StepTimeline(registry=r)
            for step in range(1, 4):
                tl.record_step(step=step, loss=1.0 / step,
                               data_wait_s=0.002, device_s=0.010,
                               hook_s=0.001)
        snap = r.collect()
        assert snap["train_steps_total"] == 3
        assert snap["train_step_device_ms"]["count"] == 3
        steps = [rec for rec in log.tail(10) if rec["event"] == "step"]
        assert len(steps) == 3
        for rec in steps:
            assert rec["data_wait_ms"] == pytest.approx(2.0)
            assert rec["device_ms"] == pytest.approx(10.0)
            assert rec["steps_per_sec"] > 0

    def test_unguarded_nan_emits_divergence(self):
        r = obs.MetricsRegistry()
        with _installed(obs, obs.EventLog(None)) as log:
            tl = obs.StepTimeline(registry=r)
            tl.record_step(step=1, loss=float("nan"), data_wait_s=0.0,
                           device_s=0.01, ok=None)
        assert r.collect()["train_divergence_total"] == 1
        div = [rec for rec in log.tail(5) if rec["event"] == "divergence"]
        assert len(div) == 1 and div[0]["guarded"] is False
        (step_rec,) = [rec for rec in log.tail(5) if rec["event"] == "step"]
        json.dumps(step_rec)

    def test_new_attempt_resets_rate_clock(self):
        tl = obs.StepTimeline(registry=obs.MetricsRegistry())
        tl.record_step(step=1, loss=1.0, data_wait_s=0.0, device_s=0.01)
        assert tl._last_done is not None
        tl.new_attempt()
        assert tl._last_done is None
        tl.record_step(step=2, loss=1.0, data_wait_s=0.0, device_s=0.01)

    def test_guarded_skip_suppresses_duplicate(self):
        r = obs.MetricsRegistry()
        with _installed(obs, obs.EventLog(None)) as log:
            tl = obs.StepTimeline(registry=r)
            tl.record_step(step=1, loss=float("nan"), data_wait_s=0.0,
                           device_s=0.01, ok=False, grad_norm=float("inf"))
        assert r.collect()["train_divergence_total"] == 1
        assert not [rec for rec in log.tail(5)
                    if rec["event"] == "divergence"]

    def test_graph_census_is_not_ported(self):
        """The graph census this test once saw refused is ported: a
        census summary is taken, its autograd remainder published on
        ``collective_graph_bytes_total{source="ad"}`` (an empty declared
        delta, world 1, emits no ``comms_profile`` event, as in JAX)."""
        r = obs.MetricsRegistry()
        tl = obs.StepTimeline(registry=r)
        with _installed(obs, obs.EventLog(None)) as log:
            tl.set_comms_per_step({}, graph={"ad_bytes": 1.0})
        assert r.collect()["collective_graph_bytes_total"] == {
            '{source="ad"}': 1.0}
        assert not [rec for rec in log.tail(5)
                    if rec["event"] == "comms_profile"]

    def test_the_peak_resolves_through_the_trainer(self):
        """MFU over the card's peak by its name; the CPU takes the JAX
        package's placeholder, as JAX's timeline does on its CPU."""
        assert ttrain.peak_flops_per_chip() == 100e12
        assert ttrain.peak_hbm_bytes_per_chip() == 819e9
        assert ttrain._peaks("NVIDIA H100 80GB HBM3") == (989.4e12, 3.35e12)
        assert ttrain._peaks("NVIDIA H100 PCIe") == (756e12, 2.0e12)
        assert ttrain.estimate_mfu(1e12, 10.0) == pytest.approx(0.1)


# ---------------------------------------------------------------------------
# ProfilerTrigger over torch.profiler
# ---------------------------------------------------------------------------

class _FakeProfile:
    """``torch.profiler.profile`` as the trigger drives it."""

    def __init__(self, activities):
        self.activities = activities
        self.state = "new"
        self.exported = None
        _FakeProfile.made.append(self)

    def start(self):
        self.state = "started"

    def stop(self):
        self.state = "stopped"

    def export_chrome_trace(self, path):
        self.exported = path
        Path(path).write_text("{}")


@pytest.fixture
def fake_profiler(monkeypatch):
    _FakeProfile.made = []
    monkeypatch.setattr(torch.profiler, "profile", _FakeProfile)
    return _FakeProfile


class TestProfilerTrigger:
    """``tests/test_obs.py``'s ``TestProfilerTrigger`` on the port, with a
    fake ``torch.profiler.profile``; then one real CPU capture."""

    def _trigger(self, tmp_path, **kwargs):
        defaults = dict(slow_factor=3.0, capture_steps=2, warmup_steps=3,
                        registry=obs.MetricsRegistry())
        defaults.update(kwargs)
        return obs.ProfilerTrigger(str(tmp_path), **defaults)

    def test_fires_on_spike_not_on_warmup(self, tmp_path, fake_profiler):
        with _installed(obs, obs.EventLog(None)) as log:
            trig = self._trigger(tmp_path)
            trig.on_step(1, 5000.0)  # the first run: no window yet
            assert not fake_profiler.made
            for step in range(2, 8):
                trig.on_step(step, 10.0)
            assert not fake_profiler.made
            trig.on_step(8, 100.0)  # 10x the median: fire
            assert [p.state for p in fake_profiler.made] == ["started"]
            trig.on_step(9, 105.0)
            trig.on_step(10, 11.0)  # the second captured step: stop
            (prof,) = fake_profiler.made
            assert prof.state == "stopped"
            assert prof.exported.endswith("trace.json")
            assert os.path.isfile(prof.exported)
        actions = [rec["action"] for rec in log.tail(10)
                   if rec["event"] == "trace"]
        assert actions == ["start", "complete"]
        (start,) = [r for r in log.tail(10) if r.get("action") == "start"]
        assert start["reason"].startswith("slow_step")
        assert start["trace_dir"].startswith(str(tmp_path))
        assert os.path.dirname(prof.exported) == start["trace_dir"]

    def test_captured_steps_stay_out_of_baseline(self, tmp_path,
                                                 fake_profiler):
        trig = self._trigger(tmp_path, capture_steps=1)
        for step in range(1, 6):
            trig.on_step(step, 10.0)
        trig.on_step(6, 1000.0)
        trig.on_step(7, 1000.0)
        assert fake_profiler.made[0].state == "stopped"
        trig.on_step(8, 35.0)  # 3.5x the clean 10 ms median
        assert len(fake_profiler.made) == 2

    def test_manual_trigger_file(self, tmp_path, fake_profiler):
        trig = self._trigger(tmp_path, warmup_steps=100)
        trig.on_step(1, 10.0)
        assert not fake_profiler.made
        (tmp_path / "TRIGGER").touch()
        trig.on_step(2, 10.0)
        assert len(fake_profiler.made) == 1
        assert not (tmp_path / "TRIGGER").exists()

    def test_trace_dir_created_for_trigger_file(self, tmp_path):
        target = tmp_path / "does" / "not" / "exist"
        self._trigger(target)
        assert os.path.isdir(target)

    def test_sigusr2_flag_consumed_without_lock(self, tmp_path,
                                                fake_profiler):
        trig = self._trigger(tmp_path, warmup_steps=100)
        trig._signal_pending = True  # what the handler does
        trig.on_step(1, 10.0)
        assert len(fake_profiler.made) == 1
        assert trig._signal_pending is False

    def test_request_idempotent_while_active(self, tmp_path, fake_profiler):
        trig = self._trigger(tmp_path, warmup_steps=100, capture_steps=3)
        trig.request("manual")
        trig.request("manual")
        trig.on_step(1, 10.0)
        assert len(fake_profiler.made) == 1
        trig.request("manual")  # dropped: a capture is in flight
        for step in (2, 3, 4):
            trig.on_step(step, 10.0)
        assert fake_profiler.made[0].state == "stopped"
        assert len(fake_profiler.made) == 1

    def test_a_failed_capture_disarms_and_the_step_goes_on(
            self, tmp_path, monkeypatch, caplog):
        def broken(activities):
            raise RuntimeError("CUPTI unavailable")

        monkeypatch.setattr(torch.profiler, "profile", broken)
        trig = self._trigger(tmp_path, warmup_steps=100)
        trig.request()
        with caplog.at_level(logging.ERROR):
            trig.on_step(1, 10.0)  # no raise: the catch is the capture's
        assert trig._disabled and "disabling further captures" in caplog.text
        trig.request()
        trig.on_step(2, 10.0)
        assert trig._active_dir is None

    def test_close_ends_a_capture_in_flight(self, tmp_path, fake_profiler):
        with _installed(obs, obs.EventLog(None)) as log:
            trig = self._trigger(tmp_path, warmup_steps=100, capture_steps=5)
            trig.request()
            trig.on_step(3, 10.0)
            trig.on_step(4, 10.0)
            trig.close()
        (done,) = [r for r in log.tail(5) if r.get("action") == "complete"]
        assert done["steps_captured"] == 1
        assert fake_profiler.made[0].state == "stopped"

    def test_a_real_cpu_capture_is_a_chrome_trace(self, tmp_path):
        """torch.profiler on the host: the exported trace names the aten
        ops the captured step ran (on the card, the kernels too)."""
        trig = self._trigger(tmp_path, warmup_steps=100, capture_steps=1)
        trig.request()
        trig.on_step(1, 10.0)
        a = torch.randn(64, 64)
        (a @ a).sum()
        trig.on_step(2, 10.0)
        (trace,) = tmp_path.glob("step1-*/trace.json")
        events = json.loads(trace.read_text())["traceEvents"]
        assert any(e.get("name") == "aten::mm" for e in events)
        assert trig._captures.value == 1


# ---------------------------------------------------------------------------
# MetricsServer
# ---------------------------------------------------------------------------

class TestExporters:
    def test_metrics_server_both_formats(self):
        r = obs.MetricsRegistry()
        r.counter("train_steps_total").inc(5)
        with obs.MetricsServer(registry=r, port=0) as server:
            base = f"http://127.0.0.1:{server.port}"
            with urllib.request.urlopen(base + "/metrics",
                                        timeout=10) as resp:
                assert resp.headers["Content-Type"].startswith("text/plain")
                text = resp.read().decode()
            assert "# TYPE train_steps_total counter" in text
            assert "train_steps_total 5" in text
            with urllib.request.urlopen(base + "/metrics?format=json",
                                        timeout=10) as resp:
                assert json.loads(resp.read())["train_steps_total"] == 5
            req = urllib.request.Request(
                base + "/metrics", headers={"Accept": "application/json"})
            with urllib.request.urlopen(req, timeout=10) as resp:
                assert json.loads(resp.read())["train_steps_total"] == 5
            with urllib.request.urlopen(base + "/metrics?format=state",
                                        timeout=10) as resp:
                state = json.loads(resp.read())
            assert state["metrics"][0]["name"] == "train_steps_total"
            with urllib.request.urlopen(base + "/healthz",
                                        timeout=10) as resp:
                assert resp.status == 200
            with pytest.raises(urllib.error.HTTPError) as err:
                urllib.request.urlopen(base + "/nope", timeout=10)
            assert err.value.code == 404

    def test_a_server_starts_once_and_closes(self):
        server = obs.MetricsServer(registry=obs.MetricsRegistry()).start()
        try:
            assert server.port > 0
            with pytest.raises(RuntimeError, match="already started"):
                server.start()
        finally:
            server.close()
        server.close()  # idempotent

    def test_choose_format(self):
        assert obs.choose_format("/metrics", None) == "json"
        assert obs.choose_format("/metrics", None,
                                 default="prometheus") == "prometheus"
        assert obs.choose_format("/metrics?format=prometheus",
                                 "application/json") == "prometheus"
        assert obs.choose_format("/metrics", "text/plain") == "prometheus"
        assert obs.choose_format("/metrics?format=bogus", None,
                                 default="json") == "json"


# ---------------------------------------------------------------------------
# logging utilities
# ---------------------------------------------------------------------------

class TestLoggingUtils:
    def test_setup_logging_idempotent_level(self):
        root = logging.getLogger()
        saved_level, saved_handlers = root.level, list(root.handlers)
        try:
            logging_utils.setup_logging(logging.INFO)
            assert root.level == logging.INFO
            logging_utils.setup_logging(logging.DEBUG)
            assert root.level == logging.DEBUG
        finally:
            root.setLevel(saved_level)
            root.handlers[:] = saved_handlers

    def test_setup_logging_leaves_foreign_handlers_alone(self):
        root = logging.getLogger()
        saved_level, saved_handlers = root.level, list(root.handlers)
        foreign = logging.StreamHandler()
        marker = logging.Formatter("THEIRS %(message)s")
        foreign.setFormatter(marker)
        try:
            root.addHandler(foreign)
            logging_utils.setup_logging(logging.INFO, structured=True)
            assert foreign.formatter is marker
        finally:
            root.removeHandler(foreign)
            root.setLevel(saved_level)
            root.handlers[:] = saved_handlers

    @pytest.mark.parametrize("fields", [
        {"event": "step", "loss": 0.5, "ok": True, "msg": "two words",
         "none": None},
        {"empty": "", "eq": "a=b", "quote": 'say "x"', "n": 3,
         "f": float("inf")}], ids=["plain", "quoted"])
    def test_format_kv_is_the_jax_rendering(self, fields):
        assert logging_utils.format_kv(fields) == jlogging.format_kv(fields)
        if "msg" in fields:
            assert logging_utils.format_kv(fields) == \
                'event=step loss=0.5 ok=true msg="two words" none=null'

    def test_key_value_formatter_dict_msg(self):
        record = logging.LogRecord("n", logging.INFO, "p", 1,
                                   {"step": 3, "loss": 0.25}, (), None)
        out = logging_utils.KeyValueFormatter().format(record)
        assert "step=3" in out and "loss=0.25" in out

    def test_event_log_mirrors_records_to_the_logger(self, caplog):
        log = obs.EventLog(None, run_id="m", mirror_logger=True)
        with caplog.at_level(logging.INFO, "ntxent_tpu_torch.obs.events"):
            log.emit("step", step=7, loss=0.5)
        assert "event=step" in caplog.text and "step=7" in caplog.text
        assert "run_id=m" in caplog.text


# ---------------------------------------------------------------------------
# the flight recorder
# ---------------------------------------------------------------------------

FLIGHT_RECORDS = [
    ("step", dict(step=1, loss=4.5, data_wait_ms=1.25, device_ms=30.0)),
    ("retry", dict(fn="read", call_attempt=1, max_attempts=3,
                   error="OSError: blip", delay_s=0.1)),
    ("divergence", dict(action="skip", step=2, loss=float("nan"),
                        grad_norm=float("inf"), guarded=True, lag=0)),
    ("checkpoint", dict(action="save", step=2, ok=True, forced=False)),
    ("restart", dict(attempt=0, end_step=None, error="ChaosError: x")),
]


def _flight(events_module, directory, tail):
    log = events_module.EventLog(None, run_id="flight", tail=tail)
    log.set_attempt(2)
    for name, fields in FLIGHT_RECORDS:
        log.emit(name, **fields)
    return log.dump_flight(str(directory), reason="stall:5.0s")


def _lines(path):
    out = []
    for line in Path(path).read_text().splitlines():
        record = json.loads(line)
        out.append(json.dumps(_strip(record)))
    return out


def test_flight_dumps_equal_the_jax_dumps(tmp_path):
    """The same records through each package's log: the same lines, key
    order included, the time fields apart; the tail bounds the dump."""
    want = _flight(jobs.events, tmp_path / "jax", tail=4)
    got = _flight(obs.events, tmp_path / "port", tail=4)
    assert Path(got).name.startswith("flight_")
    assert _lines(got) == _lines(want)
    header = json.loads(Path(got).read_text().splitlines()[0])
    assert header == {**header, "event": "flight", "reason": "stall:5.0s",
                      "run_id": "flight", "attempt": 2, "records": 4}
    assert '"loss": "nan"' in Path(got).read_text()  # strict JSON


def test_flight_dump_directories(tmp_path, monkeypatch):
    """The argument, then NTXENT_FLIGHT_DIR, then the log file's own
    directory, then the working directory, which a routine dump (a
    preemption signal) skips; nothing without records or a log."""
    monkeypatch.delenv("NTXENT_FLIGHT_DIR", raising=False)
    monkeypatch.chdir(tmp_path)
    log = obs.EventLog(None)
    assert log.dump_flight() is None  # no records
    log.emit("step", step=1)
    assert log.dump_flight(routine=True) is None
    assert Path(log.dump_flight()).parent == Path(".")
    monkeypatch.setenv("NTXENT_FLIGHT_DIR", str(tmp_path / "env"))
    assert Path(log.dump_flight(routine=True)).parent == tmp_path / "env"
    monkeypatch.delenv("NTXENT_FLIGHT_DIR")
    with obs.EventLog(str(tmp_path / "logs" / "run.jsonl")) as filed:
        filed.emit("step", step=1)
        assert Path(filed.dump_flight(routine=True)).parent \
            == tmp_path / "logs"
    assert obs.events.dump_flight() is None  # nothing installed


def test_preemption_signal_dumps_the_flight_recorder(tmp_path):
    """The first poll that sees the signal dumps, where telemetry lives
    (routine: the log's directory), once."""
    path = tmp_path / "run.jsonl"
    with obs.EventLog(str(path)) as log, _installed(obs, log):
        log.emit("step", step=3, loss=1.0)
        guard = PreemptionGuard()
        assert not guard.requested()
        guard.request()
        assert guard.requested() and guard.requested()
    (dump,) = tmp_path.glob("flight_*.jsonl")
    header, *records = [json.loads(x) for x in
                        dump.read_text().splitlines()]
    assert header["reason"] == "signal" and records[0]["step"] == 3


# ---------------------------------------------------------------------------
# training's layers: series and events against the JAX package's
# ---------------------------------------------------------------------------

GUARD_SERIES = ("train_divergence_skips_total",
                "train_divergence_backoffs_total",
                "train_divergence_rollbacks_total")


def _guard_run(guard_cls, outcome_cls, error_cls, events_module, registry):
    before = _series(registry, GUARD_SERIES)
    log = events_module.EventLog(None, run_id="guard")
    oks = [True, False, False, True, True, False, False, False, False]
    with _installed(events_module, log):
        guard = guard_cls(backoff_after=2, rollback_after=5, regrow_after=2)
        with pytest.raises(error_cls):
            for step, ok in enumerate(oks, 1):
                guard(outcome_cls(step=step, loss=1.0 if ok else float("nan"),
                                  grad_norm=1.0 if ok else float("inf"),
                                  ok=ok, lag=1))
    return (_delta(before, _series(registry, GUARD_SERIES)),
            registry.collect()["train_grad_scale"],
            [_strip(r) for r in log.tail(50)])


def test_guard_series_and_events_equal_the_jax_guards():
    want = _guard_run(JaxGuard, JaxOutcome, JaxDivergenceError, jobs.events,
                      jobs.default_registry())
    got = _guard_run(DivergenceGuard, ttrain.StepOutcome, DivergenceError,
                     obs.events, obs.default_registry())
    assert got == want
    # the fifth bad step spends the budget before its skip is recorded
    assert [r["action"] for r in got[2]] == [
        "skip", "backoff", "skip", "backoff", "rollback"]
    assert got[0] == {GUARD_SERIES[0]: 5, GUARD_SERIES[1]: 2,
                      GUARD_SERIES[2]: 1}


def test_guard_publishes_initial_scale():
    DivergenceGuard(init_scale=0.25)
    assert obs.default_registry().collect()["train_grad_scale"] == 0.25
    DivergenceGuard()
    assert obs.default_registry().collect()["train_grad_scale"] == 1.0


RETRY_SERIES = ("retries_total", "retries_exhausted_total")


def _retry_run(policy_cls, events_module, registry):
    before = _series(registry, RETRY_SERIES)
    log = events_module.EventLog(None, run_id="retry")
    calls = []

    def flaky():
        calls.append(1)
        if len(calls) < 3:
            raise OSError("blip")
        return "ok"

    def broken():
        raise OSError("gone")

    with _installed(events_module, log):
        policy = policy_cls(max_attempts=3, base_delay_s=0.01, seed=3,
                            sleep=lambda s: None)
        assert policy.call(flaky) == "ok"
        with pytest.raises(OSError, match="gone"):
            policy.call(broken)
    return (_delta(before, _series(registry, RETRY_SERIES)),
            [_strip(r) for r in log.tail(50)])


def test_retry_series_and_events_equal_the_jax_policys():
    want = _retry_run(JaxRetry, jobs.events, jobs.default_registry())
    got = _retry_run(RetryPolicy, obs.events, obs.default_registry())
    assert got == want
    assert got[0] == {"retries_total": 4, "retries_exhausted_total": 1}
    assert [r["fn"] for r in got[1]] == ["flaky"] * 2 + ["broken"] * 2


SUPERVISOR_SERIES = ("supervisor_attempts_total", "supervisor_restarts_total",
                     "supervisor_topology_restarts_total")


def _supervise(supervisor_cls, events_module, registry):
    before = _series(registry, SUPERVISOR_SERIES)
    log = events_module.EventLog(None, run_id="sup")

    def run_attempt(attempt, stop_fn, watchdog):
        events_module.emit("bench", note=f"attempt {attempt}")
        if attempt == 0:
            raise RuntimeError("boom")
        return types.SimpleNamespace(step=4), [{"step": 4}]

    with _installed(events_module, log):
        result = supervisor_cls(run_attempt, num_steps=4, max_restarts=2,
                                sleep=lambda s: None).run()
    assert result.completed
    return (_delta(before, _series(registry, SUPERVISOR_SERIES)),
            [_strip(r) for r in log.tail(50)])


def test_supervisor_series_and_events_equal_the_jax_supervisors():
    want = _supervise(JaxSupervisor, jobs.events, jobs.default_registry())
    got = _supervise(Supervisor, obs.events, obs.default_registry())
    assert got == want
    (restart,) = [r for r in got[1] if r["event"] == "restart"]
    assert restart["error"] == "RuntimeError: boom"
    # each attempt stamps the records it emits
    assert [r["attempt"] for r in got[1] if r["event"] == "bench"] == [0, 1]


def test_a_stall_dumps_the_flight_recorder(tmp_path, monkeypatch):
    """The supervisor's stall escalation dumps the event tail, then stops
    the attempt; the watchdog counts the stall."""
    monkeypatch.setenv("NTXENT_FLIGHT_DIR", str(tmp_path))
    stalls = obs.default_registry().counter("watchdog_stalls_total")
    before = stalls.value

    def run_attempt(attempt, stop_fn, watchdog):
        if attempt == 0:
            obs.emit("step", step=1, loss=2.0)
            deadline = time.monotonic() + 20.0
            while not stop_fn() and time.monotonic() < deadline:
                time.sleep(0.02)  # silent: no beat
            return types.SimpleNamespace(step=1), []
        return types.SimpleNamespace(step=2), []

    with _installed(obs, obs.EventLog(None, run_id="stall")):
        result = Supervisor(run_attempt, num_steps=2, max_restarts=1,
                            stall_timeout_s=0.3, sleep=lambda s: None).run()
    assert result.completed and result.records[0].stalled
    # the stall's dump, then (as in the JAX package) the stop request's:
    # the attempt's PreemptionGuard sees it as a signal
    dumps = {}
    for path in tmp_path.glob("flight_*.jsonl"):
        header, *records = [json.loads(x)
                            for x in path.read_text().splitlines()]
        dumps[header["reason"].split(":")[0]] = records
    assert sorted(dumps) == ["signal", "stall"]
    assert [(r["event"], r.get("step")) for r in dumps["stall"]] \
        == [("step", 1)]
    assert stalls.value == before + 1


def test_watchdog_stall_series_equals_the_jax_watchdogs():
    from ntxent_tpu.utils.watchdog import StallWatchdog as JaxWatchdog

    deltas = []
    for cls, registry in ((JaxWatchdog, jobs.default_registry()),
                          (StallWatchdog, obs.default_registry())):
        before = _series(registry, ["watchdog_stalls_total"])
        with cls(timeout_s=0.2, poll_s=0.02):
            deadline = time.monotonic() + 10.0
            while (_series(registry, ["watchdog_stalls_total"])
                   == before and time.monotonic() < deadline):
                time.sleep(0.02)
        deltas.append(_delta(before,
                             _series(registry, ["watchdog_stalls_total"])))
    assert deltas[0] == deltas[1] == {"watchdog_stalls_total": 1}


CKPT_SERIES = (
    "checkpoint_saves_total", "checkpoint_save_failures_total",
    "checkpoint_restores_total", "checkpoint_corrupt_fallbacks_total",
    "checkpoint_save_ms", "checkpoint_queue_depth",
    "checkpoint_async_saves_total", "checkpoint_save_blocked_ms",
    "checkpoint_save_overlap_ms", "checkpoint_gc_deleted_total",
    "checkpoint_mirror_copies_total", "checkpoint_mirror_failures_total",
    "checkpoint_mirror_restores_total")


def _jax_state():
    from ntxent_tpu import cli as jcli
    from ntxent_tpu.models import SimCLRModel as JaxSimCLR
    from ntxent_tpu.training.trainer import TrainerConfig as JaxConfig
    from ntxent_tpu.training.trainer import create_train_state as jax_state

    model = JaxSimCLR(encoder=jcli._make_encoder("tiny", 8),
                      proj_hidden_dim=16, proj_dim=8)
    return jax_state(model, jax.random.PRNGKey(0), (1, 8, 8, 3),
                     JaxConfig())


def _port_state():
    args = cli.build_train_parser().parse_args(
        ["--model", "tiny", "--image-size", "8", "--proj-hidden-dim", "16",
         "--proj-dim", "8"])
    return ttrain.create_train_state(cli.build_model(args),
                                     ttrain.TrainerConfig(),
                                     torch.device("cpu"))


def _corrupt(directory: Path, step: int) -> None:
    state = directory / str(step) / "state.msgpack"
    state.write_bytes(b"\0" * state.stat().st_size)


def _checkpoint_run(root, manager_cls, async_cls, state, restore,
                    events_module, registry):
    """Saves with retention and a mirror, a corrupt step in both copies,
    a corrupt primary with a good mirror, an async writer."""
    before = _series(registry, CKPT_SERIES)
    log = events_module.EventLog(None, run_id="ckpt")
    primary, mirror = root / "primary", root / "mirror"
    with _installed(events_module, log):
        manager = manager_cls(primary, max_to_keep=2, mirror_dir=mirror)
        for step in (1, 2, 3):
            assert manager.save(step, state)
        _corrupt(primary, 3)
        _corrupt(mirror, 3)
        restore(manager, state)  # 3 in every replica corrupt: back to 2
        _corrupt(primary, 2)
        restore(manager, state)  # 2's primary corrupt: from the mirror
        writer = async_cls(manager_cls(root / "async"))
        for step in (1, 2):
            writer.save(step, state)
            writer.wait_until_finished()
        writer.close()
    after = _series(registry, CKPT_SERIES)
    return _delta(before, after), [_strip(r) for r in log.tail(100)]


def test_checkpoint_series_and_events_equal_the_jax_managers(tmp_path):
    want = _checkpoint_run(tmp_path / "jax", JaxManager, JaxAsync,
                           _jax_state(), lambda m, s: m.restore(s),
                           jobs.events, jobs.default_registry())
    got = _checkpoint_run(tmp_path / "port", CheckpointManager,
                          AsyncCheckpointer, _port_state(),
                          lambda m, s: m.restore(s), obs.events,
                          obs.default_registry())
    assert got == want
    assert got[0]["checkpoint_saves_total"] == 5
    assert got[0]["checkpoint_gc_deleted_total"] == 1
    assert got[0]["checkpoint_mirror_restores_total"] == 1
    assert got[0]["checkpoint_async_saves_total"] == 2
    actions = [(r["action"], r["step"]) for r in got[1]]
    assert ("fallback", 3) in actions and ("restore", 2) in actions


def test_a_failed_save_is_counted_and_emitted(tmp_path):
    from ntxent_tpu_torch.resilience.faults import FaultInjector, FaultPlan

    injector = FaultInjector(FaultPlan.parse("diskfull@1"))
    failures = obs.default_registry().counter(
        "checkpoint_save_failures_total")
    before = failures.value
    with _installed(obs, obs.EventLog(None)) as log:
        manager = CheckpointManager(tmp_path,
                                    fault_hook=injector.on_checkpoint_write)
        assert not manager.save(1, _port_state())
    assert failures.value == before + 1
    (rec,) = [r for r in log.tail(5) if r["event"] == "checkpoint"]
    assert rec["ok"] is False and "Errno 28" in rec["error"]


# ---------------------------------------------------------------------------
# FLOPs
# ---------------------------------------------------------------------------

def _flop_count(fn, *args, **kwargs) -> float:
    counter = FlopCounterMode(display=False)
    with counter:
        fn(*args, **kwargs)
    return float(counter.get_total_flops())


def _unit(rows, d, seed):
    z = torch.from_numpy(np.random.default_rng(seed).normal(
        size=(rows, d)).astype(np.float32))
    return z / z.norm(dim=1, keepdim=True)


def _kernel_cases() -> dict:
    """{kernel: (plain call, the wrapper's tally, the tally's share of the
    plain version's FLOPs)}."""
    rows, d = 128, 24  # whole 64-column blocks of the triangular plain code
    z = _unit(rows, d, 0)
    _, lse = ntxent.ntxent_fwd_plain(z, 0.1)
    zr, gid = z[:32], torch.arange(32, dtype=torch.int32)
    cgid = torch.arange(rows, dtype=torch.int32)
    _, lse_r = ntxent.ntxent_fwd_general_plain(zr, z, gid, 0.1)
    lr, lc = ntxent.block_lse_dual_plain(zr, z, gid, cgid, 0.1, rows)
    za, zb, scale = _unit(48, d, 1), _unit(48, d, 2), torch.tensor(12.0)
    _, la, lb = infonce.infonce_dual_fwd_plain(za, zb, scale)
    zs, sgid = za[:16], torch.arange(16, dtype=torch.int32)
    ls, _ = infonce.infonce_dual_fwd_rect_plain(zs, zb, scale)
    bh, lq, lk, hd = 4, 20, 28, 64
    q = torch.randn(bh, lq, hd)
    k, v = torch.randn(bh, lk, hd), torch.randn(bh, lk, hd)
    do = torch.randn(bh, lq, hd)
    o, alse = attention.attention_plain(q, k, v)
    delta = (o * do).sum(-1)
    carry = (torch.full((bh, lq), -1e30), torch.zeros(bh, lq),
             torch.zeros(bh, lq, hd))
    cases = [
        ("#1", lambda: ntxent.ntxent_fwd_plain(z, 0.1),
         flops.scores(rows, rows, d), 1.0),
        ("#1 general", lambda: ntxent.ntxent_fwd_general_plain(
            zr, z, gid, 0.1), flops.scores(32, rows, d), 1.0),
        ("#2", lambda: ntxent.ntxent_fwd_tri_plain(z, 0.1),
         flops.triangle_fwd(rows, d), 0.5),
        ("#3", lambda: ntxent.ntxent_bwd_tri_plain(z, lse, 0.1),
         flops.triangle_bwd(rows, d), 0.75),
        ("#4", lambda: infonce.infonce_bwd_cols_plain(
            zs, zb, sgid, scale, ls, lb), flops.scores_and_product(16, 48, d),
         1.0),
        ("#5", lambda: ntxent.ntxent_bwd_sym_plain(z, lse, 0.1),
         flops.scores_and_product(rows, rows, d), 1.0),
        ("#5 cross-modal", lambda: infonce.infonce_bwd_rows_plain(
            zs, zb, sgid, scale, ls, lb), flops.scores_and_product(16, 48, d),
         1.0),
        ("#6 rows", lambda: ntxent.ntxent_bwd_general_rows_plain(
            zr, z, gid, lse_r, 0.1), flops.scores_and_product(32, rows, d),
         1.0),
        ("#6 cols", lambda: ntxent.ntxent_bwd_general_cols_plain(
            zr, z, gid, lse_r, 0.1), flops.scores_and_product(32, rows, d),
         1.0),
        ("#7", lambda: ntxent.block_lse_dual_plain(zr, z, gid, cgid, 0.1,
                                                    rows),
         flops.scores(32, rows, d), 1.0),
        ("#8", lambda: ntxent.block_grads_dual_plain(
            zr, z, gid, cgid, lr, lc, 0.1, rows),
         flops.scores_and_products(32, rows, d), 1.0),
        ("#9", lambda: infonce.infonce_dual_fwd_plain(za, zb, scale),
         flops.scores(48, 48, d), 1.0),
        ("#9 rectangular", lambda: infonce.infonce_dual_fwd_rect_plain(
            zs, zb, scale), flops.scores(16, 48, d), 1.0),
        ("#10", lambda: infonce.infonce_dual_bwd_plain(za, zb, scale, la,
                                                        lb),
         flops.scores_and_products(48, 48, d), 1.0),
        ("#11", lambda: attention.attention_plain(q, k, v),
         flops.flash_fwd(bh, lq, lk, hd), 1.0),
        ("#12", lambda: attention.flash_fold_plain(q, k, v, *carry),
         flops.flash_fwd(bh, lq, lk, hd), 1.0),
        ("#13", lambda: attention.attention_dq_plain(q, k, v, do, alse,
                                                      delta),
         flops.flash_dq(bh, lq, lk, hd), 1.0),
        ("#14", lambda: attention.attention_dkv_plain(q, k, v, do, alse,
                                                       delta),
         flops.flash_dkv(bh, lq, lk, hd), 1.0),
    ]
    return {name: rest for name, *rest in cases}


KERNELS = ["#1", "#1 general", "#2", "#3", "#4", "#5", "#5 cross-modal",
           "#6 rows", "#6 cols", "#7", "#8", "#9", "#9 rectangular", "#10",
           "#11", "#12", "#13", "#14"]


@pytest.mark.parametrize("kernel", KERNELS)
def test_kernel_flop_tally_is_its_plain_versions_count(kernel):
    plain, tally, share = _kernel_cases()[kernel]
    assert tally == pytest.approx(share * _flop_count(plain), rel=1e-12)


def test_the_tally_counts_open_counts_on_any_thread():
    flops.add(1e9)  # nothing open: dropped
    with flops.counting() as outer:
        flops.add(5.0)
        with flops.counting() as inner:
            worker = threading.Thread(target=flops.add, args=(7.0,))
            worker.start()
            worker.join()
    assert (outer.flops, inner.flops) == (12.0, 7.0)


def test_a_cpu_tensor_adds_nothing_to_the_tally():
    """On the CPU the wrappers run their plain versions, which the aten
    counter sees; the tally is only for launches."""
    z = _unit(64, 16, 3)
    with flops.counting() as tally, FlopCounterMode(display=False) as aten:
        loss = ntxent.ntxent_loss_fused(z.requires_grad_(), 0.1)
        loss.backward()
    assert tally.flops == 0.0
    assert aten.get_total_flops() == flops.scores(64, 64, 16) \
        + flops.scores_and_product(64, 64, 16)


def _views(seed):
    rng = np.random.default_rng(seed)
    return [rng.uniform(size=(BATCH, IMAGE, IMAGE, 3)).astype(np.float32)
            for _ in range(2)]


@pytest.mark.parametrize("remat", [False, True], ids=["plain", "remat"])
def test_a_tiny_vit_steps_flops_against_xla(remat):
    """The step's FLOPs against XLA's cost analysis of the JAX step: 0.75
    to 1.0 of it (XLA also counts element-wise work); ``--remat``'s
    recompute counted as XLA counts the program it runs."""
    from ntxent_tpu.training.trainer import TrainerConfig as JaxConfig
    from ntxent_tpu.training.trainer import compiled_step_flops
    from ntxent_tpu.training.trainer import create_train_state as jax_state
    from ntxent_tpu.training.trainer import make_train_step as jax_step

    jmodel, variables = _tiny_jax_simclr("xla")
    jstate = jax_state(jmodel, jax.random.PRNGKey(0), (1, IMAGE, IMAGE, 3),
                       JaxConfig(batch_size=BATCH))
    v1, v2 = _views(0)
    want = compiled_step_flops(jax_step(0.2, remat=remat), jstate,
                               jnp.asarray(v1), jnp.asarray(v2))
    model = load_flax_variables(_tiny_port_simclr("xla"), variables)
    state = ttrain.create_train_state(
        model, ttrain.TrainerConfig(batch_size=BATCH), torch.device("cpu"))
    with ttrain.count_step_flops() as count:
        ttrain.make_train_step(0.2, remat=remat)(
            state, torch.from_numpy(v1), torch.from_numpy(v2))
    assert 0.75 * want <= count.flops <= want, (count.flops, want)
    if remat:
        with ttrain.count_step_flops() as plain:
            ttrain.make_train_step(0.2)(
                state, torch.from_numpy(v1), torch.from_numpy(v2))
        assert count.flops > 1.2 * plain.flops  # one more forward


# ---------------------------------------------------------------------------
# train_loop(timeline=) and fit(timeline=)
# ---------------------------------------------------------------------------

class _Batches:
    """Views of a tiny ViT step, with the prefetcher's ``last_timing``."""

    def __init__(self, timed=False):
        self.i, self.timed = 0, timed

    def __next__(self):
        self.i += 1
        return tuple(torch.from_numpy(v) for v in _views(self.i))

    def __iter__(self):
        return self

    def last_timing(self):
        return (0.001, 0.0005)


def _tiny_state():
    """A tiny ViT SimCLR state with weights drawn from a seed."""
    model = init_weights(_tiny_port_simclr("xla"),
                         torch.Generator().manual_seed(0))
    return ttrain.create_train_state(
        model, ttrain.TrainerConfig(batch_size=BATCH), torch.device("cpu"))


def _loop(monkeypatch, steps=3, timeline=None, start=0, **kwargs):
    """train_loop of a tiny ViT; returns (history, the syncs it made)."""
    syncs = []
    real_sync = ttrain._sync
    monkeypatch.setattr(ttrain, "_sync",
                        lambda device: (syncs.append(1), real_sync(device)))
    state = _tiny_state()
    state.step = start
    data = kwargs.pop("data", None) or _Batches()
    history = ttrain.train_loop(state, data, ttrain.make_train_step(0.2),
                                steps, log_every=1, timeline=timeline,
                                **kwargs)
    return history, len(syncs)


def test_without_a_timeline_the_loop_adds_no_sync_and_no_count(
        monkeypatch):
    def refuse():
        raise AssertionError("counted without a timeline")

    monkeypatch.setattr(ttrain, "count_step_flops", refuse)
    for lag in (0, 1):
        history, syncs = _loop(monkeypatch, metrics_lag=lag)
        assert syncs == 1  # the loop's entry, as before
        assert len(history) == 3 and "mfu" not in history[0]


@pytest.mark.parametrize("lag", [0, 1], ids=["sync", "lag1"])
def test_the_timeline_records_every_step(monkeypatch, lag):
    """Global step numbers, one compile event with step 1's FLOPs, every
    step's fields; a sync a step on the synchronous path only."""
    registry = obs.MetricsRegistry()
    timeline = obs.StepTimeline(registry=registry)
    with _installed(obs, obs.EventLog(None)) as log:
        history, syncs = _loop(monkeypatch, timeline=timeline, start=5,
                               metrics_lag=lag, data=_Batches(timed=True))
    records = log.tail(50)
    (compile_rec,) = [r for r in records if r["event"] == "compile"]
    steps = [r for r in records if r["event"] == "step"]
    assert [r["step"] for r in steps] == [6, 7, 8]
    assert compile_rec["flops"] > 0
    assert timeline.flops_per_step == compile_rec["flops"]
    for rec in steps:
        assert {"data_wait_ms", "host_fetch_ms", "transfer_ms", "device_ms",
                "checkpoint_ms", "steps_per_sec", "mfu"} <= set(rec)
        assert rec["transfer_ms"] == 0.5 and rec["device_ms"] > 0
    assert registry.collect()["train_steps_total"] == 3
    assert registry.collect()["train_compiles_total"] == 1
    assert all(h["mfu"] > 0 for h in history)
    # entry + step 1's count, and on the synchronous path one a step
    assert syncs == (2 + 3 if not lag else 2)


def test_a_guarded_timeline_carries_the_outcome(monkeypatch):
    """``ok`` and ``grad_norm`` of the guarded step ride the step events;
    the guard's own divergence events stand for the timeline's."""
    timeline = obs.StepTimeline(registry=obs.MetricsRegistry())
    guard = DivergenceGuard(backoff_after=None, rollback_after=None)
    state = _tiny_state()

    class Poisoned(_Batches):
        def __next__(self):
            v1, v2 = super().__next__()
            return (v1 * float("nan"), v2) if self.i == 2 else (v1, v2)

    with _installed(obs, obs.EventLog(None)) as log:
        ttrain.train_loop(state, Poisoned(),
                          ttrain.make_train_step(0.2, guard=True), 3,
                          step_guard=guard, timeline=timeline)
    steps = [r for r in log.tail(50) if r["event"] == "step"]
    assert [r["ok"] for r in steps] == [True, False, True]
    assert all("grad_norm" in r for r in steps)
    div = [r for r in log.tail(50) if r["event"] == "divergence"]
    assert [(r["action"], r["guarded"]) for r in div] == [("skip", True)]


def test_fit_hands_its_timeline_to_the_loop_and_restarts_reset_it(
        monkeypatch, tmp_path):
    timeline = obs.StepTimeline(registry=obs.MetricsRegistry())
    calls = []
    real = timeline.new_attempt
    monkeypatch.setattr(timeline, "new_attempt",
                        lambda: (calls.append(1), real()))
    state = _tiny_state()
    with _installed(obs, obs.EventLog(None)) as log:
        ttrain.fit(state, _Batches(), ttrain.make_train_step(0.2), 2,
                   checkpoint_dir=str(tmp_path), checkpoint_every=1,
                   timeline=timeline)
    assert calls == [1]
    names = [r["event"] for r in log.tail(50)]
    assert names.count("step") == 2 and names.count("checkpoint") == 2


def test_measure_comms_overlap_publishes_on_the_timeline(tmp_path):
    """In a gloo world of one the A/B runs and its result lands in the
    overlap gauges and one ``comms_overlap`` event."""
    from ntxent_tpu_torch.parallel import mesh

    registry = obs.MetricsRegistry()
    timeline = obs.StepTimeline(registry=registry)
    mesh.init_from_file(str(tmp_path / "store"), 0, 1, device="cpu")
    try:
        with _installed(obs, obs.EventLog(None)) as log:
            result = ttrain.measure_comms_overlap(
                None, 8, 16, repeats=1, warmup=1, ring_chunks=2,
                timeline=timeline)
    finally:
        mesh.shutdown()
    (rec,) = [r for r in log.tail(5) if r["event"] == "comms_overlap"]
    assert rec["chunks"] == result["chunks"] == 2
    assert rec["monolithic_ms"] == round(result["monolithic_ms"], 3)
    snap = registry.collect()
    assert snap["train_step_comms_overlap_ms"] == result["overlap_ms"]


# ---------------------------------------------------------------------------
# device memory
# ---------------------------------------------------------------------------

def test_device_memory_tracker_on_the_cpu(tmp_path):
    """The CPU has no device statistics: the JAX package's keys on the
    card, an empty sample here, and the profile saves either way."""
    assert memory.device_memory_mb("cpu") == {}
    tracker = memory.DeviceMemoryTracker("cpu")
    assert tracker.log_memory("start") == {"step": "start"}
    path = tracker.save_profile(tmp_path / "memory_profile.json")
    assert json.loads(path.read_text()) == [{"step": "start"}]
    assert [key for _, key in memory._KEYS] == [
        "allocated_mb", "peak_allocated_mb", "reserved_mb"]


# ---------------------------------------------------------------------------
# the CLI's telemetry flags against the JAX CLI's
# ---------------------------------------------------------------------------

CLI_FLAGS = ["--model", "tiny", "--image-size", "8", "--batch", "8",
             "--steps", "20", "--metrics-port", "0", "--chaos",
             "nan@3,fetch@2", "--log-every", "5"]
CLI_LIMIT_S = 240.0


def _child(argv, log_path: Path):
    env = dict(os.environ, OMP_NUM_THREADS="1", JAX_PLATFORMS="cpu",
               PYTHONPATH=str(REPO))
    env.pop("XLA_FLAGS", None)  # one CPU device: the JAX CLI's one card
    return subprocess.Popen([sys.executable, *argv], cwd=str(REPO), env=env,
                            stdout=subprocess.DEVNULL,
                            stderr=open(log_path, "w"))


def _scrape_mid_run(proc, log_path: Path) -> tuple[str, dict]:
    """Poll the endpoint until the run's counters moved (the injected
    faults included); the server dies with the run, so a scrape that
    shows them was taken mid-run."""
    deadline = time.monotonic() + CLI_LIMIT_S
    port = None
    while port is None and time.monotonic() < deadline:
        for line in log_path.read_text().splitlines():
            if "metrics endpoint: http://127.0.0.1:" in line:
                port = int(line.split("127.0.0.1:")[1].split("/")[0])
        if proc.poll() is not None and port is None:
            raise AssertionError(log_path.read_text()[-2000:])
        time.sleep(0.02)
    base = f"http://127.0.0.1:{port}/metrics"
    while time.monotonic() < deadline and proc.poll() is None:
        try:
            with urllib.request.urlopen(base + "?format=json",
                                        timeout=5) as resp:
                snap = json.loads(resp.read())
            if snap.get("train_steps_total", 0) >= 3 \
                    and snap.get("retries_total", 0) >= 1 \
                    and snap.get("train_divergence_total", 0) >= 1:
                with urllib.request.urlopen(base, timeout=5) as resp:
                    return resp.read().decode(), snap
        except OSError:
            pass
        time.sleep(0.005)
    raise AssertionError("no mid-run scrape with the run's counters: "
                         + log_path.read_text()[-2000:])


def test_train_telemetry_flags_against_the_jax_cli(tmp_path):
    """``train ... --metrics-port 0 --log-jsonl --chaos 'nan@3,fetch@2'``
    (after ``scripts/obs_smoke.sh``): a mid-run scrape in both formats,
    then the same event names (and counts) and step-event keys as the JAX
    CLI's run of the same flags; its loss curve, its Chrome trace."""
    jax_log = tmp_path / "jax.jsonl"
    jax_run = _child(["-m", "ntxent_tpu.cli", "--platform", "cpu",
                      *CLI_FLAGS, "--log-jsonl", str(jax_log)],
                     tmp_path / "jax.log")
    port_log = tmp_path / "port.jsonl"
    port_run = _child(["-m", "ntxent_tpu_torch.cli", "train", "--device",
                       "cpu", *CLI_FLAGS, "--log-jsonl", str(port_log)],
                      tmp_path / "port.log")
    try:
        text, snap = _scrape_mid_run(port_run, tmp_path / "port.log")
        assert port_run.wait(CLI_LIMIT_S) == 0
        assert jax_run.wait(CLI_LIMIT_S) == 0
    finally:
        for proc in (jax_run, port_run):
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    for name in ("train_steps_total", "train_step_device_ms", "train_mfu",
                 "retries_total", "train_divergence_total"):
        assert f"\n{name}" in "\n" + text or f"# TYPE {name}" in text, name
        assert name in snap
    want = [json.loads(x) for x in jax_log.read_text().splitlines()]
    got = [json.loads(x) for x in port_log.read_text().splitlines()]
    assert Counter(r["event"] for r in got) \
        == Counter(r["event"] for r in want)
    keys = {frozenset(r) for r in got if r["event"] == "step"}
    assert keys == {frozenset(r) for r in want if r["event"] == "step"}
    losses = crashsim.losses_from_jsonl(port_log)
    assert losses.keys() == set(range(1, 21))
    assert all(np.isfinite(losses[s]) for s in (1, 2))
    assert str(losses) == str(jcrashsim.losses_from_jsonl(port_log))
    assert crashsim.losses_from_jsonl(tmp_path / "missing.jsonl") == {}
    from ntxent_tpu_torch.obs import trace

    out = tmp_path / "trace.json"
    assert trace.main([str(port_log), "-o", str(out)]) == 0
    events = json.loads(out.read_text())["traceEvents"]
    assert sum(e.get("cat") == "step" for e in events) == 20
