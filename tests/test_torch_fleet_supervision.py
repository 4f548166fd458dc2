"""Supervision of the port's serving fleet on the CPU: ``ServingFleet``
over stdlib fake worker processes, the chaos fleet actions, attach mode,
two routers over one pool, the autoscaler's drain against real processes,
the shadow mirror's verdicts, and the training timeline's history.

Workers here are ``torch_fleet_fakes.FAKE_WORKER`` subprocesses (they
publish a port file and answer ``/readyz``, as the port's serve does under
``--port-file``) or in-process ``FakeWorker`` servers; no model runs. The
port's serve workers run in ``test_torch_fleet_e2e.py``. Every wait is
bounded (``tick_until`` and the ``_wait`` helpers), so a hang fails its
case instead of cutting the run.
"""

from __future__ import annotations

import math
import os
import signal
import time

import pytest

from ntxent_tpu.obs import history as j_history
from ntxent_tpu.obs.timeline import StepTimeline as JaxStepTimeline
from ntxent_tpu.resilience import FaultInjector as JaxInjector
from ntxent_tpu.resilience import FaultPlan as JaxPlan
from ntxent_tpu_torch.obs import events
from ntxent_tpu_torch.obs.history import MetricHistory
from ntxent_tpu_torch.obs.registry import MetricsRegistry
from ntxent_tpu_torch.obs.timeline import StepTimeline
from ntxent_tpu_torch.resilience import FaultInjector, FaultPlan
from ntxent_tpu_torch.resilience.retry import RetryPolicy
from ntxent_tpu_torch.serving import (
    AutoscaleController,
    FleetRouter,
    ServingFleet,
    ShadowMirror,
    WorkerPool,
)

from torch_fleet_fakes import (
    FakeClock,
    FakeWorker,
    fake_worker_cmd,
    pool_with,
    post,
    tick_until,
)

pytestmark = pytest.mark.fleet


def _fleet(tmp_path, n=1, **kw):
    kw.setdefault("backoff", RetryPolicy(max_attempts=10, base_delay_s=0.05,
                                         multiplier=1.0, jitter=0.0))
    return ServingFleet(fake_worker_cmd, n_workers=n,
                        workdir=tmp_path / "fleet", poll_s=0.1,
                        health_timeout_s=2.0, **kw)


def _ready(fleet, n=None):
    want = len(fleet.workers_snapshot()) if n is None else n
    return lambda: sum(1 for w in fleet.pool.workers() if w.ready) == want


def _wait(predicate, timeout_s=10.0):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if predicate():
            return True
        time.sleep(0.02)
    return False


# ---------------------------------------------------------------------------
# spawn, probe, restart, eject


def test_spawns_and_reports_ready(tmp_path):
    fleet = _fleet(tmp_path, n=2)
    for w in fleet.workers:
        fleet._spawn(w)
    try:
        assert tick_until(fleet, _ready(fleet, 2))
        assert {w.checkpoint_step for w in fleet.pool.workers()} == {1}
        assert int(fleet._spawns.value) == 2
    finally:
        fleet.stop()
    assert all(w.proc.poll() is not None for w in fleet.workers)


def test_a_sigkilled_worker_restarts_with_a_flight_dump(tmp_path):
    log = events.EventLog(str(tmp_path / "router.jsonl"), run_id="r")
    events.install(log)
    fleet = _fleet(tmp_path, n=1, eject_after=3)
    worker = fleet.workers[0]
    fleet._spawn(worker)
    try:
        assert tick_until(fleet, _ready(fleet))
        for _ in range(3):  # the router saw the worker die mid-forward
            fleet.pool.report_failure(worker.worker_id, "connection reset")
        first_pid = worker.pid
        os.kill(first_pid, signal.SIGKILL)
        worker.proc.wait(5.0)
        fleet.tick()  # the death: not ready, a restart scheduled
        assert not fleet.pool.workers()[0].ready and worker.restarts == 1
        assert tick_until(fleet, _ready(fleet))
        assert worker.pid != first_pid and worker.restarts == 1
        assert int(fleet._worker_restarts.value) == 1
        assert int(fleet._ejections.value) == 0  # failures were cleared
    finally:
        fleet.stop()
        events.install(None)
        log.close()
    actions = [r["action"] for r in events.read_events(
        str(tmp_path / "router.jsonl"), "fleet")]
    assert actions[:4] == ["spawn", "death", "restart_scheduled", "spawn"]
    dumps = sorted(tmp_path.glob("flight_*.jsonl"))
    assert dumps, "no flight dump at the worker's death"
    header = events.read_events(str(dumps[0]), "flight")[0]
    assert header["reason"].startswith("worker_death:w0:")


def test_forward_failures_eject_a_probe_passing_worker(tmp_path):
    fleet = _fleet(tmp_path, n=1, eject_after=3)
    worker = fleet.workers[0]
    fleet._spawn(worker)
    try:
        assert tick_until(fleet, _ready(fleet))
        for _ in range(3):
            fleet.pool.report_failure(worker.worker_id, "http 500")
        fleet.tick()  # the probe passes; the eject check still fires
        assert int(fleet._ejections.value) == 1 and worker.restarts == 1
        assert tick_until(fleet, _ready(fleet))
    finally:
        fleet.stop()


def test_a_failed_spawn_reschedules_until_the_budget_rules(tmp_path):
    fleet = ServingFleet(
        lambda wid, pf: ["/nonexistent-binary-xyzzy"], n_workers=1,
        workdir=tmp_path / "fleet", poll_s=0.05, max_restarts=2,
        backoff=RetryPolicy(max_attempts=10, base_delay_s=0.01,
                            multiplier=1.0, jitter=0.0))
    worker = fleet.workers[0]
    fleet._spawn(worker)  # fails, must not raise
    assert worker.proc is None and worker.restart_at is not None
    deadline = time.monotonic() + 10.0
    while worker.restarts <= fleet.max_restarts \
            and time.monotonic() < deadline:
        fleet.tick()
        time.sleep(0.02)
    assert worker.restarts == fleet.max_restarts + 1
    assert worker.restart_at is None and worker.proc is None


# ---------------------------------------------------------------------------
# chaos fleet actions


@pytest.mark.parametrize("spec", ["killworker@3,slowworker@5,spike@2",
                                  "drainworker@1,killworker@1", ""])
def test_on_fleet_tick_dispenses_what_the_jax_injector_does(spec):
    port, jax = FaultInjector(FaultPlan.parse(spec)), \
        JaxInjector(JaxPlan.parse(spec))
    for _ in range(7):
        assert port.on_fleet_tick() == jax.on_fleet_tick()
    assert port.fired == jax.fired
    assert port.on_batch((1,)) == (1,)  # fleet actions never hit batches


def test_killworker_and_slowworker_fire_on_their_ticks(tmp_path):
    inj = FaultInjector(FaultPlan.parse("killworker@2,slowworker@4"))
    fleet = _fleet(tmp_path, n=2, injector=inj, slowworker_s=0.5,
                   eject_after=1000)
    for w in fleet.workers:
        fleet._spawn(w)
    try:
        assert tick_until(fleet, _ready(fleet, 2))
        # armed: the ticks count from here
        killed = fleet.workers[0]
        # the process, not ``killed.proc``: the tick that kills it may reap
        # it too and clear ``proc`` for the restart
        first_pid, first_proc = killed.pid, killed.proc
        fleet.tick()
        fleet.tick()  # tick 2: SIGKILL w0 (round-robin from the first)
        assert inj.fired == ["killworker@2"]
        assert _wait(lambda: first_proc.poll() is not None)
        fleet.tick()
        fleet.tick()  # tick 4: SIGSTOP a live worker
        assert inj.fired == ["killworker@2", "slowworker@4"]
        slowed = next(w for w in fleet.workers if w.slow_until is not None)
        assert tick_until(fleet, lambda: slowed.slow_until is None,
                          timeout_s=5.0)  # SIGCONT after slowworker_s
        assert tick_until(fleet, _ready(fleet, 2))
        assert killed.pid != first_pid and killed.restarts == 1
        assert slowed.proc.poll() is None
    finally:
        fleet.stop()


def test_a_probe_that_times_out_marks_a_live_worker_busy(tmp_path):
    """The port's probe (a stated difference from JAX's, whose pool then
    picks nothing and whose log says nothing): a live worker whose /readyz
    times out is not ready but busy, logged as a ``probe_timeout``, and
    the pool still routes to it when no ready worker remains; the next
    probe that answers clears it."""
    log = events.EventLog(str(tmp_path / "router.jsonl"))
    events.install(log)
    fleet = ServingFleet(fake_worker_cmd, n_workers=1,
                         workdir=tmp_path / "fleet", poll_s=0.1,
                         health_timeout_s=0.3, eject_after=1000,
                         backoff=RetryPolicy(max_attempts=10,
                                             base_delay_s=0.05,
                                             multiplier=1.0, jitter=0.0))
    worker = fleet.workers[0]
    fleet._spawn(worker)
    try:
        assert tick_until(fleet, _ready(fleet, 1))
        os.kill(worker.pid, signal.SIGSTOP)  # the listener stops answering
        try:
            fleet._probe(worker)
            [entry] = fleet.pool.workers()
            assert entry.alive and entry.busy and not entry.ready
            picked = fleet.pool.pick()
            assert picked is not None and picked.worker_id == "w0"
            fleet.pool.done("w0")
        finally:
            os.kill(worker.pid, signal.SIGCONT)
        assert tick_until(fleet, _ready(fleet, 1))
        assert not fleet.pool.workers()[0].busy
    finally:
        fleet.stop()
        events.install(None)
        log.close()
    timeouts = [r for r in events.read_events(
        str(tmp_path / "router.jsonl"), "fleet")
        if r["action"] == "probe_timeout"]
    assert [(r["worker"], r["timeout_s"]) for r in timeouts] == [("w0", 0.3)]


def test_drainworker_and_spike_need_their_hooks(tmp_path):
    inj = FaultInjector(FaultPlan.parse("spike@1,drainworker@2"))
    fleet = _fleet(tmp_path, n=2, injector=inj)
    for w in fleet.workers:
        fleet._spawn(w)
    crowds = []
    try:
        assert tick_until(fleet, _ready(fleet, 2))
        fleet.tick()  # spike without a hook: logged, nothing happens
        fleet.on_spike = crowds.append
        ctl = AutoscaleController(fleet, fleet.pool, registry=fleet.registry,
                                  min_workers=1, max_workers=2,
                                  idle_ticks=10**6)
        fleet.autoscaler = ctl
        fleet.tick()  # drainworker: the highest ordinal drains
        assert inj.fired == ["spike@1", "drainworker@2"]
        assert ctl.snapshot()["draining"] == {"w1": {"reason": "chaos"}}
        assert [w.worker_id for w in fleet.pool.workers()
                if not w.draining] == ["w0"]
        victim = fleet.workers[1]
        ctl.observe(MetricsRegistry())  # zero in flight: retired
        assert [w.worker_id for w in fleet.workers_snapshot()] == ["w0"]
        assert _wait(lambda: victim.proc.poll() is not None)
        assert crowds == []
    finally:
        fleet.stop()


def test_a_drain_waits_for_zero_in_flight_before_the_sigterm(tmp_path):
    fleet = _fleet(tmp_path, n=2)
    for w in fleet.workers:
        fleet._spawn(w)
    clock = FakeClock()
    try:
        assert tick_until(fleet, _ready(fleet, 2))
        ctl = AutoscaleController(fleet, fleet.pool, registry=fleet.registry,
                                  min_workers=1, max_workers=3,
                                  drain_deadline_s=60.0, clock=clock)
        entry = fleet.pool.pick(exclude={"w0"})  # one request on w1
        assert entry.worker_id == "w1"
        assert ctl.force_drain(reason="test") == "w1"
        ctl.observe(MetricsRegistry())
        victim = fleet.workers[1]
        assert victim.proc.poll() is None  # still busy: not retired
        fleet.pool.done("w1")
        clock.advance(1.0)
        ctl.observe(MetricsRegistry())
        assert [w.worker_id for w in fleet.workers_snapshot()] == ["w0"]
        assert _wait(lambda: victim.proc.poll() is not None)
        assert victim.proc.returncode == -signal.SIGTERM
        # scale-up through the same supervision path: a fresh ordinal
        added = fleet.add_worker()
        assert added.worker_id == "w2"
        assert tick_until(fleet, _ready(fleet, 2))
    finally:
        fleet.stop()


# ---------------------------------------------------------------------------
# replica routers


def test_attach_probes_without_owning_the_processes(tmp_path):
    primary = _fleet(tmp_path, n=1)
    worker = primary.workers[0]
    primary._spawn(worker)
    try:
        assert tick_until(primary, _ready(primary))
        replica = ServingFleet(fake_worker_cmd, n_workers=1,
                               workdir=tmp_path / "fleet", poll_s=0.1,
                               attach=True)
        assert [w.worker_id for w in replica.workers] == ["w0"]
        assert tick_until(replica, _ready(replica))
        assert int(replica._spawns.value) == 0
        assert replica.add_worker() is None
        first_pid = worker.pid
        os.kill(first_pid, signal.SIGKILL)
        worker.proc.wait(5.0)
        assert tick_until(replica, lambda: not any(
            w.ready for w in replica.pool.workers()))
        assert replica.workers[0].restarts == 0
        assert tick_until(primary, _ready(primary))  # a new port
        assert worker.pid != first_pid
        assert tick_until(replica, _ready(replica))
        replica.stop()
        assert worker.alive()  # the replica leaves the primary's process
    finally:
        primary.stop()


def test_two_routers_over_one_pool_converge():
    w0, w1 = FakeWorker(step=1), FakeWorker(step=1)
    pools = [pool_with(WorkerPool, {"w0": w0, "w1": w1}, canary_fraction=1.0,
                       canary_min_requests=2, canary_max_error_rate=0.5)
             for _ in range(2)]
    routers = []
    try:
        for pool in pools:
            routers.append(FleetRouter(pool, example_shape=(2,), port=0,
                                       retries=2,
                                       forward_timeout_s=10.0).start())
        urls = [f"http://127.0.0.1:{r.port}/embed" for r in routers]
        for url in urls:
            assert post(url, {"inputs": [[0.5, 0.5]]})[0] == 200
        w1.step = 2
        for pool in pools:
            pool.set_health("w1", alive=True, ready=True, checkpoint_step=2)
        for url, pool in zip(urls, pools):
            for i in range(8):
                assert post(url, {"inputs": [[float(i), 1.0]]})[0] == 200
                if pool.trusted_step == 2:
                    break
        assert [p.trusted_step for p in pools] == [2, 2]
        w0.close()
        for url in urls:
            status, body, _ = post(url, {"inputs": [[500.0, 1.0]]})
            assert status == 200 and body["embeddings"][0][0] == 2.0
    finally:
        for router in routers:
            router.close()
        w1.close()


# ---------------------------------------------------------------------------
# shadow drift


@pytest.mark.parametrize("sign,verdict", [(1.0, "promote"),
                                          (-1.0, "rollback")])
def test_the_shadow_mirror_judges_the_canary_by_drift(sign, verdict):
    trusted, canary = FakeWorker(step=1), FakeWorker(step=2)
    canary.sign = sign
    pool = pool_with(WorkerPool, {"w0": trusted}, canary_fraction=0.5,
                     canary_min_requests=4, shadow_max_drift=0.5,
                     shadow_min_samples=4)
    router = FleetRouter(pool, example_shape=(2,), port=0, retries=1,
                         warm_rows=0).start()
    mirror = ShadowMirror(pool, fraction=1.0).start()
    router.attach_shadow(mirror)
    url = f"http://127.0.0.1:{router.port}/embed"
    try:
        pool.upsert("w1", canary.url)
        pool.set_health("w1", alive=True, ready=True, checkpoint_step=2)
        for i in range(40):
            assert post(url, {"inputs": [[float(i), 1.0]] * 2})[0] == 200
            if pool.trusted_step == 2 or pool.bad_steps:
                break
            time.sleep(0.02)
        assert _wait(lambda: pool.trusted_step == 2 or pool.bad_steps)
        last = pool.last_verdict
        if verdict == "promote":
            assert pool.trusted_step == 2 and last["drift_p99"] == 0.0
        else:
            assert pool.bad_steps == {2} and last["reason"] == "shadow_drift"
            assert last["drift_p99"] == pytest.approx(2.0)
            assert _wait(lambda: canary.rollbacks == [{"step": 2}])
            assert router.alerts.snapshot()["firing"] == ["canary_rollback"]
        assert mirror.snapshot()["mirrored"] >= 2
        assert all(r == {"step": 2} for r in trusted.rollbacks)
    finally:
        mirror.stop()
        router.close()
        trusted.close()
        canary.close()


# ---------------------------------------------------------------------------
# the training timeline's history


def test_the_step_timeline_records_into_a_history_as_jax_does(tmp_path):
    """``StepTimeline(history=)``: the same three series the JAX timeline
    records, the device ms and losses equal (steps/s is the wall clock's),
    a non-finite loss dropped, the spill written when due."""
    recorded = {}
    for name, timeline_cls, history_cls in (
            ("jax", JaxStepTimeline, j_history.MetricHistory),
            ("port", StepTimeline, MetricHistory)):
        clock = FakeClock()
        hist = history_cls(spill_dir=str(tmp_path / name),
                           spill_interval_s=2.0, clock=clock)
        tl = timeline_cls(registry=MetricsRegistry() if name == "port"
                          else None, history=hist)
        for step, loss in enumerate((2.0, 1.5, float("nan"), 1.25), 1):
            clock.advance(1.0)
            tl.record_step(step, loss, data_wait_s=0.001,
                           device_s=0.010 * step)
        recorded[name] = hist
    port, jax = recorded["port"], recorded["jax"]
    assert port.series_names() == jax.series_names() == [
        "train_loss", "train_step_device_ms", "train_steps_per_sec"]
    for series in ("train_loss", "train_step_device_ms"):
        assert [p["value"] for p in port.query(series)["points"]] == \
            [p["value"] for p in jax.query(series)["points"]]
    assert [p["value"] for p in port.query("train_loss")["points"]] == [
        2.0, 1.5, 1.25]
    assert all(math.isfinite(p["value"]) and p["value"] > 0 for p in
               port.query("train_steps_per_sec")["points"])
    assert (tmp_path / "port" / "history.json").exists()
