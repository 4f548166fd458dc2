"""The port's shard plane against the JAX package's: ``ShardFanout`` over
in-process ``ShardServer``s, a dead shard's rows journaled and repaired,
the versioned plane, the client's cooldowns, the shard fleet's chaos
channel and the plane's width check.

The same numpy rows go through a plane of each package, and through a
plane that mixes them (the port's fan-out over one JAX shard and one of
the port's, and the reverse): the HTTP wire is the JAX package's, so the
answers are equal exactly.
"""

from __future__ import annotations

import json
import logging
import socket
import sys
import time
import urllib.request

import numpy as np
import pytest

import ntxent_tpu.retrieval as J
import ntxent_tpu_torch.retrieval as P
from ntxent_tpu.resilience import FaultInjector as JaxInjector
from ntxent_tpu.resilience import FaultPlan as JaxPlan
from ntxent_tpu_torch.obs import events
from ntxent_tpu_torch.resilience import FaultInjector, FaultPlan, RetryPolicy
from ntxent_tpu_torch.serving.fleet import ServingFleet

DIM = 16


def unit_rows(n, seed=0, dim=DIM):
    r = np.random.RandomState(seed)
    x = r.randn(n, dim).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def _plane(fan_pkg, server_pkgs, journal_dir, step=100, n_rows=768):
    """A trained fan-out over live shard servers (exhaustive probing, so
    recall moves only with the rows a shard holds)."""
    servers = [m.ShardServer(DIM).start() for m in server_pkgs]
    fan = fan_pkg.ShardFanout([s.url for s in servers], dim=DIM,
                              train_rows=256, n_centroids=16, nprobe=16,
                              pq_m=8, journal_dir=journal_dir,
                              cooldown_s=0.2)
    fan.activate(step)
    base = unit_rows(n_rows, seed=1)
    for lo in range(0, n_rows, 256):
        fan.insert(np.arange(lo, min(lo + 256, n_rows)), base[lo:lo + 256])
    assert fan.trained
    return servers, fan, base


def _close(servers, fan):
    fan.close()
    for s in servers:
        s.stop()


def self_hit(fan, rows, ids=None):
    res = fan.search(rows, k=1)
    want = np.arange(rows.shape[0]) if ids is None else ids
    return float(np.mean(res["ids"][:, 0] == want))


def _answer(res):
    return (res["ids"], res["scores"], res["shards"], res["version"],
            res["rows"])


def _same(a, b):
    assert np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])
    assert a[2:] == b[2:]


def _kill_and_repair(fan_pkg, server_pkgs, tmp_path):
    """One script: search, kill shard 1, insert while it is down, restart
    it empty on its port, repair; returns what each step answered."""
    servers, fan, base = _plane(fan_pkg, server_pkgs, tmp_path / "journal")
    out = {}
    try:
        q = base[:32]
        out["up"] = _answer(fan.search(q, k=5))
        port, pkg = servers[1].port, server_pkgs[1]
        servers[1].stop()
        live = unit_rows(256, seed=5)
        fan.insert(np.arange(2000, 2256), live)
        out["depth_down"] = fan.journal.depth(1)
        down = fan.search(q, k=5)
        out["down"] = (down["shards"]["ok"], down["shards"]["degraded"])
        servers[1] = pkg.ShardServer(DIM, port=port).start()
        deadline = time.monotonic() + 30.0
        while time.monotonic() < deadline:
            fan.repair_tick()
            if sum(fan.journal.depths().values()) == 0 \
                    and self_hit(fan, base) == 1.0 \
                    and self_hit(fan, live, np.arange(2000, 2256)) == 1.0:
                break
            time.sleep(0.05)
        out["healed"] = (sum(fan.journal.depths().values()),
                         self_hit(fan, base),
                         self_hit(fan, live, np.arange(2000, 2256)),
                         fan.dropped)
        out["after"] = _answer(fan.search(q, k=5))
        out["rows"] = [s.shard.rows for s in servers]
    finally:
        _close(servers, fan)
    return out


@pytest.fixture(scope="module")
def reference_run(tmp_path_factory):
    return _kill_and_repair(J, (J, J, J), tmp_path_factory.mktemp("jax"))


@pytest.mark.parametrize("mix", ["port", "port_over_jax", "jax_over_port"])
def test_fanout_kill_journal_and_repair_match_the_reference(tmp_path, mix,
                                                            reference_run):
    fan_pkg, server_pkgs = {"port": (P, (P, P, P)),
                            "port_over_jax": (P, (J, P, J)),
                            "jax_over_port": (J, (P, J, P))}[mix]
    want = reference_run
    got = _kill_and_repair(fan_pkg, server_pkgs, tmp_path / "got")
    assert want["depth_down"] > 0 and want["down"] == (2, True)
    assert want["healed"] == (0, 1.0, 1.0, 0)
    assert want["up"][2] == {"ok": 3, "total": 3, "degraded": False}
    for key in ("up", "after"):
        _same(want[key], got[key])
    for key in ("depth_down", "down", "healed", "rows"):
        assert want[key] == got[key], key


def _versioned(m, tmp_path):
    servers, fan, base = _plane(m, (m, m), tmp_path / m.__name__)
    try:
        fresh = unit_rows(256, seed=9)
        pre = [s.shard.rows for s in servers]
        fan.promote(200)
        cut = [(s.shard.version, s.shard.rows) for s in servers]
        fan.insert(np.arange(5000, 5256), fresh)
        promoted = _answer(fan.search(fresh[:8], k=3))
        back = fan.rollback_to(100)
        restored = [(s.shard.version, s.shard.rows) for s in servers]
        fan.on_canary_rollback(300, "shadow_drift")
        return (pre, cut, promoted, back, restored,
                _answer(fan.search(base[:8], k=3)),
                {k: v for k, v in fan.snapshot().items() if k != "shards"})
    finally:
        _close(servers, fan)


def test_the_versioned_plane_promotes_and_rolls_back_as_the_reference(
        tmp_path):
    want, got = _versioned(J, tmp_path), _versioned(P, tmp_path)
    assert want[1] == [(200, 0), (200, 0)] and want[3] is True
    assert want[4] == [(100, rows) for rows in want[0]]
    assert want[:2] == got[:2] and want[3:5] == got[3:5]
    _same(want[2], got[2])
    _same(want[5], got[5])
    assert want[6] == got[6]


def _dead_port():
    sk = socket.socket()
    sk.bind(("127.0.0.1", 0))
    port = sk.getsockname()[1]
    sk.close()
    return port


@pytest.mark.parametrize("pkg", [J, P], ids=["jax", "port"])
def test_client_cooldowns_split_by_failure_mode(pkg):
    """A dead process takes the long cooldown and no retry; a stopped one
    (the SIGSTOP of ``lagshard``: the handshake lands, no answer comes)
    the short one with a free retry."""
    dead = pkg.ShardClient(f"http://127.0.0.1:{_dead_port()}",
                           timeout_s=1.0, cooldown_s=30.0,
                           timeout_cooldown_s=0.1)
    assert dead.call("/healthz") is None
    assert (dead.failures, dead.timeouts, dead.available) == (1, 0, False)
    assert dead.call("/healthz", force=True) is None and dead.failures == 2
    sk = socket.socket()
    sk.bind(("127.0.0.1", 0))
    sk.listen(1)
    try:
        stopped = pkg.ShardClient(f"http://127.0.0.1:{sk.getsockname()[1]}",
                                  timeout_s=0.3, cooldown_s=30.0,
                                  timeout_cooldown_s=30.0)
        assert stopped.call("/healthz") is None
        assert stopped.timeouts == 1 and stopped.available
        assert stopped.call("/healthz") is None
        assert (stopped.timeouts, stopped.available) == (2, False)
    finally:
        sk.close()


def test_the_shard_chaos_channel_ticks_as_the_reference_s():
    plan = "killworker@1,killshard@2,lagshard@3,killshard@5"
    mine, ref = FaultInjector(FaultPlan.parse(plan)), \
        JaxInjector(JaxPlan.parse(plan))
    assert FaultPlan.parse(plan).has_shard_actions()
    assert not FaultPlan.parse("killworker@1").has_shard_actions()
    for _ in range(6):
        assert mine.on_shard_tick() == ref.on_shard_tick()
        assert mine.on_fleet_tick() == ref.on_fleet_tick()
    assert mine.fired == ref.fired


def test_killshard_restarts_the_shard_process_on_its_port(tmp_path):
    """``python -m ntxent_tpu_torch.retrieval.shard`` under the port's
    ``ServingFleet(chaos_channel="shard")``: killshard@2 SIGKILLs it and
    supervision brings it back ready on the same fixed port; the shard
    fleet's events carry ``channel: shard`` (the router's log holds both
    fleets', whose worker ids collide)."""
    port = _dead_port()
    log = events.EventLog(str(tmp_path / "events.jsonl"))
    previous = events.install(log)

    def make_cmd(worker_id, port_file):
        return [sys.executable, "-m", "ntxent_tpu_torch.retrieval.shard",
                "--dim", "8", "--port", str(port), "--port-file",
                str(port_file)]

    injector = FaultInjector(FaultPlan.parse("killshard@2"))
    fleet = ServingFleet(make_cmd, n_workers=1, workdir=tmp_path / "shards",
                         poll_s=0.1, health_timeout_s=2.0, injector=injector,
                         chaos_channel="shard",
                         backoff=RetryPolicy(max_attempts=10,
                                             base_delay_s=0.05,
                                             multiplier=1.0, jitter=0.0))
    worker = fleet.workers[0]
    fleet._spawn(worker)

    def until(done, what):
        deadline = time.monotonic() + 30.0
        while time.monotonic() < deadline:
            fleet.tick()
            if done():
                return
            time.sleep(0.05)
        raise AssertionError(f"timed out waiting for {what}")

    try:
        until(lambda: any(w.ready for w in fleet.pool.workers()), "ready")
        first = worker.proc.pid
        until(lambda: injector.fired and worker.restarts >= 1
              and worker.proc is not None and worker.proc.poll() is None
              and worker.proc.pid != first, "the restart")
        assert injector.fired == ["killshard@2"]
        until(lambda: any(w.ready for w in fleet.pool.workers()),
              "ready again")
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/readyz",
                                    timeout=5) as r:
            assert json.loads(r.read())["ok"] is True
    finally:
        fleet.stop()
        events.install(previous)
        log.close()
    assert worker.proc is None or worker.proc.poll() is not None
    fleet_events = events.read_events(str(tmp_path / "events.jsonl"),
                                      "fleet")
    assert [r["action"] for r in fleet_events][:3] == [
        "spawn", "death", "restart_scheduled"]
    assert fleet_events[1]["rc"] == -9
    assert {r.get("channel") for r in fleet_events} == {"shard"}


@pytest.mark.parametrize("pkg", [J, P], ids=["jax", "port"])
def test_a_plane_of_another_width_drops_every_insert(pkg, caplog):
    """Copied from the reference (ROADMAP.md Queue C): the fleet's shard
    plane is ``--proj-dim`` wide whatever the workers serve, so under
    ``--head features`` (768 wide against 128) every insert is refused
    with a warning and the plane stays empty."""
    server = pkg.ShardServer(128).start()
    fan = pkg.ShardFanout([server.url], dim=128, train_rows=4,
                          n_centroids=2, nprobe=2, pq_m=8)
    try:
        fan.activate(1)
        with caplog.at_level(logging.WARNING):
            got = fan.insert(np.arange(8), unit_rows(8, seed=3, dim=768))
        assert got == 0 and fan.insert_auto(unit_rows(2, dim=768)) == []
        assert "insert rejected — dim 768 != plane dim 128" in caplog.text
        assert not fan.trained and fan.snapshot()["buffered"] == 0
        assert fan.insert(np.arange(8), unit_rows(8, seed=3, dim=128)) == 8
        assert fan.trained
    finally:
        _close([server], fan)
