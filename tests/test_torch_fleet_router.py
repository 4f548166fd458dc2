"""The port's ``FleetRouter`` held to the JAX package's over the same fake
workers, and the router's own surfaces.

Each package's router runs one scripted request sequence against its own
pair of stdlib fake workers (``torch_fleet_fakes.FakeWorker``: rows of
the worker's step, scriptable 5xx, 429, 400 and garbage answers): cache
misses, a full and a partial cache hit, a worker 5xx hidden by failover,
every worker saturated (429 with the largest ``Retry-After``), a 4xx
passed through, an oversized body (413), a canary whose errors roll the
step back fleet-wide (``POST /rollback`` to every worker), a promote that
flushes the cache and replays its hot rows, and a garbage 200. The status
codes, bodies, ``X-Checkpoint-Step`` / ``Retry-After`` headers, the
workers' calls and the counters are compared exactly; latency histograms
and alert stamps (wall time) and request ids (random) are left out.
"""

from __future__ import annotations

import json
import time
import types

import pytest

from ntxent_tpu.obs import registry as j_registry
from ntxent_tpu.serving import cache as j_cache
from ntxent_tpu.serving import router as j_router
from ntxent_tpu_torch.obs import registry as t_registry
from ntxent_tpu_torch.serving import cache as t_cache
from ntxent_tpu_torch.serving import router as t_router

from torch_fleet_fakes import FakeWorker, get, pool_with, post

pytestmark = pytest.mark.fleet

JAX = types.SimpleNamespace(registry=j_registry, cache=j_cache,
                            router=j_router)
PORT = types.SimpleNamespace(registry=t_registry, cache=t_cache,
                             router=t_router)
HEADERS = ("X-Checkpoint-Step", "Retry-After", "Connection")


def _rows(n, value):
    return [[float(value), float(value) + 0.5] for _ in range(n)]


def _wait(predicate, timeout_s=10.0):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if predicate():
            return True
        time.sleep(0.01)
    return False


def _no_wall(obj):
    """``obj`` without the wall-clock stamps of alert records."""
    if isinstance(obj, dict):
        return {k: _no_wall(v) for k, v in obj.items()
                if k not in ("since", "refreshed", "resolved_at")}
    if isinstance(obj, list):
        return [_no_wall(v) for v in obj]
    return obj


def _scrub(collected: dict) -> dict:
    """A registry's ``collect()`` without the wall-time latency series."""
    return {k: v for k, v in collected.items()
            if not k.startswith("fleet_latency_ms")}


def _script(pkg):
    w0, w1 = FakeWorker(dim=3, step=1), FakeWorker(dim=3, step=1)
    reg = pkg.registry.MetricsRegistry()
    pool = pool_with(pkg.router.WorkerPool, {"w0": w0, "w1": w1},
                     canary_fraction=0.5, canary_min_requests=3,
                     canary_max_error_rate=0.2, registry=reg)
    cache = pkg.cache.EmbeddingCache(capacity_rows=64, ttl_s=300.0,
                                     buckets=(1, 4), registry=reg,
                                     hot_rows=8)
    router = pkg.router.FleetRouter(pool, cache=cache, example_shape=(2,),
                                    port=0, retries=1, forward_timeout_s=10.0,
                                    max_body_bytes=4096, registry=reg,
                                    warm_rows=4).start()
    url = f"http://127.0.0.1:{router.port}"
    trail = []

    def send(payload, path="/embed", headers=None):
        status, body, hdrs = post(url + path, payload, headers)
        trail.append((status, body,
                      {k: hdrs[k] for k in HEADERS if k in hdrs},
                      "X-Request-Id" in hdrs))
        return status, body

    try:
        send({"inputs": _rows(2, 0.5)})                 # misses
        send({"inputs": _rows(2, 0.5)})                 # a full hit
        send({"inputs": _rows(1, 0.5) + _rows(1, 7.0)})  # a partial hit
        send({"inputs": [0.25, 0.75]})                  # one unbatched row
        w0.mode = "err500"
        send({"inputs": _rows(1, 2.0)})                 # failover to w1
        w0.mode = w1.mode = "busy429"
        send({"inputs": _rows(1, 3.0)})                 # all saturated
        w0.mode, w1.mode = "bad400", "ok"
        send({"inputs": _rows(1, 4.0)})                 # 4xx passes through
        w0.mode = w1.mode = "scalar500"
        send({"inputs": _rows(1, 4.5)})                 # budget exhausted
        w0.mode = w1.mode = "ok"
        send({"inputs": _rows(400, 5.0)})               # over the body cap
        send({"not_inputs": 1})                         # passed to a worker
        send({}, path="/nope")
        # A canary whose every answer is a 5xx: failover hides it from
        # the client, the verdict rolls it back fleet-wide.
        w1.step = 2
        w1.mode = "err500"
        pool.set_health("w1", alive=True, ready=True, checkpoint_step=2)
        for i in range(8):
            send({"inputs": _rows(1, 10.0 + i)})
            if pool.bad_steps:
                break
        assert _wait(lambda: w0.rollbacks and w1.rollbacks)
        trail.append((w0.rollbacks, w1.rollbacks))
        send({"inputs": _rows(1, 30.0)})                # old cohort only
        # A clean canary promotes; the promote flushes the cache and
        # replays its hot rows through the new step.
        w1.mode = "ok"
        w0.step = w1.step = 3
        for wid in ("w0", "w1"):
            pool.set_health(wid, alive=True, ready=True, checkpoint_step=3)
        for i in range(8):
            send({"inputs": _rows(1, 40.0 + i)})
            if pool.trusted_step == 3:
                break
        assert _wait(lambda: router._cache_warmed.value > 0)
        send({"inputs": _rows(2, 0.5)})                 # warmed at step 3
        w0.mode = "garbage200"
        send({"inputs": _rows(1, 50.0)})                # retried on w1
        w0.mode = "ok"
        w0.step_header = 3                              # the reply's label
        send({"inputs": _rows(1, 51.0)})
        for path in ("/healthz", "/alerts", "/metrics?format=prometheus",
                     "/metrics/fleet", "/metrics/history", "/nope"):
            status, ctype, body = get(url + path)
            if "prometheus" in path:
                body = "\n".join(
                    line for line in body.decode().splitlines()
                    if "fleet_latency_ms" not in line)
            elif ctype == "application/json":
                body = _no_wall(json.loads(body))
            trail.append((path, status, ctype, body))
        metrics = router.metrics_dict()
        metrics.pop("latency_ms")
        for worker in metrics["workers"].values():
            worker.pop("url")               # the fake's own port
        trail.append(metrics)
        trail.append(_scrub(reg.collect()))
        trail.append((w0.embed_calls, w1.embed_calls))
        return trail
    finally:
        router.close()
        w0.close()
        w1.close()


def test_the_router_answers_and_counts_as_the_jax_router():
    jax_trail, port_trail = _script(JAX), _script(PORT)
    assert len(port_trail) == len(jax_trail)
    for got, want in zip(port_trail, jax_trail):
        assert got == want
    statuses = [t[0] for t in port_trail if isinstance(t, tuple)
                and isinstance(t[0], int)]
    assert {200, 400, 404, 413, 429, 500} <= set(statuses)
    metrics = port_trail[-3]
    assert metrics["trusted_step"] == 3 and metrics["bad_steps"] == [2]
    assert metrics["cache_only_responses"] >= 2
    assert metrics["cache_warmed"] >= 1


def test_the_router_tier_answers_without_workers_and_stamps_its_run():
    reg = t_registry.MetricsRegistry()
    pool = t_router.WorkerPool(registry=reg)
    router = t_router.FleetRouter(pool, example_shape=(2,), port=0,
                                  registry=reg).start()
    try:
        router.set_run_id("fleet-run")
        url = f"http://127.0.0.1:{router.port}"
        status, body, _ = post(url + "/embed", {"inputs": _rows(1, 1.0)})
        assert status == 503 and body == {"error": "no ready workers"}
        status, _, raw = get(url + "/healthz")
        assert status == 503 and b"no_ready_workers" in raw
        status, _, raw = get(url + "/metrics/fleet")
        assert status == 503
        status, _, raw = get(url + "/metrics?format=state")
        assert status == 200 and b"serving_run_info" in raw
        # the retrieval routes answer as the JAX router's do with no
        # index attached
        for path in ("/search", "/index/insert"):
            status, body, _ = post(url + path, {"inputs": _rows(1, 1.0)})
            assert status == 503
            assert body["error"].startswith("no retrieval index attached")
        assert get(url + "/index")[0] == 503
    finally:
        router.close()


def test_tenant_admission_sheds_with_retry_after_in_the_router():
    w0 = FakeWorker(dim=2, step=1)
    reg = t_registry.MetricsRegistry()
    pool = pool_with(t_router.WorkerPool, {"w0": w0}, registry=reg)
    router = t_router.FleetRouter(pool, example_shape=(2,), port=0,
                                  registry=reg).start()
    router.admission = t_router.TenantAdmission(
        default_rate=0.01, default_burst=2.0, registry=reg)
    url = f"http://127.0.0.1:{router.port}/embed"
    try:
        assert post(url, {"inputs": _rows(2, 1.0)},
                    {"X-Tenant": "a"})[0] == 200
        status, body, headers = post(url, {"inputs": _rows(1, 1.0)},
                                     {"X-Tenant": "a"})
        assert status == 429 and body["tenant"] == "a"
        assert int(headers["Retry-After"]) >= 1
        assert post(url, {"inputs": _rows(1, 1.0)},
                    {"X-Tenant": "b"})[0] == 200
        assert router.metrics_dict()["tenants"] == {"a": 0.0, "b": 1.0}
    finally:
        router.close()
        w0.close()
    assert reg.collect()["fleet_rejected_total"] == {
        '{reason="tenant_quota"}': 1.0}
