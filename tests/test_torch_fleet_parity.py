"""The port's fleet tier held to the JAX package's on the same inputs.

The fleet tier is host code in both packages (stdlib and numpy; the JAX
package's imports no JAX either), so one test process imports both and
drives the same scripted sequence through each, under the same fake
clocks. Every comparison is exact (``==`` on Python floats, bytes and
dicts; ``np.array_equal`` on arrays), except where a record carries the
wall clock (an alert's ``since``, ``refreshed`` and ``resolved_at``),
which is dropped before the comparison:

* ``row_key`` bytes and ``EmbeddingCache`` hit, miss, TTL and LRU
  eviction sequences with their counters;
* ``WorkerPool``'s picks, canary verdicts and snapshots over one script
  of upserts, health, outcomes and drift samples;
* ``TokenBucket``, ``TenantAdmission`` and ``parse_tenant_quotas``;
* ``cosine_drift``;
* ``merge_states`` over a port worker's ``ServingMetrics.dump_state``
  and a JAX worker's;
* ``SLOEngine``'s alert transitions;
* ``MetricHistory`` (rollups, queries, the spill, reopened across the
  packages both ways), ``HistoryRecorder``, ``AnomalyDetector`` and the
  Holt-Winters ``Forecaster``;
* ``AutoscaleController.step_signals`` decisions and full ``observe``
  ticks over a stub fleet;
* ``export_merged_chrome_trace`` over a router's and two workers' logs.
"""

from __future__ import annotations

import json
import types

import numpy as np
import pytest

from ntxent_tpu.obs import aggregate as j_aggregate
from ntxent_tpu.obs import history as j_history
from ntxent_tpu.obs import registry as j_registry
from ntxent_tpu.obs import slo as j_slo
from ntxent_tpu.obs import trace as j_trace
from ntxent_tpu.serving import autoscale as j_autoscale
from ntxent_tpu.serving import cache as j_cache
from ntxent_tpu.serving import router as j_router
from ntxent_tpu.serving import shadow as j_shadow
from ntxent_tpu.serving.metrics import ServingMetrics as JaxServingMetrics
from ntxent_tpu_torch.obs import aggregate as t_aggregate
from ntxent_tpu_torch.obs import history as t_history
from ntxent_tpu_torch.obs import registry as t_registry
from ntxent_tpu_torch.obs import slo as t_slo
from ntxent_tpu_torch.obs import trace as t_trace
from ntxent_tpu_torch.serving import autoscale as t_autoscale
from ntxent_tpu_torch.serving import cache as t_cache
from ntxent_tpu_torch.serving import router as t_router
from ntxent_tpu_torch.serving import shadow as t_shadow
from ntxent_tpu_torch.serving.metrics import ServingMetrics

from torch_fleet_fakes import FakeClock, FakeFleet

pytestmark = pytest.mark.fleet

JAX = types.SimpleNamespace(aggregate=j_aggregate, history=j_history,
                            registry=j_registry, slo=j_slo, trace=j_trace,
                            autoscale=j_autoscale, cache=j_cache,
                            router=j_router, shadow=j_shadow)
PORT = types.SimpleNamespace(aggregate=t_aggregate, history=t_history,
                             registry=t_registry, slo=t_slo, trace=t_trace,
                             autoscale=t_autoscale, cache=t_cache,
                             router=t_router, shadow=t_shadow)
WALL_KEYS = ("since", "refreshed", "resolved_at")


def _both(scenario):
    """Run ``scenario(package)`` for the JAX package and the port; return
    both results for the caller to compare."""
    return scenario(JAX), scenario(PORT)


def _no_wall(obj):
    """``obj`` with the wall-clock stamps of alert records dropped."""
    if isinstance(obj, dict):
        return {k: _no_wall(v) for k, v in obj.items() if k not in WALL_KEYS}
    if isinstance(obj, (list, tuple)):
        return [_no_wall(v) for v in obj]
    return obj


# ---------------------------------------------------------------------------
# the embedding cache


@pytest.mark.parametrize("row", [
    np.zeros((2,), np.float32),
    np.arange(12, dtype=np.float32).reshape(2, 2, 3),
    np.arange(12, dtype=np.float64).reshape(2, 2, 3),
    np.array([-0.0, 0.0, np.nan, np.inf], np.float32),
    np.arange(6, dtype=np.float32).reshape(3, 2).T,  # not contiguous
], ids=["zeros", "image", "float64", "specials", "transposed"])
def test_row_key_bytes_are_the_jax_ones(row):
    assert t_cache.row_key(row) == j_cache.row_key(row)


def test_cache_hit_miss_and_eviction_sequences_equal_jax():
    rng = np.random.default_rng(0)
    rows = rng.normal(size=(8, 2, 3)).astype(np.float32)
    emb = rng.normal(size=(8, 4)).astype(np.float32)

    def scenario(pkg):
        clock = FakeClock()
        reg = pkg.registry.MetricsRegistry()
        cache = pkg.cache.EmbeddingCache(capacity_rows=4, ttl_s=10.0,
                                         buckets=(1, 4), registry=reg,
                                         clock=clock, hot_rows=2)
        trail = []

        def look(idx):
            hits, misses = cache.lookup(rows[idx])
            trail.append(({int(i): v.tolist() for i, v in hits.items()},
                          [int(m) for m in misses], cache.generation))

        cache.insert(rows[:3], emb[:3])
        look([0, 1, 5])             # partial hit
        clock.advance(4.0)
        cache.insert(rows[3:6], emb[3:6])   # past capacity: LRU evicts
        look([0, 1, 2, 3, 4, 5])
        clock.advance(7.0)          # rows 0-2 past the TTL
        look([1, 4])
        trail.append([k.tolist() for k in cache.hot_keys(4)])
        trail.append(cache.clear(reason="promote"))
        look([4])
        cache.insert(rows[6:], emb[6:])
        look([6, 7, 0])
        trail.append(cache.snapshot())
        trail.append(reg.collect())
        return trail

    jax_trail, port_trail = _both(scenario)
    assert port_trail == jax_trail


def test_the_insert_asks_its_trust_gate_under_the_lock():
    """The port's one addition to JAX's cache: ``insert(..., admit)``
    asks the router's trust gate under the cache's lock, after the
    hashing, so a promote whose flush lands while a laggard's rows are
    hashed keeps them out of the new model's generation (JAX asks the
    gate before the hashing; ROADMAP.md Queue C)."""
    from ntxent_tpu_torch.serving.cache import EmbeddingCache

    rng = np.random.default_rng(1)
    rows = rng.normal(size=(4, 2, 3)).astype(np.float32)
    emb = rng.normal(size=(4, 4)).astype(np.float32)
    cache = EmbeddingCache(capacity_rows=8, ttl_s=10.0, clock=FakeClock())
    trusted = {"step": 1}

    def admit():  # rows computed at step 1
        return trusted["step"] == 1

    cache.insert(rows[:2], emb[:2], admit)
    trusted["step"] = 2                      # the promote
    cache.clear(reason="promote")
    cache.insert(rows[2:], emb[2:], admit)   # the laggard's: refused
    assert cache.lookup(rows) == ({}, [0, 1, 2, 3])
    cache.insert(rows[2:], emb[2:])
    hits, misses = cache.lookup(rows)
    assert sorted(hits) == [2, 3] and misses == [0, 1]


def test_the_router_logs_each_cache_insert_jax_logs_none(tmp_path):
    """A stated difference: the port's router logs every cache insert of
    fetched rows as a ``fleet`` event (``action="cache_insert"``: the
    request, the step that computed the rows, the step trusted at the
    lookup, the cache generation, the trust gate's verdict and the rows'
    key prefixes), the evidence ``chip_smoke.py``'s ``[fleet]`` prints
    for an answer that mixes steps; JAX's router logs none. The same
    requests through both routers over one fake worker: misses, a full
    hit (no insert), a partial hit (one insert of the missed row)."""
    from ntxent_tpu.obs import events as j_events
    from ntxent_tpu_torch.obs import events as t_events

    from torch_fleet_fakes import FakeWorker, pool_with, post

    rows = [[0.5, 1.5], [2.5, 3.5], [4.5, 5.5]]

    def scenario(pkg, events, path):
        worker = FakeWorker(dim=3, step=1)
        reg = pkg.registry.MetricsRegistry()
        pool = pool_with(pkg.router.WorkerPool, {"w0": worker},
                         registry=reg)
        cache = pkg.cache.EmbeddingCache(capacity_rows=8, ttl_s=300.0,
                                         registry=reg)
        router = pkg.router.FleetRouter(pool, cache=cache,
                                        example_shape=(2,), port=0,
                                        registry=reg).start()
        previous = events.install(events.EventLog(str(path)))
        try:
            url = f"http://127.0.0.1:{router.port}/embed"
            for payload in (rows[:2], rows[:2], rows[1:]):
                assert post(url, {"inputs": payload})[0] == 200
        finally:
            events.install(previous)
            router.close()
        return [r for r in events.read_events(str(path), "fleet")
                if r.get("action") == "cache_insert"]

    jax_inserts = scenario(JAX, j_events, tmp_path / "jax.jsonl")
    port_inserts = scenario(PORT, t_events, tmp_path / "port.jsonl")
    assert jax_inserts == []
    keys = [t_cache.row_key(np.asarray(r, np.float32)).hex()[:16]
            for r in rows]
    assert [(r["step"], r["trusted"], r["admitted"], r["keys"])
            for r in port_inserts] == [(1, 1, True, keys[:2]),
                                       (1, 1, True, keys[2:])]


# ---------------------------------------------------------------------------
# the worker pool's routing and canary state machine


def _pool_script(pkg):
    """Upserts, health, picks, outcomes and drift samples: a trusted step,
    a canary promoted, a canary rolled back on drift, a demotion."""
    reg = pkg.registry.MetricsRegistry()
    pool = pkg.router.WorkerPool(canary_fraction=0.5, canary_min_requests=4,
                                 canary_max_error_rate=0.25,
                                 shadow_max_drift=0.1, shadow_min_samples=3,
                                 registry=reg)
    adopted, demoted = [], []
    pool.on_trusted_adopt = adopted.append
    pool.on_trusted_rollback = lambda new, old: demoted.append((new, old))
    trail = []

    def pick(n, exclude=None):
        for _ in range(n):
            entry = pool.pick(exclude=exclude)
            trail.append(None if entry is None else
                         (entry.worker_id, entry.checkpoint_step))
            if entry is not None:
                pool.done(entry.worker_id)

    for i in range(3):
        pool.upsert(f"w{i}", f"http://127.0.0.1:{9000 + i}/")
    pick(1)                                     # nothing ready: None
    for i in range(3):
        pool.set_health(f"w{i}", alive=True, ready=True, checkpoint_step=1)
    pick(4)
    pool.set_health("w2", alive=True, ready=True, checkpoint_step=2)
    pick(6)                                     # canary on every 2nd pick
    for ok in (True, True, False, True):
        trail.append(pool.observe("w2", 2, ok))  # deferred: no drift yet
    trail.append(pool.observe_drift(2, [0.01, 0.02]))
    trail.append(pool.observe_drift(2, [0.03]))
    trail.append(pool.observe("w2", 2, True))   # promote
    trail.append(pool.snapshot())
    for wid in ("w0", "w1"):
        pool.set_health(wid, alive=True, ready=True, checkpoint_step=2)
    pool.set_health("w1", alive=True, ready=True, checkpoint_step=3)
    pick(4)
    trail.append(pool.observe_drift(3, [0.05, 0.4, 0.5]))   # drift breach
    trail.append(pool.allow_cache_insert(3))
    trail.append(pool.allow_cache_insert(2))
    pick(3)
    pool.report_failure("w0", "http 500")
    pool.report_failure("w0", "connection reset")
    trail.append(pool.snapshot())
    pool.clear_failures("w0")
    trail.append(pool.set_draining("w2", True))
    pick(3)
    trail.append(pool.routable_count())
    trail.append(pool.set_draining("w2", False))
    for i in range(3):                          # the fleet reverted
        pool.set_health(f"w{i}", alive=True, ready=True, checkpoint_step=1)
    pool.remove("w1")
    pick(2, exclude={"w0"})
    trail.append(pool.snapshot())
    trail.append((adopted, demoted))
    trail.append(reg.collect())
    return trail


def test_worker_pool_decisions_and_snapshots_equal_jax():
    jax_trail, port_trail = _both(_pool_script)
    assert port_trail == jax_trail
    assert ("promote", 2) in port_trail and ("rollback", 3) in port_trail


def test_a_busy_worker_beats_a_503_jax_answers_503():
    """A stated difference: a worker whose last /readyz probe timed out
    while it was alive (``busy``) is not ready, but the port's pool still
    picks it when no ready worker remains; JAX's pool picks nothing there
    (the router's 503). One worker left under load, its probe past the
    timeout, turned into client-visible 503s. Where a ready worker
    exists, both pools pick it; a draining or dead worker is never
    picked."""
    def script(pkg, busy):
        pool = pkg.router.WorkerPool(registry=pkg.registry.MetricsRegistry())
        for wid in ("w0", "w1"):
            pool.upsert(wid, f"http://127.0.0.1:9000/{wid}")
            pool.set_health(wid, alive=True, ready=True, checkpoint_step=1)
        trail = []

        def pick():
            entry = pool.pick()
            trail.append(None if entry is None else entry.worker_id)
            if entry is not None:
                pool.done(entry.worker_id)

        # w0's probe times out: w1 is ready and takes every pick
        pool.set_health("w0", alive=True, ready=False, **busy)
        pick()
        pick()
        # w1 retired: w0, busy, is all that is left
        pool.remove("w1")
        pick()
        trail.append(pool.routable_count())
        pool.set_draining("w0", True)
        pick()
        pool.set_draining("w0", False)
        pool.set_health("w0", alive=False, ready=False)     # dead
        pick()
        pool.set_health("w0", alive=True, ready=False)      # warming: 503
        pick()
        pool.set_health("w0", alive=True, ready=False, **busy)
        pool.set_health("w0", alive=True, ready=True, checkpoint_step=1)
        pick()
        return trail

    jax_trail = script(JAX, {})
    port_trail = script(PORT, {"busy": True})
    assert jax_trail == ["w1", "w1", None, 0, None, None, None, "w0"]
    assert port_trail == ["w1", "w1", "w0", 0, None, None, None, "w0"]
    # without the timeout the port's pool is JAX's
    assert script(PORT, {}) == jax_trail


# ---------------------------------------------------------------------------
# admission


def test_token_buckets_and_tenant_admission_equal_jax():
    def scenario(pkg):
        trail = []
        # Times far past the monotonic clock's own reading: a bucket made
        # now starts full in both packages whatever the host's uptime.
        t0 = 1e9
        bucket = pkg.router.TokenBucket(rate=2.0, burst=3.0)
        for now, cost in ((0.0, 1), (0.0, 2), (0.1, 1), (1.0, 1), (5.0, 9),
                          (5.0, 3)):
            trail.append(bucket.try_take(cost, now=t0 + now))
        reg = pkg.registry.MetricsRegistry()
        adm = pkg.router.TenantAdmission(
            default_rate=1.0, default_burst=2.0,
            quotas={"big": (10.0, 20.0)}, registry=reg, max_tenants=3)
        t = t0
        for tenant, cost in (("big", 15), ("big", 10), (None, 1),
                             (" ", 2), ("a/b c", 1), ("x" * 80, 1),
                             ("fresh", 1), ("another", 1), ("default", 1)):
            t += 0.25
            trail.append(adm.admit(tenant, cost=cost, now=t))
        trail.append(adm.snapshot())
        trail.append(reg.collect())
        return trail

    jax_trail, port_trail = _both(scenario)
    assert port_trail == jax_trail


@pytest.mark.parametrize("spec", [
    "default=100,big=1000:2000", "  a=1.5 , b=2:3,", "", "x=0.5",
    "bad", "=3", "a=x", "a=-1", "a=1:0"])
def test_parse_tenant_quotas_equals_jax(spec):
    def parse(pkg):
        try:
            return ("ok", pkg.autoscale.parse_tenant_quotas(spec))
        except ValueError as e:
            return ("error", str(e))

    jax_out, port_out = _both(parse)
    assert port_out == jax_out


# ---------------------------------------------------------------------------
# shadow drift


def test_cosine_drift_equals_jax():
    rng = np.random.default_rng(1)
    a = rng.normal(size=(16, 8)).astype(np.float32)
    b = a + 0.1 * rng.normal(size=(16, 8)).astype(np.float32)
    b[3] = -a[3]
    a[5] = 0.0          # a collapsed row diffs at the maximum
    b[7] = 0.0
    assert np.array_equal(t_shadow.cosine_drift(a, b),
                          j_shadow.cosine_drift(a, b))
    assert np.array_equal(t_shadow.cosine_drift(a[:1].astype(np.float64),
                                                b[:1]),
                          j_shadow.cosine_drift(a[:1].astype(np.float64),
                                                b[:1]))
    with pytest.raises(ValueError):
        t_shadow.cosine_drift(a, b[:3])


# ---------------------------------------------------------------------------
# federation


def _serving_state(metrics_cls, scale):
    """A worker's raw ``/metrics?format=state`` view after a few requests
    (the port's serving series carry the JAX worker's names)."""
    m = metrics_cls()
    for i, rows in enumerate((1, 3, 5, 2)):
        m.request_accepted()
        m.observe_request_size(rows)
        m.request_done(10.0 * scale + i)
    m.set_queue_depth(2 * scale)
    m.request_rejected("queue_full")
    return m.registry.dump_state()


def test_merge_states_of_a_port_and_a_jax_worker_equals_jax():
    states = {"w0": _serving_state(ServingMetrics, 1),
              "w1": _serving_state(JaxServingMetrics, 2)}
    router = t_registry.MetricsRegistry()
    router.counter("fleet_requests_total").inc(7)
    router.histogram("fleet_latency_ms", labels={"stage": "total"}).observe(
        3.5)
    states["router"] = router.dump_state()
    assert ({e["name"] for e in states["w0"]["metrics"]}
            == {e["name"] for e in states["w1"]["metrics"]})
    merged = {}
    for name, pkg in (("jax", JAX), ("port", PORT)):
        reg = pkg.aggregate.merge_states(states)
        merged[name] = (reg.dump_state(), reg.collect(),
                        reg.render_prometheus())
    assert merged["port"] == merged["jax"]
    assert 'instance="w1"' in merged["port"][2]


def test_fleet_aggregator_scrape_failures_equal_jax():
    """A target that cannot be reached keeps its last-good state, marked
    down, then drops: the same merged view in both packages."""
    def scenario(pkg):
        good = {"w0": _serving_state(ServingMetrics, 1)}
        calls = {"n": 0}
        w1_state = _serving_state(JaxServingMetrics, 2)

        def scrape(url):
            calls["n"] += 1
            if url == "w1" and calls["n"] > 2:
                return None             # unreachable from the 2nd tick
            return good["w0"] if url == "w0" else w1_state

        agg = pkg.aggregate.FleetAggregator(
            lambda: {"w0": "w0", "w1": "w1"}, interval_s=60.0,
            stale_after=2)
        agg._scrape = scrape
        out = []
        for _ in range(4):
            out.append(agg.scrape_once().dump_state())
        out.append(agg.snapshot())
        return out

    jax_out, port_out = _both(scenario)
    assert _no_wall(port_out) == _no_wall(jax_out)


# ---------------------------------------------------------------------------
# SLOs


def test_slo_alert_transitions_equal_jax():
    def scenario(pkg):
        clock = FakeClock()
        reg = pkg.registry.MetricsRegistry()
        requests = reg.counter("fleet_requests_total")
        rejected = reg.counter("fleet_rejected_total",
                               labels={"reason": "worker_error"})
        saturated = reg.counter("fleet_rejected_total",
                                labels={"reason": "saturated"})
        latency = reg.histogram("fleet_latency_ms",
                                labels={"stage": "total"})
        objectives = [
            pkg.slo.Objective(name="availability", kind="availability",
                              target=0.99,
                              total_metric="fleet_requests_total",
                              bad_metric="fleet_rejected_total",
                              bad_exclude={"reason": "saturated"},
                              fast_window_s=10.0, slow_window_s=30.0,
                              burn_factor=2.0),
            pkg.slo.Objective(name="latency_p99", kind="quantile",
                              target=50.0, metric="fleet_latency_ms",
                              labels={"stage": "total"}, q=0.99),
        ]
        store = pkg.slo.AlertStore(registry=reg)
        engine = pkg.slo.SLOEngine(objectives, store=store, clock=clock)
        trail = []
        for tick in range(24):
            clock.advance(2.0)
            requests.inc(10)
            if 4 <= tick < 12:
                rejected.inc(3)
            saturated.inc(5)        # backpressure is never a failure
            latency.observe(80.0 if 6 <= tick < 10 else 5.0)
            trail.append(engine.evaluate(reg))
        trail.append(store.snapshot())
        trail.append(pkg.slo.counter_total(reg, "fleet_rejected_total"))
        trail.append(pkg.slo.counter_total(reg, "fleet_rejected_total",
                                           exclude={"reason": "saturated"}))
        trail.append(pkg.slo.histogram_quantile(
            reg, "fleet_latency_ms", 0.5, labels={"stage": "total"}))
        trail.append(reg.collect())
        return trail

    jax_trail, port_trail = _both(scenario)
    assert _no_wall(port_trail) == _no_wall(jax_trail)
    assert any(t for t in port_trail[:24])      # something fired


# ---------------------------------------------------------------------------
# metrics history


def _history_script(pkg, spill_dir=None):
    clock = FakeClock(t=10_000.0)
    reg = pkg.registry.MetricsRegistry()
    hist = pkg.history.MetricHistory(raw_len=16, rollup_len=8,
                                     max_series=4, spill_dir=spill_dir,
                                     spill_interval_s=5.0, registry=reg,
                                     clock=clock)
    trail = []
    rng = np.random.default_rng(2)
    for i in range(90):
        clock.advance(1.5)
        trail.append(hist.record("rate", float(rng.gamma(2.0, 3.0)),
                                 t=clock.t))
        trail.append(hist.record("depth", float(i % 7), t=clock.t))
    trail.append(hist.record("rate", float("nan"), t=clock.t))
    trail.append(hist.record("rate", "x", t=clock.t))
    for extra in ("a", "b", "c"):
        trail.append(hist.record(extra, 1.0, t=clock.t))  # cap at 4
    for series in ("rate", "depth"):
        for step in ("raw", "10s", "1m"):
            trail.append(hist.query(series, step=step))
            trail.append(hist.query(series, step=step, window_s=20.0))
    trail.append(hist.snapshot())
    trail.append(hist.series_names())
    trail.append(reg.collect())
    return hist, trail


def test_metric_history_values_equal_jax():
    (_, jax_trail), (_, port_trail) = _both(_history_script)
    assert port_trail == jax_trail


@pytest.mark.parametrize("writer,reader", [("port", "jax"), ("jax", "port")])
def test_a_spill_written_by_one_package_reopens_in_the_other(
        tmp_path, writer, reader):
    pkgs = {"jax": JAX, "port": PORT}
    hist, _ = _history_script(pkgs[writer], spill_dir=str(tmp_path))
    path = hist.spill()
    assert path is not None
    reopened = pkgs[reader].history.MetricHistory(
        raw_len=16, rollup_len=8, max_series=4, spill_dir=str(tmp_path))
    assert reopened.series_names() == hist.series_names()
    for series in hist.series_names():
        for step in ("raw", "10s", "1m"):
            assert reopened.query(series, step=step) == hist.query(
                series, step=step)
    # the file is the same bytes whichever package writes it
    other, _ = _history_script(pkgs[reader], spill_dir=str(tmp_path / "o"))
    (tmp_path / "o").mkdir(exist_ok=True)
    other_path = other.spill()
    with open(path, "rb") as f1, open(other_path, "rb") as f2:
        assert json.loads(f1.read()) == json.loads(f2.read())


def test_history_recorder_and_anomaly_detector_equal_jax():
    def scenario(pkg):
        clock = FakeClock()
        reg = pkg.registry.MetricsRegistry()
        store = pkg.slo.AlertStore(registry=reg)
        hist = pkg.history.MetricHistory(raw_len=64, rollup_len=8,
                                         registry=reg, clock=clock)
        det = pkg.history.AnomalyDetector(store=store, window=32, warmup=8,
                                          mad_factor=4.0, clear_ticks=3,
                                          registry=reg)
        rec = pkg.history.HistoryRecorder(hist, detector=det, clock=clock)
        merged = pkg.registry.MetricsRegistry()
        requests = merged.counter("fleet_requests_total")
        hits = merged.counter("fleet_cache_hits_total")
        misses = merged.counter("fleet_cache_misses_total")
        depth = {w: merged.gauge("serving_queue_depth",
                                 labels={"instance": w})
                 for w in ("w0", "w1")}
        lat = merged.histogram("fleet_latency_ms",
                               labels={"stage": "total"})
        trail = []
        for tick in range(40):
            clock.advance(1.0)
            requests.inc(10 + (tick % 3))
            hits.inc(tick % 4)
            misses.inc(2)
            depth["w0"].set(float(tick % 5))
            depth["w1"].set(40.0 if tick == 30 else 1.0)
            lat.observe(5.0 + tick % 2)
            trail.append(rec.on_merge(merged))
            trail.append(det.firing())
        for series in ("fleet_request_rate", "serving_queue_depth"):
            for value in (1.0, 1.1, 0.9, 1.0, 1.2, 0.8, 1.0, 1.05, 9.0, 1.0):
                trail.append(det.observe(series + "_b", value, t=clock.t))
        trail.append(det.firing())
        trail.append(store.snapshot())
        trail.append(hist.snapshot())
        trail.append(reg.collect())
        return trail

    jax_trail, port_trail = _both(scenario)
    assert _no_wall(port_trail) == _no_wall(jax_trail)


@pytest.mark.parametrize("season_s", [None, 24.0])
def test_forecaster_values_equal_jax(season_s):
    def scenario(pkg):
        fc = pkg.history.Forecaster(season_s=season_s, season_buckets=6,
                                    min_samples=5, bound_max=1e4)
        out = []
        rng = np.random.default_rng(3)
        t = 0.0
        for i in range(60):
            t += float(rng.uniform(0.5, 1.5))
            value = 10.0 + 0.5 * i + 3.0 * np.sin(i / 3.0)
            fc.observe(t, float(value))
            out.append((fc.forecast(10.0), fc.forecast(0.0)))
        fc.observe(t - 5.0, 1.0)            # out of order: ignored
        fc.observe(t + 1.0, float("nan"))   # garbage: ignored
        out.append(fc.forecast(30.0))
        return out

    jax_out, port_out = _both(scenario)
    assert port_out == jax_out
    assert port_out[-1] is not None


def test_gauge_reduce_and_ingest_timeline_equal_jax():
    def scenario(pkg):
        reg = pkg.registry.MetricsRegistry()
        for i, v in enumerate((3.0, 7.0, 5.0)):
            reg.gauge("serving_worker_rss_bytes",
                      labels={"instance": f"w{i}"}).set(v)
        hist = pkg.history.MetricHistory(raw_len=8, rollup_len=8)
        n = pkg.history.ingest_timeline(hist, [
            {"t": 0, "fleet_request_rate": 4.0, "fleet_p99_ms": 9.0},
            {"t": 1, "fleet_request_rate": 5.0},
            {"t": 2, "fleet_p99_ms": "bad"}], t0=100.0)
        return (pkg.history.gauge_reduce(reg, "serving_worker_rss_bytes",
                                         "sum"),
                pkg.history.gauge_reduce(reg, "serving_worker_rss_bytes",
                                         "max"),
                pkg.history.gauge_reduce(reg, "absent", "max"),
                n, hist.query("fleet_request_rate"),
                [s.name for s in pkg.history.DEFAULT_SERIES])

    jax_out, port_out = _both(scenario)
    assert port_out == jax_out


# ---------------------------------------------------------------------------
# autoscaling


def _controller(pkg, n=2, **kw):
    clock = FakeClock()
    fleet = FakeFleet([f"w{i}" for i in range(n)])
    pool = pkg.router.WorkerPool()
    for i in range(n):
        pool.upsert(f"w{i}", f"http://127.0.0.1:{9000 + i}")
        pool.set_health(f"w{i}", alive=True, ready=True, checkpoint_step=0)
    kw.setdefault("min_workers", 1)
    kw.setdefault("max_workers", 4)
    kw.setdefault("up_ticks", 2)
    kw.setdefault("idle_ticks", 3)
    kw.setdefault("up_cooldown_s", 10.0)
    kw.setdefault("down_cooldown_s", 20.0)
    ctl = pkg.autoscale.AutoscaleController(fleet, pool, clock=clock,
                                            registry=pool.registry, **kw)
    return ctl, fleet, pool, clock


def test_autoscale_step_signals_decisions_equal_jax():
    stream = ([dict(queue_depth=20.0, inflight=1.0)] * 5
              + [dict(queue_depth=0.0, inflight=9.0)] * 3
              + [dict(queue_depth=0.0, inflight=0.0, p99_ms=900.0)] * 3
              + [dict(queue_depth=0.0, inflight=0.0, burn=3.0)] * 3
              + [dict(queue_depth=0.0, inflight=0.0, rss_bytes=9e9)] * 2
              + [dict(queue_depth=0.0, inflight=0.0,
                      forecast_queue_depth=50.0)] * 3
              + [dict(queue_depth=0.0, inflight=0.0,
                      forecast_rate=500.0)] * 3
              + [dict(queue_depth=0.0, inflight=0.0)] * 30)

    def scenario(pkg):
        ctl, fleet, _, clock = _controller(
            pkg, up_p99_ms=500.0, up_rss_bytes=1e9, predict_horizon_s=30.0,
            predict_capacity=100.0)
        out = []
        size, routable = 2, 2
        for i, sig in enumerate(stream):
            clock.advance(4.0)
            signals = {"size": size, "routable": routable, "p99_ms": None,
                       "burn": None, **sig}
            if i == 40:
                signals["size"] = 0      # below the floor
            action, reason = ctl.step_signals(signals)
            out.append((action, reason))
            if action == "up":
                size = routable = min(size + 1, 4)
            elif action == "down":
                size = routable = max(size - 1, 1)
        out.append(ctl.snapshot())
        return out

    jax_out, port_out = _both(scenario)
    assert port_out == jax_out
    actions = {a for a, _ in port_out[:-1]}
    assert {"up", "down", "hold"} <= actions


def test_autoscale_observe_ticks_drain_and_force_drain_equal_jax():
    def scenario(pkg):
        ctl, fleet, pool, clock = _controller(pkg, n=3, idle_ticks=2,
                                              down_cooldown_s=0.0,
                                              drain_deadline_s=10.0)
        merged = pkg.registry.MetricsRegistry()
        requests = merged.counter("fleet_requests_total")
        queue = merged.gauge("serving_queue_depth", labels={"instance": "w0"})
        out = []
        for tick in range(12):
            clock.advance(5.0)
            requests.inc(20)
            queue.set(30.0 if tick < 3 else 0.0)
            if tick == 6:
                pool.pick()            # a request in flight on the victim
            if tick == 8:
                for w in pool.workers():
                    pool.done(w.worker_id)
            out.append(ctl.observe(merged))
            out.append((list(fleet.members), list(fleet.retired),
                        ctl.snapshot()))
        out.append(ctl.force_drain(reason="chaos"))
        out.append(pool.registry.collect())
        return out

    jax_out, port_out = _both(scenario)
    assert port_out == jax_out


# ---------------------------------------------------------------------------
# the merged Chrome trace


def test_export_merged_chrome_trace_equals_jax(tmp_path):
    def write(name, records):
        path = tmp_path / f"{name}.jsonl"
        path.write_text("".join(json.dumps(r) + "\n" for r in records))
        return str(path)

    router = write("router", [
        {"event": "span", "t": 0.5, "wall": 100.5, "run_id": "r",
         "name": "fleet.forward", "dur_ms": 40.0, "request_id": "q1",
         "worker": "w0", "thread": "h1"},
        {"event": "span", "t": 0.6, "wall": 100.6, "run_id": "r",
         "name": "fleet.request", "dur_ms": 45.0, "request_id": "q1"},
        {"event": "fleet", "t": 0.1, "wall": 100.1, "run_id": "r",
         "action": "spawn", "worker": "w0"},
        {"event": "span", "t": 0.7, "wall": 100.7, "run_id": "other",
         "name": "fleet.cache", "dur_ms": 0.1, "request_id": "q2"},
    ])
    w0 = write("w0", [
        {"event": "span", "t": 3.0, "wall": 100.55, "run_id": "r",
         "name": "serve.request", "dur_ms": 30.0, "request_id": "q1"},
        {"event": "step", "t": 3.1, "wall": 100.6, "run_id": "r", "step": 1,
         "loss": 1.5, "data_wait_ms": 1.0, "device_ms": 2.0},
        {"event": "rollout", "t": 3.2, "wall": 100.7, "run_id": "r",
         "action": "adopt"},
    ])
    (tmp_path / "b").mkdir()
    dup = str(tmp_path / "b" / "w0.jsonl")
    with open(dup, "w") as f:
        f.write(json.dumps({"event": "span", "t": 0.0, "wall": 99.0,
                            "name": "serve.batch", "dur_ms": 1.0}) + "\n")
    for run_id in (None, "r"):
        jax_trace = j_trace.export_merged_chrome_trace([router, w0, dup],
                                                       run_id=run_id)
        port_trace = t_trace.export_merged_chrome_trace([router, w0, dup],
                                                        run_id=run_id)
        assert port_trace["traceEvents"] == jax_trace["traceEvents"]
        for key in ("sources", "run_ids"):
            assert port_trace["otherData"][key] == jax_trace["otherData"][key]
        assert t_trace.validate_chrome_trace(port_trace) > 0
    out = tmp_path / "merged.json"
    assert t_trace.main([router, w0, "-o", str(out)]) == 0
    lanes = {e["pid"] for e in json.loads(out.read_text())["traceEvents"]}
    assert lanes == {1, 2}
    single = tmp_path / "single.json"
    assert t_trace.main([router, "--merge", "-o", str(single)]) == 0
    assert t_trace.main([str(tmp_path / "missing.jsonl")]) == 1
