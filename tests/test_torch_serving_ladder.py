"""The adaptive bucket ladder of the port (``serving/ladder.py`` and
``InferenceEngine(adaptive=True)``) on the CPU.

* The pure math against the JAX package's ``ntxent_tpu.serving.ladder``
  on seeded size streams: ``SizeHistogram`` weights, ``observations``,
  ``expected_padded_rows`` and the DP of ``optimize_ladder`` equal,
  exactly (both are the same stdlib arithmetic).
* The adaptive-engine cases of ``tests/test_ragged.py`` on the port's
  engine over a linear model: a swap cuts padding and requests pay no
  first run, the min-requests gate, the empty histogram, single-size
  traffic, hysteresis, a failed re-warm keeps the old ladder, a chunk
  that raced a swap finishes on its snapshot, oversized requests still
  chunk through the top rung, a weight reload mid-re-warm abandons the
  publish, the background worker; the ladder and size series.
"""

import threading
import time

import numpy as np
import pytest
import torch
from torch import nn

from ntxent_tpu.serving import ladder as jax_ladder
from ntxent_tpu_torch.serving import (
    InferenceEngine,
    SizeHistogram,
    expected_padded_rows,
    optimize_ladder,
)

torch.set_num_threads(1)  # one torch thread a test worker


def _linear(dim=3, seed=0):
    model = nn.Linear(2, dim, bias=False)
    with torch.no_grad():
        model.weight.copy_(torch.from_numpy(
            np.random.RandomState(seed).rand(dim, 2).astype(np.float32)))
    return model


def _engine(buckets=(1, 4, 16, 64), dim=3, **kw):
    """The port's engine over y = x W^T (every rung runs in ms)."""
    return InferenceEngine(_linear(dim), (2,), buckets=buckets,
                           device="cpu", **kw)


def _want(eng, x):
    return x @ eng.model.weight.detach().numpy().T


def _feed(engine, sizes, reps=1):
    rng = np.random.RandomState(7)
    for _ in range(reps):
        for n in sizes:
            engine.embed(rng.rand(n, 2).astype(np.float32))


# ---------------------------------------------------------------------------
# the math against the JAX package


def _stream(seed, n):
    """Skewed chunk sizes: a mass at 5-9 and 20-40, a tail to 70."""
    rng = np.random.default_rng(seed)
    mix = rng.random(n)
    return np.where(mix < 0.5, rng.integers(5, 10, n),
                    np.where(mix < 0.9, rng.integers(20, 41, n),
                             rng.integers(1, 71, n))).tolist()


@pytest.mark.parametrize("seed,decay", [(0, 0.999), (1, 0.9), (2, 1.0)])
def test_histogram_and_dp_equal_the_jax_ladder(seed, decay):
    ours, theirs = SizeHistogram(decay), jax_ladder.SizeHistogram(decay)
    for size in _stream(seed, 3000):
        ours.observe(size)
        theirs.observe(size)
    assert ours.observations == theirs.observations == 3000
    weights = ours.weights()
    assert weights == theirs.weights()
    assert ours.total_weight() == theirs.total_weight()
    for budget in (1, 2, 3, 4, 6, 9):
        for top, prior in ((64, (1, 4, 16, 64)), (128, (1, 8, 128))):
            got = optimize_ladder(weights, budget, top, prior)
            assert got == jax_ladder.optimize_ladder(weights, budget, top,
                                                     prior)
            assert got[-1] == top and len(got) <= budget
            assert expected_padded_rows(weights, got) == \
                jax_ladder.expected_padded_rows(weights, got)


def test_dp_matches_brute_force_and_keeps_the_prior_when_empty():
    import itertools

    weights = {3: 2.0, 5: 1.0, 11: 4.0, 12: 0.5, 30: 1.5}
    best = min(
        (expected_padded_rows(weights, rungs + (64,)), rungs + (64,))
        for k in range(0, 3)
        for rungs in itertools.combinations(sorted(weights), k))
    got = optimize_ladder(weights, 3, 64, (1, 64))
    assert expected_padded_rows(weights, got) == pytest.approx(best[0])
    assert optimize_ladder({}, 4, 64, (1, 4, 64)) == (1, 4, 64)
    assert optimize_ladder({70: 1.0}, 4, 64, (1, 64)) == (64,)
    with pytest.raises(ValueError):
        SizeHistogram(decay=0.0)
    with pytest.raises(ValueError):
        SizeHistogram().observe(0)


# ---------------------------------------------------------------------------
# the adaptive engine (tests/test_ragged.py:161-345)


def test_swap_cuts_padding_and_requests_never_pay_a_compile():
    eng = _engine(adaptive=True, ladder_max_buckets=4,
                  ladder_min_requests=10)
    eng.warmup()
    _feed(eng, (3, 5, 7), reps=10)
    compiles = eng.metrics.compiles
    assert eng.refresh_ladder() is True
    assert eng.buckets == (3, 5, 7, 64)
    assert eng.ladder_generation == 1
    assert eng.metrics.ladder_swaps == 1
    assert eng.metrics.ladder_compiles >= 3  # first runs off the path
    pad_before = eng.metrics.rows_padded
    rng = np.random.RandomState(3)
    for n in (3, 5, 7, 3):
        x = rng.rand(n, 2).astype(np.float32)
        np.testing.assert_allclose(eng.embed(x), _want(eng, x), rtol=1e-6)
    assert eng.metrics.rows_padded == pad_before  # no new padding
    assert eng.metrics.compiles == compiles  # no request-path first run


def test_below_min_requests_keeps_the_prior():
    eng = _engine(adaptive=True, ladder_min_requests=50)
    eng.warmup()
    _feed(eng, (3, 5), reps=5)
    assert eng.refresh_ladder() is False
    assert eng.buckets == eng.initial_buckets
    assert eng.ladder_generation == 0


def test_empty_histogram_and_a_fixed_ladder_keep_the_prior():
    eng = _engine(adaptive=True)
    assert eng.refresh_ladder() is False
    assert eng.refresh_ladder(force=True) is False
    fixed = _engine()
    _feed(fixed, (3, 5), reps=5)
    assert fixed.histogram is None
    assert fixed.refresh_ladder(force=True) is False
    assert fixed.buckets == fixed.initial_buckets


def test_single_size_traffic_collapses_to_one_rung_plus_top():
    eng = _engine(adaptive=True, ladder_min_requests=5)
    eng.warmup()
    _feed(eng, (5,), reps=10)
    assert eng.refresh_ladder() is True
    assert eng.buckets == (5, 64)


def test_hysteresis_skips_marginal_proposals():
    eng = _engine(buckets=(3, 64), adaptive=True, ladder_min_requests=1)
    eng.warmup()
    _feed(eng, (3,), reps=10)
    assert eng.refresh_ladder() is False
    assert eng.ladder_generation == 0


def test_rewarm_failure_keeps_serving_on_the_old_ladder():
    eng = _engine(adaptive=True, ladder_min_requests=5)
    eng.warmup()
    _feed(eng, (3, 5, 7), reps=5)
    orig = eng._executable

    def exploding(bucket, *snap, **kw):
        if kw.get("background"):
            raise RuntimeError("kernel build failed")
        return orig(bucket, *snap, **kw)

    eng._executable = exploding
    before = eng.buckets
    assert eng.refresh_ladder() is False
    assert eng.buckets == before and eng.ladder_generation == 0
    assert eng.metrics.to_dict()["ladder"]["refresh_failures"] == 1
    eng._executable = orig
    x = np.random.RandomState(1).rand(5, 2).astype(np.float32)
    np.testing.assert_allclose(eng.embed(x), _want(eng, x), rtol=1e-6)


def test_swap_racing_an_in_flight_chunk_keeps_its_snapshot():
    eng = _engine(adaptive=True, ladder_min_requests=1)
    eng.warmup()
    _feed(eng, (3,), reps=3)
    in_chunk = threading.Event()
    release = threading.Event()
    orig = eng._executable

    def gated(bucket, *snap, **kw):
        exe = orig(bucket, *snap, **kw)
        if kw.get("background"):
            return exe  # the re-warm must not deadlock

        def wrapper(*args):
            in_chunk.set()
            assert release.wait(10.0)
            return exe(*args)

        return wrapper

    eng._executable = gated
    x = np.random.RandomState(2).rand(3, 2).astype(np.float32)
    result = {}
    t = threading.Thread(
        target=lambda: result.setdefault("out", eng.embed(x)))
    t.start()
    assert in_chunk.wait(10.0)  # the chunk holds (bucket 4, its run)
    assert eng.refresh_ladder() is True  # evicts rung 4
    assert eng.buckets == (3, 64)
    assert all(k[0] in (3, 64) for k in eng._cache)
    release.set()
    t.join(10.0)
    np.testing.assert_allclose(result["out"], _want(eng, x), rtol=1e-6)


def test_oversized_requests_still_chunk_through_the_max_bucket():
    eng = _engine(adaptive=True, ladder_min_requests=5,
                  ladder_max_buckets=3)
    eng.warmup()
    _feed(eng, (3, 5), reps=5)
    assert eng.refresh_ladder() is True
    assert eng.buckets[-1] == eng.max_bucket == 64
    calls = eng.metrics.device_calls
    x = np.random.RandomState(4).rand(131, 2).astype(np.float32)
    np.testing.assert_allclose(eng.embed(x), _want(eng, x), rtol=1e-6)
    assert eng.metrics.device_calls == calls + 3  # 64 + 64 + 3


def test_weight_reload_mid_rewarm_abandons_the_publish():
    eng = _engine(adaptive=True, ladder_min_requests=1)
    eng.warmup()
    _feed(eng, (3, 5), reps=3)
    orig = eng._executable

    def reload_then_run(bucket, *snap, **kw):
        if kw.get("background") and not getattr(reload_then_run,
                                                "done", False):
            reload_then_run.done = True
            eng.update_variables({"weight": eng.model.weight + 1.0})
        return orig(bucket, *snap, **kw)

    eng._executable = reload_then_run
    before = eng.buckets
    assert eng.refresh_ladder() is False  # runs of a retired hash
    assert eng.buckets == before and eng.ladder_generation == 0
    eng._executable = orig
    assert eng.refresh_ladder() is True  # the next cycle lands
    x = np.random.RandomState(5).rand(3, 2).astype(np.float32)
    np.testing.assert_allclose(eng.embed(x), _want(eng, x), rtol=1e-6)
    causes = eng.metrics.to_dict()
    assert causes["ladder"]["swaps"] == 1


def test_background_worker_thread_swaps_and_close_stops_it():
    eng = _engine(adaptive=True, ladder_min_requests=5,
                  ladder_interval_s=0.05)
    try:
        eng.warmup()
        _feed(eng, (3, 5, 7), reps=5)
        deadline = time.monotonic() + 10.0
        while eng.ladder_generation == 0 and time.monotonic() < deadline:
            time.sleep(0.02)
        assert eng.ladder_generation >= 1
        assert eng.buckets == (3, 5, 7, 64)
    finally:
        eng.close()
    assert eng._ladder_thread is None


# ---------------------------------------------------------------------------
# the ladder's series


def test_request_sizes_and_bucket_waste_in_both_views():
    eng = _engine()
    eng.warmup()
    _feed(eng, (3, 5, 3))
    m = eng.metrics.to_dict()
    assert m["request_sizes"] == {"4": 2, "8": 1}  # pow2 ceilings
    assert m["buckets"]["16"]["padding_waste"] == pytest.approx(11 / 16)
    prom = eng.metrics.render_prometheus()
    assert 'serving_request_size_total{rows="4"} 2' in prom
    assert 'serving_bucket_padding_waste{bucket="16"}' in prom
    eng.embed(np.zeros((67, 2), np.float32))  # 64 + a 3-row tail
    m = eng.metrics.to_dict()
    assert m["request_sizes"]["64"] == 1 and m["request_sizes"]["4"] == 3


def test_ladder_block_and_membership_gauges_track_swaps():
    eng = _engine(adaptive=True, ladder_min_requests=1)
    eng.warmup()
    m = eng.metrics.to_dict()
    assert m["ladder"]["buckets"] == [1, 4, 16, 64]
    assert m["compile"] == {"compiles": 4, "cache_hits": 0}
    _feed(eng, (5,), reps=3)
    assert eng.refresh_ladder() is True
    m = eng.metrics.to_dict()["ladder"]
    assert m["buckets"] == [5, 64]
    assert m["generation"] == 1 and m["swaps"] == 1 and m["compiles"] == 1
    prom = eng.metrics.render_prometheus()
    assert 'serving_ladder_bucket{bucket="5"} 1' in prom
    assert 'serving_ladder_bucket{bucket="4"} 0' in prom
    assert "serving_ladder_swaps_total 1" in prom
    assert "serving_ladder_generation 1" in prom
    assert 'serving_compiles_by_cause_total{reason="first_compile"} 1' \
        in prom
    assert 'serving_compiles_by_cause_total{reason="new_shape"} 4' in prom
