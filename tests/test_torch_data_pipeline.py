"""The port's host and device read-ahead (``training/data.py``) and the
lag-1 loop (``train_loop(metrics_lag=1)``), on the CPU.

``PrefetchIterator`` keeps its end-of-stream sentinel where the
reference drops it: each case runs its consumer on a thread joined with
its own time limit, so a hang fails the case instead of cutting the run.
The lag-1 loop is held bit for bit to the synchronous loop (no NaN, a NaN
batch mid-run, a NaN on the last step, which still raises) and to the
JAX package's loop for the order and the ``lag`` of the outcomes.
"""

import copy
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ntxent_tpu.resilience import DivergenceGuard as JaxGuard
from ntxent_tpu.training.trainer import make_train_step as jax_step
from ntxent_tpu.training.trainer import train_loop as jax_train_loop
from ntxent_tpu_torch import cli
from ntxent_tpu_torch.resilience import DivergenceError, DivergenceGuard
from ntxent_tpu_torch.training import datasets as tdata
from ntxent_tpu_torch.training import trainer as ttrain
from ntxent_tpu_torch.training.data import DevicePrefetcher, PrefetchIterator
from ntxent_tpu_torch.weights import train_state_dict
from test_torch_resilience import GUARD_CONFIG, _jax_state
from test_torch_resnet import STEP_CONFIG, step_views, tiny_simclr_pair

torch.set_num_threads(1)  # one torch thread a test worker

LIMIT_S = 20.0  # each PrefetchIterator case's own time limit


def _within_limit(fn):
    """Run ``fn`` on a daemon thread; fail if it is not done in LIMIT_S.
    Returns what it returned, or raises what it raised."""
    box = {}

    def run():
        try:
            box["value"] = fn()
        except BaseException as e:  # re-raised on the test's thread
            box["error"] = e

    thread = threading.Thread(target=run, daemon=True)
    thread.start()
    thread.join(LIMIT_S)
    assert not thread.is_alive(), f"no result within {LIMIT_S} s: a hang"
    if "error" in box:
        raise box["error"]
    return box["value"]


def _full_queue(items, depth):
    """A PrefetchIterator whose producer has filled its queue and ended
    its stream (the sentinel still to put)."""
    pre = PrefetchIterator(iter(items), depth=depth)
    _within_limit(lambda: _wait(lambda: pre.queue.full()))
    return pre


def _wait(condition):
    import time

    while not condition():
        time.sleep(0.01)


@pytest.mark.parametrize("items,depth", [([0, 1], 2), ([0, 1, 2, 3], 1),
                                         ([], 1)])
def test_stop_iteration_arrives_after_a_full_queue(items, depth):
    pre = _full_queue(items, depth) if items \
        else PrefetchIterator(iter(items), depth=depth)
    assert _within_limit(lambda: list(pre)) == items
    with pytest.raises(StopIteration):
        _within_limit(lambda: next(pre))


def test_a_producer_error_reaches_the_consumer_with_its_type():
    def broken():
        yield 1
        yield 2
        raise KeyError("row 3")

    pre = PrefetchIterator(broken(), depth=1)
    assert _within_limit(lambda: next(pre)) == 1
    assert _within_limit(lambda: next(pre)) == 2
    with pytest.raises(KeyError, match="row 3"):
        _within_limit(lambda: next(pre))
    pre.close()  # seen by the consumer: not raised again


def test_close_joins_a_blocked_producer_and_raises_an_unseen_error():
    pre = _full_queue(range(100), 2)
    _within_limit(pre.close)
    assert not pre.thread.is_alive()

    def broken():
        raise OSError("disk")
        yield  # a generator

    pre = PrefetchIterator(broken(), depth=1)
    _within_limit(lambda: _wait(lambda: pre.error is not None))
    with pytest.raises(OSError, match="disk"):
        pre.close()
    with PrefetchIterator(iter([1, 2, 3]), depth=1) as p:
        assert next(p) == 1
    assert not p.thread.is_alive()


def _loader(n=24, batch=4, seed=5):
    data = np.random.default_rng(seed).integers(0, 256, (n, 6, 6, 3),
                                                dtype=np.uint8)
    return tdata.StreamingLoader(tdata.ArraySource(data), batch, seed=seed,
                                 num_threads=2)


@pytest.mark.parametrize("depth", [1, 2, 5])
def test_device_prefetcher_on_cpu_tensors(depth):
    pre = DevicePrefetcher(_loader(), depth=depth)
    plain = iter(_loader())
    reference = _loader()
    for _ in range(8):  # across the epoch boundary (6 batches an epoch)
        assert pre.state() == reference.state()
        got = next(pre)
        assert got.device.type == "cpu" and got.dtype == torch.uint8
        want = next(plain)
        np.testing.assert_array_equal(got.numpy(), want)
        reference.restore({"epoch": pre.state()["epoch"],
                           "offset": pre.state()["offset"], "seed": 5})
        fetch_s, transfer_s = pre.last_timing()
        assert fetch_s >= 0 and transfer_s >= 0


def test_device_prefetcher_restores_to_the_consumers_position():
    pre = DevicePrefetcher(_loader(), depth=3)
    batches = [next(pre) for _ in range(4)]
    assert pre.state() == {"epoch": 0, "offset": 4, "seed": 5}
    pre.restore({"epoch": 0, "offset": 1, "seed": 5})
    again = [next(pre) for _ in range(3)]
    for a, b in zip(again, batches[1:]):
        assert torch.equal(a, b)
    # tuples (CLIP's images and tokens) keep their structure
    images = np.zeros((8, 2, 2, 3), np.uint8)
    tokens = np.arange(16).reshape(8, 2)
    paired = DevicePrefetcher(tdata.PairedArrayLoader(images, tokens, 4),
                              depth=2)
    x, t = next(paired)
    assert x.shape == (4, 2, 2, 3) and t.shape == (4, 2)


def test_pipelines_with_prefetch_give_the_same_views():
    data = np.random.default_rng(2).integers(0, 256, (16, 8, 8, 3),
                                             dtype=np.uint8)

    def pipe(prefetch):
        loader = tdata.StreamingLoader(tdata.ArraySource(data), 4, seed=1)
        return tdata.TwoViewPipeline(loader, "cpu", seed=3,
                                     prefetch=prefetch)

    plain, ahead = pipe(0), pipe(2)
    for _ in range(6):
        assert plain.state() == ahead.state()
        for a, b in zip(next(plain), next(ahead)):
            assert torch.equal(a, b)
    assert plain.last_timing() is None and ahead.last_timing() is not None


# ---------------------------------------------------------------------------
# The lag-1 loop
# ---------------------------------------------------------------------------

def _run(lag, nan_at=(), steps=4, guard=None, hook_log=None):
    """A tiny ResNet SimCLR run of ``steps`` guarded steps; the batches
    numbered in ``nan_at`` (from 1) NaN-filled. Returns the state, the
    outcomes the guard saw and the history."""
    _, _, model = tiny_simclr_pair()
    state = ttrain.create_train_state(
        model, ttrain.TrainerConfig(**GUARD_CONFIG), torch.device("cpu"))
    views = step_views(steps)

    def batches():
        for i, (v1, v2) in enumerate(views, 1):
            v1 = torch.from_numpy(v1)
            if i in nan_at:
                v1 = torch.full_like(v1, float("nan"))
            yield v1, torch.from_numpy(v2)

    outcomes = []

    class Recording(DivergenceGuard):
        def __call__(self, outcome):
            outcomes.append(outcome)
            if hook_log is not None:
                hook_log.append(("outcome", outcome.step))
            return super().__call__(outcome)

    guard = guard or Recording(backoff_after=None, rollback_after=None)
    step_hook = (None if hook_log is None
                 else lambda s: hook_log.append(("hook", s.step)))
    history = ttrain.train_loop(
        state, batches(), ttrain.make_train_step(STEP_CONFIG["temperature"],
                                                 guard=True),
        steps, log_every=1, step_guard=guard, metrics_lag=lag,
        step_hook=step_hook, log=False)
    return state, outcomes, history


def _flat(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, prefix + (k,)))
        elif v is not None:
            out[prefix + (k,)] = np.asarray(v)
    return out


def _assert_bitwise(a, b):
    fa, fb = _flat(train_state_dict(a)), _flat(train_state_dict(b))
    assert fa.keys() == fb.keys()
    for key, value in fa.items():
        np.testing.assert_array_equal(fb[key], value, err_msg=str(key))


@pytest.mark.parametrize("nan_at", [(), (2,), (1, 3)],
                         ids=["clean", "nan2", "nan1_3"])
def test_lag1_ends_bit_for_bit_where_the_sync_guard_ends(nan_at):
    sync, out0, hist0 = _run(0, nan_at)
    lag, out1, hist1 = _run(1, nan_at)
    _assert_bitwise(sync, lag)
    assert sync.optimizer.count == lag.optimizer.count == 4 - len(nan_at)
    assert [(o.step, o.ok, o.lag) for o in out0] == [
        (i, i not in nan_at, 0) for i in range(1, 5)]
    assert [(o.step, o.ok, o.lag) for o in out1] == [
        (i, i not in nan_at, 1) for i in range(1, 5)]
    for a, b in zip(out0, out1):
        assert a.loss == b.loss or (np.isnan(a.loss) and np.isnan(b.loss))
    assert [h["step"] for h in hist1] == [1, 2, 3, 4]
    assert all(h["data_wait_ms"] >= 0 for h in hist1)


def test_unguarded_lag1_equals_the_plain_loop():
    def run(lag):
        _, _, model = tiny_simclr_pair()
        state = ttrain.create_train_state(
            model, ttrain.TrainerConfig(**GUARD_CONFIG), torch.device("cpu"))
        views = [tuple(map(torch.from_numpy, v)) for v in step_views(3)]
        hist = ttrain.train_loop(state, iter(views), ttrain.make_train_step(
            STEP_CONFIG["temperature"]), 3, log_every=2, metrics_lag=lag,
            log=False)
        return state, hist

    (a, ha), (b, hb) = run(0), run(1)
    _assert_bitwise(a, b)
    assert [h["step"] for h in ha] == [h["step"] for h in hb] == [2, 3]
    assert [h["loss"] for h in ha] == [h["loss"] for h in hb]


def test_a_nan_on_the_last_step_still_raises():
    def halt(outcome):
        if not outcome.ok:
            raise DivergenceError(f"step {outcome.step}")

    with pytest.raises(DivergenceError, match="step 4"):
        _run(1, nan_at=(4,), guard=halt)
    halt.scale_value = lambda: 1.0  # as a guard with a scale, too
    with pytest.raises(DivergenceError, match="step 4"):
        _run(1, nan_at=(4,), guard=halt)


def test_lag_must_be_0_or_1():
    with pytest.raises(ValueError, match="metrics_lag must be 0 or 1"):
        _run(2)


def _jax_events(nan_at, steps=4):
    """The order of the JAX loop's step hooks and outcomes under lag 1."""
    jmodel, variables, _ = tiny_simclr_pair()
    jstate = _jax_state(jmodel, variables, 8)
    events, outcomes = [], []

    class Recording(JaxGuard):
        def __call__(self, outcome):
            outcomes.append(outcome)
            events.append(("outcome", outcome.step))
            return super().__call__(outcome)

    def batches():
        for i, (v1, v2) in enumerate(step_views(steps), 1):
            if i in nan_at:
                v1 = np.full_like(v1, np.nan)
            yield jnp.asarray(v1), jnp.asarray(v2)

    jax_train_loop(jstate, batches(), jax_step(STEP_CONFIG["temperature"],
                                               guard=True), steps,
                   log_every=1, flops_per_step=None,
                   step_hook=lambda s: events.append(("hook", int(s.step))),
                   step_guard=Recording(backoff_after=None,
                                        rollback_after=None),
                   metrics_lag=1)
    return events, outcomes


def test_outcomes_and_hooks_come_in_the_jax_order():
    events = []
    _, outcomes, _ = _run(1, nan_at=(3,), hook_log=events)
    jevents, joutcomes = _jax_events(nan_at=(3,))
    assert events == jevents
    assert [(o.step, o.ok, o.lag) for o in outcomes] == [
        (o.step, o.ok, o.lag) for o in joutcomes]
    assert [o.lag for o in outcomes] == [1, 1, 1, 1]
    jax.clear_caches()


def test_lars_kept_step_equals_the_host_step_and_counts_on_the_device():
    _, _, model = tiny_simclr_pair()
    a = ttrain.create_train_state(model, ttrain.TrainerConfig(**GUARD_CONFIG),
                                  torch.device("cpu"))
    b = ttrain.create_train_state(copy.deepcopy(model), ttrain.TrainerConfig(
        **GUARD_CONFIG), torch.device("cpu"))
    for p, q in zip(a.model.parameters(), b.model.parameters()):
        p.grad = torch.full_like(p, 0.01)
        q.grad = torch.full_like(q, 0.01)
    for ok in (True, True):
        a.optimizer.step()
        b.optimizer.step_kept(torch.tensor(ok))
    _assert_bitwise(a, b)
    b.optimizer.step_kept(torch.tensor(False))  # the count stays
    assert b.optimizer.count == 2
    b.optimizer.count = 7
    assert b.optimizer.count == 7


def test_lag1_guard_under_accumulation_runs_through_the_cli(monkeypatch):
    """``train --lag-metrics --accum-steps 2 --nan-policy skip`` with a
    NaN micro-batch ends where the run without ``--lag-metrics`` ends
    (``test_torch_accum_lag.py`` holds the steps themselves)."""
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    argv = ["--device", "cpu", "--model", "tiny", "--image-size", "8",
            "--batch", "4", "--steps", "4", "--log-every", "1",
            "--proj-hidden-dim", "16", "--proj-dim", "8",
            "--synthetic-samples", "8", "--warmup-steps", "1",
            "--accum-steps", "2", "--nan-policy", "skip", "--chaos",
            "nan@2"]
    lag, hist = cli.train(cli.build_train_parser().parse_args(
        argv + ["--lag-metrics"]))
    sync, _ = cli.train(cli.build_train_parser().parse_args(argv))
    assert [np.isfinite(h["loss"]) for h in hist] == [True, False, True,
                                                      True]
    assert lag.optimizer.counters is not None
    assert (lag.optimizer.mini_step, lag.optimizer.gradient_step) == (1, 1)
    _assert_bitwise(sync, lag)


# ---------------------------------------------------------------------------
# The pipeline flags on the data-parallel branches (gloo worlds of 2)
# ---------------------------------------------------------------------------

def _world_of_2(tmp_path, argv, name) -> str:
    """``ntxent-train`` ``argv`` in a gloo world of 2; rank 0's log."""
    import torch_dist_workers as workers
    from test_torch_distributed import _spawn

    out = tmp_path / name
    out.mkdir()
    _spawn(workers.run_cli, 2, (argv, str(out)), out)
    return (out / "rank0.log").read_text()


def _losses(log: str) -> list[str]:
    import re

    return re.findall(r"trainer: step \d+ loss (\S+)", log)


PIPED = ["--prefetch", "2", "--lag-metrics"]


def test_data_parallel_simclr_takes_the_pipeline_flags(tmp_path):
    """Each rank reads its rows of the npy store through the native
    loader, prefetch and the lag-1 guard: the losses are those of the
    threaded loader without them, in the same world."""
    store = tmp_path / "rows.npy"
    np.save(store, np.random.default_rng(4).integers(0, 256, (16, 8, 8, 3),
                                                     dtype=np.uint8))
    argv = ["--device", "cpu", "--model", "tiny", "--batch", "8", "--steps",
            "3", "--log-every", "1", "--proj-hidden-dim", "16", "--proj-dim",
            "8", "--dataset", "npy", "--data-dir", str(store),
            "--nan-policy", "skip"]
    plain = _world_of_2(tmp_path, argv, "plain")
    piped = _world_of_2(tmp_path, argv + ["--loader", "native", *PIPED],
                        "piped")
    assert "data-parallel over 2 ranks (gloo, strip loss)" in piped
    assert "device prefetch: depth 2" in piped and "lag-1" in piped
    assert len(_losses(plain)) == 3 and _losses(piped) == _losses(plain)


def test_data_parallel_clip_takes_the_pipeline_flags(tmp_path):
    from test_torch_clip_dp import CLI_ARGV

    plain = _world_of_2(tmp_path, CLI_ARGV, "plain")
    piped = _world_of_2(tmp_path, CLI_ARGV + PIPED + ["--loader", "native"],
                        "piped")
    assert "--loader native ignored" in piped and "lag-1" in piped
    assert len(_losses(plain)) == 2 and _losses(piped) == _losses(plain)
