"""Training resilience of the port on the CPU, against the JAX package
where it has a counterpart: the chaos plans (``resilience.faults``), the
divergence guard (``resilience.guard`` and the guarded steps), the stall
watchdog (``utils.watchdog``), the supervisor and the CLI's resilience
flags.

The JAX package's own cases (``tests/test_resilience.py``,
``tests/test_watchdog.py``) are repeated against the port's modules; the
plan parser, the guard's tiers and the guarded steps are held to the JAX
objects on the same inputs.

Tolerances: the guarded steps take the same fp32 arithmetic in another
summation order, over steps at a small learning rate (``GUARD_CONFIG``)
-> 1e-5 absolute on the loss and the running statistics, 1e-5 relative
on the gradient norm, each parameter and momentum leaf within 1e-5 plus
5e-4 of the norm of its change (the train steps' bound of
``test_torch_resnet.py``: a ReLU whose input lies within rounding of 0
takes the other side in one package and moves one gradient entry by
~1e-3, as it does on two of the four tiny-ResNet batches here); the
counts, the step and the decisions exactly. A skipped step leaves the
state bit for bit as it was. The guarded step at scale 1 on a clean batch
equals the unguarded step bit for bit (it only adds a norm and a
multiplication by 1.0). Restarts that replay from a checkpoint equal the
uninterrupted run bit for bit (the same CPU arithmetic in the same
order), compared by the checkpoints' CRC32.
"""

import dataclasses
import errno
import json
import logging
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from ntxent_tpu.resilience import DivergenceError as JaxDivergenceError
from ntxent_tpu.resilience import DivergenceGuard as JaxGuard
from ntxent_tpu.resilience import FaultInjector as JaxInjector
from ntxent_tpu.resilience import FaultPlan as JaxPlan
from ntxent_tpu.training.trainer import StepOutcome as JaxOutcome
from ntxent_tpu.training.trainer import make_train_step as jax_step
from ntxent_tpu_torch import cli
from ntxent_tpu_torch.resilience import (
    ChaosError,
    DivergenceError,
    DivergenceGuard,
    FaultInjector,
    FaultPlan,
    RetryPolicy,
    truncate_checkpoint_file,
)
from ntxent_tpu_torch.resilience.supervisor import Supervisor
from ntxent_tpu_torch.training import (
    ArraySource,
    StepOutcome,
    StreamingLoader,
    fit,
    train_loop,
)
from ntxent_tpu_torch.training import trainer as ttrain
from ntxent_tpu_torch.utils.watchdog import StallWatchdog
from ntxent_tpu_torch.weights import train_state_dict

from test_torch_resnet import STEP_CONFIG, step_views, tiny_simclr_pair
from test_torch_training import (
    BATCH,
    IMAGE,
    _tiny_jax_simclr,
    _tiny_port_simclr,
)

torch.set_num_threads(1)  # see test_torch_training.py

TINY_ARGV = ["--device", "cpu", "--model", "tiny", "--image-size", "8",
             "--batch", "4", "--log-every", "1", "--proj-hidden-dim", "16",
             "--proj-dim", "8", "--synthetic-samples", "8",
             "--warmup-steps", "1", "--base-lr", "3.0"]
CLIP_ARGV = ["--objective", "clip", "--model", "tiny", "--device", "cpu",
             "--image-size", "16", "--token-len", "16", "--vocab-size", "100",
             "--batch", "8", "--steps", "2", "--synthetic-samples", "24",
             "--warmup-steps", "1", "--base-lr", "1e-3", "--log-every", "1"]


def _np(tree):
    return jax.tree_util.tree_map(np.array, jax.device_get(tree))


def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out |= _flat(v, prefix + (k,))
        return out
    return {prefix: tree}


def _assert_state_close(ours: dict, theirs: dict, start: dict):
    """Two train-state dicts of the JAX layout, leaf for leaf: the counts
    and the step exactly, the running statistics within 1e-5, each
    parameter and momentum leaf within 1e-5 plus 5e-4 of the norm of its
    change since ``start`` (the train-step bound of
    ``test_torch_resnet.py``)."""
    ours, theirs, start = _flat(ours), _flat(theirs), _flat(start)
    assert sorted(ours) == sorted(theirs)
    for key, want in theirs.items():
        if want is None:
            assert ours[key] is None, key
            continue
        got, want = np.asarray(ours[key]), np.asarray(want)
        if key[0] == "params" or "trace" in key:
            change = float(np.linalg.norm(want - np.asarray(start[key])))
            err = float(np.linalg.norm(got - want))
            assert err <= 1e-5 + 5e-4 * change, (key, err, change)
            continue
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=0,
                                   err_msg=str(key))


# ---------------------------------------------------------------------------
# Chaos plans and the injector
# ---------------------------------------------------------------------------

GOOD_SPECS = ["nan@3, sigterm@6,truncate@1,fetch@2,crash@5", "",
              "kill@4,diskfull@2,shrink@5,grow@7,nan@1,nan@9",
              "killworker@7,slowworker@2,spike@3,drainworker@4",
              "killshard@1,lagshard@9,,truncate@2"]
BAD_SPECS = ["nan3", "explode@1", "nan@x", "nan@0", "crash@-2"]


@pytest.mark.parametrize("spec", GOOD_SPECS)
def test_faultplan_parse_matches_jax(spec):
    ours, theirs = FaultPlan.parse(spec, seed=4), JaxPlan.parse(spec, seed=4)
    assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)


@pytest.mark.parametrize("spec", BAD_SPECS)
def test_faultplan_parse_rejects_as_jax(spec):
    with pytest.raises(ValueError) as theirs:
        JaxPlan.parse(spec)
    with pytest.raises(ValueError) as ours:
        FaultPlan.parse(spec)
    assert str(ours.value) == str(theirs.value)


def test_injector_ordinals_match_jax():
    spec = "nan@2,crash@3,killworker@1,lagshard@1"
    ours, theirs = FaultInjector(FaultPlan.parse(spec)), \
        JaxInjector(JaxPlan.parse(spec))
    b1 = ours.on_batch((torch.ones(3), torch.ones(3)))
    assert all(bool(torch.isfinite(t).all()) for t in b1)
    theirs.on_batch((jnp.ones(3), jnp.ones(3)))
    b2 = ours.on_batch((torch.ones(3), torch.ones(3)))
    assert all(bool(torch.isnan(t).all()) for t in b2)
    theirs.on_batch((jnp.ones(3), jnp.ones(3)))
    with pytest.raises(ChaosError):
        ours.on_batch((torch.ones(3), torch.ones(3)))
    with pytest.raises(Exception, match="injected crash at batch 3"):
        theirs.on_batch((jnp.ones(3), jnp.ones(3)))
    assert ours.fired == theirs.fired == ["nan@2", "crash@3"]


def test_injector_poison_spares_integer_tensors():
    injector = FaultInjector(FaultPlan.parse("nan@1"))
    imgs, toks = injector.on_batch((torch.ones(2, 4),
                                    torch.ones(2, 4, dtype=torch.long)))
    assert bool(torch.isnan(imgs).all()) and imgs.dtype == torch.float32
    assert bool((toks == 1).all()) and toks.dtype == torch.long


def test_injector_diskfull_and_truncate(tmp_path):
    injector = FaultInjector(FaultPlan.parse("diskfull@2,truncate@2"))
    injector.on_checkpoint_write()
    with pytest.raises(OSError) as e:
        injector.on_checkpoint_write()
    assert e.value.errno == errno.ENOSPC
    injector.on_checkpoint_write()
    for step, size in ((1, 64), (3, 100)):
        (tmp_path / str(step)).mkdir()
        (tmp_path / str(step) / "state.msgpack").write_bytes(b"x" * size)
        (tmp_path / str(step) / "meta.json").write_bytes(b"{}")
    injector.between_attempts(tmp_path)  # attempt 1: nothing due
    assert (tmp_path / "3" / "state.msgpack").stat().st_size == 100
    injector.between_attempts(tmp_path)
    assert (tmp_path / "3" / "state.msgpack").stat().st_size == 50
    assert (tmp_path / "1" / "state.msgpack").stat().st_size == 64
    assert injector.fired == ["diskfull@2", "truncate@2"]
    assert truncate_checkpoint_file(tmp_path / "none") is None


def test_chaos_iterator_keeps_the_data_position():
    args = cli.build_train_parser().parse_args(TINY_ARGV)
    args.image_size = 8
    pipe = FaultInjector(FaultPlan.parse("nan@9")).wrap_iterator(
        cli._make_pipeline(args, torch.device("cpu")))
    next(pipe)
    state = pipe.state()
    want = next(pipe)
    pipe.restore(state)
    got = next(pipe)
    assert all(torch.equal(a, b) for a, b in zip(want, got))


# ---------------------------------------------------------------------------
# Retrying loader reads
# ---------------------------------------------------------------------------

def test_streaming_loader_retries_flaky_fetch():
    images = np.random.RandomState(0).rand(32, 4, 4, 3).astype(np.float32)
    injector = FaultInjector(FaultPlan.parse("fetch@2,fetch@5"))
    loader = StreamingLoader(
        injector.wrap_source(ArraySource(images)), 8, seed=3,
        retry_policy=RetryPolicy(max_attempts=3, base_delay_s=0.0))
    clean = StreamingLoader(ArraySource(images), 8, seed=3)
    for got, want in zip(loader, clean):
        np.testing.assert_array_equal(got, want)
        if injector._fetches > 40:
            break
    assert injector.fired == ["fetch@2", "fetch@5"]


def test_streaming_loader_without_retry_propagates():
    images = np.random.RandomState(0).rand(32, 4, 4, 3).astype(np.float32)
    injector = FaultInjector(FaultPlan.parse("fetch@1"))
    loader = StreamingLoader(injector.wrap_source(ArraySource(images)), 8)
    with pytest.raises(OSError, match="injected transient fetch failure"):
        next(iter(loader))


# ---------------------------------------------------------------------------
# DivergenceGuard against the JAX guard
# ---------------------------------------------------------------------------

# (constructor arguments, outcome pattern: 1 ok, 0 skipped)
GUARD_CASES = [
    (dict(backoff_after=2, rollback_after=5), "0010011100"),
    (dict(backoff_after=1, rollback_after=None, regrow_after=2),
     "0110111011111"),
    (dict(backoff_after=1, rollback_after=None, min_scale=0.2), "0000001"),
    (dict(backoff_after=1, rollback_after=9, min_scale=0.3), "0000"),
    (dict(backoff_after=None, rollback_after=None), "00000000001"),
    (dict(backoff_after=3, rollback_after=None, backoff_factor=0.25,
          regrow_after=1), "000000111"),
]


def _drive(guard, outcome_cls, error_cls, pattern):
    trace = []
    for i, c in enumerate(pattern, start=1):
        outcome = outcome_cls(step=i, loss=1.0 if c == "1" else float("nan"),
                              grad_norm=1.0, ok=c == "1")
        try:
            guard(outcome)
            trace.append(("ok", guard.scale, guard.consecutive_skips,
                          guard.total_skips))
        except error_cls as e:
            trace.append(("rollback", str(e), guard.scale))
            guard.reset_attempt()
    return trace


@pytest.mark.parametrize("kwargs,pattern", GUARD_CASES)
def test_divergence_guard_matches_jax(kwargs, pattern):
    ours = _drive(DivergenceGuard(**kwargs), StepOutcome, DivergenceError,
                  pattern)
    theirs = _drive(JaxGuard(**kwargs), JaxOutcome, JaxDivergenceError,
                    pattern)
    assert ours == theirs


def test_divergence_guard_keeps_stats_and_the_scale_across_attempts():
    guard = DivergenceGuard(backoff_after=1, rollback_after=3)
    bad = StepOutcome(step=1, loss=float("nan"), grad_norm=None, ok=False)
    guard(bad)
    guard(bad)
    with pytest.raises(DivergenceError):
        guard(bad)
    assert guard.stats == {"skips": 3, "backoffs": 2, "rollbacks": 1,
                           "scale": 0.25}
    guard.reset_attempt()
    assert guard.total_skips == 0 and guard.scale_value() == 0.25
    assert isinstance(guard.scale_value(), float)
    with pytest.raises(ValueError):
        DivergenceGuard(backoff_factor=1.0)


# ---------------------------------------------------------------------------
# Guarded steps against the JAX guarded step
# ---------------------------------------------------------------------------

# The guarded steps' optimizer: test_torch_resnet.py's step at a tenth of
# its learning rate. At its own (0.094 at batch 8) the tiny ResNet's loss
# oscillates from step to step and the fp32 order differences of both
# packages grow ~10x a step, guard or no guard (the plain steps drift the
# same); at 0.0094 a step moves each parameter little, and the comparison
# sees the guard, not that amplification.
GUARD_CONFIG = dict(STEP_CONFIG, base_lr=0.3)


def _jax_state(jmodel, variables, image):
    from ntxent_tpu.training.trainer import TrainerConfig as JaxConfig
    from ntxent_tpu.training.trainer import create_train_state as jax_state

    jstate = jax_state(jmodel, jax.random.PRNGKey(0), (1, image, image, 3),
                       JaxConfig(**GUARD_CONFIG))
    return jstate.replace(
        params=jax.tree_util.tree_map(jnp.asarray, variables["params"]),
        batch_stats=jax.tree_util.tree_map(jnp.asarray,
                                           variables["batch_stats"]))


def _vit_pair():
    from ntxent_tpu_torch.weights import load_flax_variables

    jmodel, variables = _tiny_jax_simclr("xla")
    model = load_flax_variables(_tiny_port_simclr("xla"), variables)
    rng = np.random.default_rng(9)
    views = [tuple(rng.uniform(size=(BATCH, IMAGE, IMAGE, 3)).astype(
        np.float32) for _ in range(2)) for _ in range(4)]
    return _jax_state(jmodel, variables, IMAGE), model, views


def _resnet_pair():
    jmodel, variables, model = tiny_simclr_pair()
    return _jax_state(jmodel, variables, 8), model, step_views(4)


PAIRS = {"vit": _vit_pair, "resnet": _resnet_pair}
# (batch index, poisoned, scale): a clean step, a NaN batch, a clean step
# at half scale, a clean step
SEQUENCE = [(0, False, 1.0), (1, True, 1.0), (2, False, 0.5),
            (3, False, 1.0)]


def _port_state(model):
    return ttrain.create_train_state(model, ttrain.TrainerConfig(
        **GUARD_CONFIG), torch.device("cpu"))


@pytest.mark.parametrize("which", sorted(PAIRS))
def test_guarded_steps_match_jax(which):
    jstate, model, views = PAIRS[which]()
    jstep = jax_step(STEP_CONFIG["temperature"], guard=True)
    state = _port_state(model)
    step = ttrain.make_train_step(STEP_CONFIG["temperature"], guard=True)
    start = train_state_dict(state)
    for index, poisoned, scale in SEQUENCE:
        v1, v2 = views[index]
        if poisoned:
            v1 = np.full_like(v1, np.nan)
        before = train_state_dict(state)
        jstate, jm = jstep(jstate, jnp.asarray(v1), jnp.asarray(v2),
                           jnp.asarray(scale, jnp.float32))
        state, m = step(state, torch.from_numpy(v1), torch.from_numpy(v2),
                        scale)
        assert bool(m["step_ok"]) == bool(jm["step_ok"]) == (not poisoned)
        ours = train_state_dict(state)
        _assert_state_close(ours, _np(serialization.to_state_dict(jstate)),
                            start)
        if poisoned:
            assert not np.isfinite(float(m["loss"]))
            assert int(ours["step"]) == int(before["step"]) + 1
            before.pop("step"), ours.pop("step")
            for key, value in _flat(before).items():
                if value is not None:  # bit for bit as before the step
                    np.testing.assert_array_equal(_flat(ours)[key], value)
        else:
            np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                                       atol=1e-5, rtol=0)
            np.testing.assert_allclose(float(m["grad_norm"]),
                                       float(jm["grad_norm"]), rtol=1e-5)
    assert state.step == 4 and state.optimizer.count == 3


@pytest.mark.parametrize("which", sorted(PAIRS))
def test_guarded_step_at_scale_1_equals_the_plain_step_bitwise(which):
    _, model, views = PAIRS[which]()
    plain = _port_state(model)
    guarded = _port_state(_copy(model))
    pstep = ttrain.make_train_step(STEP_CONFIG["temperature"])
    gstep = ttrain.make_train_step(STEP_CONFIG["temperature"], guard=True)
    for v1, v2 in views[:3]:
        plain, pm = pstep(plain, torch.from_numpy(v1), torch.from_numpy(v2))
        guarded, gm = gstep(guarded, torch.from_numpy(v1),
                            torch.from_numpy(v2))
        assert torch.equal(pm["loss"], gm["loss"]) and bool(gm["step_ok"])
    a, b = _flat(train_state_dict(plain)), _flat(train_state_dict(guarded))
    for key, value in a.items():
        if value is not None:
            np.testing.assert_array_equal(b[key], value, err_msg=str(key))


def _copy(model):
    import copy

    return copy.deepcopy(model)


def test_train_loop_step_guard_rollback_escalates():
    _, model, views = _resnet_pair()
    state = _port_state(model)
    step = ttrain.make_train_step(0.1, guard=True)

    def nan_batches():
        v1, v2 = views[0]
        while True:
            yield torch.full((8, 8, 8, 3), float("nan")), torch.from_numpy(v2)

    guard = DivergenceGuard(backoff_after=None, rollback_after=2)
    with pytest.raises(DivergenceError):
        train_loop(state, nan_batches(), step, num_steps=10, log_every=100,
                   step_guard=guard)
    assert guard.total_skips == 2 and state.step == 2
    assert state.optimizer.count == 0


# ---------------------------------------------------------------------------
# The stall watchdog (tests/test_watchdog.py's cases)
# ---------------------------------------------------------------------------

def _wait_for(event, timeout_s=5.0):
    assert event.wait(timeout_s), "watchdog never fired"


def test_watchdog_detects_a_stall_and_dumps_stacks(tmp_path):
    dump = tmp_path / "stall.txt"
    fired = []
    dog = StallWatchdog(timeout_s=0.3, on_stall=fired.append,
                        dump_path=str(dump))
    with dog:
        _wait_for(dog.stalled)
    assert fired and fired[0] >= 0.3
    text = dump.read_text()
    assert "StallWatchdog dump" in text
    assert "test_torch_resilience" in text or "threading" in text


def test_watchdog_beats_prevent_a_stall():
    dog = StallWatchdog(timeout_s=0.5, poll_s=0.05)
    with dog:
        for _ in range(12):
            time.sleep(0.1)
            dog.beat()
        assert not dog.stalled.is_set()


def test_watchdog_beat_rearms_after_a_stall():
    dog = StallWatchdog(timeout_s=0.2, poll_s=0.05)
    with dog:
        _wait_for(dog.stalled)
        dog.beat()
        assert not dog.stalled.is_set()
        _wait_for(dog.stalled)


def test_watchdog_on_stall_is_one_shot_until_reset():
    fired = []
    dog = StallWatchdog(timeout_s=0.2, poll_s=0.05, on_stall=fired.append)
    with dog:
        _wait_for(dog.fired)
        _wait_for(dog.stalled)
        dog.beat()
        _wait_for(dog.stalled)
        time.sleep(0.2)
        assert len(fired) == 1
        dog.reset()
        _wait_for(dog.stalled)
    assert len(fired) == 2


def test_watchdog_contains_an_on_stall_exception(tmp_path):
    def boom(_):
        raise RuntimeError("policy failed")

    dog = StallWatchdog(timeout_s=0.2, on_stall=boom,
                        dump_path=str(tmp_path / "d.txt"))
    with dog:
        _wait_for(dog.stalled)


def test_watchdog_rejects_a_bad_timeout_and_restarts():
    with pytest.raises(ValueError):
        StallWatchdog(timeout_s=0.0)
    dog = StallWatchdog(timeout_s=0.2, poll_s=0.05)
    dog.start()
    dog.stop()
    dog.start()
    try:
        _wait_for(dog.stalled)
    finally:
        dog.stop()


def test_train_loop_beats_the_watchdog():
    _, model, views = _resnet_pair()
    state = _port_state(model)
    data = iter([tuple(map(torch.from_numpy, v)) for v in views])
    with StallWatchdog(timeout_s=30.0, poll_s=0.05) as dog:
        beats = []
        real = dog.beat
        dog.beat = lambda: (beats.append(1), real())[1]
        history = train_loop(state, data, ttrain.make_train_step(0.1), 4,
                             log_every=1, watchdog=dog)
    assert not dog.stalled.is_set() and len(history) == 4
    assert len(beats) == 4


# ---------------------------------------------------------------------------
# The supervisor (tests/test_resilience.py's cases)
# ---------------------------------------------------------------------------

class _FakeState:
    def __init__(self, step):
        self.step = step


def _fast_backoff():
    return RetryPolicy(max_attempts=10, base_delay_s=0.0, jitter=0.0)


def test_supervisor_restarts_after_a_crash():
    seen = []

    def run_attempt(attempt, stop_fn, watchdog):
        seen.append(attempt)
        if attempt == 0:
            raise ChaosError("boom")
        return _FakeState(10), [{"step": 10, "loss": 1.0}]

    result = Supervisor(run_attempt, num_steps=10, max_restarts=2,
                        backoff=_fast_backoff(), sleep=lambda s: None).run()
    assert result.completed and seen == [0, 1]
    assert "boom" in result.records[0].error
    assert result.records[0].end_step is None
    assert result.records[1].error is None
    assert result.records[1].end_step == 10 and result.state.step == 10
    assert result.history == [{"step": 10, "loss": 1.0}]


def test_supervisor_gives_up_when_the_budget_is_spent():
    def run_attempt(attempt, stop_fn, watchdog):
        raise ChaosError(f"attempt {attempt} dies")

    slept = []
    result = Supervisor(run_attempt, num_steps=10, max_restarts=2,
                        backoff=_fast_backoff(), sleep=slept.append).run()
    assert not result.completed and len(result.records) == 3
    assert len(slept) == 2
    with pytest.raises(ValueError):
        Supervisor(run_attempt, num_steps=1, max_restarts=-1)


def test_supervisor_restarts_a_topology_change_on_the_same_world():
    """``shrink@1`` ends the attempt with ``TopologyChange``; with no
    elastic rebuild ported, the next attempt runs on the same world."""
    injector = FaultInjector(FaultPlan.parse("shrink@1"))
    batches = injector.wrap_iterator(iter([(torch.ones(1),)] * 4))

    def run_attempt(attempt, stop_fn, watchdog):
        next(batches)
        return _FakeState(5), []

    result = Supervisor(run_attempt, num_steps=5, max_restarts=1,
                        backoff=_fast_backoff(), sleep=lambda s: None).run()
    assert result.completed and injector.fired == ["shrink@1"]
    assert result.records[0].topology == "shrink"
    assert result.records[0].end_step is None
    assert result.records[1].topology is None


def test_supervisor_stall_escalation_stops_and_restarts():
    def run_attempt(attempt, stop_fn, watchdog):
        if attempt == 0:  # hung: never beats until the guard stops it
            deadline = time.monotonic() + 10.0
            while not stop_fn():
                assert time.monotonic() < deadline, "no stall escalation"
                time.sleep(0.02)
            return _FakeState(4), []
        watchdog.beat()
        return _FakeState(10), [{"step": 10, "loss": 0.5}]

    result = Supervisor(run_attempt, num_steps=10, max_restarts=2,
                        backoff=_fast_backoff(), sleep=lambda s: None,
                        stall_timeout_s=0.3).run()
    assert result.completed
    assert result.records[0].stalled and result.records[0].preempted
    assert not result.records[1].stalled


def _pipeline(args):
    args.image_size = 8
    return cli._make_pipeline(args, torch.device("cpu"))


def _tiny_state(args):
    args.image_size = 8
    return ttrain.create_train_state(cli.build_model(args),
                                     cli._train_config(args),
                                     torch.device("cpu"))


def test_supervisor_chaos_plan_completes_with_fit(tmp_path):
    """The reference's acceptance scenario through the port's ``fit``:
    nan@3, sigterm@6 and truncate@1 under a supervisor; the run reaches
    its steps, step counters never regress, attempt 0 was preempted and
    attempt 1 resumed behind its save (the truncated newest step)."""
    args = cli.build_train_parser().parse_args(TINY_ARGV + ["--steps", "10"])
    injector = FaultInjector(FaultPlan.parse("nan@3,sigterm@6,truncate@1"))
    step = ttrain.make_train_step(0.1, guard=True)
    guard = DivergenceGuard(backoff_after=None, rollback_after=None)
    data = injector.wrap_iterator(_pipeline(args))

    def run_attempt(attempt, stop_fn, watchdog):
        guard.reset_attempt()
        return fit(_tiny_state(args), data, step, 10,
                   checkpoint_dir=str(tmp_path), checkpoint_every=2,
                   log_every=1, stop_fn=stop_fn, watchdog=watchdog,
                   step_guard=guard)

    result = Supervisor(run_attempt, num_steps=10,
                        checkpoint_dir=str(tmp_path), max_restarts=3,
                        backoff=_fast_backoff(), sleep=lambda s: None,
                        injector=injector).run()
    assert sorted(injector.fired) == ["nan@3", "sigterm@6", "truncate@1"]
    assert result.completed and result.state.step == 10
    assert np.isfinite(result.histories[-1][-1]["loss"])
    for history in result.histories:
        steps = [h["step"] for h in history]
        assert steps == sorted(steps)
    ends = [r.end_step for r in result.records]
    assert ends == sorted(ends) and len(result.records) == 2
    assert result.records[0].preempted
    assert 1 <= result.records[0].end_step < 10
    assert guard.stats["skips"] == 1


# ---------------------------------------------------------------------------
# The CLI's resilience flags
# ---------------------------------------------------------------------------

def _train(tmp_path, name, *flags):
    directory = tmp_path / name
    args = cli.build_train_parser().parse_args(
        TINY_ARGV + ["--ckpt-dir", str(directory), "--ckpt-every", "1",
                     "--ckpt-keep-last", "0", *flags])
    state, history = cli.train(args)
    return state, history, directory


def _crc(directory, step):
    manifests = json.loads((directory / "manifests.json").read_text())
    return manifests[str(step)]["files"]["state.msgpack"]


def test_chaos_plan_replays_crash_and_truncate_exactly(tmp_path, caplog):
    """``nan@2,crash@4,truncate@1,diskfull@1`` under ``--max-restarts 2``
    completes. Which state it must end at: the crash and the truncation
    replay exactly (attempt 1 restores step 2, the truncated step 3 is
    passed over, and the same batches follow), diskfull@1 costs nothing
    (the checkpoint retry policy writes the step again), and nan@2 skips
    one update. So the run ends at the CRC of the run whose plan is only
    ``nan@2``, and not at the clean run's."""
    caplog.set_level(logging.INFO)
    steps = ["--steps", "6", "--nan-policy", "skip"]
    _, _, chaos = _train(tmp_path, "chaos", *steps, "--max-restarts", "2",
                         "--chaos", "nan@2,crash@4,truncate@1,diskfull@1")
    fired = [r.getMessage() for r in caplog.records
             if r.getMessage().startswith("chaos faults fired")]
    assert fired == ["chaos faults fired: diskfull@1, nan@2, crash@4, "
                     "truncate@1"]
    assert any("resumed from checkpoint at step 2" in r.getMessage()
               for r in caplog.records)
    _, _, nan_only = _train(tmp_path, "nan", *steps, "--chaos", "nan@2")
    _, _, clean = _train(tmp_path, "clean", *steps)
    assert _crc(chaos, 6) == _crc(nan_only, 6)
    assert _crc(chaos, 6) != _crc(clean, 6)


def _case_remat(tmp_path):
    plain, _, d0 = _train(tmp_path, "plain", "--steps", "2")
    remat, _, d1 = _train(tmp_path, "remat", "--steps", "2", "--remat")
    assert _crc(d0, 2) == _crc(d1, 2)


def _case_accum_steps(tmp_path):
    args = cli.build_train_parser().parse_args(TINY_ARGV + ["--steps", "1"])
    args.image_size = 8
    initial = cli.build_model(args).state_dict()
    state, _, _ = _train(tmp_path, "accum", "--steps", "3",
                         "--accum-steps", "2")
    assert state.step == 3 and state.optimizer.gradient_step == 1
    assert state.optimizer.mini_step == 1 and state.optimizer.count == 1
    one, _, _ = _train(tmp_path, "one", "--steps", "1", "--accum-steps", "2")
    for name, p in one.model.named_parameters():  # no update after one
        assert torch.equal(p.detach(), initial[name]), name


def _case_nan_policy(tmp_path):
    for policy in ("skip", "backoff", "rollback"):
        state, history, _ = _train(tmp_path, policy, "--steps", "2",
                                   "--nan-policy", policy)
        assert state.step == 2 and all(np.isfinite(h["loss"])
                                       for h in history)


def _case_stall_timeout(tmp_path):
    state, _, _ = _train(tmp_path, "dog", "--steps", "2", "--stall-timeout",
                         "60")
    assert state.step == 2


def _case_max_restarts(tmp_path):
    _, _, clean = _train(tmp_path, "clean", "--steps", "4")
    state, _, d = _train(tmp_path, "crash", "--steps", "4", "--max-restarts",
                         "1", "--chaos", "crash@3")
    assert state.step == 4 and _crc(d, 4) == _crc(clean, 4)


def _case_chaos(tmp_path):
    args = cli.build_train_parser().parse_args(
        TINY_ARGV + ["--chaos", "nan@1,explode@2"])
    with pytest.raises(SystemExit, match="--chaos: unknown fault action "
                                         "'explode' in 'explode@2'"):
        cli.train(args)


RESILIENCE_FLAG_CASES = {
    "--remat": _case_remat, "--accum-steps": _case_accum_steps,
    "--nan-policy": _case_nan_policy, "--stall-timeout": _case_stall_timeout,
    "--max-restarts": _case_max_restarts, "--chaos": _case_chaos,
}


@pytest.mark.parametrize("case", sorted(RESILIENCE_FLAG_CASES))
def test_resilience_flags_do_their_job(case, tmp_path, monkeypatch):
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    RESILIENCE_FLAG_CASES[case](tmp_path)


def test_chaos_fetch_is_retried_by_the_loader(tmp_path, caplog,
                                             monkeypatch):
    """``--chaos fetch@3`` fails the third source read; the loader's retry
    policy reads it again, so the run ends where the clean run does."""
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    caplog.set_level(logging.INFO)
    _, _, clean = _train(tmp_path, "clean", "--steps", "2")
    _, _, flaky = _train(tmp_path, "flaky", "--steps", "2", "--chaos",
                         "fetch@3")
    assert any("chaos faults fired: fetch@3" in r.getMessage()
               for r in caplog.records)
    assert any("transient failure" in r.getMessage()
               for r in caplog.records)
    assert _crc(flaky, 2) == _crc(clean, 2)


def test_a_supervised_run_that_spends_its_budget_exits_1(tmp_path,
                                                         monkeypatch):
    monkeypatch.setattr(Supervisor, "__init__", _no_sleep(Supervisor.__init__))
    argv = ["train", *TINY_ARGV, "--steps", "4", "--ckpt-dir",
            str(tmp_path), "--max-restarts", "1", "--chaos", "crash@2,crash@3"]
    with pytest.raises(SystemExit) as e:
        cli.main(argv)
    assert e.value.code == 1


def _no_sleep(init):
    def wrapped(self, *args, **kwargs):
        init(self, *args, **kwargs)
        self.sleep = lambda s: None

    return wrapped


def test_clip_nan_policy_warns_and_trains(caplog, monkeypatch):
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    caplog.set_level(logging.WARNING)
    args = cli.build_train_parser().parse_args(
        CLIP_ARGV + ["--nan-policy", "skip", "--remat", "--accum-steps", "2"])
    state, history = cli.train(args)
    assert state.step == 2 and all(np.isfinite(h["loss"]) for h in history)
    assert any("--nan-policy skip ignored: the CLIP steps carry no in-step "
               "divergence guard" in r.getMessage() for r in caplog.records)
    assert state.optimizer.gradient_step == 1


@pytest.mark.parametrize("flags,match", [
    (["--accum-steps", "0"], "--accum-steps must be positive"),
    (["--max-restarts", "-1"], "--max-restarts must be >= 0"),
    (["--stall-timeout", "0"], "--stall-timeout must be positive"),
])
def test_resilience_flag_values_are_checked(flags, match):
    with pytest.raises(SystemExit, match=match):
        cli.train(cli.build_train_parser().parse_args(TINY_ARGV + flags))
