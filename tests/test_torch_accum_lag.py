"""The lag-1 guard under gradient accumulation (``train_loop(
metrics_lag=1)`` over a guarded step whose optimizer is ``MultiSteps``)
on the CPU.

* Against the port's synchronous guard under the same accumulation: the
  same micro-batches, NaN-filled ones among them, end bit for bit in the
  same state (``weights.train_state_dict``: parameters, momentum,
  accumulator, counters, running statistics), k = 2 and 3.
* Against the JAX package's guarded step under ``optax.MultiSteps``
  (``create_train_state(accum_steps=2)``, ``make_train_step(guard=True)``)
  on the same weights and micro-batches, a NaN one included: the counters
  exactly, each parameter's change within ``test_torch_resnet.py``'s
  train-step bound, as ``test_torch_accum.py`` holds the unguarded steps.
* The device counters: read back only on request, written by a restore.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ntxent_tpu.training.trainer import TrainerConfig as JaxConfig
from ntxent_tpu.training.trainer import create_train_state as jax_state
from ntxent_tpu.training.trainer import make_train_step as jax_step
from ntxent_tpu_torch.resilience import DivergenceGuard
from ntxent_tpu_torch.training import MultiSteps
from ntxent_tpu_torch.training import trainer as ttrain
from ntxent_tpu_torch.weights import load_train_state_dict, train_state_dict

from test_torch_data_pipeline import _assert_bitwise
from test_torch_resilience import GUARD_CONFIG
from test_torch_resnet import (
    STEP_CONFIG,
    assert_same_update,
    step_views,
    tiny_port_model,
    tiny_simclr_pair,
)

torch.set_num_threads(1)  # one torch thread a test worker

STEPS = 6


def _batches(nan_at, steps=STEPS):
    for i, (v1, v2) in enumerate(step_views(steps), 1):
        v1 = torch.from_numpy(v1)
        if i in nan_at:
            v1 = torch.full_like(v1, float("nan"))
        yield v1, torch.from_numpy(v2)


def _run(lag: int, k: int, nan_at=(), steps=STEPS):
    """``steps`` guarded micro-steps of the tiny ResNet SimCLR at
    ``--accum-steps k``; the micro-batches numbered in ``nan_at`` (from
    1) NaN-filled. Returns the state and the outcomes' ok flags."""
    _, _, model = tiny_simclr_pair()
    state = ttrain.create_train_state(
        model, ttrain.TrainerConfig(**GUARD_CONFIG, accum_steps=k),
        torch.device("cpu"))
    oks = []

    class Recording(DivergenceGuard):
        def __call__(self, outcome):
            oks.append(outcome.ok)
            return super().__call__(outcome)

    ttrain.train_loop(
        state, _batches(nan_at, steps),
        ttrain.make_train_step(STEP_CONFIG["temperature"], guard=True),
        steps, log_every=1, metrics_lag=lag, log=False,
        step_guard=Recording(backoff_after=None, rollback_after=None))
    return state, oks


def _kept_updates(steps, k, nan_at) -> int:
    good = [i for i in range(1, steps + 1) if i not in nan_at]
    return len(good) // k


@pytest.mark.parametrize("k,nan_at", [
    (2, ()), (2, (2,)), (2, (1, 4)), (3, ()), (3, (3,)), (3, (2, 6))],
    ids=["k2-clean", "k2-nan2", "k2-nan1_4", "k3-clean", "k3-nan3",
         "k3-nan2_6"])
def test_lag1_under_accumulation_ends_bit_for_bit_where_the_sync_guard_ends(
        k, nan_at):
    sync, ok0 = _run(0, k, nan_at)
    lag, ok1 = _run(1, k, nan_at)
    _assert_bitwise(sync, lag)
    want = [i not in nan_at for i in range(1, STEPS + 1)]
    assert ok0 == ok1 == want
    updates = _kept_updates(STEPS, k, nan_at)
    good = STEPS - len(nan_at)
    for state in (sync, lag):
        opt = state.optimizer
        assert isinstance(opt, MultiSteps)
        assert (opt.gradient_step, opt.mini_step, opt.count) == (
            updates, good % k, updates)
    assert lag.optimizer.counters is not None  # decided on the device
    assert sync.optimizer.counters is None


def test_lag1_under_accumulation_matches_the_jax_guarded_step():
    """JAX's guarded step under ``optax.MultiSteps`` (k = 2), micro-batch 2
    NaN-filled; the port's lag-1 loop on the same weights and batches."""
    jmodel, variables, start = tiny_simclr_pair()
    before = {n: p.detach().clone() for n, p in start.named_parameters()}
    cfg = dict(GUARD_CONFIG, accum_steps=2)
    jstate = jax_state(jmodel, jax.random.PRNGKey(0), (1, 8, 8, 3),
                       JaxConfig(**cfg))
    jstate = jstate.replace(
        params=jax.tree_util.tree_map(jnp.asarray, variables["params"]),
        batch_stats=jax.tree_util.tree_map(jnp.asarray,
                                           variables["batch_stats"]))
    jtrain = jax_step(cfg["temperature"], guard=True)
    nan_at = (2,)
    oks = []
    for v1, v2 in _batches(nan_at, 5):
        jstate, jm = jtrain(jstate, jnp.asarray(v1.numpy()),
                            jnp.asarray(v2.numpy()), jnp.float32(1.0))
        oks.append(bool(jm["step_ok"]))
    lag, port_oks = _run(1, 2, nan_at, steps=5)
    assert oks == port_oks == [True, False, True, True, True]
    opt = lag.optimizer
    assert opt.mini_step == int(jstate.opt_state.mini_step) == 0
    assert opt.gradient_step == int(jstate.opt_state.gradient_step) == 2
    assert int(lag.step) == int(jstate.step) == 5
    want = tiny_port_model({
        "params": jax.tree_util.tree_map(np.asarray, jstate.params),
        "batch_stats": jax.tree_util.tree_map(np.asarray,
                                              jstate.batch_stats)})
    assert_same_update(lag.model, before, want)


def test_device_counters_read_back_on_request_and_take_a_restore():
    lag, _ = _run(1, 3, (), steps=4)
    opt = lag.optimizer
    assert opt.counters.tolist() == [1.0, 1.0]
    tree = train_state_dict(lag)
    assert (int(np.asarray(tree["opt_state"]["mini_step"])),
            int(np.asarray(tree["opt_state"]["gradient_step"]))) == (1, 1)
    # a restore writes through to the device counters the flat buffer
    # keeps
    tree["opt_state"]["mini_step"] = np.array(2, np.int32)
    load_train_state_dict(lag, tree)
    assert opt.counters.tolist() == [2.0, 1.0] and opt.mini_step == 2
    assert opt.counters.data_ptr() == lag.kept.live[-2:].data_ptr()
