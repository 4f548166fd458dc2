"""Gradient accumulation of the port (``training.accum.MultiSteps``,
``TrainerConfig.accum_steps``) against ``optax.MultiSteps`` on the CPU.

* The optimizer alone: the same gradient trees go through the port's
  ``MultiSteps`` over LARS (SimCLR's optimizer) and over AdamW (CLIP's),
  and through the JAX package's states with ``optax.MultiSteps`` (as
  ``create_train_state(accum_steps=k)`` and the CLIP branch of the JAX
  CLI build them), k = 2 and 3, six micro-steps. After each, the whole
  state in the JAX layout (``weights.train_state_dict`` against
  ``flax.serialization.to_state_dict``: the same keys, ``mini_step``,
  ``gradient_step``, the inner counts, the accumulator, the momentum or
  moments, the parameters) within 1e-5: fp32 updates of the same
  gradients in another order.
* Whole train steps of the tiny ResNet at k = 2 against JAX's: the loss
  within 1e-5, each parameter's change within ``test_torch_resnet.py``'s
  train-step bound, the running statistics (which move every
  micro-step) within 1e-5, the counters exactly.
* A guarded step on a NaN batch leaves the accumulator state bit for bit.
* A run stopped after an odd micro-step (mid-accumulation) and resumed
  ends at the uninterrupted run's checkpoint CRC.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import serialization

from ntxent_tpu.training.lars import cosine_warmup_schedule as jax_schedule
from ntxent_tpu.training.trainer import TrainerConfig as JaxConfig
from ntxent_tpu.training.trainer import TrainState as JaxState
from ntxent_tpu.training.trainer import create_train_state as jax_state
from ntxent_tpu.training.trainer import make_train_step as jax_step
from ntxent_tpu_torch import cli
from ntxent_tpu_torch.training import MultiSteps
from ntxent_tpu_torch.training import trainer as ttrain
from ntxent_tpu_torch.weights import (
    _torch_tensors,
    load_flax_variables,
    train_state_dict,
)

from test_torch_clip import _jax_clip, _port_clip, _variables
from test_torch_resnet import (
    STEP_CONFIG,
    assert_same_update,
    step_views,
    tiny_port_model,
    tiny_simclr_pair,
)
from test_torch_training import IMAGE, _tiny_jax_simclr, _tiny_port_simclr

torch.set_num_threads(1)  # see test_torch_training.py

LARS_CFG = dict(batch_size=8, temperature=0.2, base_lr=30.0,
                weight_decay=1e-4, warmup_steps=1, total_steps=10)
ADAMW = dict(base_lr=1e-2, warmup=1, total=10, wd=1e-2)
MICRO_STEPS = 6


def _np(tree):
    return jax.tree_util.tree_map(np.array, jax.device_get(tree))


def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out |= _flat(v, prefix + (k,))
        return out
    return {prefix: tree}


def assert_state_close(ours: dict, theirs: dict, atol: float = 1e-5):
    """Two train-state dicts of the JAX layout: the same keys, every leaf
    within ``atol``."""
    ours, theirs = _flat(ours), _flat(theirs)
    assert sorted(ours) == sorted(theirs)
    for key, want in theirs.items():
        if want is None:
            assert ours[key] is None, key
            continue
        np.testing.assert_allclose(np.asarray(ours[key], np.float64),
                                   np.asarray(want, np.float64), atol=atol,
                                   rtol=0, err_msg=str(key))


@jax.jit
def jax_apply(state, grad_tree):
    """One optax micro-step of a JAX state (compiled: op by op it takes
    seconds a step)."""
    return state.apply_gradients(grads=grad_tree)


def grads(params, count, seed):
    rng = np.random.default_rng(seed)
    return [jax.tree_util.tree_map(
        lambda p: (0.1 * rng.normal(size=np.shape(p))).astype(np.float32),
        params) for _ in range(count)]


def port_micro_step(state, grad_tree, stats):
    """One micro-step of the port on a flax-layout gradient tree."""
    tensors = _torch_tensors(state.model, grad_tree, stats)
    for name, p in state.model.named_parameters():
        p.grad = torch.from_numpy(tensors[name])
    state.optimizer.step()
    state.step += 1


def lars_states(k: int):
    """(JAX SimCLR state with optax.MultiSteps over LARS, its variables,
    the port state with MultiSteps over LARS) of the tiny ViT."""
    jmodel, variables = _tiny_jax_simclr("xla")
    jstate = jax_state(jmodel, jax.random.PRNGKey(0), (1, IMAGE, IMAGE, 3),
                       JaxConfig(**LARS_CFG, accum_steps=k))
    jstate = jstate.replace(params=jax.tree_util.tree_map(
        jnp.asarray, variables["params"]))
    model = load_flax_variables(_tiny_port_simclr("xla"), variables)
    state = ttrain.create_train_state(
        model, ttrain.TrainerConfig(**LARS_CFG, accum_steps=k),
        torch.device("cpu"))
    return jstate, variables, state


def adamw_states(k: int):
    """(JAX CLIP state with optax.MultiSteps over AdamW, its variables, the
    port state) of the tiny CLIP."""
    jmodel = _jax_clip()
    variables = _variables(jmodel)
    tx = optax.adamw(jax_schedule(ADAMW["base_lr"], ADAMW["warmup"],
                                  ADAMW["total"]), weight_decay=ADAMW["wd"])
    jstate = JaxState.create(
        apply_fn=jmodel.apply, params=jax.tree_util.tree_map(
            jnp.asarray, variables["params"]),
        tx=optax.MultiSteps(tx, every_k_schedule=k))
    model = load_flax_variables(_port_clip(), variables)
    cfg = ttrain.TrainerConfig(base_lr=ADAMW["base_lr"],
                               warmup_steps=ADAMW["warmup"],
                               total_steps=ADAMW["total"],
                               weight_decay=ADAMW["wd"], accum_steps=k)
    state = ttrain.create_clip_train_state(model, cfg, torch.device("cpu"))
    return jstate, variables, state


STATES = {"lars": lars_states, "adamw": adamw_states}


@pytest.mark.parametrize("k", [2, 3])
@pytest.mark.parametrize("opt", sorted(STATES))
def test_accumulation_matches_optax_multisteps(opt, k):
    jstate, variables, state = STATES[opt](k)
    assert isinstance(state.optimizer, MultiSteps)
    stats = variables.get("batch_stats", {})
    for i, g in enumerate(grads(_np(jstate.params), MICRO_STEPS, seed=k)):
        jstate = jax_apply(jstate, g)
        port_micro_step(state, g, stats)
        assert state.optimizer.mini_step == (i + 1) % k
        assert state.optimizer.gradient_step == (i + 1) // k
        assert state.optimizer.count == (i + 1) // k
        assert_state_close(train_state_dict(state),
                           _np(serialization.to_state_dict(jstate)))


def test_no_update_between_the_kth_micro_steps():
    _, variables, state = lars_states(3)
    before = {n: p.detach().clone() for n, p in
              state.model.named_parameters()}
    for g in grads(variables["params"], 2, seed=1):
        port_micro_step(state, g, variables["batch_stats"])
    for name, p in state.model.named_parameters():
        assert torch.equal(p.detach(), before[name]), name
    assert state.optimizer.inner.count == 0
    with pytest.raises(ValueError):
        MultiSteps(state.optimizer.inner, 0)


def test_accumulating_train_steps_match_jax():
    jmodel, variables, model = tiny_simclr_pair()
    cfg = dict(STEP_CONFIG, accum_steps=2)
    jstate = jax_state(jmodel, jax.random.PRNGKey(0), (1, 8, 8, 3),
                       JaxConfig(**cfg))
    jstate = jstate.replace(
        params=jax.tree_util.tree_map(jnp.asarray, variables["params"]),
        batch_stats=jax.tree_util.tree_map(jnp.asarray,
                                           variables["batch_stats"]))
    jtrain = jax_step(cfg["temperature"])
    state = ttrain.create_train_state(model, ttrain.TrainerConfig(**cfg),
                                      torch.device("cpu"))
    step = ttrain.make_train_step(cfg["temperature"])
    before = {k: v.detach().clone() for k, v in model.named_parameters()}
    for v1, v2 in step_views(4):
        jstate, jm = jtrain(jstate, jnp.asarray(v1), jnp.asarray(v2))
        state, m = step(state, torch.from_numpy(v1), torch.from_numpy(v2))
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                                   atol=1e-5, rtol=0)
        assert state.step == int(jstate.step)
        assert state.optimizer.mini_step == int(jstate.opt_state.mini_step)
    assert state.optimizer.gradient_step == 2
    assert_same_update(model, before, tiny_port_model(
        {"params": _np(jstate.params),
         "batch_stats": _np(jstate.batch_stats)}))


def test_a_skipped_step_leaves_the_accumulator_as_it_was():
    _, _, model = tiny_simclr_pair()
    state = ttrain.create_train_state(
        model, ttrain.TrainerConfig(**STEP_CONFIG, accum_steps=3),
        torch.device("cpu"))
    step = ttrain.make_train_step(0.2, guard=True)
    (v1, v2), _ = step_views(2)
    state, m = step(state, torch.from_numpy(v1), torch.from_numpy(v2))
    assert bool(m["step_ok"]) and state.optimizer.mini_step == 1
    before = _flat(train_state_dict(state))
    state, m = step(state, torch.full_like(torch.from_numpy(v1), np.nan),
                    torch.from_numpy(v2))
    assert not bool(m["step_ok"]) and state.step == 2
    after = _flat(train_state_dict(state))
    for key, value in before.items():
        if key != ("step",) and value is not None:
            np.testing.assert_array_equal(after[key], value, err_msg=str(key))


TINY_ARGV = ["--device", "cpu", "--model", "tiny", "--image-size", "8",
             "--batch", "4", "--log-every", "1", "--proj-hidden-dim", "16",
             "--proj-dim", "8", "--synthetic-samples", "8",
             "--warmup-steps", "1", "--base-lr", "3.0", "--accum-steps",
             "2", "--ckpt-every", "1", "--ckpt-keep-last", "0"]


def _crc(directory, step):
    manifests = json.loads((directory / "manifests.json").read_text())
    return manifests[str(step)]["files"]["state.msgpack"]


@pytest.mark.parametrize("objective", ["simclr", "clip"])
def test_a_run_resumed_mid_accumulation_ends_at_the_same_crc(
        objective, tmp_path, monkeypatch):
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    argv = TINY_ARGV + (["--objective", "clip", "--model", "tiny",
                         "--image-size", "16", "--token-len", "16",
                         "--vocab-size", "100", "--synthetic-samples", "24",
                         "--base-lr", "1e-3"]
                        if objective == "clip" else [])

    def run(name, steps):
        args = cli.build_train_parser().parse_args(
            argv + ["--ckpt-dir", str(tmp_path / name), "--steps",
                    str(steps)])
        return cli.train(args)

    whole, _ = run("whole", 5)
    part, _ = run("parts", 3)
    assert part.optimizer.mini_step == 1  # stopped mid-accumulation
    resumed, history = run("parts", 5)
    assert [h["step"] for h in history] == [4, 5]
    assert _crc(tmp_path / "parts", 5) == _crc(tmp_path / "whole", 5)
    assert resumed.optimizer.gradient_step == whole.optimizer.gradient_step
