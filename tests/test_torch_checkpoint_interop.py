"""Checkpoints shared by the two packages, on the CPU: a step the JAX
package's ``CheckpointManager`` writes is resumed by the port, and a step
the port writes is restored by the JAX manager against a JAX template,
for SimCLR's LARS and for CLIP's AdamW; ``serve --ckpt-dir`` of the port
embeds what the JAX ``apply`` of the same checkpoint embeds.

Tolerances:

* the optimizer across the packages: both take the same gradients (numpy
  trees, converted by the weights converter), so only fp32 rounding of
  the update differs -> ``test_lars_steps_match_optax``'s 1e-6 on the
  parameters and on the momentum or Adam moments after 2 + 2 steps;
* a restore is exact: the same fp32 bits in both layouts;
* serving: both towers run in bf16 (the serve path's dtype) -> the serve
  phase's 2e-2 on unit-norm embeddings;
* gradient accumulation (``optax.MultiSteps``'s state written by either
  package after an odd micro-step and resumed by the other): the whole
  state in the JAX layout within 1e-5 of an uninterrupted trajectory,
  as ``tests/test_torch_accum.py`` holds the optimizers.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import serialization

from ntxent_tpu import cli as jcli
from ntxent_tpu.models import SimCLRModel as JaxSimCLR
from ntxent_tpu.training.checkpoint import CheckpointManager as JaxManager
from ntxent_tpu.training.lars import cosine_warmup_schedule as jax_schedule
from ntxent_tpu.training.trainer import TrainerConfig as JaxConfig
from ntxent_tpu.training.trainer import TrainState as JaxState
from ntxent_tpu.training.trainer import create_train_state as jax_state
from ntxent_tpu_torch import cli
from ntxent_tpu_torch.training import CheckpointManager
from ntxent_tpu_torch.training import trainer as ttrain
from ntxent_tpu_torch.weights import (
    _torch_tensors,
    flax_variables,
    load_flax_variables,
    train_state_dict,
)

from test_torch_clip import _jax_clip, _port_clip
from test_torch_clip import _variables as _clip_variables
from test_torch_training import IMAGE, _tiny_jax_simclr, _tiny_port_simclr

torch.set_num_threads(1)  # see test_torch_training.py

LARS_CFG = dict(batch_size=8, temperature=0.2, base_lr=30.0,
                weight_decay=1e-4, warmup_steps=1, total_steps=10)
ADAMW = dict(base_lr=1e-2, warmup=1, total=10, wd=1e-2)


def _np(tree):
    return jax.tree_util.tree_map(np.array, jax.device_get(tree))


def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out |= _flat(v, prefix + (k,))
        return out
    return {prefix: np.asarray(tree)}


def _grads(params, count, seed):
    rng = np.random.default_rng(seed)
    return [jax.tree_util.tree_map(
        lambda p: (0.1 * rng.normal(size=np.shape(p))).astype(np.float32),
        params) for _ in range(count)]


def _port_step(state, grads, stats):
    """One optimizer step of the port on a flax-layout gradient tree."""
    tensors = _torch_tensors(state.model, grads, stats)
    for name, p in state.model.named_parameters():
        p.grad = torch.from_numpy(tensors[name])
    state.optimizer.step()
    state.step += 1


def _close(got: dict, want: dict, atol: float):
    got, want = _flat(got), _flat(want)
    assert sorted(got) == sorted(want)
    for key in want:
        np.testing.assert_allclose(got[key], want[key], atol=atol, rtol=0,
                                   err_msg=str(key))


def _equal(got: dict, want: dict):
    got, want = _flat(got), _flat(want)
    assert sorted(got) == sorted(want)
    for key in want:
        np.testing.assert_array_equal(got[key], want[key], err_msg=str(key))


# ---------------------------------------------------------------------------
# SimCLR: LARS (optax.lars's chain)
# ---------------------------------------------------------------------------

def _jax_simclr_state():
    jmodel, variables = _tiny_jax_simclr("xla")
    state = jax_state(jmodel, jax.random.PRNGKey(0), (1, IMAGE, IMAGE, 3),
                      JaxConfig(**LARS_CFG))
    return state.replace(params=jax.tree_util.tree_map(
        jnp.asarray, variables["params"])), variables


def _port_simclr_state(variables=None):
    model = _tiny_port_simclr("xla")
    if variables is not None:
        load_flax_variables(model, variables)
    return ttrain.create_train_state(model, ttrain.TrainerConfig(**LARS_CFG),
                                     torch.device("cpu"))


def test_a_jax_lars_step_resumes_in_the_port(tmp_path):
    """2 optax steps, saved by the JAX manager; the port restores them and
    takes 2 more on the same gradients: optax's 4 uninterrupted steps."""
    jstate, variables = _jax_simclr_state()
    grads = _grads(_np(jstate.params), 4, seed=1)
    for g in grads[:2]:
        jstate = jstate.apply_gradients(grads=g)
    manager = JaxManager(tmp_path)
    assert manager.save(2, jstate, force=True)
    manager.close()

    state = _port_simclr_state()  # other weights: the restore overwrites
    CheckpointManager(tmp_path).restore(state)
    assert state.step == 2 and state.optimizer.count == 2
    stats = _np(jstate.batch_stats)
    for g in grads[2:]:
        _port_step(state, g, stats)
        jstate = jstate.apply_gradients(grads=g)
    ours = train_state_dict(state)
    _close(ours["params"], _np(jstate.params), 1e-6)
    _close(ours["opt_state"]["3"]["trace"], _np(jstate.opt_state[3].trace),
           1e-6)
    assert int(ours["opt_state"]["2"]["count"]) == int(
        jstate.opt_state[2].count) == 4


def test_a_port_lars_step_restores_in_jax(tmp_path):
    jstate, variables = _jax_simclr_state()
    state = _port_simclr_state(variables)
    grads = _grads(variables["params"], 2, seed=2)
    for g in grads:
        _port_step(state, g, variables["batch_stats"])
    assert CheckpointManager(tmp_path).save(2, state)

    restored = JaxManager(tmp_path).restore(jstate)
    ours = train_state_dict(state)
    assert int(restored.step) == 2
    _equal(_np(restored.params), ours["params"])
    _equal(_np(restored.batch_stats), ours["batch_stats"])
    _equal(_np(restored.opt_state[3].trace), ours["opt_state"]["3"]["trace"])
    assert int(restored.opt_state[2].count) == 2


# ---------------------------------------------------------------------------
# CLIP: AdamW (optax.adamw's chain)
# ---------------------------------------------------------------------------

def _jax_clip_state():
    model = _jax_clip()
    variables = _clip_variables(model)
    tx = optax.adamw(jax_schedule(ADAMW["base_lr"], ADAMW["warmup"],
                                  ADAMW["total"]),
                     weight_decay=ADAMW["wd"])
    return JaxState.create(apply_fn=model.apply, params=jax.tree_util.tree_map(
        jnp.asarray, variables["params"]), tx=tx), variables


def _port_clip_state(variables=None):
    model = _port_clip()
    if variables is not None:
        load_flax_variables(model, variables)
    cfg = ttrain.TrainerConfig(base_lr=ADAMW["base_lr"],
                               warmup_steps=ADAMW["warmup"],
                               total_steps=ADAMW["total"],
                               weight_decay=ADAMW["wd"])
    return ttrain.create_clip_train_state(model, cfg, torch.device("cpu"))


def test_a_jax_adamw_step_resumes_in_the_port(tmp_path):
    jstate, variables = _jax_clip_state()
    grads = _grads(_np(jstate.params), 4, seed=3)
    for g in grads[:2]:
        jstate = jstate.apply_gradients(grads=g)
    manager = JaxManager(tmp_path)
    assert manager.save(2, jstate, force=True)
    manager.close()

    state = _port_clip_state()
    CheckpointManager(tmp_path).restore(state)
    assert state.step == 2 and state.optimizer.count == 2
    for g in grads[2:]:
        _port_step(state, g, {})
        jstate = jstate.apply_gradients(grads=g)
    ours = train_state_dict(state)
    assert ours["batch_stats"] is None  # as the JAX CLIP state leaves it
    _close(ours["params"], _np(jstate.params), 1e-6)
    adam = jstate.opt_state[0]
    _close(ours["opt_state"]["0"]["mu"], _np(adam.mu), 1e-6)
    _close(ours["opt_state"]["0"]["nu"], _np(adam.nu), 1e-6)
    assert int(ours["opt_state"]["0"]["count"]) == int(adam.count) == 4


def test_a_port_adamw_step_restores_in_jax(tmp_path):
    jstate, variables = _jax_clip_state()
    state = _port_clip_state(variables)
    for g in _grads(variables["params"], 2, seed=4):
        _port_step(state, g, {})
    assert CheckpointManager(tmp_path).save(2, state)

    restored = JaxManager(tmp_path).restore(jstate)
    ours = train_state_dict(state)
    assert int(restored.step) == 2 and restored.batch_stats is None
    _equal(_np(restored.params), ours["params"])
    adam = restored.opt_state[0]
    _equal(_np(adam.mu), ours["opt_state"]["0"]["mu"])
    _equal(_np(adam.nu), ours["opt_state"]["0"]["nu"])
    assert int(adam.count) == int(restored.opt_state[2].count) == 2


def test_flax_variables_inverts_load_flax_variables():
    _, variables = _tiny_jax_simclr("xla")
    model = load_flax_variables(_tiny_port_simclr("xla"), variables)
    _equal(flax_variables(model), {"params": variables["params"],
                                   "batch_stats": variables["batch_stats"]})
    clip_vars = _clip_variables(_jax_clip())
    back = flax_variables(load_flax_variables(_port_clip(), clip_vars))
    _equal(back["params"], clip_vars["params"])
    assert back["batch_stats"] == {}


# ---------------------------------------------------------------------------
# Serving a JAX checkpoint
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("head", ["embedding", "features"])
def test_serve_ckpt_dir_embeds_what_the_jax_apply_embeds(tmp_path, head):
    encoder = jcli._make_encoder("tiny", 8)
    jmodel = JaxSimCLR(encoder=encoder, proj_hidden_dim=16, proj_dim=8)
    jstate = jax_state(jmodel, jax.random.PRNGKey(5), (1, 8, 8, 3),
                       JaxConfig())
    rng = np.random.default_rng(6)
    # trained-looking statistics, so that the restore has to carry them
    stats = jax.tree_util.tree_map(
        lambda x: jnp.asarray(rng.uniform(0.5, 1.5, np.shape(x)),
                              jnp.float32), jstate.batch_stats)
    jstate = jstate.replace(batch_stats=stats)
    manager = JaxManager(tmp_path)
    assert manager.save(3, jstate, force=True)
    manager.close()

    args = cli.build_serve_parser().parse_args(
        ["--device", "cpu", "--model", "tiny", "--image-size", "8",
         "--proj-hidden-dim", "16", "--proj-dim", "8", "--port", "0",
         "--head", head, "--no-warmup", "--ckpt-dir", str(tmp_path)])
    server = cli.build_server(args)
    x = rng.uniform(-1, 1, (5, 8, 8, 3)).astype(np.float32)
    got = server.engine.embed(x)
    variables = {"params": jstate.params, "batch_stats": jstate.batch_stats}
    want = jmodel.apply(variables, jnp.asarray(x), train=False,
                        method=None if head == "embedding"
                        else JaxSimCLR.features)
    np.testing.assert_allclose(got, np.asarray(want, np.float32), atol=2e-2,
                               rtol=0)


# ---------------------------------------------------------------------------
# Gradient accumulation: optax.MultiSteps's state, mid-accumulation
# ---------------------------------------------------------------------------

ACCUM_K = 2


def _accum_fixture(opt):
    from test_torch_accum import STATES

    return STATES[opt](ACCUM_K)


def _accum_grads(jstate, count):
    from test_torch_accum import grads

    return grads(_np(jstate.params), count, seed=11)


@pytest.mark.parametrize("opt", ["lars", "adamw"])
def test_a_port_accumulation_state_crosses_to_jax_and_back(opt, tmp_path):
    """The port takes 3 micro-steps (k = 2: one update, one gradient
    accumulated) and saves; the JAX package restores that step, takes 2
    more and saves; the port restores that and takes 2 more. It ends
    where 7 uninterrupted optax micro-steps end, within 1e-5 (the
    optimizer tests' fp32 bound); each restore is exact."""
    from test_torch_accum import (
        assert_state_close,
        jax_apply,
        port_micro_step,
    )

    jstate, variables, state = _accum_fixture(opt)
    stats = variables.get("batch_stats", {})
    gs = _accum_grads(jstate, 7)
    whole = jstate
    for g in gs:
        whole = jax_apply(whole, g)
    for g in gs[:3]:
        port_micro_step(state, g, stats)
    assert state.optimizer.mini_step == 1
    assert CheckpointManager(tmp_path / "a").save(3, state)

    restored = JaxManager(tmp_path / "a").restore(_accum_fixture(opt)[0])
    assert int(restored.step) == 3 and int(restored.opt_state.mini_step) == 1
    _equal(_np(serialization.to_state_dict(restored)["opt_state"]),
           train_state_dict(state)["opt_state"])
    for g in gs[3:5]:
        restored = jax_apply(restored, g)
    manager = JaxManager(tmp_path / "b")
    assert manager.save(5, restored, force=True)
    manager.close()

    state = _accum_fixture(opt)[2]
    CheckpointManager(tmp_path / "b").restore(state)
    assert state.step == 5 and state.optimizer.mini_step == 1
    assert state.optimizer.gradient_step == 2
    for g in gs[5:]:
        port_micro_step(state, g, stats)
    assert_state_close(train_state_dict(state),
                       _np(serialization.to_state_dict(whole)))


@pytest.mark.parametrize("opt", ["lars", "adamw"])
def test_a_jax_accumulation_state_crosses_to_the_port_and_back(opt,
                                                               tmp_path):
    """The reverse: JAX 3 micro-steps, the port 2, JAX 2 more, against 7
    uninterrupted port micro-steps, within 1e-5."""
    from test_torch_accum import (
        assert_state_close,
        jax_apply,
        port_micro_step,
    )

    jstate, variables, whole = _accum_fixture(opt)
    stats = variables.get("batch_stats", {})
    gs = _accum_grads(jstate, 7)
    for g in gs:
        port_micro_step(whole, g, stats)
    for g in gs[:3]:
        jstate = jax_apply(jstate, g)
    manager = JaxManager(tmp_path / "a")
    assert manager.save(3, jstate, force=True)
    manager.close()

    state = _accum_fixture(opt)[2]
    CheckpointManager(tmp_path / "a").restore(state)
    assert state.step == 3 and state.optimizer.mini_step == 1
    for g in gs[3:5]:
        port_micro_step(state, g, stats)
    assert CheckpointManager(tmp_path / "b").save(5, state)

    restored = JaxManager(tmp_path / "b").restore(_accum_fixture(opt)[0])
    assert int(restored.opt_state.mini_step) == 1
    for g in gs[5:]:
        restored = jax_apply(restored, g)
    assert_state_close(train_state_dict(whole),
                       _np(serialization.to_state_dict(restored)))


def test_an_accumulation_state_refuses_a_plain_optimizer(tmp_path):
    """A step written with --accum-steps 2 does not load into a state
    without accumulation (the optimizer layouts differ), nor the reverse:
    the restore raises and names the layout."""
    jstate, variables, state = _accum_fixture("lars")
    assert CheckpointManager(tmp_path / "accum").save(1, state)
    plain = _port_simclr_state(variables)
    with pytest.raises(Exception, match="does not load"):
        CheckpointManager(tmp_path / "accum").restore(plain)
    assert CheckpointManager(tmp_path / "plain").save(1, plain)
    with pytest.raises(Exception, match="does not load"):
        CheckpointManager(tmp_path / "plain").restore(state)
