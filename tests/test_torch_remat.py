"""Rematerialization of the port's four train steps on the CPU
(``remat=True``: the encoder-and-head forward under
``torch.utils.checkpoint``, run again in the backward).

* Each of the four factories with ``remat=True`` equals the same factory
  without it bit for bit over two steps: the loss, every gradient, every
  parameter and every BatchNorm running statistic (the same CPU
  arithmetic in the same order). The SimCLR steps run the tiny ResNet,
  whose BatchNorm updates its running statistics in ``forward``: the
  recompute must leave them alone. A control with the freeze switched
  off moves them twice and misses.
* The comms accounting under remat: the port's remat step records what
  its plain step records (``bn_pmean`` once per BatchNorm call, the
  gradient and statistics pmeans, the loss's collectives), as the JAX
  step's trace-time shims record the same ops under ``jax.checkpoint``
  as without it (checked here too).
* Against JAX's ``remat=True`` steps: the tiny ResNet SimCLR step and the
  tiny CLIP step, two steps each: the loss within 1e-5, each parameter's
  change and the running statistics within ``test_torch_resnet.py``'s
  train-step bound (5e-4 of the change's norm plus 1e-5; 1e-5 on the
  statistics). CLIP's attention key biases are left out: their gradient
  is zero in exact arithmetic (softmax ignores a per-query constant), so
  AdamW's first steps turn each package's rounding noise into a change
  of about the learning rate, of either sign.
"""

import contextlib
import datetime

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import Mesh, NamedSharding
from jax.sharding import PartitionSpec as P

from ntxent_tpu.parallel.mesh import comms_accounting as jcomms
from ntxent_tpu.parallel.mesh import replicate_state
from ntxent_tpu.training.lars import cosine_warmup_schedule as jax_schedule
from ntxent_tpu.training.trainer import TrainState as JaxState
from ntxent_tpu.training.trainer import make_clip_train_step as jax_clip_step
from ntxent_tpu.training.trainer import make_sharded_train_step as jsharded
from ntxent_tpu.training.trainer import make_train_step as jax_step
from ntxent_tpu_torch.models import cross_replica_batch_norm
from ntxent_tpu_torch.models.layers import BatchNorm
from ntxent_tpu_torch.parallel import mesh
from ntxent_tpu_torch.training import trainer as ttrain
from ntxent_tpu_torch.weights import load_flax_variables

from test_torch_clip import _inputs, _jax_clip, _port_clip, _variables
from test_torch_resnet import (
    STEP_CONFIG,
    _np,
    assert_same_update,
    jax_tiny_state,
    step_views,
    tiny_port_model,
    tiny_simclr_pair,
)
from test_torch_training import IMAGE, _tiny_port_simclr

torch.set_num_threads(1)  # see test_torch_training.py

CLIP_CONFIG = dict(batch_size=8, base_lr=1e-2, warmup_steps=1,
                   total_steps=10, weight_decay=1e-2)


@pytest.fixture
def group_of_one(tmp_path):
    """A gloo world of one joined by this process for one test."""
    mesh.init_from_file(tmp_path / "store", 0, 1, device="cpu",
                        timeout=datetime.timedelta(seconds=60))
    yield torch.distributed.group.WORLD
    mesh.shutdown()


def _simclr(model_fn, sharded, remat, image=8):
    model = model_fn()
    if sharded:
        cross_replica_batch_norm(model, torch.distributed.group.WORLD)
    state = ttrain.create_train_state(model, ttrain.TrainerConfig(
        **STEP_CONFIG), torch.device("cpu"))
    step = (ttrain.make_sharded_train_step(None, 0.2, remat=remat)
            if sharded else ttrain.make_train_step(0.2, remat=remat))
    rng = np.random.default_rng(9)
    batches = [tuple(torch.from_numpy(rng.uniform(size=(
        8, image, image, 3)).astype(np.float32)) for _ in range(2))
        for _ in range(2)]
    return state, step, batches


def _resnet():
    return tiny_simclr_pair()[2]


def _vit():
    from ntxent_tpu_torch.models import init_weights

    return init_weights(_tiny_port_simclr("flash"),
                        torch.Generator().manual_seed(3))


def _clip(sharded, remat):
    model = load_flax_variables(_port_clip(), _variables(_jax_clip(), 6))
    state = ttrain.create_clip_train_state(model, ttrain.TrainerConfig(
        **CLIP_CONFIG), torch.device("cpu"))
    step = (ttrain.make_sharded_clip_train_step(None, remat=remat)
            if sharded else ttrain.make_clip_train_step(remat=remat))
    batches = []
    for seed in (5, 7):
        images, tokens = _inputs(seed=seed)
        batches.append((torch.from_numpy(images),
                        torch.from_numpy(tokens).long()))
    return state, step, batches


CASES = {
    "simclr": lambda remat: _simclr(_resnet, False, remat),
    "simclr_vit_flash": lambda remat: _simclr(_vit, False, remat, IMAGE),
    "sharded_simclr": lambda remat: _simclr(_resnet, True, remat),
    "clip": lambda remat: _clip(False, remat),
    "sharded_clip": lambda remat: _clip(True, remat),
}


def _run(case, remat):
    state, step, batches = CASES[case](remat)
    trail = []
    for a, b in batches:
        state, metrics = step(state, a, b)
        trail.append({"loss": metrics["loss"].clone(),
                      **{f"grad/{n}": p.grad.clone()
                         for n, p in state.model.named_parameters()},
                      **{f"state/{n}": t.clone()
                         for n, t in state.model.state_dict().items()}})
    return trail


def _assert_trails_equal(got, want):
    for step, (a, b) in enumerate(zip(got, want)):
        assert a.keys() == b.keys()
        for key in b:
            assert torch.equal(a[key], b[key]), (step, key)


@pytest.mark.parametrize("case", sorted(CASES))
def test_remat_equals_the_plain_step_bitwise(case, request):
    if case.startswith("sharded"):
        request.getfixturevalue("group_of_one")
    _assert_trails_equal(_run(case, True), _run(case, False))


def test_remat_without_the_freeze_moves_the_statistics_twice(monkeypatch):
    """The control: a recompute that may update the running statistics
    (what ``torch.utils.checkpoint`` does to a BatchNorm that updates in
    ``forward``) makes the remat step differ from the plain one, so the
    bitwise test above would catch a double update."""
    monkeypatch.setattr(ttrain, "_recompute_contexts",
                        lambda: (contextlib.nullcontext(),
                                 contextlib.nullcontext()))
    got, want = _run("simclr", True), _run("simclr", False)
    stats = [k for k in want[0] if k.endswith("running_mean")]
    assert stats
    assert not all(torch.equal(got[0][k], want[0][k]) for k in stats)
    assert torch.equal(got[0]["loss"], want[0]["loss"])


def test_remat_records_what_the_plain_step_records(group_of_one):
    """The port: a remat step's comms delta equals the plain step's. JAX:
    the same, from the shims of the sharded step's trace on a one-device
    mesh (flax's BatchNorm psums past the shims, so JAX records no
    ``bn_pmean``; the port records it once per BatchNorm call either
    way)."""
    deltas = {}
    for remat in (False, True):
        state, step, batches = _simclr(_resnet, True, remat)
        mark = mesh.comms_accounting().totals()
        step(state, *batches[0])
        deltas[remat] = mesh.comms_accounting().delta(mark)
    assert deltas[True] == deltas[False]
    norms = sum(isinstance(m, BatchNorm) for m in state.model.modules())
    assert deltas[True][("bn_pmean", "data")][0] == 2 * norms  # mean, var
    jmodel, variables, _ = tiny_simclr_pair(axis_name="data")
    jmesh = Mesh(np.array(jax.devices()[:1]), ("data",))
    shard = NamedSharding(jmesh, P("data"))
    v1, v2 = step_views(1)[0]
    jdeltas = {}
    for remat in (False, True):
        state = replicate_state(jax_tiny_state(jmodel, variables), jmesh)
        jstep = jsharded(jmesh, 0.2, interpret=True, remat=remat)
        mark = jcomms().totals()
        jstep(state, jax.device_put(v1, shard), jax.device_put(v2, shard))
        jdeltas[remat] = jcomms().delta(mark)
    assert jdeltas[True] == jdeltas[False]
    assert {op for op, _ in jdeltas[True]} == {"all_gather", "psum", "pmean"}
    for op in ("all_gather", "psum", "pmean"):
        assert deltas[True][(op, "data")][0] == jdeltas[True][(op, "data")][0]


def test_remat_simclr_step_matches_jax_remat():
    jmodel, variables, model = tiny_simclr_pair()
    jstate = jax_tiny_state(jmodel, variables)
    jtrain = jax_step(STEP_CONFIG["temperature"], remat=True)
    state = ttrain.create_train_state(
        model, ttrain.TrainerConfig(**STEP_CONFIG), torch.device("cpu"))
    step = ttrain.make_train_step(STEP_CONFIG["temperature"], remat=True)
    before = {k: v.detach().clone() for k, v in model.named_parameters()}
    for v1, v2 in step_views(2):
        jstate, jm = jtrain(jstate, jnp.asarray(v1), jnp.asarray(v2))
        state, m = step(state, torch.from_numpy(v1), torch.from_numpy(v2))
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                                   atol=1e-5, rtol=0)
    assert_same_update(model, before, tiny_port_model(
        {"params": _np(jstate.params),
         "batch_stats": _np(jstate.batch_stats)}))


def test_remat_clip_step_matches_jax_remat():
    jmodel = _jax_clip()
    variables = _variables(jmodel, 6)
    tx = optax.adamw(jax_schedule(CLIP_CONFIG["base_lr"], 1, 10),
                     weight_decay=CLIP_CONFIG["weight_decay"])
    jstate = JaxState.create(apply_fn=jmodel.apply, params=jax.tree_util.
                             tree_map(jnp.asarray, variables["params"]),
                             tx=tx)
    jtrain = jax_clip_step(remat=True)
    state, step, batches = _clip(False, True)
    model = state.model
    before = {k: v.detach().clone() for k, v in model.named_parameters()}
    for images, tokens in batches:
        jstate, jm = jtrain(jstate, jnp.asarray(images.numpy()),
                            jnp.asarray(tokens.numpy().astype(np.int32)))
        state, m = step(state, images, tokens)
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                                   atol=1e-5, rtol=0)
    want = dict(load_flax_variables(_port_clip(), {
        "params": _np(jstate.params)}).named_parameters())
    for name, p in model.named_parameters():
        if name.endswith("attn.key.bias"):
            continue  # zero gradient: AdamW scales its rounding noise to lr
        delta = (p - before[name]).detach()
        want_delta = (want[name] - before[name]).detach()
        err = float((delta - want_delta).norm())
        assert err <= 5e-4 * float(want_delta.norm()) + 1e-5, (name, err)


def test_remat_keeps_the_gradient_of_every_projection():
    state, step, batches = _simclr(_vit, False, True, IMAGE)
    state, _ = step(state, *batches[0])
    for block in state.model.backbone.blocks:
        for proj in (block.attn.query, block.attn.key, block.attn.value):
            assert proj.weight.grad.abs().sum() > 0
