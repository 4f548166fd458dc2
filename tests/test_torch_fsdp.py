"""ZeRO-3 of the port (``parallel/fsdp.py`` over ``parallel/shards.py``)
against the JAX package's ``parallel/fsdp.py`` (after
``tests/test_fsdp.py``).

The spec rule is held to JAX's on the JAX tests' shapes; a rank's
parameter bytes to JAX's ``param_bytes_per_device`` on an 8-device mesh
at the same world and shapes (the tiny ResNet SimCLR). The steps run in a
gloo world of 8 ranks (``torch_mp_workers.run_fsdp``), spawned while JAX
computes, from the same flax weights on the same views: two steps of the
tiny ResNet SimCLR under ZeRO-3 with the strip, pair and oracle losses
and under hybrid ZeRO on a ('dcn' 2, 'data' 4) grid, each held to JAX's
``make_fsdp_train_step`` on the (8,) mesh; two micro-steps under
accumulation, the MoE ViT tower and the tiny CLIP, held to JAX's
unsharded steps (which JAX's own tests hold to its sharded ones). A
``fit`` under ZeRO-3 saves in the single-card format: JAX's
``CheckpointManager`` and the port's restore it on one device.
Tolerances (fp32): losses and aux 1e-5; LARS parameters after two steps
1e-4; running statistics 1e-5; the AdamW rule of ``test_torch_moe``.
"""

from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax.training.train_state import TrainState as FlaxState

from ntxent_tpu import models as jmodels
from ntxent_tpu.parallel import create_mesh
from ntxent_tpu.parallel.fsdp import fsdp_param_spec as jspec
from ntxent_tpu.parallel.fsdp import make_fsdp_train_step as jfsdp_step
from ntxent_tpu.parallel.fsdp import param_bytes_per_device as jbytes
from ntxent_tpu.parallel.fsdp import shard_train_state_fsdp as jshard
from ntxent_tpu.training.checkpoint import CheckpointManager as JaxManager
from ntxent_tpu.training.lars import cosine_warmup_schedule as jsched
from ntxent_tpu.training.trainer import TrainerConfig as JaxConfig
from ntxent_tpu.training.trainer import create_train_state as jstate
from ntxent_tpu.training.trainer import make_clip_train_step as jclip_step
from ntxent_tpu.training.trainer import make_train_step as jstep
from ntxent_tpu_torch.parallel import fsdp
from ntxent_tpu_torch.training import CheckpointManager, create_train_state
from ntxent_tpu_torch.training.trainer import TrainerConfig
from ntxent_tpu_torch.weights import flax_variables

import torch_mp_workers as workers
from test_torch_distributed import _flatten, _spawn
from test_torch_moe import (
    CLIP_CONFIG,
    STEP_CONFIG,
    _assert_params,
    _clip_batches,
    _jax_clip,
    _jax_vit_simclr,
    _np,
    _views,
    assert_adamw_update,
)

torch.set_num_threads(1)  # see test_torch_training.py

WORLD = 8


def _jax_resnet():
    import functools

    return jmodels.SimCLRModel(
        encoder=functools.partial(jmodels.ResNet, stage_sizes=(1, 1),
                                  small_images=True, dtype=jnp.float32),
        proj_hidden_dim=workers.TINY_PROJ[0],
        proj_dim=workers.TINY_PROJ[1], dtype=jnp.float32)


def _state(jmodel, variables, accum=1):
    state = jstate(jmodel, jax.random.PRNGKey(0), (1, 16, 16, 3),
                   JaxConfig(**STEP_CONFIG, accum_steps=accum))
    return state.replace(
        params=jax.tree.map(jnp.asarray, variables["params"]),
        batch_stats=jax.tree.map(jnp.asarray, variables["batch_stats"]))


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    jmodel = _jax_resnet()
    variables = _np(jmodel.init(jax.random.PRNGKey(0),
                                jnp.zeros((1, 16, 16, 3)), train=False))
    jmoe = _jax_vit_simclr(moe_experts=2)
    moe_vars = _np(jmoe.init(jax.random.PRNGKey(1),
                             jnp.zeros((1, 16, 16, 3)), train=False))
    jclip = _jax_clip(moe_experts=0)
    images, tokens = _clip_batches(2, batch=WORLD)
    clip_vars = _np(jclip.init(jax.random.PRNGKey(4), images[0][:1],
                               tokens[0][:1], train=False))
    ckpt = tmp_path_factory.mktemp("fsdp_ckpt")
    views = _views(2, batch=16, seed=7)
    inputs = {"views": views, "images": images, "tokens": tokens,
              "ckpt": np.array(str(ckpt)),
              **_flatten(variables["params"], "params"),
              **_flatten(variables["batch_stats"], "batch_stats"),
              **_flatten(moe_vars["params"], "moe_params"),
              **_flatten(moe_vars["batch_stats"], "moe_batch_stats"),
              **_flatten(clip_vars["params"], "clip_params"),
              **{f"cfg:{k}": np.asarray(v) for k, v in STEP_CONFIG.items()},
              **{f"clipcfg:{k}": np.asarray(v)
                 for k, v in CLIP_CONFIG.items()}}
    return dict(jmodel=jmodel, variables=variables, jmoe=jmoe,
                moe_vars=moe_vars, jclip=jclip, clip_vars=clip_vars,
                ckpt=ckpt, inputs=inputs)


@pytest.fixture(scope="module")
def world(setup, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("fsdp_world")
    np.savez(tmp / "inputs.npz", **setup["inputs"])
    with ThreadPoolExecutor(max_workers=1) as pool:
        future = pool.submit(_spawn, workers.run_fsdp, WORLD,
                             (str(tmp / "inputs.npz"), str(tmp)), tmp)

        def results():
            future.result()
            return [dict(np.load(tmp / f"rank{r}.npz"))
                    for r in range(WORLD)]

        yield results


def _run(state, step, views):
    losses, auxes = [], []
    for v1, v2 in views:
        state, metrics = step(state, jnp.asarray(v1), jnp.asarray(v2))
        losses.append(float(metrics["loss"]))
        if "moe_aux" in metrics:
            auxes.append(float(metrics["moe_aux"]))
    return state, losses, auxes


@pytest.fixture(scope="module")
def jax_fsdp(setup, world):
    """Two steps of JAX's ZeRO-3 step on the (8,) mesh (strip loss):
    (losses, params, batch_stats)."""
    mesh = create_mesh(axis_names=("data",))
    state = jshard(_state(setup["jmodel"], setup["variables"]), mesh)
    state, losses, _ = _run(state, jfsdp_step(
        mesh, STEP_CONFIG["temperature"], interpret=True),
        setup["inputs"]["views"])
    return losses, _np(state.params), _np(state.batch_stats)


def _rank_model(res, prefix, model):
    model.load_state_dict({k[len(prefix) + 1:]: torch.from_numpy(v)
                           for k, v in res.items()
                           if k.startswith(prefix + ":")})
    return model


def _assert_stats(model, stats):
    got = flax_variables(model)["batch_stats"]
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(stats)):
        np.testing.assert_allclose(a, b, atol=1e-5)


def test_spec_rules_match_jax():
    """The largest divisible dimension (trailing on ties), small leaves
    and indivisible leaves whole: JAX's rule on JAX's shapes and on 200
    random ones."""
    cases = [((256, 256), 8, 2 ** 14), ((3, 3, 64, 256), 8, 2 ** 14),
             ((64,), 8, 2 ** 14), ((129, 129), 8, 1)]
    rng = np.random.RandomState(1)
    for _ in range(200):
        shape = tuple(int(rng.choice([1, 3, 4, 6, 8, 16, 24, 64]))
                      for _ in range(rng.randint(1, 5)))
        cases.append((shape, int(rng.choice([2, 3, 4, 8])), 16))
    for shape, size, floor in cases:
        want = tuple(jspec(np.zeros(shape), axis_size=size,
                           min_shard_elems=floor))
        assert fsdp.fsdp_param_spec(shape, axis_size=size,
                                    min_shard_elems=floor) == want, shape


def test_param_bytes_per_device_match_jax(setup, world):
    """A rank keeps exactly the bytes JAX's device 0 does at the same
    world (the default threshold), far less than the whole model; the
    largest leaf and its LARS trace cut 1/P."""
    mesh = create_mesh(axis_names=("data",))
    placed = jshard(_state(setup["jmodel"], setup["variables"]), mesh)
    ranks = world()
    assert int(ranks[0]["default_bytes"]) == jbytes(placed)
    total = sum(leaf.size * 4 for leaf in jax.tree.leaves(
        setup["variables"]["params"]))
    assert int(ranks[0]["fsdp_strip_bytes"]) < 0.6 * total
    model = workers.resnet_simclr()
    state = create_train_state(model, TrainerConfig(**STEP_CONFIG),
                               torch.device("cpu"))
    big = max(state.model.named_parameters(), key=lambda kv: kv[1].numel())
    spec = fsdp.fsdp_param_spec(tuple(big[1].shape), axis_size=WORLD)
    assert spec, "the largest leaf is cut"


@pytest.mark.parametrize("prefix", ["fsdp_strip_", "fsdp_pair_",
                                    "fsdp_oracle_", "hybrid_"])
def test_fsdp_steps_match_jax(setup, jax_fsdp, world, prefix):
    """ZeRO-3 with the strip, pair and oracle losses, and hybrid ZeRO:
    every rank's losses; rank 0's whole parameters and running statistics
    after two steps; every rank the same whole state."""
    losses, params, stats = jax_fsdp
    ranks = world()
    for r in ranks:
        np.testing.assert_allclose(r[f"{prefix}loss"], losses, atol=1e-5)
        assert not bool(r["jax_loaded"])
    model = _rank_model(ranks[0], prefix, workers.resnet_simclr())
    _assert_params(model, params)
    _assert_stats(model, stats)
    for r in ranks[1:]:
        for key, value in ranks[0].items():
            if key.startswith(prefix + ":"):
                np.testing.assert_array_equal(r[key], value, err_msg=key)


def test_hybrid_zero_keeps_a_slice_of_four(world):
    """Hybrid ZeRO cuts over the slice's 4 ranks and replicates across the
    2 slices: more bytes a rank than flat ZeRO over 8, fewer than whole;
    the parameter group must ride the batch group."""
    r = world()[0]
    assert int(r["fsdp_strip_bytes"]) < int(r["hybrid_bytes"])
    whole = sum(v.size * 4 for k, v in r.items()
                if k.startswith("fsdp_strip_:") and "running" not in k)
    assert int(r["hybrid_bytes"]) < whole
    assert "batch" in str(r["outside_batch"])


def test_fsdp_composes_with_gradient_accumulation(setup, world):
    """``MultiSteps`` over ZeRO-3's slices: two micro-steps (the update on
    the second) equal JAX's two accumulated steps."""
    state = _state(setup["jmodel"], setup["variables"], accum=2)
    state, losses, _ = _run(state, jstep(STEP_CONFIG["temperature"],
                                         use_fused=False),
                            setup["inputs"]["views"])
    ranks = world()
    np.testing.assert_allclose(ranks[0]["accum_loss"], losses, atol=1e-5)
    model = _rank_model(ranks[0], "accum_", workers.resnet_simclr())
    _assert_params(model, state.params)
    _assert_stats(model, state.batch_stats)


def test_fsdp_composes_with_moe_towers(setup, world):
    """ZeRO-3 over the MoE ViT SimCLR: the aux loss over the global batch
    (global routing) and the update equal JAX's unsharded MoE step."""
    state = _state(setup["jmoe"], setup["moe_vars"])
    state, losses, auxes = _run(state, jstep(STEP_CONFIG["temperature"],
                                             use_fused=False,
                                             moe_aux_weight=0.01),
                                setup["inputs"]["views"])
    ranks = world()
    for r in ranks:
        np.testing.assert_allclose(r["fsdp_moe_loss"], losses, atol=1e-5)
        np.testing.assert_allclose(r["fsdp_moe_moe_aux"], auxes, atol=1e-5)
    model = _rank_model(ranks[0], "fsdp_moe_", workers.vit_simclr(moe=2))
    _assert_params(model, state.params)


def test_fsdp_clip_step_matches_jax(setup, world):
    """The CLIP step under ZeRO-3 (dual InfoNCE over the world) against
    JAX's CLIP step, AdamW's moments cut with their parameters."""
    jclip, clip_vars = setup["jclip"], setup["clip_vars"]
    tx = optax.adamw(jsched(CLIP_CONFIG["base_lr"], 1, 10),
                     weight_decay=CLIP_CONFIG["weight_decay"])
    state = FlaxState.create(apply_fn=jclip.apply, params=jax.tree.map(
        jnp.asarray, clip_vars["params"]), tx=tx)
    step = jclip_step(use_fused=False)
    losses = []
    for im, tk in zip(setup["inputs"]["images"], setup["inputs"]["tokens"]):
        state, metrics = step(state, jnp.asarray(im), jnp.asarray(tk))
        losses.append(float(metrics["loss"]))
    ranks = world()
    np.testing.assert_allclose(ranks[0]["fsdp_clip_loss"], losses,
                               atol=1e-5)
    model = _rank_model(ranks[0], "fsdp_clip_", workers.tiny_clip())
    assert_adamw_update(model, clip_vars, state.params,
                        CLIP_CONFIG["base_lr"])


def test_zero3_saves_restore_on_one_device_in_either_package(setup,
                                                             jax_fsdp,
                                                             world):
    """The steps a ``fit`` under ZeRO-3 saved are whole leaves in the
    single-card format: JAX's ``CheckpointManager`` restores step 2 into
    a one-device JAX state, the port's into a single-card state, both at
    the sharded run's parameters."""
    world()
    _, params, stats = jax_fsdp
    restored = JaxManager(str(setup["ckpt"])).restore(
        _state(setup["jmodel"], setup["variables"]))
    assert int(restored.step) == 2
    for a, b in zip(jax.tree.leaves(_np(restored.params)),
                    jax.tree.leaves(params)):
        np.testing.assert_allclose(a, b, atol=1e-4, rtol=1e-4)
    state = create_train_state(workers.resnet_simclr(),
                               TrainerConfig(**STEP_CONFIG),
                               torch.device("cpu"))
    manager = CheckpointManager(str(setup["ckpt"]))
    try:
        state = manager.restore(state)
    finally:
        manager.close()
    assert state.step == 2 and state.sharding is None
    _assert_params(state.model, params)
    _assert_stats(state.model, stats)
