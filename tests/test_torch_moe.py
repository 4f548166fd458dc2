"""The port's switch-MoE layer (``ntxent_tpu_torch/parallel/moe.py``), its
expert-parallel form and the MoE towers and steps, against the JAX
package's ``parallel/moe.py`` (case for case after ``tests/test_moe.py``).

The same seeded numpy inputs and the JAX layer's weights, carried across
as they are (the flax layout needs no transpose), go through both.
Tolerances (fp32): routing is identical (expert ids and kept flags
compared exactly); outputs and losses differ by summation order, 1e-5;
gradients 1e-4 relative with 1e-5 absolute; parameters after a LARS or
AdamW step 1e-4. The expert-parallel layer runs in a gloo world of 8
ranks (``torch_mp_workers.run_moe``), spawned while JAX computes; the
data-parallel MoE step in a world of 4 is held to JAX's ``shard_map``
step on a 4-device mesh.
"""

import functools
from concurrent.futures import ThreadPoolExecutor

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax.training.train_state import TrainState as FlaxState
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as P

from ntxent_tpu import models as jmodels
from ntxent_tpu.parallel.mesh import replicate_state
from ntxent_tpu.parallel.moe import _route as jroute
from ntxent_tpu.parallel.moe import init_moe_params as jinit
from ntxent_tpu.parallel.moe import switch_moe as jmoe
from ntxent_tpu.training.lars import exclusion_mask as jmask
from ntxent_tpu.training.trainer import TrainerConfig as JaxConfig
from ntxent_tpu.training.trainer import create_train_state as jstate
from ntxent_tpu.training.trainer import make_clip_train_step as jclip_step
from ntxent_tpu.training.trainer import make_sharded_train_step as jsharded
from ntxent_tpu.training.trainer import make_train_step as jstep
from ntxent_tpu_torch.parallel import moe
from ntxent_tpu_torch.training import trainer as ttrain
from ntxent_tpu_torch.training.lars import exclusion_mask
from ntxent_tpu_torch.weights import (
    flax_paths,
    flax_variables,
    load_flax_variables,
)

import torch_mp_workers as workers
from test_torch_distributed import _flatten, _mesh, _spawn

torch.set_num_threads(1)  # see test_torch_training.py

D, F = 16, 32
LEAVES = ("router", "w_up", "b_up", "w_down", "b_down")
STEP_CONFIG = dict(batch_size=8, temperature=0.2, base_lr=3.0,
                   weight_decay=1e-4, warmup_steps=1, total_steps=10)
CLIP_CONFIG = dict(batch_size=4, base_lr=1e-3, weight_decay=1e-4,
                   warmup_steps=1, total_steps=10)
EP_WORLD, EP_CF = 8, 8.0


def _np(tree):
    return jax.tree_util.tree_map(np.array, jax.device_get(tree))


def _port(params) -> moe.MoEParams:
    return moe.MoEParams(*(torch.tensor(np.asarray(getattr(params, k)))
                           .requires_grad_() for k in LEAVES))


def _x(seed, *shape):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _jax_vit_simclr(moe_experts=2):
    return jmodels.SimCLRModel(
        encoder=functools.partial(
            jmodels.VisionTransformer, **{k: v for k, v in
                                          workers.TINY_VIT.items()
                                          if k != "image_size"},
            dtype=jnp.float32, moe_experts=moe_experts),
        proj_hidden_dim=workers.TINY_PROJ[0],
        proj_dim=workers.TINY_PROJ[1], dtype=jnp.float32)


def _jax_clip(moe_experts=2):
    vit = {k: v for k, v in workers.TINY_CLIP_VIT.items()
           if k != "image_size"}
    return jmodels.CLIPModel(
        image_encoder=functools.partial(jmodels.VisionTransformer, **vit,
                                        dtype=jnp.float32,
                                        moe_experts=moe_experts),
        text_encoder=functools.partial(jmodels.TextTransformer,
                                       **workers.TINY_CLIP_TEXT,
                                       dtype=jnp.float32),
        embed_dim=workers.TINY_CLIP_EMBED)


def _views(steps, batch=8, seed=9):
    rng = np.random.default_rng(seed)
    return np.stack([[rng.uniform(size=(batch, 16, 16, 3)).astype(np.float32)
                      for _ in range(2)] for _ in range(steps)])


def _clip_batches(steps, seed=11, batch=4):
    rng = np.random.default_rng(seed)
    return (np.stack([rng.uniform(size=(batch, 16, 16, 3)).astype(np.float32)
                      for _ in range(steps)]),
            np.stack([rng.integers(1, 32, (batch, 8)).astype(np.int32)
                      for _ in range(steps)]))


@pytest.fixture(scope="module")
def setup():
    key = jax.random.PRNGKey(0)
    params = jinit(key, EP_WORLD, D, F)
    x = _x(3, 128, D)
    jmodel = _jax_vit_simclr()
    variables = _np(jmodel.init(jax.random.PRNGKey(1),
                                jnp.zeros((1, 16, 16, 3)), train=False))
    inputs = {"x": x, "cf": np.float32(EP_CF), "views": _views(2),
              **{f"moe/{k}": np.asarray(getattr(params, k)) for k in LEAVES},
              **_flatten(variables["params"], "params"),
              **_flatten(variables["batch_stats"], "batch_stats"),
              **{f"cfg:{k}": np.asarray(v) for k, v in STEP_CONFIG.items()}}
    return params, jmodel, variables, inputs


@pytest.fixture(scope="module")
def world(setup, tmp_path_factory):
    """The world of 8 started in the background (JAX computes meanwhile);
    yields a future of [results of rank 0, 1, ...]."""
    inputs = setup[3]
    tmp = tmp_path_factory.mktemp("moe_world")
    np.savez(tmp / "inputs.npz", **inputs)
    with ThreadPoolExecutor(max_workers=1) as pool:
        future = pool.submit(_spawn, workers.run_moe, EP_WORLD,
                             (str(tmp / "inputs.npz"), str(tmp)), tmp)

        def results():
            future.result()
            return [dict(np.load(tmp / f"rank{r}.npz"))
                    for r in range(EP_WORLD)]

        yield results


# ---------------------------------------------------------------------------
# the layer
# ---------------------------------------------------------------------------


def test_single_expert_equals_dense():
    params = jinit(jax.random.PRNGKey(0), 1, D, F)
    x = _x(1, 4, 6, D)
    y, aux = moe.switch_moe(_port(params), torch.tensor(x),
                            capacity_factor=2.0)
    dense = fnn.gelu(x @ params.w_up[0] + params.b_up[0]) @ params.w_down[0] \
        + params.b_down[0]
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(dense),
                               rtol=1e-5, atol=1e-5)
    # one expert: f = p = 1, aux = E f p = 1
    np.testing.assert_allclose(float(aux), 1.0, atol=1e-6)


def test_balanced_router_aux_is_one():
    params = jax.tree.map(jnp.zeros_like, jinit(jax.random.PRNGKey(0), 4, D,
                                                F))
    _, aux = moe.switch_moe(_port(params), torch.tensor(_x(2, 32, D)),
                            capacity_factor=8.0)
    # uniform probabilities; ties break to expert 0, as in JAX
    np.testing.assert_allclose(float(aux), 1.0, atol=1e-6)


def test_capacity_drop_passes_through_zero():
    """C = 1 keeps at most one token an expert; the dropped rows are
    exactly zero, the kept ones JAX's."""
    params = jinit(jax.random.PRNGKey(0), 2, D, F)
    x = _x(4, 16, D)
    y, _ = moe.switch_moe(_port(params), torch.tensor(x),
                          capacity_factor=0.125)
    want, _ = jmoe(params, jnp.asarray(x), capacity_factor=0.125)
    y = y.detach().numpy()
    assert np.isfinite(y).all()
    assert (np.linalg.norm(y, axis=-1) == 0).sum() >= 16 - 2
    np.testing.assert_array_equal(np.linalg.norm(y, axis=-1) == 0,
                                  np.linalg.norm(np.asarray(want), axis=-1)
                                  == 0)
    np.testing.assert_allclose(y, np.asarray(want), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("cf", [0.125, 1.25, 8.0])
def test_routing_values_and_gradients_match_jax(cf):
    """Expert ids and kept flags identical to JAX's dispatch mask (by
    index: no (T, E, C) tensor); output, aux and every gradient."""
    params = jinit(jax.random.PRNGKey(5), 4, D, F)
    x = _x(6, 2, 24, D)
    x2d = x.reshape(-1, D)
    c = moe.capacity(x2d.shape[0], 4, cf)
    dispatch, _, _, _ = jroute(jnp.asarray(x2d), params.router, c)
    dispatch = np.asarray(dispatch)
    expert, _, kept, _, _, _ = moe.route(torch.tensor(x2d),
                                         torch.tensor(np.asarray(
                                             params.router)), c)
    np.testing.assert_array_equal(kept.numpy(), dispatch.any(axis=(1, 2)))
    rows = dispatch.any(axis=2)
    np.testing.assert_array_equal(expert.numpy()[kept.numpy()],
                                  rows.argmax(axis=1)[kept.numpy()])

    tp, xt = _port(params), torch.tensor(x).requires_grad_()
    y, aux = moe.switch_moe(tp, xt, capacity_factor=cf)
    (y.square().sum() + aux).backward()

    def loss(p, v):
        out, a = jmoe(p, v, capacity_factor=cf)
        return jnp.sum(out ** 2) + a

    want_y, want_aux = jmoe(params, jnp.asarray(x), capacity_factor=cf)
    gp, gx = jax.grad(loss, argnums=(0, 1))(params, jnp.asarray(x))
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(want_y),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(float(aux), float(want_aux), atol=1e-5)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx), rtol=1e-4,
                               atol=1e-5)
    for k in LEAVES:
        np.testing.assert_allclose(getattr(tp, k).grad.numpy(),
                                   np.asarray(getattr(gp, k)), rtol=1e-4,
                                   atol=1e-5, err_msg=k)


def test_no_dispatch_mask_is_built():
    """No tensor of the (T, E, C) one-hot dispatch's size exists in the
    forward or backward: the largest is the (E, C, f) hidden batch."""
    from torch.utils._python_dispatch import TorchDispatchMode

    t, e, cf = 2048, 8, 1.25
    c = moe.capacity(t, e, cf)
    sizes = []

    class Sizes(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            for o in (out if isinstance(out, (tuple, list)) else (out,)):
                if isinstance(o, torch.Tensor):
                    sizes.append(o.numel())
            return out

    params = moe.init_moe_params(torch.Generator().manual_seed(0), e, D, F)
    for k in LEAVES:
        getattr(params, k).requires_grad_()
    x = torch.randn(t, D, requires_grad=True)
    with Sizes():
        y, aux = moe.switch_moe(params, x, capacity_factor=cf)
        (y.square().sum() + aux).backward()
    assert max(sizes) <= e * c * F < t * e * c


def test_moe_mlp_keeps_its_aux_and_carries_the_flax_leaves(setup):
    """``MoEMlp`` keeps the aux of its last forward (flax ``sow``); the
    tower's MoE leaves come from and go back to the flax layout, and the
    LARS mask treats them as JAX's (``router``, ``b_up``, ``b_down`` are
    not named ``bias``: they take decay and the trust ratio)."""
    _, jmodel, variables, _ = setup
    model = load_flax_variables(workers.vit_simclr(moe=2), variables)
    assert [type(b.mlp).__name__ for b in model.backbone.blocks] \
        == ["MlpBlock", "MoEMlp"]
    back = flax_variables(model)["params"]
    for k in LEAVES:
        np.testing.assert_array_equal(
            back["backbone"]["block_1"]["MoEMlp_0"][k],
            variables["params"]["backbone"]["block_1"]["MoEMlp_0"][k])
    paths = flax_paths(model)
    assert paths["backbone.blocks.1.mlp.w_up"] == (
        "backbone", "block_1", "MoEMlp_0", "w_up")
    want = jax.tree_util.tree_flatten_with_path(jmask(variables["params"]))
    want = {tuple(k.key for k in path): bool(v) for path, v in want[0]}
    got = exclusion_mask(model)
    assert {paths[n]: v for n, v in got.items()} == want
    x = torch.tensor(np.random.default_rng(0).uniform(
        size=(2, 16, 16, 3)).astype(np.float32))
    z = model(x)
    aux = moe.moe_aux_from(model)
    assert z.shape == (2, 32) and torch.isfinite(aux)
    aux.backward()
    assert torch.isfinite(model.backbone.blocks[1].mlp.router.grad).all()


def test_moe_vit_tower_matches_jax():
    """The MoE ViT (every other block) forward and its summed aux."""
    m = jmodels.VisionTransformer(patch_size=8, hidden_dim=16, depth=2,
                                  num_heads=2, mlp_dim=32, dtype=jnp.float32,
                                  moe_experts=4)
    x = np.random.default_rng(2).uniform(size=(2, 16, 16, 3)).astype(
        np.float32)
    variables = _np(m.init(jax.random.PRNGKey(3), x, train=False))
    want, state = m.apply(variables, x, train=True,
                          mutable=["intermediates"])
    leaves = jax.tree.leaves(state["intermediates"])
    assert len(leaves) == 1  # depth 2: one MoE block (block_1)
    tower = load_flax_variables(jmodels_port_vit(), variables)
    got = tower(torch.tensor(x))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(float(moe.moe_aux_from(tower)),
                               float(leaves[0]), atol=1e-5)


def jmodels_port_vit():
    from ntxent_tpu_torch.models import VisionTransformer

    return VisionTransformer(image_size=16, patch_size=8, hidden_dim=16,
                             depth=2, num_heads=2, mlp_dim=32,
                             dtype=torch.float32, moe_experts=4)


# ---------------------------------------------------------------------------
# the steps
# ---------------------------------------------------------------------------


def _jax_simclr_state(jmodel, variables):
    state = jstate(jmodel, jax.random.PRNGKey(0), (1, 16, 16, 3),
                   JaxConfig(**STEP_CONFIG))
    return state.replace(params=jax.tree.map(jnp.asarray,
                                             variables["params"]))


def _port_simclr_state(variables):
    return ttrain.create_train_state(
        load_flax_variables(workers.vit_simclr(moe=2), variables),
        ttrain.TrainerConfig(**STEP_CONFIG), torch.device("cpu"))


def _assert_params(model, want, atol=1e-4):
    got = flax_variables(model)["params"]
    for (path, a), b in zip(jax.tree_util.tree_flatten_with_path(got)[0],
                            jax.tree.leaves(_np(want))):
        np.testing.assert_allclose(a, b, atol=atol, rtol=atol,
                                   err_msg=jax.tree_util.keystr(path))


@pytest.fixture(scope="module")
def jax_simclr(setup, world):
    """Two JAX steps of the tiny MoE ViT SimCLR at moe_aux_weight 0.01:
    (losses, aux, final params), single device."""
    _, jmodel, variables, inputs = setup
    state = _jax_simclr_state(jmodel, variables)
    step = jstep(STEP_CONFIG["temperature"], use_fused=False,
                 moe_aux_weight=0.01)
    losses, auxes = [], []
    for v1, v2 in inputs["views"]:
        state, metrics = step(state, jnp.asarray(v1), jnp.asarray(v2))
        losses.append(float(metrics["loss"]))
        auxes.append(float(metrics["moe_aux"]))
    return losses, auxes, state.params


def test_moe_vit_train_step_matches_jax(setup, jax_simclr):
    """Two steps of the MoE ViT SimCLR: the aux joins the objective
    (loss, ``metrics["moe_aux"]``, the LARS update); weight 0 keeps the
    metrics without it."""
    _, _, variables, inputs = setup
    losses, auxes, params = jax_simclr
    state = _port_simclr_state(variables)
    step = ttrain.make_train_step(STEP_CONFIG["temperature"],
                                  moe_aux_weight=0.01)
    for i, (v1, v2) in enumerate(inputs["views"]):
        state, metrics = step(state, torch.tensor(v1), torch.tensor(v2))
        np.testing.assert_allclose(float(metrics["loss"]), losses[i],
                                   atol=1e-5)
        np.testing.assert_allclose(float(metrics["moe_aux"]), auxes[i],
                                   atol=1e-5)
    _assert_params(state.model, params)
    _, metrics0 = ttrain.make_train_step(0.2)(state, torch.tensor(v1),
                                              torch.tensor(v2))
    assert "moe_aux" not in metrics0


@pytest.mark.parametrize("lag", [False, True])
def test_moe_aux_on_the_guarded_path(setup, jax_simclr, lag):
    """The guarded step (host and lag-1 paths) reports the same loss and
    aux, and takes the same update."""
    _, _, variables, inputs = setup
    losses, auxes, params = jax_simclr
    state = _port_simclr_state(variables)
    step = ttrain.make_train_step(STEP_CONFIG["temperature"],
                                  moe_aux_weight=0.01, guard=True)
    for i, (v1, v2) in enumerate(inputs["views"]):
        state, metrics = step(state, torch.tensor(v1), torch.tensor(v2),
                              lag=lag)
        np.testing.assert_allclose(float(metrics["loss"]), losses[i],
                                   atol=1e-5)
        np.testing.assert_allclose(float(metrics["moe_aux"]), auxes[i],
                                   atol=1e-5)
    _assert_params(state.model, params)


def test_moe_clip_train_step_matches_jax():
    """CLIP with an MoE image tower under AdamW: the aux joins the
    InfoNCE objective, two steps."""
    jmodel = _jax_clip()
    images, tokens = _clip_batches(2)
    variables = _np(jmodel.init(jax.random.PRNGKey(4), images[0][:1],
                                tokens[0][:1], train=False))
    from ntxent_tpu.training.lars import cosine_warmup_schedule as jsched

    tx = optax.adamw(jsched(1e-3, 1, 10), weight_decay=1e-4)
    jst = FlaxState.create(apply_fn=jmodel.apply,
                           params=jax.tree.map(jnp.asarray,
                                               variables["params"]), tx=tx)
    jtrain = jclip_step(use_fused=False, moe_aux_weight=0.01)
    state = ttrain.create_clip_train_state(
        load_flax_variables(workers.tiny_clip(moe=2), variables),
        ttrain.TrainerConfig(**CLIP_CONFIG), torch.device("cpu"))
    step = ttrain.make_clip_train_step(moe_aux_weight=0.01)
    for im, tk in zip(images, tokens):
        jst, jm = jtrain(jst, jnp.asarray(im), jnp.asarray(tk))
        state, m = step(state, torch.tensor(im), torch.tensor(tk).long())
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                                   atol=1e-5)
        np.testing.assert_allclose(float(m["moe_aux"]), float(jm["moe_aux"]),
                                   atol=1e-5)
    assert_adamw_update(state.model, variables, jst.params,
                        CLIP_CONFIG["base_lr"])


def assert_adamw_update(model, variables, want, lr):
    """Each parameter's change from ``variables`` within 1e-3 of the JAX
    change's norm plus 1e-5 (AdamW divides each gradient by its own root
    mean square, so an entry near 0 turns a summation-order difference
    into an update difference of up to the lr); the attention key
    biases, whose gradient is 0 in exact arithmetic, held to AdamW's step
    bound of 2 lr an entry (``test_torch_clip_dp``'s rule)."""
    got = jax.tree_util.tree_flatten_with_path(
        flax_variables(model)["params"])[0]
    for (path, a), b, w in zip(got, jax.tree.leaves(variables["params"]),
                               jax.tree.leaves(_np(want))):
        name = jax.tree_util.keystr(path)
        delta, want_delta = a - b, w - b
        if "['key']['bias']" in name:
            assert np.abs(delta).max() <= 2 * lr, name
            continue
        err = np.linalg.norm(delta - want_delta)
        assert err <= 1e-3 * np.linalg.norm(want_delta) + 1e-5, (name, err)


# ---------------------------------------------------------------------------
# worlds
# ---------------------------------------------------------------------------


def test_expert_parallel_matches_the_local_layer(setup, world):
    """8-way expert parallelism (two all-to-alls) over the world's rows
    equals the unsharded JAX layer: outputs, the global aux on every
    rank, and the gradients (summed over the ranks)."""
    params, _, _, inputs = setup
    ranks = world()
    x = jnp.asarray(inputs["x"])
    want, want_aux = jmoe(params, x, capacity_factor=EP_CF)
    got = np.concatenate([r["ep_y"] for r in ranks])
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5, atol=1e-5)
    for r in ranks:
        np.testing.assert_allclose(float(r["ep_aux"]), float(want_aux),
                                   atol=1e-5)
        assert not bool(r["jax_loaded"])

    def loss(p):
        y, aux = jmoe(p, x, capacity_factor=EP_CF)
        return jnp.sum(y ** 2) + aux

    grads = jax.grad(loss)(params)
    for k in LEAVES:
        np.testing.assert_allclose(ranks[0][f"ep_g:{k}"],
                                   np.asarray(getattr(grads, k)),
                                   rtol=1e-4, atol=1e-5, err_msg=k)


def test_expert_count_must_divide_the_world(world):
    assert "divisible" in str(world()[0]["ep_divisible"])


def test_data_parallel_moe_step_matches_jax_shard_map(setup, world):
    """``make_sharded_train_step(moe_aux_weight=0.01)`` in a world of 4:
    each rank routes its own rows (the per-shard aux estimator), the
    reported loss and aux are pmean'd; held to JAX's ``shard_map`` step
    on a 4-device mesh, two steps."""
    _, jmodel, variables, inputs = setup
    mesh = _mesh(4)
    state = replicate_state(_jax_simclr_state(jmodel, variables), mesh)
    step = jsharded(mesh, STEP_CONFIG["temperature"], interpret=True,
                    moe_aux_weight=0.01)
    shard = NamedSharding(mesh, P("data"))
    losses, auxes = [], []
    for v1, v2 in inputs["views"]:
        state, metrics = step(state, jax.device_put(v1, shard),
                              jax.device_put(v2, shard))
        losses.append(float(metrics["loss"]))
        auxes.append(float(metrics["moe_aux"]))
    ranks = world()[:4]
    for r in ranks:
        np.testing.assert_allclose(r["dp_moe_loss"], losses, atol=1e-5)
        np.testing.assert_allclose(r["dp_moe_moe_aux"], auxes, atol=1e-5)
    model = workers.vit_simclr(moe=2)
    model.load_state_dict({k[len("dp_moe_:"):]: torch.from_numpy(v)
                           for k, v in ranks[0].items()
                           if k.startswith("dp_moe_:")})
    _assert_params(model, state.params)
