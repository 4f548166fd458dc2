"""Megatron tensor parallelism of the port (``parallel/tp.py``) and its
composition with ZeRO-3, against the JAX package's ``parallel/tp.py``
(after ``tests/test_tp.py``).

The layout rules are held to JAX's leaf by leaf: the port's module rule
(``tp_leaves``) cuts the entries of every flax leaf that JAX's
``tp_param_spec`` cuts, and the same leaves at model sizes 2 and 4; and the
composed Megatron + ZeRO-3 rule over 200 random shapes. The steps run in
a gloo world of 8 ranks as the (data 4, model 2) grid
(``torch_mp_workers.run_tp``), spawned while JAX computes: two steps of
the tiny ViT SimCLR under TP (the strip loss over 'data' and over both
axes, the oracle loss) and under Megatron + ZeRO-3, each held to JAX's
``make_tp_simclr_train_step`` on the (4, 2) mesh; two steps of the tiny
CLIP with an MoE image tower under TP, held to JAX's CLIP step with the
MoE aux loss. Tolerances (fp32): losses and aux 1e-5; LARS parameters
after two steps 1e-4; the AdamW rule of ``test_torch_moe``; BatchNorm
statistics 1e-5.
"""

from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax.training.train_state import TrainState as FlaxState

from ntxent_tpu.parallel.fsdp import param_bytes_per_device as jbytes
from ntxent_tpu.parallel.mesh import create_mesh
from ntxent_tpu.parallel.tp import _drop_indivisible as jdrop
from ntxent_tpu.parallel.tp import make_tp_simclr_train_step as jtp_step
from ntxent_tpu.parallel.tp import shard_train_state as jshard
from ntxent_tpu.parallel.tp import shard_train_state_tp_fsdp as jshard_fsdp
from ntxent_tpu.parallel.tp import tp_fsdp_param_spec as jtp_fsdp
from ntxent_tpu.parallel.tp import tp_param_spec as jspec
from ntxent_tpu.training.lars import cosine_warmup_schedule as jsched
from ntxent_tpu.training.trainer import make_clip_train_step as jclip_step
from ntxent_tpu_torch.parallel import fsdp, tp
from ntxent_tpu_torch.weights import (
    flax_paths,
    flax_variables,
    load_flax_variables,
)

import torch_mp_workers as workers
from test_torch_distributed import _flatten, _spawn
from test_torch_moe import (
    CLIP_CONFIG,
    STEP_CONFIG,
    _assert_params,
    _clip_batches,
    _jax_clip,
    _jax_simclr_state,
    _jax_vit_simclr,
    _np,
    _views,
    assert_adamw_update,
)

torch.set_num_threads(1)  # see test_torch_training.py

WORLD, GRID = 8, (4, 2)
MIN_SHARD = workers.MIN_SHARD


def _keys(path):
    return [k.key for k in path]


@pytest.fixture(scope="module")
def setup():
    jmodel = _jax_vit_simclr(moe_experts=0)
    variables = _np(jmodel.init(jax.random.PRNGKey(1),
                                jnp.zeros((1, 16, 16, 3)), train=False))
    jclip = _jax_clip()
    images, tokens = _clip_batches(2)
    clip_vars = _np(jclip.init(jax.random.PRNGKey(4), images[0][:1],
                               tokens[0][:1], train=False))
    inputs = {"views": _views(2), "images": images, "tokens": tokens,
              **_flatten(variables["params"], "params"),
              **_flatten(variables["batch_stats"], "batch_stats"),
              **_flatten(clip_vars["params"], "clip_params"),
              **{f"cfg:{k}": np.asarray(v) for k, v in STEP_CONFIG.items()},
              **{f"clipcfg:{k}": np.asarray(v)
                 for k, v in CLIP_CONFIG.items()}}
    return jmodel, variables, jclip, clip_vars, inputs


@pytest.fixture(scope="module")
def world(setup, tmp_path_factory):
    inputs = setup[-1]
    tmp = tmp_path_factory.mktemp("tp_world")
    np.savez(tmp / "inputs.npz", **inputs)
    with ThreadPoolExecutor(max_workers=1) as pool:
        future = pool.submit(_spawn, workers.run_tp, WORLD,
                             (str(tmp / "inputs.npz"), str(tmp)), tmp)

        def results():
            future.result()
            return [dict(np.load(tmp / f"rank{r}.npz"))
                    for r in range(WORLD)]

        yield results


# ---------------------------------------------------------------------------
# the layout rules
# ---------------------------------------------------------------------------


def _trees(setup):
    jmodel, variables, jclip, clip_vars, _ = setup
    moe_vars = _np(_jax_vit_simclr(moe_experts=2).init(
        jax.random.PRNGKey(2), jnp.zeros((1, 16, 16, 3)), train=False))
    return {"vit": variables["params"], "moe": moe_vars["params"],
            "clip": clip_vars["params"]}


class _Mesh:
    def __init__(self, model_size):
        self.shape = {"model": model_size}


def _jax_cut(path, leaf, model_size) -> int | None:
    """The dimension JAX's rule cuts over the model axis, or None."""
    spec = jdrop(jspec(path, leaf), leaf, _Mesh(model_size))
    return next((i for i, a in enumerate(spec) if a is not None), None)


def _tagged_models() -> dict:
    """The tiny ViT, MoE ViT and MoE CLIP, every parameter entry a value
    of its own."""
    models = {"vit": workers.vit_simclr(), "moe": workers.vit_simclr(moe=2),
              "clip": workers.tiny_clip(moe=2)}
    for model in models.values():
        start = 0
        with torch.no_grad():
            for p in model.parameters():
                p.copy_(torch.arange(start, start + p.numel(),
                                     dtype=torch.float32).view(p.shape))
                start += p.numel()
    return models


def test_param_spec_matches_jax_on_every_leaf():
    """Every leaf of the ViT, the MoE ViT and the MoE CLIP is cut as JAX's
    spec cuts it at model size 2: with every parameter entry a value of
    its own, carried to the flax layout, rank r's slice of the port's cut
    dimension holds the values of rank r's slice of the flax leaf along
    JAX's, and a leaf JAX keeps whole the port keeps whole."""
    for name, model in _tagged_models().items():
        cut = tp.tp_leaves(model, 2)
        names = {path: n for n, path in flax_paths(model).items()}
        params = dict(model.named_parameters())
        tree = flax_variables(model)["params"]
        for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
            torch_name = names[tuple(_keys(path))]
            dim = _jax_cut(path, leaf, 2)
            assert (dim is None) == (torch_name not in cut), \
                (name, torch_name)
            if dim is None:
                continue
            ours = params[torch_name].detach().chunk(2, cut[torch_name])
            for r, theirs in enumerate(np.split(leaf, 2, axis=dim)):
                np.testing.assert_array_equal(
                    np.sort(ours[r].numpy(), axis=None),
                    np.sort(theirs, axis=None), err_msg=f"{name} {path}")


@pytest.mark.parametrize("model_size", [2, 4])
def test_module_rule_cuts_the_leaves_jax_cuts(setup, model_size):
    """The port's module rule cuts exactly the leaves whose JAX spec keeps
    a model axis once indivisible dimensions are dropped (at 4 the
    2-head attention stays whole, as in JAX); the ViT, the MoE ViT and
    the MoE CLIP."""
    _, variables, _, clip_vars, _ = setup
    models = {"vit": workers.vit_simclr(), "moe": workers.vit_simclr(moe=2),
              "clip": workers.tiny_clip(moe=2)}
    trees = _trees(setup)
    for name, model in models.items():
        paths = flax_paths(model)
        want = set()
        for path, leaf in jax.tree_util.tree_flatten_with_path(
                trees[name])[0]:
            if _jax_cut(path, leaf, model_size) is not None:
                want.add(tuple(_keys(path)))
        got = {paths[n] for n in tp.tp_leaves(model, model_size)}
        assert got == want, (name, sorted(got ^ want))


def test_composed_rule_matches_jax_over_random_shapes():
    """Megatron + ZeRO-3 (``tp_fsdp_param_spec``) against JAX's rule over
    random shapes of a query kernel (heads on dim 1, claimed by the model
    axis where it divides it), and JAX's fuzz invariants."""

    class _Key:
        def __init__(self, key):
            self.key = key

    path = (_Key("MultiHeadAttention_0"), _Key("query"), _Key("kernel"))
    rng = np.random.RandomState(0)
    for _ in range(200):
        shape = tuple(int(rng.choice([1, 3, 4, 6, 8, 16, 24, 64]))
                      for _ in range(3))
        data, model = int(rng.choice([2, 3, 4, 8])), int(rng.choice([2, 3,
                                                                    4]))
        want = list(jtp_fsdp(path, np.zeros(shape), data_size=data,
                             model_size=model, min_shard_elems=1))
        want += [None] * (3 - len(want))
        tp_dim = 1 if shape[1] % model == 0 else None
        got = tp.tp_fsdp_param_spec(shape, tp_dim, data, min_shard_elems=1)
        assert got == (want.index("data") if "data" in want else None), (
            shape, data, model, want)
        assert got is None or (got != tp_dim and shape[got] % data == 0)
    # a 3-head tower on a 2-wide model axis: the freed dim goes to 'data'
    assert tp.tp_fsdp_param_spec((64, 3, 32), None, 4,
                                 min_shard_elems=1) == 0
    assert tp.tp_fsdp_param_spec((64, 4, 32), 1, 4, min_shard_elems=1) == 0
    assert fsdp.largest_divisible_dim((64, 4, 32), 4, taken=(0,)) == 2


def test_oracle_refuses_loss_axes():
    with pytest.raises(ValueError, match="loss_axes"):
        tp.make_tp_simclr_train_step(0.1, loss_impl="oracle",
                                     loss_axes="both")
    with pytest.raises(ValueError, match="loss_axes"):
        tp.make_tp_clip_train_step(loss_impl="oracle", loss_axes="data")


# ---------------------------------------------------------------------------
# the steps, (data 4, model 2)
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_tp(setup, world):
    """Two steps of JAX's TP SimCLR step on the (4, 2) mesh (strip loss),
    LARS: (losses, params, batch_stats), and the per-device parameter
    bytes of JAX's Megatron + ZeRO-3 placement."""
    jmodel, variables, _, _, inputs = setup
    mesh = create_mesh(shape=GRID, axis_names=("data", "model"))
    state = jshard(_jax_simclr_state(jmodel, variables).replace(
        batch_stats=jax.tree.map(jnp.asarray, variables["batch_stats"])),
        mesh)
    step = jtp_step(mesh, STEP_CONFIG["temperature"], has_batch_stats=True,
                    interpret=True)
    losses = []
    for v1, v2 in inputs["views"]:
        state, metrics = step(state, jnp.asarray(v1), jnp.asarray(v2))
        losses.append(float(metrics["loss"]))
    placed = jshard_fsdp(_jax_simclr_state(jmodel, variables), mesh,
                         min_shard_elems=MIN_SHARD)
    return losses, _np(state.params), _np(state.batch_stats), \
        jbytes(placed)


def _rank_model(res, prefix, model):
    model.load_state_dict({k[len(prefix) + 1:]: torch.from_numpy(v)
                           for k, v in res.items()
                           if k.startswith(prefix + ":")})
    return model


@pytest.mark.parametrize("prefix", ["tp_", "tpboth_", "tporacle_",
                                    "tpfsdp_"])
def test_tp_simclr_steps_match_jax(setup, jax_tp, world, prefix):
    """The strip loss over 'data' (every model rank the same rows), over
    both axes (each model rank its share), the oracle loss, and Megatron +
    ZeRO-3: every rank's losses, and rank 0's whole parameters and
    running statistics after two steps, against JAX's TP step; every rank
    ends with the same whole state."""
    losses, params, stats, _ = jax_tp
    ranks = world()
    for r in ranks:
        np.testing.assert_allclose(r[f"{prefix}loss"], losses, atol=1e-5)
        assert not bool(r["jax_loaded"])
    model = _rank_model(ranks[0], prefix, workers.vit_simclr())
    _assert_params(model, params)
    for name, buf in model.named_buffers():
        assert buf.shape  # running statistics of the projector's BN
    from ntxent_tpu_torch.weights import flax_variables

    got = flax_variables(model)["batch_stats"]
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(stats)):
        np.testing.assert_allclose(a, b, atol=1e-5)
    for r in ranks[1:]:
        for key, value in ranks[0].items():
            if key.startswith(prefix + ":"):
                np.testing.assert_array_equal(r[key], value, err_msg=key)


def test_tp_cuts_the_weights_and_zero3_cuts_them_again(jax_tp, world):
    """A rank keeps its model slice of the cut weights (fewer bytes than
    the whole model), and under Megatron + ZeRO-3 exactly JAX's bytes a
    device."""
    ranks = world()
    whole = sum(v.size * 4 for k, v in ranks[0].items()
                if k.startswith("tp_:") and "running" not in k)
    assert int(ranks[0]["tp_bytes"]) < whole
    assert int(ranks[0]["tpfsdp_bytes"]) == jax_tp[3]


def test_tp_clip_with_moe_matches_jax(setup, world):
    """Two steps of the tiny CLIP with an MoE image tower under TP
    (``moe_aux_weight`` 0.01, routed over the global batch): losses and
    aux against JAX's CLIP step, and the AdamW update."""
    _, _, jclip, clip_vars, inputs = setup
    tx = optax.adamw(jsched(CLIP_CONFIG["base_lr"], 1, 10),
                     weight_decay=CLIP_CONFIG["weight_decay"])
    state = FlaxState.create(apply_fn=jclip.apply, params=jax.tree.map(
        jnp.asarray, clip_vars["params"]), tx=tx)
    step = jclip_step(use_fused=False, moe_aux_weight=0.01)
    losses, auxes = [], []
    for im, tk in zip(inputs["images"], inputs["tokens"]):
        state, metrics = step(state, jnp.asarray(im), jnp.asarray(tk))
        losses.append(float(metrics["loss"]))
        auxes.append(float(metrics["moe_aux"]))
    ranks = world()
    for r in ranks:
        np.testing.assert_allclose(r["tpclip_loss"], losses, atol=1e-5)
        np.testing.assert_allclose(r["tpclip_moe_aux"], auxes, atol=1e-5)
    model = _rank_model(ranks[0], "tpclip_", workers.tiny_clip(moe=2))
    assert_adamw_update(model, clip_vars, state.params,
                        CLIP_CONFIG["base_lr"])


def test_tp_modules_carry_whole_flax_leaves(setup):
    """A TP-sliced module gathered back (``Sharding.gather``) is the plain
    module again: its flax variables are the whole leaves (checked in a
    world of one, where the slices are the whole tensors)."""
    import datetime
    import tempfile

    from ntxent_tpu_torch.parallel import mesh
    from ntxent_tpu_torch.training import create_train_state
    from ntxent_tpu_torch.training.trainer import TrainerConfig
    from ntxent_tpu_torch.weights import flax_variables

    _, variables, _, _, _ = setup
    with tempfile.TemporaryDirectory() as d:
        mesh.init_from_file(f"{d}/store", 0, 1, device="cpu",
                            timeout=datetime.timedelta(seconds=60))
        try:
            data, model_group = mesh.grid_groups(1, 1)
            state = create_train_state(
                load_flax_variables(workers.vit_simclr(), variables),
                TrainerConfig(**STEP_CONFIG), torch.device("cpu"))
            state = tp.shard_train_state(state, model_group, data)
            attn = state.model.backbone.blocks[0].attn
            assert attn.tp_group is model_group and attn.local_heads == 2
            whole = state.sharding.gather(state)
            assert whole.model.backbone.blocks[0].attn.tp_group is None
            got = flax_variables(whole.model)["params"]
        finally:
            mesh.shutdown()
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(
            variables["params"])):
        np.testing.assert_array_equal(a, b)
