"""The port's ResNet encoders, their flax-exact BatchNorm, the weight
converter and a ResNet SimCLR train step against the JAX package.

The same numpy inputs and the same flax weights (carried across by
``load_flax_variables``, with every BatchNorm scale, bias and running
statistic drawn at random so that no zero-initialized scale hides a
branch) go through both packages on the CPU.

Tolerances:

* fp32 models, where the point is the algorithm: the same arithmetic in
  another summation order -> 1e-5 on features and running statistics of
  the shallow nets (``tiny``, ``resnet18``); through ResNet-50's 53
  norms, 1e-4 of the features' largest magnitude.
* bf16 models (the default dtype): both compute convolutions in bf16
  and round activations to bf16 after every norm, at places that differ
  (XLA fuses and rounds once where PyTorch rounds per op) -> 3e-2 of the
  largest magnitude, with the fp32 comparison beside it holding the
  algorithm.
* the train step (fp32): as the ViT steps of ``test_torch_training.py``,
  1e-4 on the loss, 5e-4 relative on each parameter's change plus 1e-5
  absolute for changes that are rounding noise on both sides, 1e-5 on
  the running statistics.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ntxent_tpu import models as jmodels
from ntxent_tpu.training.trainer import TrainerConfig as JaxConfig
from ntxent_tpu.training.trainer import create_train_state as jax_state
from ntxent_tpu.training.trainer import make_train_step as jax_step
from ntxent_tpu_torch import cli
from ntxent_tpu_torch.models import ResNet, SimCLRModel, init_weights
from ntxent_tpu_torch.models import resnet as tresnet
from ntxent_tpu_torch.training import trainer as ttrain
from ntxent_tpu_torch.training.lars import exclusion_mask
from ntxent_tpu_torch.weights import flax_paths, load_flax_variables

torch.set_num_threads(1)  # see test_torch_training.py

TINY_PROJ = (32, 16)  # projection hidden and output widths of the steps


def _np(tree):
    return jax.tree_util.tree_map(np.array, jax.device_get(tree))


def _randomize_norms(variables, seed):
    """Every BatchNorm scale, bias, mean and var drawn at random, in place
    (the scale in [0.2, 0.6] keeps ResNet-50's residual stream bounded)."""
    rng = np.random.default_rng(seed)

    def visit(params, stats):
        for key, node in params.items():
            if "scale" in node and "bias" in node:
                c = node["scale"].shape[0]
                node["scale"] = rng.uniform(0.2, 0.6, c).astype(np.float32)
                node["bias"] = (0.1 * rng.normal(size=c)).astype(np.float32)
                stats[key]["mean"] = (0.1 * rng.normal(size=c)).astype(
                    np.float32)
                stats[key]["var"] = rng.uniform(0.5, 1.5, c).astype(
                    np.float32)
            elif isinstance(node, dict) and "kernel" not in node:
                visit(node, stats[key])

    visit(variables["params"], variables["batch_stats"])
    return variables


def _jax_encoder(name, dtype, axis_name=None):
    """The JAX CLI's encoder of ``--model`` at a small image size
    (``cli.py:365-382``): the CIFAR stem."""
    if name == "tiny":
        return functools.partial(jmodels.ResNet, stage_sizes=(1,),
                                 small_images=True, dtype=dtype,
                                 axis_name=axis_name)
    table = {"resnet18": jmodels.ResNet18, "resnet50": jmodels.ResNet50}
    return functools.partial(table[name], small_images=True, dtype=dtype,
                             axis_name=axis_name)


def _port_encoder(name, dtype):
    if name == "tiny":
        return ResNet((1,), small_images=True, dtype=dtype)
    return cli.RESNETS[name](small_images=True, dtype=dtype)


def _images(batch, size, seed):
    return np.random.default_rng(seed).uniform(
        size=(batch, size, size, 3)).astype(np.float32)


def _max_rel(got, want):
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize("size,kernel,stride,pads", [
    (224, 7, 2, (2, 3)), (112, 3, 2, (0, 1)), (56, 3, 2, (0, 1)),
    (28, 3, 2, (0, 1)), (14, 3, 2, (0, 1)), (32, 3, 1, (1, 1)),
    (7, 1, 1, (0, 0)), (7, 3, 2, (1, 1))])
def test_same_padding_is_flax_same(size, kernel, stride, pads):
    assert tresnet.same_padding(size, kernel, stride) == pads
    # and it is what XLA pads
    lo_hi = jax.lax.padtype_to_pads((size,), (kernel,), (stride,), "SAME")
    assert tuple(lo_hi[0]) == pads


@pytest.mark.parametrize("name", ["tiny", "resnet18"])
def test_train_mode_forward_and_statistics_match_flax(name):
    jmodel = _jax_encoder(name, jnp.float32)()
    x = _images(6, 32, seed=0)
    variables = _randomize_norms(
        _np(jmodel.init(jax.random.PRNGKey(0), x, train=False)), seed=1)
    want, updates = jmodel.apply(variables, x, train=True,
                                 mutable=["batch_stats"])
    model = load_flax_variables(_port_encoder(name, torch.float32),
                                variables).train()
    got = model(torch.from_numpy(x))
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=1e-5, rtol=0)
    new = load_flax_variables(_port_encoder(name, torch.float32),
                              {"params": variables["params"],
                               "batch_stats": _np(updates["batch_stats"])})
    for (key, buf), (_, ref) in zip(model.named_buffers(),
                                    new.named_buffers()):
        torch.testing.assert_close(buf, ref, atol=1e-5, rtol=0, msg=key)


def test_bf16_forward_matches_flax_within_rounding():
    jmodel = _jax_encoder("tiny", jnp.bfloat16)()
    x = _images(6, 16, seed=2)
    variables = _randomize_norms(
        _np(jmodel.init(jax.random.PRNGKey(1), x, train=False)), seed=3)
    want = np.asarray(jmodel.apply(variables, x, train=True,
                                   mutable=["batch_stats"])[0])
    model = load_flax_variables(_port_encoder("tiny", torch.bfloat16),
                                variables).train()
    got = model(torch.from_numpy(x))
    assert got.dtype == torch.float32
    assert _max_rel(got.detach().numpy(), want) <= 3e-2


@pytest.mark.parametrize("size", [64, 224])
def test_resnet50_eval_forward_matches_flax(size):
    """64 px takes the CIFAR stem; 224 px the ImageNet stem, where flax's
    asymmetric SAME padding of the strided stem, max-pool and 3x3
    convolutions shows (symmetric padding shifts every window)."""
    enc = functools.partial(jmodels.ResNet50, small_images=size <= 64,
                            dtype=jnp.float32)
    jmodel = enc()
    x = _images(2, size, seed=4)
    variables = _randomize_norms(_np(jax.jit(
        lambda k: jmodel.init(k, x, train=False))(jax.random.PRNGKey(2))),
        seed=5)
    want = np.asarray(jax.jit(lambda v, x: jmodel.apply(v, x, train=False))(
        variables, x))
    model = load_flax_variables(
        tresnet.ResNet50(small_images=size <= 64, dtype=torch.float32),
        variables).eval()
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    assert got.shape == (2, 2048)
    assert _max_rel(got, want) <= 1e-4


def test_converter_covers_every_leaf_of_resnet50_simclr():
    jmodel = jmodels.SimCLRModel(encoder=jmodels.ResNet50)
    shapes = jax.eval_shape(lambda: jmodel.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 224, 224, 3)), train=False))
    variables = jax.tree_util.tree_map(
        lambda s: np.random.default_rng(0).normal(size=s.shape).astype(
            np.float32), shapes)
    model = SimCLRModel(tresnet.ResNet50())
    # raises on any flax leaf without a torch tensor and the reverse;
    # 164 = stem (3) + 16 blocks x 9 + 4 shortcuts x 3 + head (5)
    load_flax_variables(model, variables)
    leaves = {tuple(str(k.key) for k in path) for path, _ in
              jax.tree_util.tree_flatten_with_path(variables["params"])[0]}
    paths = flax_paths(model)
    assert set(paths.values()) == leaves and len(paths) == len(leaves) == 164
    conv = variables["params"]["backbone"]["BottleneckBlock_3"]["Conv_1"][
        "kernel"]
    np.testing.assert_array_equal(
        model.backbone.blocks[3].convs[1].weight.detach().numpy(),
        conv.transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(
        model.backbone.blocks[15].norms[2].running_var.numpy(),
        variables["batch_stats"]["backbone"]["BottleneckBlock_15"][
            "BatchNorm_2"]["var"])


def test_lars_excludes_every_norm_and_keeps_every_conv():
    mask = exclusion_mask(SimCLRModel(tresnet.ResNet50()))
    for name, applies in mask.items():
        is_norm = ".norms." in name or "_bn." in name or ".bn1." in name
        assert applies == (not is_norm and not name.endswith("bias")), name


def tiny_port_model(variables):
    """The port of the JAX CLI's ``--model tiny`` SimCLR model (fp32)
    holding flax ``variables``."""
    return load_flax_variables(
        SimCLRModel(_port_encoder("tiny", torch.float32), *TINY_PROJ,
                    dtype=torch.float32), variables)


def tiny_simclr_pair(seed=0, axis_name=None):
    """The JAX CLI's ``--model tiny`` SimCLR model in fp32 with randomized
    norms, as (flax model, numpy variables), and its port."""
    jmodel = jmodels.SimCLRModel(
        encoder=_jax_encoder("tiny", jnp.float32, axis_name),
        proj_hidden_dim=TINY_PROJ[0], proj_dim=TINY_PROJ[1],
        axis_name=axis_name, dtype=jnp.float32)
    variables = _randomize_norms(_np(jmodel.init(
        jax.random.PRNGKey(seed), jnp.zeros((1, 8, 8, 3)), train=False)),
        seed + 1)
    return jmodel, variables, tiny_port_model(variables)


STEP_CONFIG = dict(batch_size=8, temperature=0.2, base_lr=3.0,
                   weight_decay=1e-4, warmup_steps=1, total_steps=10)


def jax_tiny_state(jmodel, variables):
    """A JAX TrainState of ``jmodel`` holding ``variables``."""
    cfg = JaxConfig(**STEP_CONFIG)
    state = jax_state(jmodel, jax.random.PRNGKey(0), (1, 8, 8, 3), cfg)
    return state.replace(
        params=jax.tree_util.tree_map(jnp.asarray, variables["params"]),
        batch_stats=jax.tree_util.tree_map(jnp.asarray,
                                           variables["batch_stats"]))


def step_views(steps, batch=8, seed=9):
    rng = np.random.default_rng(seed)
    return [tuple(rng.uniform(size=(batch, 8, 8, 3)).astype(np.float32)
                  for _ in range(2)) for _ in range(steps)]


def assert_same_update(model, before, want):
    """Each parameter's change from ``before`` and every running statistic
    of ``model`` equal those of the port model ``want`` (see the module
    docstring for the bounds)."""
    want_params = dict(want.named_parameters())
    for name, p in model.named_parameters():
        delta = (p - before[name]).detach()
        want_delta = (want_params[name] - before[name]).detach()
        err = float((delta - want_delta).norm())
        assert err <= 5e-4 * float(want_delta.norm()) + 1e-5, (name, err)
    want_bufs = dict(want.named_buffers())
    for name, buf in model.named_buffers():
        torch.testing.assert_close(buf, want_bufs[name], atol=1e-5, rtol=0,
                                   msg=name)


@pytest.mark.parametrize("use_fused", [None, True])
def test_tiny_resnet_train_steps_match_jax(use_fused):
    """Two steps (step 0 runs at lr 0, the warmup's first value) from the
    same flax weights on the same views: losses, every parameter's change
    and every running statistic. ``use_fused=True`` runs the NT-Xent
    kernels' plain versions; the JAX step takes the oracle on the CPU."""
    jmodel, variables, model = tiny_simclr_pair()
    jstate = jax_tiny_state(jmodel, variables)
    jtrain = jax_step(STEP_CONFIG["temperature"])
    state = ttrain.create_train_state(
        model, ttrain.TrainerConfig(**STEP_CONFIG), torch.device("cpu"))
    step = ttrain.make_train_step(STEP_CONFIG["temperature"],
                                  use_fused=use_fused)
    before = {k: v.detach().clone() for k, v in model.named_parameters()}
    for v1, v2 in step_views(2):
        jstate, jmetrics = jtrain(jstate, jnp.asarray(v1), jnp.asarray(v2))
        state, metrics = step(state, torch.from_numpy(v1),
                              torch.from_numpy(v2))
        np.testing.assert_allclose(float(metrics["loss"]),
                                   float(jmetrics["loss"]), atol=1e-4, rtol=0)
    assert_same_update(model, before, tiny_port_model(
        {"params": _np(jstate.params),
         "batch_stats": _np(jstate.batch_stats)}))


def test_space_to_depth_stem_is_not_ported():
    """Named when the stem raised NotImplementedError; ported since
    (ROADMAP.md Queue A 6(b)): ``stem="space_to_depth"`` builds a ResNet
    whose stem is ``SpaceToDepthStem`` with the conv stem's state dict, and
    the two compute the same linear map (fp32, the summation order
    apart); the CIFAR stem and unknown stems refuse it, as in the JAX
    package (``tests/test_torch_stem.py`` holds it against JAX's)."""
    from ntxent_tpu_torch.models.resnet import SpaceToDepthStem

    s2d = ResNet((1,), stem="space_to_depth", dtype=torch.float32)
    conv = ResNet((1,), dtype=torch.float32)
    assert isinstance(s2d.stem_conv, SpaceToDepthStem)
    init_weights(conv, torch.Generator().manual_seed(0))
    s2d.load_state_dict(conv.state_dict())  # one layout, one set of keys
    x = torch.from_numpy(np.random.default_rng(0).uniform(
        size=(2, 72, 72, 3)).astype(np.float32))
    torch.testing.assert_close(s2d.eval()(x), conv.eval()(x), rtol=0,
                               atol=1e-4)
    with pytest.raises(ValueError, match="requires the ImageNet stem"):
        ResNet((1,), stem="space_to_depth", small_images=True)
    with pytest.raises(ValueError, match="unknown stem"):
        ResNet((1,), stem="s2d")
