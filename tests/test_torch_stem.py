"""The space-to-depth ResNet stem of the port
(``ntxent_tpu_torch/models/resnet.py``, ``SpaceToDepthStem``) against the
JAX package's (``ntxent_tpu/models/resnet.py:31-80``), on the CPU.

Tolerances (fp32 on both sides; the stem is one convolution whose sums
run in another order in each):

* the space-to-depth layout: exact (a permutation);
* the stem against JAX's from one weight: 1e-5 of the output's largest
  magnitude, the error of a 147-term fp32 sum in another order;
* the stem against the port's own 7x7/2 conv stem (the same linear map):
  the same 1e-5;
* a one-stage ResNet with the stem in train mode against flax: 1e-5, as
  ``tests/test_torch_resnet.py`` holds the conv stem's ResNets;
* bf16 (the path's dtype) against the conv stem: 2e-2 of the largest
  magnitude, the serve path's bf16 tolerance.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ntxent_tpu import models as jmodels
from ntxent_tpu.models.resnet import SpaceToDepthStem as JaxStem
from ntxent_tpu.models.resnet import _space_to_depth as jax_space_to_depth
from ntxent_tpu_torch import cli
from ntxent_tpu_torch.models import ResNet, init_weights
from ntxent_tpu_torch.models.resnet import (
    Conv,
    SpaceToDepthStem,
    space_to_depth,
)
from ntxent_tpu_torch.weights import load_flax_variables

from test_torch_resnet import _np, _randomize_norms

torch.set_num_threads(1)  # one torch thread a test worker

REL = 1e-5
BF16_REL = 2e-2


def _images(batch, size, seed, channels=3):
    return np.random.default_rng(seed).uniform(
        size=(batch, size, size, channels)).astype(np.float32)


def _nchw(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(x).permute(0, 3, 1, 2)


def _max_rel(got, want) -> float:
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize("size,channels", [(8, 3), (224, 3), (30, 5)])
def test_space_to_depth_is_the_jax_layout(size, channels):
    """(a, b, c) phase-major channels, the NCHW view of JAX's NHWC."""
    x = _images(2, size, seed=size, channels=channels)
    want = np.asarray(jax_space_to_depth(jnp.asarray(x), 2))
    got = space_to_depth(_nchw(x)).permute(0, 2, 3, 1).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("size,width", [(224, 64), (72, 64), (30, 16)])
def test_stem_matches_the_jax_stem(size, width):
    """From one (7, 7, C, width) kernel carried across (the port keeps it
    as (width, C, 7, 7), the conv stem's layout)."""
    x = _images(2, size, seed=1)
    jstem = JaxStem(width, dtype=jnp.float32)
    params = _np(jstem.init(jax.random.PRNGKey(size), x))
    want = np.asarray(jstem.apply(params, x))
    stem = SpaceToDepthStem(3, width, torch.float32)
    with torch.no_grad():
        stem.weight.copy_(torch.from_numpy(
            params["params"]["kernel"].transpose(3, 2, 0, 1)))
    got = stem(_nchw(x)).permute(0, 2, 3, 1).detach().numpy()
    assert got.shape == want.shape == (2, size // 2, size // 2, width)
    assert _max_rel(got, want) < REL


@pytest.mark.parametrize("size", [224, 72, 30, 16])
def test_stem_is_the_conv_stem(size):
    """The same linear map as the 7x7/2 conv with flax's SAME padding
    (2, 3) at even sizes; a weight is shared, so checkpoints interchange."""
    x = _nchw(_images(2, size, seed=2))
    conv = Conv(3, 64, 7, 2, torch.float32)
    init_weights(conv, torch.Generator().manual_seed(size))
    stem = SpaceToDepthStem(3, 64, torch.float32)
    stem.load_state_dict(conv.state_dict())
    assert _max_rel(stem(x).detach().numpy(),
                    conv(x).detach().numpy()) < REL


def test_stem_refuses_odd_sizes():
    with pytest.raises(ValueError, match="even H/W"):
        SpaceToDepthStem(3, 8, torch.float32)(torch.zeros(1, 3, 9, 9))


def test_bf16_stem_against_the_conv_stem():
    x = _nchw(_images(2, 72, seed=3))
    conv = Conv(3, 64, 7, 2)
    init_weights(conv, torch.Generator().manual_seed(0))
    stem = SpaceToDepthStem(3, 64)
    stem.load_state_dict(conv.state_dict())
    got, want = stem(x).float(), conv(x).float()
    assert got.dtype == torch.float32 and stem(x).dtype == torch.bfloat16
    assert _max_rel(got.detach().numpy(), want.detach().numpy()) < BF16_REL


def test_resnet_with_the_stem_matches_flax():
    """A one-stage ResNet with the space-to-depth stem at 72 px in train
    mode (batch statistics) against the flax ResNet from the same
    variables: the weight converter needs nothing new."""
    jmodel = jmodels.ResNet(stage_sizes=(1,), stem="space_to_depth",
                            dtype=jnp.float32)
    x = _images(4, 72, seed=4)
    variables = _randomize_norms(
        _np(jmodel.init(jax.random.PRNGKey(3), x, train=False)), seed=5)
    assert variables["params"]["stem_conv"]["kernel"].shape == (7, 7, 3, 64)
    want, _ = jmodel.apply(variables, x, train=True,
                           mutable=["batch_stats"])
    model = load_flax_variables(
        ResNet((1,), stem="space_to_depth", dtype=torch.float32),
        variables).train()
    assert isinstance(model.stem_conv, SpaceToDepthStem)
    got = model(torch.from_numpy(x)).detach().numpy()
    assert _max_rel(got, np.asarray(want)) < REL


def test_cli_encoders_take_the_stem():
    """``--stem`` as the JAX CLI's ``_make_encoder`` takes it
    (``cli.py:357-386``): the ImageNet stem of a ResNet, refused by the
    CIFAR stem (64 px and below) and by the other encoders."""
    args = cli.build_train_parser().parse_args(
        ["--model", "resnet50", "--stem", "space_to_depth"])
    args.image_size = 224
    encoder = cli.build_model(args).backbone
    assert isinstance(encoder.stem_conv, SpaceToDepthStem)
    assert encoder.hidden_dim == 2048
    args.image_size = 64
    with pytest.raises(SystemExit, match="ImageNet stem only"):
        cli.build_model(args)
    for model in ("tiny", "vit_t16"):
        args = cli.build_train_parser().parse_args(
            ["--model", model, "--stem", "space_to_depth"])
        args.image_size = 224
        with pytest.raises(SystemExit, match="ResNet encoders only"):
            cli.build_model(args)


def test_resnet50_checkpoint_layout_is_the_conv_stems():
    """The stem's state dict is the conv stem's, key for key and shape for
    shape, at ResNet-50's width: a checkpoint of either runs under the
    other."""
    factory = functools.partial(cli.RESNETS["resnet50"], small_images=False)
    s2d, conv = factory(stem="space_to_depth"), factory()
    assert {k: v.shape for k, v in s2d.state_dict().items()} \
        == {k: v.shape for k, v in conv.state_dict().items()}
