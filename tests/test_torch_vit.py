"""The port's ViT SimCLR model against the JAX package's, on weights
carried across by ``load_flax_variables``.

Small ViT-B-shaped tower: patch 4, image 16 (17 tokens), hidden 32,
2 blocks, 4 heads, MLP 64, projection 64 -> 16. Inputs come from numpy
with a seed. On the CPU the JAX flash path runs ``attention_oracle``
(models/long_context.py:default_attention) and the port's runs the
kernel's plain version. Tolerances:

* fp32 (JAX modules built at dtype=float32): the same arithmetic in
  another summation order -> 2e-5 absolute;
* bf16 (the default policy): the frameworks round to bf16 at slightly
  different points (bias adds, softmax) -> 6e-2 on LayerNorm-scaled
  features (|x| up to ~3), 3e-2 on unit-norm embeddings.

Each layout trap of the loader has its own test below.
"""

import functools

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ntxent_tpu.models import SimCLRModel as JaxSimCLR
from ntxent_tpu.models.long_context import (
    SeqParallelSelfAttention as JaxSelfAttention,
)
from ntxent_tpu.models.projection import ProjectionHead as JaxHead
from ntxent_tpu.models.vit import MlpBlock as JaxMlp
from ntxent_tpu.models.vit import VisionTransformer as JaxViT
from ntxent_tpu.parallel.ring_attention import attention_oracle
from ntxent_tpu_torch.models import (
    MlpBlock,
    ProjectionHead,
    SeqParallelSelfAttention,
    SimCLRModel,
    VisionTransformer,
    init_weights,
)
from ntxent_tpu_torch.ops.attention import attention_plain
from ntxent_tpu_torch.weights import load_flax_variables

SMALL = dict(patch_size=4, hidden_dim=32, depth=2, num_heads=4, mlp_dim=64)
IMAGE = 16
PROJ_HIDDEN, PROJ_OUT = 64, 16
TOL = {"float32": dict(features=2e-5, embedding=2e-5),
       "bfloat16": dict(features=6e-2, embedding=3e-2)}


def _np(tree):
    return jax.tree_util.tree_map(lambda a: np.array(a), jax.device_get(tree))


def _jax_simclr(impl, dtype):
    jdt = getattr(jnp, dtype)
    enc = functools.partial(JaxViT, attention_impl=impl, dtype=jdt, **SMALL)
    model = JaxSimCLR(encoder=enc, proj_hidden_dim=PROJ_HIDDEN,
                      proj_dim=PROJ_OUT, dtype=jdt)
    variables = _np(model.init(jax.random.PRNGKey(0),
                               jnp.zeros((1, IMAGE, IMAGE, 3)), train=False))
    rng = np.random.default_rng(1)
    bn = variables["batch_stats"]["projector"]["bn1"]
    bn["mean"] = rng.normal(size=PROJ_HIDDEN).astype(np.float32) * 0.1
    bn["var"] = rng.uniform(0.5, 2.0, PROJ_HIDDEN).astype(np.float32)
    # Non-trivial cls token (flax inits it to zeros).
    variables["params"]["backbone"]["cls_token"] = rng.normal(
        size=(1, 1, SMALL["hidden_dim"])).astype(np.float32)
    return model, variables


def _port_simclr(impl, dtype):
    tdt = getattr(torch, dtype)
    enc = VisionTransformer(image_size=IMAGE, attention_impl=impl, dtype=tdt,
                            **SMALL)
    return SimCLRModel(enc, PROJ_HIDDEN, PROJ_OUT, dtype=tdt)


@pytest.fixture(scope="module")
def images():
    return np.random.default_rng(0).normal(
        size=(3, IMAGE, IMAGE, 3)).astype(np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("impl", ["flash", "xla"])
def test_simclr_slice_matches_jax(impl, dtype, images):
    jmodel, variables = _jax_simclr(impl, dtype)
    model = load_flax_variables(_port_simclr(impl, dtype), variables).eval()
    want_f = np.asarray(jmodel.apply(variables, images, train=False,
                                     method="features"))
    want_e = np.asarray(jmodel.apply(variables, images, train=False))
    x = torch.from_numpy(images)
    with torch.inference_mode():
        got_f, got_e = model.features(x), model(x)
    assert got_f.dtype == torch.float32 and got_e.dtype == torch.float32
    assert got_e.shape == (3, PROJ_OUT)
    np.testing.assert_allclose(got_f.numpy(), want_f, rtol=0,
                               atol=TOL[dtype]["features"])
    np.testing.assert_allclose(got_e.numpy(), want_e, rtol=0,
                               atol=TOL[dtype]["embedding"])
    np.testing.assert_allclose(np.linalg.norm(got_e.numpy(), axis=1), 1.0,
                               atol=1e-5)


def test_flash_and_xla_share_weights(images):
    """One set of weights serves both attention impls, as in JAX."""
    _, variables = _jax_simclr("flash", "float32")
    flash = load_flax_variables(_port_simclr("flash", "float32"), variables)
    xla = load_flax_variables(_port_simclr("xla", "float32"), variables)
    x = torch.from_numpy(images)
    with torch.inference_mode():
        torch.testing.assert_close(flash(x), xla(x), rtol=0, atol=2e-5)


def test_dense_kernels_are_transposed():
    jmlp = JaxMlp(mlp_dim=64, dtype=jnp.float32)
    x = np.random.default_rng(2).normal(size=(5, 32)).astype(np.float32)
    variables = _np(jmlp.init(jax.random.PRNGKey(1), x))
    mlp = load_flax_variables(MlpBlock(32, 64, torch.float32), variables)
    kernel = variables["params"]["Dense_0"]["kernel"]  # (in, out) = (32, 64)
    assert tuple(mlp.fc1.weight.shape) == (64, 32)
    np.testing.assert_array_equal(mlp.fc1.weight.detach().numpy(), kernel.T)
    with torch.no_grad():
        got = mlp(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(jmlp.apply(variables, x)),
                               rtol=0, atol=1e-5)


def test_gelu_is_the_tanh_approximation():
    jmlp = JaxMlp(mlp_dim=64, dtype=jnp.float32)
    x = 3.0 * np.random.default_rng(3).normal(size=(64, 32)).astype(
        np.float32)
    variables = _np(jmlp.init(jax.random.PRNGKey(2), x))
    mlp = load_flax_variables(MlpBlock(32, 64, torch.float32), variables)
    want = np.asarray(jmlp.apply(variables, x))
    with torch.no_grad():
        got = mlp(torch.from_numpy(x)).numpy()
        h = torch.nn.functional.gelu(mlp.fc1(torch.from_numpy(x)))  # erf
        erf = mlp.fc2(h).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    assert np.abs(erf - want).max() > 1e-4  # the exact GELU would not pass


def test_patch_embed_is_hwio_over_nhwc():
    rng = np.random.default_rng(4)
    x = rng.normal(size=(2, IMAGE, IMAGE, 3)).astype(np.float32)
    conv = fnn.Conv(32, (4, 4), strides=(4, 4), padding="VALID")
    conv_vars = _np(conv.init(jax.random.PRNGKey(3), x))
    want = np.asarray(conv.apply(conv_vars, x)).reshape(2, -1, 32)
    vit = VisionTransformer(image_size=IMAGE, patch_size=4, hidden_dim=32,
                            depth=0, num_heads=4, mlp_dim=64,
                            dtype=torch.float32)
    load_flax_variables(vit, {"params": {
        "patch_embed": conv_vars["params"],
        "cls_token": np.zeros((1, 1, 32), np.float32),
        "pos_embed": np.zeros((1, 17, 32), np.float32),
        "final_ln": {"scale": np.ones(32, np.float32),
                     "bias": np.zeros(32, np.float32)}}})
    with torch.no_grad():
        got = vit.patch_embed(vit.patchify(torch.from_numpy(x))).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_dense_general_qkv_and_out_layouts():
    rng = np.random.default_rng(5)
    x = rng.normal(size=(2, 9, 32)).astype(np.float32)
    jattn = JaxSelfAttention(num_heads=4, dtype=jnp.float32,
                             attention_fn=attention_oracle)
    variables = _np(jattn.init(jax.random.PRNGKey(4), x))
    p = variables["params"]
    assert p["query"]["kernel"].shape == (32, 4, 8)
    assert p["query"]["bias"].shape == (4, 8)
    assert p["out"]["kernel"].shape == (4, 8, 32)
    for name in ("query", "key", "value", "out"):  # non-zero biases
        p[name]["bias"] = rng.normal(size=p[name]["bias"].shape).astype(
            np.float32)
    attn = load_flax_variables(
        SeqParallelSelfAttention(32, 4, dtype=torch.float32,
                                 attention_fn=_plain_bl), variables)
    with torch.no_grad():
        got = attn(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(jattn.apply(variables, x)),
                               rtol=0, atol=1e-5)


def _plain_bl(q, k, v):
    """attention_plain in the (B, L, H, D) layout."""
    b, l, h, d = q.shape

    def flat(t):
        return t.permute(0, 2, 1, 3).reshape(b * h, -1, d)

    o, _ = attention_plain(flat(q), flat(k), flat(v))
    return o.reshape(b, h, l, d).permute(0, 2, 1, 3)


def test_layer_norm_epsilon_is_flax_1e6():
    """A tower whose token variance is comparable to 1e-6: torch's default
    eps of 1e-5 would visibly shrink the normalized output."""
    rng = np.random.default_rng(6)
    jvit = JaxViT(dtype=jnp.float32, patch_size=4, hidden_dim=32, depth=0,
                  num_heads=4, mlp_dim=64)
    x = np.zeros((2, IMAGE, IMAGE, 3), np.float32)
    variables = _np(jvit.init(jax.random.PRNGKey(5), x, train=False))
    variables["params"]["cls_token"] = 1e-3 * rng.normal(
        size=(1, 1, 32)).astype(np.float32)
    variables["params"]["pos_embed"] *= 0.0
    vit = load_flax_variables(
        VisionTransformer(image_size=IMAGE, dtype=torch.float32, depth=0,
                          patch_size=4, hidden_dim=32, num_heads=4,
                          mlp_dim=64), variables)
    assert vit.final_ln.eps == 1e-6
    want = np.asarray(jvit.apply(variables, x, train=False))
    with torch.no_grad():
        got = vit(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    assert np.abs(got).max() > 0.5  # normalized, not shrunk towards zero


def test_batch_norm_uses_running_stats_and_eps():
    rng = np.random.default_rng(7)
    jhead = JaxHead(hidden_dim=PROJ_HIDDEN, out_dim=PROJ_OUT,
                    dtype=jnp.float32)
    x = rng.normal(size=(4, 32)).astype(np.float32)
    variables = _np(jhead.init(jax.random.PRNGKey(6), x, train=False))
    stats = variables["batch_stats"]["bn1"]
    stats["mean"] = rng.normal(size=PROJ_HIDDEN).astype(np.float32)
    # Variances near eps make a wrong epsilon visible.
    stats["var"] = rng.uniform(1e-5, 1e-4, PROJ_HIDDEN).astype(np.float32)
    variables["params"]["bn1"]["scale"] = rng.uniform(
        0.5, 1.5, PROJ_HIDDEN).astype(np.float32)
    head = load_flax_variables(ProjectionHead(32, PROJ_HIDDEN, PROJ_OUT,
                                              dtype=torch.float32),
                               variables).eval()
    assert head.bn1.eps == 1e-5
    want = np.asarray(jhead.apply(variables, x, train=False))
    with torch.no_grad():
        got = head(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_fc2_has_no_bias():
    _, variables = _jax_simclr("flash", "float32")
    model = load_flax_variables(_port_simclr("flash", "float32"), variables)
    assert model.projector.fc2.bias is None
    variables["params"]["projector"]["fc2"]["bias"] = np.zeros(
        PROJ_OUT, np.float32)
    with pytest.raises(KeyError, match="fc2/bias"):
        load_flax_variables(_port_simclr("flash", "float32"), variables)


def test_cls_and_pos_keep_their_shapes():
    _, variables = _jax_simclr("flash", "float32")
    model = load_flax_variables(_port_simclr("flash", "float32"), variables)
    vit = model.backbone
    assert tuple(vit.cls_token.shape) == (1, 1, 32)
    assert tuple(vit.pos_embed.shape) == (1, (IMAGE // 4) ** 2 + 1, 32)
    np.testing.assert_array_equal(
        vit.pos_embed.detach().numpy(),
        variables["params"]["backbone"]["pos_embed"])
    variables["params"]["backbone"]["pos_embed"] = np.zeros(
        (1, 10, 32), np.float32)
    with pytest.raises(ValueError, match="pos_embed"):
        load_flax_variables(_port_simclr("flash", "float32"), variables)


def test_loader_rejects_missing_leaves():
    _, variables = _jax_simclr("xla", "float32")
    del variables["batch_stats"]["projector"]["bn1"]["var"]
    with pytest.raises(KeyError, match="var"):
        load_flax_variables(_port_simclr("xla", "float32"), variables)


def test_moe_is_not_ported_yet():
    """Ported since Queue A 9 (the refusal went with it): the tower mounts
    a switch-MoE MLP in every other block and takes the JAX MoE tower's
    weights, forward equal to JAX's (fp32, 1e-5)."""
    x = np.random.default_rng(0).uniform(size=(2, IMAGE, IMAGE, 3)).astype(
        np.float32)
    jax_tower = JaxViT(dtype=jnp.float32, moe_experts=4, **SMALL)
    variables = jax.device_get(jax_tower.init(jax.random.PRNGKey(0), x,
                                              train=False))
    tower = load_flax_variables(VisionTransformer(
        image_size=IMAGE, moe_experts=4, dtype=torch.float32, **SMALL),
        variables)
    assert [type(b.mlp).__name__ for b in tower.blocks] == ["MlpBlock",
                                                            "MoEMlp"]
    want = jax_tower.apply(variables, x, train=True,
                           mutable=["intermediates"])[0]
    np.testing.assert_allclose(tower(torch.tensor(x)).detach().numpy(),
                               np.asarray(want), rtol=1e-5, atol=1e-5)


def test_unknown_attention_impl_raises():
    with pytest.raises(ValueError, match="attention_impl"):
        VisionTransformer(image_size=IMAGE, attention_impl="ring", **SMALL)


def test_seeded_init_is_deterministic_and_flax_shaped():
    def build(seed):
        return init_weights(_port_simclr("flash", "float32"),
                            torch.Generator().manual_seed(seed))

    a, b, c = build(0), build(0), build(1)
    for (name, pa), pb, pc in zip(a.state_dict().items(),
                                  b.state_dict().values(),
                                  c.state_dict().values()):
        torch.testing.assert_close(pa, pb, rtol=0, atol=0)
    fc1 = a.backbone.blocks[0].mlp.fc1.weight
    assert not torch.equal(fc1, c.backbone.blocks[0].mlp.fc1.weight)
    # LeCun normal: variance 1/fan_in, truncated at two standard deviations.
    std = (1.0 / 32) ** 0.5
    assert abs(fc1.std().item() - std) < 0.2 * std
    assert fc1.abs().max().item() <= 2 * std / 0.87962566103423978 + 1e-6
    assert torch.all(a.backbone.cls_token == 0)
