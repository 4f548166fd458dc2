"""The port's training slice against the JAX package: BatchNorm in train
mode, LARS and its mask, the augmentation transforms, the seeded loader,
and whole train steps of a tiny ViT.

The same numpy inputs (and, for the train steps, the same flax weights
carried across by ``load_flax_variables``) go through both packages on
the CPU. The random streams of ``jax.random`` and ``torch.Generator``
cannot match, so each augmentation transform is held to its JAX function
at the JAX function's own draws: the test recomputes them from the key
exactly as the JAX function splits it and hands them to the port.

Tolerances (absolute unless stated):

* BatchNorm, fp32: the same two-pass statistics -> 1e-5 on outputs and
  running statistics.
* LARS: fp32 steps on the same gradients; the schedule is evaluated in
  float64 here and float32 in optax -> 1e-6 relative on lr, 1e-6 on
  parameters.
* augmentation: fp32 resampling and colour algebra in another summation
  order -> 1e-5 (2e-5 through the whole jitter).
* train steps (fp32 modules): the same arithmetic summed in another
  order, through two blocks, a projection head and three LARS steps ->
  1e-4 on the loss, 5e-4 relative on each parameter's change (plus 1e-5
  absolute for changes that are rounding noise on both sides).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ntxent_tpu.models import SimCLRModel as JaxSimCLR
from ntxent_tpu.models.projection import ProjectionHead as JaxHead
from ntxent_tpu.models.vit import VisionTransformer as JaxViT
from ntxent_tpu.training import augment as jaug
from ntxent_tpu.training.datasets import ArraySource as JaxArraySource
from ntxent_tpu.training.datasets import StreamingLoader as JaxLoader
from ntxent_tpu.training.lars import (
    cosine_warmup_schedule as jax_schedule,
)
from ntxent_tpu.training.lars import create_lars, exclusion_mask
from ntxent_tpu.training.trainer import TrainerConfig as JaxConfig
from ntxent_tpu.training.trainer import create_train_state as jax_state
from ntxent_tpu.training.trainer import make_train_step as jax_step
from ntxent_tpu_torch import cli
from ntxent_tpu_torch.models import ProjectionHead, SimCLRModel
from ntxent_tpu_torch.models import VisionTransformer, init_weights
from ntxent_tpu_torch.models.resnet import SpaceToDepthStem
from ntxent_tpu_torch.training import augment as taug
from ntxent_tpu_torch.training import datasets as tdata
from ntxent_tpu_torch.training import lars as tlars
from ntxent_tpu_torch.training import trainer as ttrain
from ntxent_tpu_torch.weights import flax_paths, load_flax_variables

TINY = dict(patch_size=8, hidden_dim=32, depth=2, num_heads=2, mlp_dim=64)
IMAGE, BATCH, PROJ_HIDDEN, PROJ_OUT = 16, 8, 32, 16

# The suite runs in several worker processes side by side, and each one
# imports this module. With torch's default CPU pool (a thread per core)
# in every worker, the torch tests here oversubscribe the cores until the
# JAX tests' 8-device CPU collectives in the other workers miss their 40 s
# rendezvous and abort. One thread is plenty at these sizes (and faster
# than a pool on them).
torch.set_num_threads(1)


def _np(tree):
    return jax.tree_util.tree_map(np.array, jax.device_get(tree))


def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out |= _flat(v, prefix + (k,))
        return out
    return {prefix: np.asarray(tree)}


# ---------------------------------------------------------------------------
# BatchNorm in train mode
# ---------------------------------------------------------------------------


def test_projection_head_train_mode_matches_flax():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(12, 24)).astype(np.float32) * 3 + 1
    jhead = JaxHead(hidden_dim=20, out_dim=8, dtype=jnp.float32)
    variables = _np(jhead.init(jax.random.PRNGKey(0), x, train=False))
    variables["params"]["bn1"]["scale"] = rng.uniform(
        0.5, 2, 20).astype(np.float32)
    variables["params"]["bn1"]["bias"] = rng.normal(size=20).astype(
        np.float32)
    variables["batch_stats"]["bn1"]["mean"] = rng.normal(size=20).astype(
        np.float32)
    variables["batch_stats"]["bn1"]["var"] = rng.uniform(
        0.5, 2, 20).astype(np.float32)
    want, updates = jhead.apply(variables, x, train=True,
                                mutable=["batch_stats"])
    head = load_flax_variables(ProjectionHead(24, 20, 8, torch.float32),
                               variables).train()
    got = head(torch.from_numpy(x))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=1e-5, rtol=0)
    stats = updates["batch_stats"]["bn1"]
    np.testing.assert_allclose(head.bn1.running_mean.numpy(),
                               np.asarray(stats["mean"]), atol=1e-6, rtol=0)
    # flax keeps the biased batch variance (torch's own update would not)
    np.testing.assert_allclose(head.bn1.running_var.numpy(),
                               np.asarray(stats["var"]), atol=1e-5, rtol=0)
    # eval mode normalizes with the running statistics and updates nothing
    before = head.bn1.running_mean.clone()
    with torch.no_grad():
        head.eval()(torch.from_numpy(x))
    torch.testing.assert_close(head.bn1.running_mean, before, rtol=0, atol=0)


# ---------------------------------------------------------------------------
# LARS
# ---------------------------------------------------------------------------


def _tiny_jax_simclr(impl="flash"):
    enc = functools.partial(JaxViT, attention_impl=impl, dtype=jnp.float32,
                            **TINY)
    model = JaxSimCLR(encoder=enc, proj_hidden_dim=PROJ_HIDDEN,
                      proj_dim=PROJ_OUT, dtype=jnp.float32)
    variables = _np(model.init(jax.random.PRNGKey(0),
                               jnp.zeros((1, IMAGE, IMAGE, 3)), train=False))
    # non-trivial cls token (flax inits it to zeros)
    variables["params"]["backbone"]["cls_token"] = np.random.default_rng(
        1).normal(size=(1, 1, TINY["hidden_dim"])).astype(np.float32)
    return model, variables


def _tiny_port_simclr(impl="flash"):
    enc = VisionTransformer(image_size=IMAGE, attention_impl=impl,
                            dtype=torch.float32, **TINY)
    return SimCLRModel(enc, PROJ_HIDDEN, PROJ_OUT, dtype=torch.float32)


def test_lars_mask_matches_exclusion_mask():
    _, variables = _tiny_jax_simclr()
    want = _flat(_np(exclusion_mask(variables["params"])))
    model = _tiny_port_simclr()
    paths = flax_paths(model)
    assert sorted(paths.values()) == sorted(want)  # one leaf per parameter
    mask = tlars.exclusion_mask(model)
    for name, path in paths.items():
        assert mask[name] == bool(want[path]), name
    # LayerNorm scale, cls_token and pos_embed stay in; BN and biases out
    assert mask["backbone.blocks.0.ln1.weight"]
    assert mask["backbone.cls_token"] and mask["backbone.pos_embed"]
    assert not mask["projector.bn1.weight"]
    assert not mask["backbone.blocks.1.attn.query.bias"]


@pytest.mark.parametrize("warmup,total", [(0, 10), (3, 10), (5, 4)])
def test_schedule_matches_optax(warmup, total):
    want = jax_schedule(0.6, warmup, total)
    got = tlars.cosine_warmup_schedule(0.6, warmup, total)
    assert got(0) == 0.0
    for count in range(12):
        np.testing.assert_allclose(got(count), float(want(count)),
                                   rtol=1e-6, atol=1e-9)


def test_lars_steps_match_optax():
    rng = np.random.default_rng(2)
    params = {"dense": {"kernel": rng.normal(size=(6, 4)).astype(np.float32),
                        "bias": rng.normal(size=4).astype(np.float32)},
              "bn1": {"scale": np.ones(4, np.float32)},
              "zero": {"kernel": np.zeros((3,), np.float32)}}
    grads = [_flat({"dense": {"kernel": rng.normal(size=(6, 4)),
                              "bias": rng.normal(size=4)},
                    "bn1": {"scale": rng.normal(size=4)},
                    "zero": {"kernel": rng.normal(size=3)}})
             for _ in range(4)]
    schedule = jax_schedule(0.8, 2, 6)
    tx = create_lars(schedule, weight_decay=1e-2, params=params)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    opt_state = tx.init(jp)
    tparams = {"/".join(k): torch.from_numpy(v.copy()).requires_grad_()
               for k, v in _flat(params).items()}
    mask = {"/".join(k): bool(v) for k, v in
            _flat(_np(exclusion_mask(params))).items()}
    opt = tlars.LARS(tparams.items(), tlars.cosine_warmup_schedule(0.8, 2, 6),
                     weight_decay=1e-2, mask=mask)
    for g in grads:
        gtree = jax.tree_util.tree_map(
            lambda x: jnp.asarray(x, jnp.float32),
            {"dense": {"kernel": g[("dense", "kernel")],
                       "bias": g[("dense", "bias")]},
             "bn1": {"scale": g[("bn1", "scale")]},
             "zero": {"kernel": g[("zero", "kernel")]}})
        updates, opt_state = tx.update(gtree, opt_state, jp)
        jp = jax.tree_util.tree_map(lambda p, u: p + u, jp, updates)
        for k, v in g.items():
            tparams["/".join(k)].grad = torch.from_numpy(
                v.astype(np.float32))
        opt.step()
    assert opt.count == 4
    for k, v in _flat(_np(jp)).items():
        np.testing.assert_allclose(tparams["/".join(k)].detach().numpy(), v,
                                   atol=1e-6, rtol=1e-6, err_msg=str(k))


def test_lars_first_step_has_zero_learning_rate():
    p = torch.ones(3, requires_grad=True)
    opt = tlars.LARS([("w", p)], tlars.cosine_warmup_schedule(1.0, 2, 10))
    p.grad = torch.ones(3)
    assert opt.step() == 0.0
    torch.testing.assert_close(p.detach(), torch.ones(3), rtol=0, atol=0)


# ---------------------------------------------------------------------------
# Augmentation transforms at the JAX function's own draws
# ---------------------------------------------------------------------------


def _image(seed=0, size=24):
    return np.random.default_rng(seed).uniform(
        size=(size, size, 3)).astype(np.float32)


def _t(x):
    return torch.from_numpy(np.array(x, np.float32)).reshape(1)


@pytest.mark.parametrize("seed", range(4))
def test_resized_crop_matches_jax(seed):
    image = _image(seed)
    key = jax.random.PRNGKey(seed)
    want = jaug.random_resized_crop(key, jnp.asarray(image))
    k_area, k_ratio, k_x, k_y = jax.random.split(key, 4)
    area = jax.random.uniform(k_area, (), minval=0.08, maxval=1.0)
    log_ratio = jax.random.uniform(k_ratio, (), minval=jnp.log(3 / 4),
                                   maxval=jnp.log(4 / 3))
    u_x = jax.random.uniform(k_x, (), maxval=1.0)
    u_y = jax.random.uniform(k_y, (), maxval=1.0)
    got = taug.resized_crop(torch.from_numpy(image)[None], _t(area),
                            _t(log_ratio), _t(u_x), _t(u_y))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want), atol=1e-5,
                               rtol=0)


@pytest.mark.parametrize("seed", range(3))
def test_color_jitter_matches_jax(seed):
    image = _image(seed)
    key = jax.random.PRNGKey(10 + seed)
    want = jaug.color_jitter(key, jnp.asarray(image))
    kb, kc, ks, kh = jax.random.split(key, 4)
    draws = [jax.random.uniform(k, (), minval=0.2, maxval=1.8)
             for k in (kb, kc, ks)]
    hue = jax.random.uniform(kh, (), minval=-0.2, maxval=0.2)
    got = taug.color_jitter(torch.from_numpy(image)[None],
                            *(_t(d) for d in draws), _t(hue))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want), atol=2e-5,
                               rtol=0)


def test_saturation_hue_and_grayscale_match_jax():
    image = _image(5)
    x = torch.from_numpy(image)[None]
    np.testing.assert_allclose(
        taug.adjust_saturation(x, _t(1.7))[0].numpy(),
        np.asarray(jaug._adjust_saturation(jnp.asarray(image), 1.7)),
        atol=1e-6, rtol=0)
    np.testing.assert_allclose(
        taug.adjust_hue(x, _t(0.9))[0].numpy(),
        np.asarray(jaug._adjust_hue(jnp.asarray(image), jnp.float32(0.9))),
        atol=1e-5, rtol=0)
    always = jaug.random_grayscale(jax.random.PRNGKey(0), jnp.asarray(image),
                                   p=1.0)
    np.testing.assert_allclose(taug.grayscale(x)[0].numpy(),
                               np.asarray(always), atol=1e-6, rtol=0)


@pytest.mark.parametrize("size", [24, 32, 40])
def test_gaussian_blur_matches_jax(size):
    image = _image(6, size)
    key = jax.random.PRNGKey(size)
    want = jaug.gaussian_blur(key, jnp.asarray(image), p=1.0)
    k_sigma, _ = jax.random.split(key)
    sigma = jax.random.uniform(k_sigma, (), minval=0.1, maxval=2.0)
    got = taug.gaussian_blur(torch.from_numpy(image)[None], _t(sigma))
    assert taug.blur_kernel_size(size) == max(3, (size // 10) | 1)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want), atol=1e-5,
                               rtol=0)


def test_augment_batch_pair_is_batched_and_seeded():
    images = torch.from_numpy(np.stack([_image(s) for s in range(6)]))
    v1, v2 = taug.augment_batch_pair(images,
                                     torch.Generator().manual_seed(0))
    w1, _ = taug.augment_batch_pair(images, torch.Generator().manual_seed(0))
    assert v1.shape == v2.shape == images.shape
    assert float(v1.min()) >= 0.0 and float(v1.max()) <= 1.0 + 1e-6
    torch.testing.assert_close(v1, w1, rtol=0, atol=0)
    assert (v1 - v2).abs().max() > 1e-2  # independent views


# ---------------------------------------------------------------------------
# Loader
# ---------------------------------------------------------------------------


def test_streaming_loader_yields_the_jax_batches():
    data = np.random.default_rng(7).integers(
        0, 255, size=(37, 4, 4, 3)).astype(np.uint8)
    want = iter(JaxLoader(JaxArraySource(data), batch_size=8, seed=3,
                          num_threads=2))
    got = iter(tdata.StreamingLoader(tdata.ArraySource(data), 8, seed=3))
    for _ in range(10):  # past the epoch boundary (4 batches an epoch)
        np.testing.assert_array_equal(next(got), next(want))


def test_two_view_pipeline_is_seeded_and_scales_uint8():
    data = np.random.default_rng(8).uniform(size=(16, 8, 8, 3)).astype(
        np.float32)

    def views(seed):
        return next(tdata.TwoViewPipeline(tdata.StreamingLoader(
            tdata.ArraySource(data), 4, seed=0), "cpu", seed=seed))

    a, b, c = views(1), views(1), views(2)
    torch.testing.assert_close(a[0], b[0], rtol=0, atol=0)
    torch.testing.assert_close(a[1], b[1], rtol=0, atol=0)
    assert (a[0] - c[0]).abs().max() > 1e-3
    u8 = tdata.TwoViewPipeline(tdata.StreamingLoader(tdata.ArraySource(
        (data * 255).astype(np.uint8)), 4), "cpu")
    v1, _ = next(u8)
    assert v1.dtype == torch.float32 and float(v1.max()) <= 1.0 + 1e-6


# ---------------------------------------------------------------------------
# Train steps: tiny ViT against JAX make_train_step
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("impl,use_fused", [("flash", None),
                                            ("flash", True), ("xla", None)])
def test_tiny_vit_train_steps_match_jax(impl, use_fused):
    """Three steps from the same flax weights on the same views; step 0
    runs at lr 0 (warmup), so the change comes from steps 1 and 2. The
    port's flash attention runs its plain forward and backward here; with
    ``use_fused=True`` the loss also runs the NT-Xent kernels' plain
    versions (the JAX step uses the oracle on the CPU). The ``xla`` impl
    trains through plain autograd of ``dot_product_attention``."""
    jmodel, variables = _tiny_jax_simclr(impl)
    cfg = JaxConfig(batch_size=BATCH, temperature=0.2, base_lr=30.0,
                    weight_decay=1e-4, warmup_steps=1, total_steps=10)
    jstate = jax_state(jmodel, jax.random.PRNGKey(0), (1, IMAGE, IMAGE, 3),
                       cfg)
    jstate = jstate.replace(params=jax.tree_util.tree_map(
        jnp.asarray, variables["params"]))
    jtrain = jax_step(cfg.temperature)

    model = load_flax_variables(_tiny_port_simclr(impl), variables)
    tcfg = ttrain.TrainerConfig(batch_size=BATCH, temperature=0.2,
                                base_lr=30.0, weight_decay=1e-4,
                                warmup_steps=1, total_steps=10)
    state = ttrain.create_train_state(model, tcfg, torch.device("cpu"))
    step = ttrain.make_train_step(tcfg.temperature, use_fused=use_fused)
    before = {k: v.detach().clone() for k, v in model.named_parameters()}

    rng = np.random.default_rng(9)
    for _ in range(3):
        v1, v2 = (rng.uniform(size=(BATCH, IMAGE, IMAGE, 3)).astype(
            np.float32) for _ in range(2))
        jstate, jmetrics = jtrain(jstate, jnp.asarray(v1), jnp.asarray(v2))
        state, metrics = step(state, torch.from_numpy(v1),
                              torch.from_numpy(v2))
        np.testing.assert_allclose(float(metrics["loss"]),
                                   float(jmetrics["loss"]), atol=1e-4, rtol=0)
    assert state.step == 3

    want = load_flax_variables(_tiny_port_simclr(), {
        "params": _np(jstate.params),
        "batch_stats": _np(jstate.batch_stats)})
    want_params = dict(want.named_parameters())
    for name, p in model.named_parameters():
        delta = (p - before[name]).detach()
        want_delta = (want_params[name] - before[name]).detach()
        # the floor covers parameters whose gradient is zero in exact
        # arithmetic (key biases, biases before BatchNorm): their change is
        # rounding noise, ~1e-6, on both sides
        err = float((delta - want_delta).norm())
        assert err <= 5e-4 * float(want_delta.norm()) + 1e-5, (name, err)
    torch.testing.assert_close(model.projector.bn1.running_var,
                               want.projector.bn1.running_var, atol=1e-5,
                               rtol=0)


def test_flash_vit_carries_gradient_to_every_projection():
    model = init_weights(_tiny_port_simclr("flash"),
                         torch.Generator().manual_seed(0)).train()
    x = torch.from_numpy(np.random.default_rng(10).uniform(
        size=(4, IMAGE, IMAGE, 3)).astype(np.float32))
    model(x).square().sum().backward()
    for block in model.backbone.blocks:
        assert block.ln1.weight.grad.abs().sum() > 0
        for proj in (block.attn.query, block.attn.key, block.attn.value):
            assert proj.weight.grad.abs().sum() > 0


@pytest.mark.parametrize("kwargs", [
    dict(moe_aux_weight=0.01), dict(moe_aux_weight=0.01, remat=True),
    dict(moe_aux_weight=0.01, guard=True)])
def test_unported_step_options_raise(kwargs):
    """The MoE loss is not ported, with or without the resilience options
    (remat and the guard are ported: tests/test_torch_remat.py,
    tests/test_torch_resilience.py)."""
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        ttrain.make_train_step(**kwargs)


# ---------------------------------------------------------------------------
# ntxent-train
# ---------------------------------------------------------------------------

CPU_ARGV = ["--device", "cpu", "--model", "vit_t16", "--vit-attention",
            "flash", "--image-size", "16", "--batch", "4", "--steps", "3",
            "--log-every", "1", "--proj-hidden-dim", "32", "--proj-dim", "8",
            "--synthetic-samples", "12", "--base-lr", "3.0",
            "--warmup-steps", "1"]


def test_train_cli_runs_on_the_cpu():
    args = cli.build_train_parser().parse_args(CPU_ARGV)
    before = {k: v.clone() for k, v in
              cli.build_model(args).state_dict().items()}
    state, history = cli.train(args)
    assert [h["step"] for h in history] == [1, 2, 3]
    assert all(np.isfinite(h["loss"]) and h["images_per_sec"] > 0
               for h in history)
    after = state.model.state_dict()
    assert any((after[k] - before[k]).abs().max() > 0 for k in before)
    assert cli.train_main(CPU_ARGV) == 0


def test_train_cli_defaults_match_the_jax_cli():
    args = cli.build_train_parser().parse_args([])
    assert (args.batch, args.steps, args.temperature, args.base_lr,
            args.weight_decay, args.warmup_steps, args.log_every,
            args.synthetic_samples, args.proj_hidden_dim, args.proj_dim,
            args.dataset, args.device) == (
        256, 1000, 0.1, 0.3, 1e-6, 100, 50, 512, 2048, 128, "synthetic",
        "cuda")


# Flags of ROADMAP.md items ported since (Queue A 3(d) and 3(e), the
# data-parallel wire): a run on one card trains and ignores them, warning
# as the JAX CLI does (none for --ring-chunks with the strip loss there).
# Queue A 6(b), the space-to-depth stem (the "--model" case): ResNet-50
# trains with it at 72 px, the ImageNet stem's smallest size here
# (--image-size <= 64 takes the CIFAR stem), under plain attention flags.
PORTED_SINCE = {"--ring-chunks": None,
                "--dp-loss": "--dp-loss chunked ignored",
                "--collective-dtype": "--collective-dtype int8 ignored",
                "--model": None}


@pytest.mark.parametrize("flags", [
    ["--model", "resnet50", "--stem", "space_to_depth", "--image-size",
     "72", "--vit-attention", "xla"],
    ["--ring-chunks", "4"],
    ["--parallel", "tp"], ["--fsdp"],
    ["--moe-experts", "4"],
    ["--dp-loss", "chunked"],
    ["--collective-dtype", "int8"]], ids=lambda f: f[0])
def test_train_cli_names_the_roadmap_item_for_unported_flags(flags, caplog,
                                                             monkeypatch):
    """A flag of an unported item exits naming it; one ported since
    (``PORTED_SINCE``) trains on one card with the JAX CLI's warning."""
    args = cli.build_train_parser().parse_args(CPU_ARGV + flags)
    if flags[0] not in PORTED_SINCE:
        with pytest.raises(SystemExit, match="ROADMAP.md Queue A"):
            cli.train(args)
        return
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    with caplog.at_level("WARNING"):
        state, history = cli.train(args)
    assert all(np.isfinite(h["loss"]) for h in history) and history
    if PORTED_SINCE[flags[0]] is not None:
        assert PORTED_SINCE[flags[0]] in caplog.text
    if "--stem" in flags:
        assert isinstance(state.model.backbone.stem_conv, SpaceToDepthStem)


def test_train_cli_raises_without_a_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = [a for a in CPU_ARGV if a not in ("--device", "cpu")]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.train(cli.build_train_parser().parse_args(argv))
