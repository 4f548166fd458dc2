"""The port's CLIP slice against the JAX package: the causal text tower,
the dual encoder, one train step, AdamW, the paired loader and the CLI.

The same numpy inputs and the same flax weights (carried across by
``load_flax_variables``) go through both packages on the CPU, at the JAX
CLI's ``--model tiny`` shape (width 32, depth 2, 2 heads, patch 8) with
a vocabulary of 100, 16 tokens and 16 px images.

Tolerances (absolute unless stated):

* forward, fp32 modules: the same arithmetic summed in another order ->
  1e-5 on features, embeddings and the scale;
* forward, bf16 modules (the path's dtype): both sides round the same
  activations to bf16 (one ulp is 2**-8 relative) in places that differ
  by summation order, through two blocks and the projection -> 2e-2 on
  the unit-norm embeddings;
* one train step, fp32: 1e-5 on the loss, and on each parameter's
  gradient 1e-5 absolute plus 1e-4 relative;
* AdamW against optax: fp32 updates of the same gradients, the schedule
  evaluated in float64 here and float32 in optax -> 1e-6 relative on the
  learning rate, 1e-6 on parameters;
* the loader: exact.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ntxent_tpu.models import CLIPModel as JaxCLIP
from ntxent_tpu.models import TextTransformer as JaxText
from ntxent_tpu.models.vit import VisionTransformer as JaxViT
from ntxent_tpu.ops.oracle import info_nce_loss as jax_info_nce_loss
from ntxent_tpu.training.datasets import PairedArrayLoader as JaxPaired
from ntxent_tpu.training.lars import (
    cosine_warmup_schedule as jax_schedule,
)
from ntxent_tpu_torch import cli
from ntxent_tpu_torch.models import (
    CLIPModel,
    EncoderBlock,
    TextTransformer,
    VisionTransformer,
    init_weights,
)
from ntxent_tpu_torch.ops import infonce
from ntxent_tpu_torch.training import adamw as tadamw
from ntxent_tpu_torch.training import datasets as tdata
from ntxent_tpu_torch.training import lars as tlars
from ntxent_tpu_torch.training import trainer as ttrain
from ntxent_tpu_torch.weights import flax_paths, load_flax_variables

# See tests/test_torch_training.py: one torch thread per test worker.
torch.set_num_threads(1)

VOCAB, TOKENS, IMAGE, BATCH, WIDTH = 100, 16, 16, 8, 32
JAX_DTYPES = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
CPU_ARGV = ["--objective", "clip", "--model", "tiny", "--device", "cpu",
            "--image-size", str(IMAGE), "--token-len", str(TOKENS),
            "--vocab-size", str(VOCAB), "--batch", str(BATCH), "--steps",
            "2", "--synthetic-samples", "24", "--warmup-steps", "1",
            "--base-lr", "1e-3", "--log-every", "1"]


def _np(tree):
    return jax.tree_util.tree_map(np.array, jax.device_get(tree))


def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out |= _flat(v, prefix + (k,))
        return out
    return {prefix: np.asarray(tree)}


def _jax_text(dtype):
    return functools.partial(JaxText, vocab_size=VOCAB, max_len=TOKENS,
                             hidden_dim=WIDTH, depth=2, num_heads=2,
                             dtype=dtype)


def _jax_clip(dtype="float32"):
    jdt = JAX_DTYPES[dtype]
    image = functools.partial(JaxViT, hidden_dim=WIDTH, depth=2,
                              num_heads=2, mlp_dim=64, patch_size=8,
                              dtype=jdt)
    return JaxCLIP(image_encoder=image, text_encoder=_jax_text(jdt),
                   embed_dim=WIDTH)


def _port_clip(dtype="float32"):
    tdt = getattr(torch, dtype)
    image = VisionTransformer(image_size=IMAGE, patch_size=8,
                              hidden_dim=WIDTH, depth=2, num_heads=2,
                              mlp_dim=64, dtype=tdt)
    text = TextTransformer(vocab_size=VOCAB, max_len=TOKENS,
                           hidden_dim=WIDTH, depth=2, num_heads=2, dtype=tdt)
    return CLIPModel(image, text, embed_dim=WIDTH)


def _inputs(seed=0, padded=True):
    """Images in [0, 1) and token ids in [1, VOCAB); with ``padded`` the
    rows end in runs of pad zeros of different lengths (none for row 0,
    all but one token for the last)."""
    rng = np.random.default_rng(seed)
    images = rng.uniform(size=(BATCH, IMAGE, IMAGE, 3)).astype(np.float32)
    tokens = rng.integers(1, VOCAB, (BATCH, TOKENS)).astype(np.int32)
    if padded:
        for i, length in enumerate(np.linspace(TOKENS, 1, BATCH).astype(int)):
            tokens[i, length:] = 0
    return images, tokens


def _variables(model, seed=0):
    images, tokens = _inputs()
    return _np(model.init(jax.random.PRNGKey(seed), images[:1], tokens[:1],
                          train=False))


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("padded", [True, False], ids=["padded", "full"])
def test_text_tower_matches_flax(padded):
    _, tokens = _inputs(seed=1, padded=padded)
    jtext = _jax_text(jnp.float32)()
    variables = _np(jtext.init(jax.random.PRNGKey(2), tokens))
    want = np.asarray(jtext.apply(variables, tokens))
    text = load_flax_variables(
        TextTransformer(vocab_size=VOCAB, max_len=TOKENS, hidden_dim=WIDTH,
                        depth=2, num_heads=2, dtype=torch.float32), variables)
    got = text(torch.from_numpy(tokens).long())
    np.testing.assert_allclose(got.detach().numpy(), want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("dtype,atol", [("float32", 1e-5),
                                        ("bfloat16", 2e-2)])
@pytest.mark.parametrize("padded", [True, False], ids=["padded", "full"])
def test_clip_model_matches_flax(dtype, atol, padded):
    images, tokens = _inputs(seed=3, padded=padded)
    jmodel = _jax_clip(dtype)
    variables = _variables(jmodel, seed=4)
    zi, zt, scale = (np.asarray(x, np.float32)
                     for x in jmodel.apply(variables, images, tokens))
    model = load_flax_variables(_port_clip(dtype), variables)
    gi, gt, gs = model(torch.from_numpy(images),
                       torch.from_numpy(tokens).long())
    assert gi.dtype == gt.dtype == gs.dtype == torch.float32
    np.testing.assert_allclose(gi.detach().numpy(), zi, atol=atol, rtol=0)
    np.testing.assert_allclose(gt.detach().numpy(), zt, atol=atol, rtol=0)
    np.testing.assert_allclose(gs.item(), scale, atol=1e-5, rtol=0)
    np.testing.assert_allclose(
        model.encode_text(torch.from_numpy(tokens).long()).detach().numpy(),
        np.asarray(jmodel.apply(variables, tokens,
                                method=jmodel.encode_text), np.float32),
        atol=atol, rtol=0)


def test_flax_paths_cover_every_clip_leaf_and_init_matches():
    variables = _variables(_jax_clip())
    model = _port_clip()
    paths = flax_paths(model)
    assert set(paths.values()) == set(_flat(variables["params"]))
    assert len(set(paths.values())) == len(paths)
    np.testing.assert_allclose(model.logit_scale.item(),
                               variables["params"]["logit_scale"], rtol=0,
                               atol=0)
    # the built model draws every table from the seed
    init = init_weights(_port_clip(), torch.Generator().manual_seed(0))
    emb = init.text_tower.embedding.detach()
    assert 0.8 < emb.std().item() * np.sqrt(WIDTH) < 1.2
    assert 0.005 < init.text_tower.pos_embed.std().item() < 0.015


def test_masked_block_refuses_flash():
    block = EncoderBlock(WIDTH, 2, 64, torch.float32, attention_impl="flash")
    x = torch.zeros(1, 4, WIDTH)
    mask = torch.ones(4, 4, dtype=torch.bool).tril()[None, None]
    with pytest.raises(ValueError, match="unmasked"):
        block(x, mask=mask)
    assert block(x).shape == x.shape


# ---------------------------------------------------------------------------
# One train step
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("use_fused", [None, True], ids=["oracle", "fused"])
def test_clip_train_step_matches_jax_value_and_grad(use_fused):
    images, tokens = _inputs(seed=5)
    jmodel = _jax_clip()
    variables = _variables(jmodel, seed=6)

    def loss_fn(params):
        zi, zt, scale = jmodel.apply({"params": params}, images, tokens)
        return jax_info_nce_loss(zi, zt, temperature=1.0 / scale)

    want_loss, grads = jax.value_and_grad(loss_fn)(variables["params"])
    want = load_flax_variables(_port_clip(), {"params": _np(grads)})

    model = load_flax_variables(_port_clip(), variables)
    cfg = ttrain.TrainerConfig(batch_size=BATCH, base_lr=1e-3,
                               warmup_steps=1, total_steps=10)
    state = ttrain.create_clip_train_state(model, cfg, torch.device("cpu"))
    step = ttrain.make_clip_train_step(use_fused=use_fused)
    state, metrics = step(state, torch.from_numpy(images),
                          torch.from_numpy(tokens).long())
    assert state.step == 1
    np.testing.assert_allclose(metrics["loss"].item(), float(want_loss),
                               atol=1e-5, rtol=0)
    ref = dict(want.named_parameters())
    assert set(ref) == {n for n, _ in model.named_parameters()}
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), ref[name].detach().numpy(),
                                   atol=1e-5, rtol=1e-4, err_msg=name)
    assert model.logit_scale.grad.abs().item() > 0


def test_clip_step_refuses_what_is_not_ported():
    """Nothing is refused since Queue A 9: ``moe_aux_weight`` builds the
    step with the MoE aux loss (held to JAX in ``test_torch_moe.py``), and
    at weight 0 the metrics carry no ``moe_aux``."""
    step = ttrain.make_clip_train_step(moe_aux_weight=0.01)
    assert callable(step)
    assert not hasattr(ttrain, "_not_ported") and not ttrain.ROADMAP_ITEMS


# ---------------------------------------------------------------------------
# AdamW on the cosine-warmup schedule
# ---------------------------------------------------------------------------


def test_adamw_matches_optax_for_three_steps():
    rng = np.random.default_rng(7)
    params = {"w": rng.normal(size=(5, 3)).astype(np.float32),
              "b": rng.normal(size=(3,)).astype(np.float32)}
    grads = [{k: rng.normal(size=v.shape).astype(np.float32)
              for k, v in params.items()} for _ in range(3)]
    base_lr, warmup, total, wd = 1e-2, 2, 6, 1e-2

    tx = optax.adamw(jax_schedule(base_lr, warmup, total), weight_decay=wd)
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    opt_state = tx.init(jparams)
    want = []
    for g in grads:
        updates, opt_state = tx.update(
            jax.tree_util.tree_map(jnp.asarray, g), opt_state, jparams)
        jparams = optax.apply_updates(jparams, updates)
        want.append(_np(jparams))

    tparams = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
               for k, v in params.items()}
    schedule = tlars.cosine_warmup_schedule(base_lr, warmup, total)
    opt = tadamw.AdamW(tparams.items(), schedule, weight_decay=wd)
    for count, (g, ref) in enumerate(zip(grads, want)):
        opt.zero_grad()
        for k, p in tparams.items():
            p.grad = torch.from_numpy(g[k])
        lr = opt.step()
        np.testing.assert_allclose(
            lr, float(jax_schedule(base_lr, warmup, total)(count)),
            rtol=1e-6, atol=0)
        for k, p in tparams.items():
            np.testing.assert_allclose(p.detach().numpy(), ref[k], atol=1e-6,
                                       rtol=0, err_msg=f"step {count} {k}")
    assert opt.count == 3


def test_adamw_refuses_a_missing_gradient():
    p = torch.nn.Parameter(torch.zeros(2))
    opt = tadamw.AdamW([("p", p)], lambda count: 0.1)
    with pytest.raises(RuntimeError, match="no gradient"):
        opt.step()


# ---------------------------------------------------------------------------
# The paired loader
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 3])
def test_paired_loader_order_matches_jax(seed):
    rng = np.random.default_rng(seed)
    images = rng.integers(0, 255, (20, 4, 4, 3)).astype(np.uint8)
    tokens = rng.integers(0, VOCAB, (20, 5)).astype(np.int32)
    jax_loader = JaxPaired(images, tokens, 6, seed=seed)
    port = iter(tdata.PairedArrayLoader(images, tokens, 6, seed=seed))
    for _ in range(7):  # three batches an epoch: crosses two epochs
        (ji, jt), (ti, tt) = next(jax_loader), next(port)
        np.testing.assert_array_equal(ti, ji)
        np.testing.assert_array_equal(tt, jt)


def test_paired_pipeline_puts_uint8_images_in_unit_range():
    images = np.full((4, 2, 2, 3), 255, np.uint8)
    tokens = np.ones((4, 3), np.int32)
    loader = tdata.PairedArrayLoader(images, tokens, 2, seed=0)
    x, t = next(tdata.PairedPipeline(loader, "cpu"))
    assert x.dtype == torch.float32 and float(x.max()) == 1.0
    assert t.dtype == torch.int64 and t.shape == (2, 3)
    with pytest.raises(ValueError):
        tdata.PairedArrayLoader(images, tokens[:3], 2)


# ---------------------------------------------------------------------------
# The CLI
# ---------------------------------------------------------------------------


def test_train_cli_clip_tiny_runs_on_cpu():
    args = cli.build_train_parser().parse_args(CPU_ARGV)
    before = {k: v.clone() for k, v in
              cli.build_clip_model(args).state_dict().items()}
    launches = (infonce.infonce_dual_fwd.launches,
                infonce.infonce_dual_bwd.launches)
    state, history = cli.train(args)
    assert [h["step"] for h in history] == [1, 2]
    for h in history:
        assert np.isfinite(h["loss"])
        # one image per pair
        assert h["images_per_sec"] == pytest.approx(
            BATCH * h["steps_per_sec"])
    after = state.model.state_dict()
    assert any((after[k] - before[k]).abs().max() > 0 for k in before)
    assert isinstance(state.model, CLIPModel)
    assert isinstance(state.optimizer, tadamw.AdamW)
    # the CPU step takes the oracle: no kernel wrapper was called
    assert launches == (infonce.infonce_dual_fwd.launches,
                        infonce.infonce_dual_bwd.launches)
    assert cli.train_main(CPU_ARGV) == 0


def test_train_cli_clip_raises_without_a_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = _without(CPU_ARGV, "--device")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.train(cli.build_train_parser().parse_args(argv))


def test_train_cli_clip_defaults():
    args = cli.build_train_parser().parse_args(["--objective", "clip"])
    assert (args.vocab_size, args.token_len, args.batch) == (49408, None, 256)
    images, tokens = cli._clip_data(args)
    assert args.token_len == 77 and args.image_size == 32
    assert images.shape == (512, 32, 32, 3) and tokens.shape == (512, 77)
    # as the JAX CLI draws them: images, then ids in [1, vocab)
    rng = np.random.RandomState(0)
    np.testing.assert_array_equal(images, rng.rand(512, 32, 32, 3).astype(
        np.float32))
    np.testing.assert_array_equal(tokens, rng.randint(1, 49408, (512, 77)))


@pytest.mark.parametrize("flags,match", [
    (["--model", "resnet50"], "ViT image tower"),
    (["--dataset", "cifar10"], "paired data"),
    (["--clip-parallel", "tp"], "ROADMAP.md Queue A 9"),
    (["--moe-experts", "4"], "ROADMAP.md Queue A 9"),
])
def test_train_cli_clip_refusals(flags, match, monkeypatch):
    """The JAX CLI's refusals; Queue A 9's flags (ported since) train on
    one process instead: ``--clip-parallel tp`` takes the single-card step
    (the JAX CLI's behaviour on one device), ``--moe-experts 4`` the MoE
    image tower with its aux in every step's history."""
    args = cli.build_train_parser().parse_args(CPU_ARGV + flags)
    if "Queue A 9" in match:
        monkeypatch.delenv("WORLD_SIZE", raising=False)
        state, history = cli.train(args)
        assert len(history) == 2 and all(np.isfinite(h["loss"])
                                         for h in history)
        moe = flags[0] == "--moe-experts"
        assert all(("moe_aux" in h) == moe for h in history)
        assert (type(state.model.image_tower.blocks[1].mlp).__name__
                == ("MoEMlp" if moe else "MlpBlock"))
        return
    with pytest.raises(SystemExit, match=match):
        cli.train(args)


def _without(argv, *flags):
    """``argv`` without each of ``flags`` and its value."""
    out, skip = [], False
    for a in argv:
        if skip:
            skip = False
        elif a in flags:
            skip = True
        else:
            out.append(a)
    return out


def _pairs_file(tmp_path, tokens):
    path = tmp_path / "pairs.npz"
    images = np.random.default_rng(0).integers(
        0, 256, (len(tokens), IMAGE, IMAGE, 3)).astype(np.uint8)
    np.savez(path, images=images, tokens=tokens)
    return str(path)


def test_train_cli_clip_reads_pairs_from_data_dir(tmp_path):
    tokens = np.random.default_rng(1).integers(0, VOCAB, (16, 12))
    argv = _without(CPU_ARGV, "--image-size", "--token-len")
    args = cli.build_train_parser().parse_args(
        argv + ["--data-dir", _pairs_file(tmp_path, tokens)])
    state, history = cli.train(args)
    assert (args.image_size, args.token_len) == (IMAGE, 12)
    assert state.model.text_tower.max_len == 12
    assert len(history) == 2 and all(np.isfinite(h["loss"]) for h in history)


@pytest.mark.parametrize("case", ["token_out_of_vocab", "negative_token",
                                  "image_size", "token_len"])
def test_train_cli_clip_checks_the_pairs(tmp_path, case):
    tokens = np.random.default_rng(2).integers(0, VOCAB, (16, TOKENS))
    extra = []
    if case == "token_out_of_vocab":
        tokens[3, 2] = VOCAB
    elif case == "negative_token":
        tokens[0, 0] = -1
    elif case == "image_size":
        extra = ["--image-size", str(2 * IMAGE)]
    argv = _without(CPU_ARGV, "--image-size")
    if case == "token_len":
        argv = _without(argv, "--token-len")
        extra = ["--token-len", str(TOKENS + 1)]
    args = cli.build_train_parser().parse_args(
        argv + extra + ["--data-dir", _pairs_file(tmp_path, tokens)])
    with pytest.raises(SystemExit):
        cli.train(args)
