"""The port's ``LongContextTransformer`` against the JAX package's.

One flax initialization of the JAX tower at the sizes of the JAX
package's ``tests/test_long_context.py`` (vocabulary 64, hidden 32,
depth 2, 8 heads, MLP 64, L 32, fp32, batch 2) goes through the port's
converter (``weights.load_flax_variables``). Then:

* the one-device plans (``attention_oracle``, ``blockwise_attention``,
  the default ``flash_attention``) equal JAX's ``model.apply`` of the
  oracle plan, and their parameter gradients of the probe ``sum(out^2)``
  equal ``jax.grad``;
* in spawned gloo worlds of 2 and 4 (``torch_dist_workers.run_ring``, no
  JAX in the ranks) each rank feeds its token shard under the causal
  ring (jnp and flash) and Ulysses plans: the ranks' output shards,
  concatenated, equal JAX's causal ``model.apply``, and the sum over the
  ranks of their parameter gradients equals ``jax.grad``;
* ``default_attention()`` is ``flash_attention``; a rank adds the
  position rows of its global positions; a sequence longer than
  ``max_len`` raises, over the whole world too.

Tolerances (fp32): outputs 1e-5 (the same products through two blocks
summed in another order), parameter gradients 1e-4 absolute plus 1e-4
relative (sums over 64 positions and, across ranks, over the shards).
"""

from concurrent.futures import ThreadPoolExecutor
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ntxent_tpu.models import LongContextTransformer as JaxLongContext
from ntxent_tpu.parallel import attention_oracle as joracle
from ntxent_tpu_torch.models import LongContextTransformer
from ntxent_tpu_torch.models import long_context as LC
from ntxent_tpu_torch.ops.attention import flash_attention
from ntxent_tpu_torch.parallel import (
    attention_oracle,
    blockwise_attention,
    make_ring_attention,
)
from ntxent_tpu_torch.weights import load_flax_variables

import torch_dist_workers as workers
from test_torch_distributed import _flatten, _spawn

torch.set_num_threads(1)  # see test_torch_training.py

WORLDS = (2, 4)
SIZES = workers.TINY_LONG_CONTEXT
BATCH, LENGTH = 2, SIZES["max_len"]
OUT_ATOL, GRAD_ATOL, GRAD_RTOL = 1e-5, 1e-4, 1e-4


def _jax_model(causal: bool):
    return JaxLongContext(**SIZES, dtype=jnp.float32,
                          attention_fn=partial(joracle, causal=causal))


@pytest.fixture(scope="module")
def setup():
    """(tokens, flax params as numpy)."""
    tokens = np.random.default_rng(7).integers(
        0, SIZES["vocab_size"], (BATCH, LENGTH)).astype(np.int32)
    params = jax.device_get(_jax_model(False).init(
        jax.random.PRNGKey(0), jnp.asarray(tokens))["params"])
    return tokens, jax.tree.map(np.asarray, params)


@pytest.fixture(scope="module")
def jax_reference(setup):
    """{causal: (JAX output, {flax path: gradient of sum(out^2)})}."""
    tokens, params = setup
    out = {}
    for causal in (False, True):
        model = _jax_model(causal)

        def probe(p, model=model):
            y = model.apply({"params": p}, jnp.asarray(tokens))
            return jnp.sum(y ** 2), y

        grads, y = jax.grad(probe, has_aux=True)(params)
        out[causal] = (np.asarray(y), _flatten(jax.device_get(grads), "lc"))
    return out


def _port(params, attention_fn):
    return load_flax_variables(
        LongContextTransformer(**SIZES, dtype=torch.float32,
                               attention_fn=attention_fn),
        {"params": params})


def _flax_grads(model, flat):
    """The port's parameter names -> the JAX gradient of each, in the
    port's layout (through the converter itself)."""
    nested = workers.nest(flat, "lc")
    grads = _port(nested, model.attention_fn)
    return dict(grads.named_parameters())


def _assert_grads(named_grads: dict, want_flat: dict, model):
    want = _flax_grads(model, want_flat)
    for name, grad in named_grads.items():
        np.testing.assert_allclose(grad, want[name].detach().numpy(),
                                   atol=GRAD_ATOL, rtol=GRAD_RTOL,
                                   err_msg=name)


PLANS = {"oracle": (False, attention_oracle),
         "blockwise": (False, partial(blockwise_attention, block_kv=8)),
         "flash_default": (False, None),
         "oracle_causal": (True, partial(attention_oracle, causal=True)),
         "flash_causal": (True, partial(flash_attention, causal=True))}


@pytest.mark.parametrize("plan", sorted(PLANS))
def test_one_device_plans_match_jax(setup, jax_reference, plan):
    tokens, params = setup
    causal, fn = PLANS[plan]
    model = _port(params, fn)
    y = model(torch.from_numpy(tokens).long())
    y.pow(2).sum().backward()
    want_y, want_g = jax_reference[causal]
    np.testing.assert_allclose(y.detach().numpy(), want_y, atol=OUT_ATOL,
                               rtol=0)
    _assert_grads({n: p.grad.numpy() for n, p in model.named_parameters()},
                  want_g, model)


def test_default_attention_is_the_flash_kernel_wrapper():
    assert LC.default_attention() is flash_attention
    model = LongContextTransformer(**SIZES)
    assert model.attention_fn is flash_attention
    assert all(b.attn.attention_fn is flash_attention for b in model.blocks)


def test_converter_covers_every_tensor_and_leaf(setup):
    _, params = setup
    extra = {**params, "unused": {"kernel": np.zeros(1, np.float32)}}
    with pytest.raises(KeyError, match="unused"):
        _port(extra, None)
    model = _port(params, None)
    np.testing.assert_array_equal(model.pos_embedding.detach().numpy(),
                                  params["pos_embedding"])
    np.testing.assert_array_equal(
        model.blocks[1].attn.out.weight.detach().numpy(),
        params["LongContextBlock_1"]["SeqParallelSelfAttention_0"]["out"][
            "kernel"].reshape(-1, SIZES["hidden_dim"]).T)


def test_a_rank_adds_the_position_rows_of_its_global_positions(
        setup, monkeypatch):
    tokens, params = setup
    model = _port(params, make_ring_attention(causal=True))
    monkeypatch.setattr(LC, "rank", lambda group=None: 1)
    monkeypatch.setattr(LC, "world_size", lambda group=None: 2)
    shard = torch.from_numpy(tokens[:, 16:]).long()
    want = (model.embedding[shard]
            + model.pos_embedding[:, 16:32]).detach()
    torch.testing.assert_close(model.embed(shard).detach(), want, atol=0,
                               rtol=0)


def test_max_len_bounds_the_global_length(setup, monkeypatch):
    tokens, params = setup
    one = _port(params, None)
    with pytest.raises(ValueError, match="exceeds max_len"):
        one(torch.zeros(1, LENGTH + 1, dtype=torch.long))
    ring = _port(params, make_ring_attention(causal=True))
    monkeypatch.setattr(LC, "world_size", lambda group=None: 4)
    with pytest.raises(ValueError, match="sequence length 64 exceeds"):
        ring(torch.zeros(1, 16, dtype=torch.long))


# ---------------------------------------------------------------------------
# Worlds of 2 and 4
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def worlds(setup, tmp_path_factory):
    tokens, params = setup
    tmp = tmp_path_factory.mktemp("long_context_worlds")
    np.savez(tmp / "inputs.npz", lc_tokens=tokens, **_flatten(params, "lc"))
    with ThreadPoolExecutor(max_workers=len(WORLDS)) as pool:
        futures = {}
        for world in WORLDS:
            out = tmp / f"world{world}"
            out.mkdir()
            futures[world] = pool.submit(
                _spawn, workers.run_ring, world,
                (str(tmp / "inputs.npz"), str(out), ["long_context"]), out)
        results = {}
        for world, future in futures.items():
            future.result()
            results[world] = [dict(np.load(tmp / f"world{world}" /
                                           f"rank{r}.npz"))
                              for r in range(world)]
    return results


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("plan", ["ring_jnp", "ring_flash", "ulysses"])
def test_sequence_parallel_plans_match_jax(setup, jax_reference, worlds,
                                           world, plan):
    _, params = setup
    ranks = worlds[world]
    want_y, want_g = jax_reference[True]
    got = np.concatenate([res[f"lc:{plan}:out"] for res in ranks], axis=1)
    np.testing.assert_allclose(got, want_y, atol=OUT_ATOL, rtol=0)
    model = _port(params, None)
    summed = {name: sum(res[f"lc:{plan}:grad:{name}"] for res in ranks)
              for name, _ in model.named_parameters()}
    _assert_grads(summed, want_g, model)


def test_rank_processes_import_no_jax(worlds):
    assert not any(bool(res["jax_loaded"]) for world in WORLDS
                   for res in worlds[world])
