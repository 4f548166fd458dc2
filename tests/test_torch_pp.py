"""The GPipe schedule of the port (``parallel/pp.py``) and the pipelined
long-context apply (``models.make_pipelined_apply``), against the JAX
package (after ``tests/test_pipeline.py``).

A gloo world of 8 ranks as the (data 2, stage 4) grid
(``torch_mp_workers.run_pp``), spawned while JAX computes: each data row
runs GPipe over its 4 stages on its half of the batch (dp x pp), with 4
microbatches (with and without ``remat``), 1 and 2, on the JAX tests'
dense stages; real encoder blocks two a stage; and the tiny long-context
tower pipelined over 4 stages with ``remat``. Held to the JAX package's
sequential application of the same stages (the oracle JAX's own GPipe is
held to), to ``jax.grad`` of it, and to the JAX tower's plain apply and
its gradients. Tolerances (fp32): outputs 1e-5, gradients 1e-4 relative
with 1e-5 absolute; the tower's outputs 1e-4 and its gradients 2e-4
relative with 5e-5 absolute, JAX's own test's (the pipelined backward
sums over microbatches and stages in another order).
"""

from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ntxent_tpu.models import LongContextTransformer as JaxTower
from ntxent_tpu.models.vit import EncoderBlock as JaxBlock
from ntxent_tpu.parallel.pp import pipeline_stage_params as jsplit
from ntxent_tpu.parallel.pp import stack_stage_params as jstack
from ntxent_tpu.parallel.ring_attention import attention_oracle as joracle
from ntxent_tpu_torch.models import LongContextTransformer
from ntxent_tpu_torch.models import make_pipelined_apply
from ntxent_tpu_torch.parallel import pp
from ntxent_tpu_torch.weights import _layout

import torch_mp_workers as workers
from test_torch_distributed import _flatten, _spawn
from test_torch_moe import _np

torch.set_num_threads(1)  # see test_torch_training.py

WORLD, S, B, D = 8, 4, 8, 16
RUNS = ["gpipe_m4", "gpipe_m4_remat", "gpipe_m1", "gpipe_m2"]


def _dense_stage(p, x):
    return jax.nn.relu(x @ p["w"] + p["b"])


def _sequential(params_list, x):
    for p in params_list:
        x = _dense_stage(p, x)
    return x


@pytest.fixture(scope="module")
def setup():
    key = jax.random.PRNGKey(0)
    stages = [{"w": np.asarray(jax.random.normal(jax.random.fold_in(key, i),
                                                 (D, D)) / np.sqrt(D)),
               "b": np.asarray(0.1 * jax.random.normal(
                   jax.random.fold_in(key, 10 + i), (D,)))}
              for i in range(S)]
    x = np.asarray(jax.random.normal(jax.random.fold_in(key, 99), (B, D)))
    blk = JaxBlock(num_heads=2, mlp_dim=32, dtype=jnp.float32)
    acts = np.asarray(jax.random.normal(key, (4, 6, D)))
    blocks = [_np(blk.init(jax.random.fold_in(key, 20 + i), acts)["params"])
              for i in range(2 * S)]
    tower = JaxTower(vocab_size=64, hidden_dim=16, depth=4, num_heads=2,
                     mlp_dim=32, max_len=32, dtype=jnp.float32,
                     attention_fn=joracle)
    tokens = np.asarray(jax.random.randint(jax.random.PRNGKey(42), (4, 8),
                                           0, 64))
    lc_vars = _np(tower.init(jax.random.PRNGKey(42), tokens))
    inputs = {"x": x, "acts": np.concatenate([acts, acts]),
              "tokens": tokens.astype(np.int64),
              **{f"stage{i}/{k}": v for i, s in enumerate(stages)
                 for k, v in s.items()},
              **{k: v for i, p in enumerate(blocks)
                 for k, v in _flatten(p, f"block{i}").items()},
              **_flatten(lc_vars["params"], "lc")}
    return stages, x, blk, acts, blocks, tower, tokens, lc_vars, inputs


@pytest.fixture(scope="module")
def world(setup, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("pp_world")
    np.savez(tmp / "inputs.npz", **setup[-1])
    with ThreadPoolExecutor(max_workers=1) as pool:
        future = pool.submit(_spawn, workers.run_pp, WORLD,
                             (str(tmp / "inputs.npz"), str(tmp)), tmp)

        def results():
            future.result()
            return [dict(np.load(tmp / f"rank{r}.npz"))
                    for r in range(WORLD)]

        yield results


@pytest.fixture(scope="module")
def jax_sequential(setup, world):
    stages, x = setup[0], setup[1]
    params = [{k: jnp.asarray(v) for k, v in s.items()} for s in stages]
    y = _sequential(params, jnp.asarray(x))
    gp, gx = jax.grad(lambda ps, v: jnp.sum(_sequential(ps, v) ** 2),
                      argnums=(0, 1))(params, jnp.asarray(x))
    return np.asarray(y), _np(gp), np.asarray(gx)


@pytest.mark.parametrize("run", RUNS)
def test_gpipe_matches_the_sequential_stages(setup, jax_sequential, world,
                                             run):
    """Forward on every rank of a row (the psum replicates the last
    stage's outputs), each stage's weight gradients, and the input's
    gradient on every stage rank, dp x pp."""
    y, gp, gx = jax_sequential
    ranks = world()
    half = B // 2
    for r, res in enumerate(ranks):
        d, s = r // S, r % S
        rows = slice(d * half, (d + 1) * half)
        np.testing.assert_allclose(res[f"{run}_y"], y[rows], rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(res[f"{run}_gx"], gx[rows], rtol=1e-4,
                                   atol=1e-5)
        # each row's stage gradients are its half's share of the total
        share = {k: res[f"{run}_g{k}"] + ranks[(1 - d) * S + s][
            f"{run}_g{k}"] for k in ("w", "b")}
        for k in ("w", "b"):
            np.testing.assert_allclose(share[k], gp[s][k], rtol=1e-4,
                                       atol=1e-5, err_msg=f"stage {s} {k}")
        assert not bool(res["jax_loaded"])


def test_uneven_microbatches_refuse(world):
    assert "microbatch" in str(world()[0]["uneven"])


def test_transformer_blocks_pipelined(setup, world):
    """Two real encoder blocks a stage (4 stages, 2 microbatches) equal
    the JAX blocks applied in sequence."""
    _, _, blk, acts, blocks, *_ = setup
    want = jnp.asarray(acts)
    for p in blocks:
        want = blk.apply({"params": p}, want)
    for res in world():
        np.testing.assert_allclose(res["blocks_y"], np.asarray(want),
                                   rtol=1e-4, atol=1e-4)


def test_pipelined_tower_matches_the_plain_apply(setup, world):
    """``make_pipelined_apply`` over 4 stages with ``remat``: the output
    and every gradient a rank holds (its stage's block, the embedding
    and the final norm, replicated) against the JAX tower's plain apply
    and ``jax.grad`` of sum(out^2)."""
    *_, tower, tokens, lc_vars, _ = setup
    want = tower.apply(lc_vars, tokens)
    grads = _np(jax.grad(lambda v: jnp.sum(tower.apply(v, tokens) ** 2))(
        lc_vars)["params"])
    model = workers.loaded(LongContextTransformer(
        vocab_size=64, hidden_dim=16, depth=4, num_heads=2, mlp_dim=32,
        max_len=32, dtype=torch.float32,
        attention_fn=workers.attention_oracle), setup[-1], "lc")
    leaves = _layout(model)
    for r, res in enumerate(world()):
        np.testing.assert_allclose(res["lc_y"], np.asarray(want), rtol=1e-4,
                                   atol=1e-5)
        held = {k[len("lc_g:"):] for k in res if k.startswith("lc_g:")}
        stage_block = f"blocks.{r % S}."
        assert any(n.startswith(stage_block) for n in held)
        assert not any(n.startswith("blocks.") and not n.startswith(
            stage_block) for n in held)
        assert {"embedding", "pos_embedding", "out_ln.weight"} <= held
        for name in held:
            node = grads
            for key in leaves[name].path:
                node = node[key]
            np.testing.assert_allclose(
                leaves[name].to_flax(res[f"lc_g:{name}"]), node, rtol=2e-4,
                atol=5e-5, err_msg=name)
        assert "split" in str(res["lc_depth"])


def test_stage_params_split():
    p = {f"block_{i}": {"w": np.full((3,), float(i), np.float32)}
         for i in range(6)}
    p["final_ln"] = {"scale": np.ones((3,), np.float32)}
    tp_ = {k: {kk: torch.tensor(vv) for kk, vv in v.items()}
           for k, v in p.items()}
    stacked, rest = pp.pipeline_stage_params(tp_, num_stages=3)
    want, want_rest = jsplit(p, num_stages=3)
    np.testing.assert_array_equal(stacked["w"].numpy(),
                                  np.asarray(want["w"]))
    assert list(rest) == list(want_rest) == ["final_ln"]
    np.testing.assert_array_equal(
        pp.stack_stage_params([{"a": torch.ones(2)}, {"a": torch.zeros(2)}])[
            "a"].numpy(),
        np.asarray(jstack([{"a": np.ones(2)}, {"a": np.zeros(2)}])["a"]))
    with pytest.raises(ValueError, match="split"):
        pp.pipeline_stage_params(tp_, num_stages=4)
    with pytest.raises(ValueError, match="block"):
        pp.pipeline_stage_params({"x": 1}, num_stages=1)


def test_a_ring_plan_cannot_nest_in_the_pipeline():
    def plan(q, k, v):
        return q

    plan.group = None
    model = LongContextTransformer(vocab_size=8, hidden_dim=16, depth=2,
                                   num_heads=2, mlp_dim=32, max_len=8,
                                   dtype=torch.float32, attention_fn=plan)
    with pytest.raises(ValueError, match="cannot run inside"):
        make_pipelined_apply(model, None, num_microbatches=1)
    with pytest.raises(ValueError, match="num_microbatches"):
        pp.make_gpipe(lambda p, x: x, None, num_microbatches=0)
