"""The port's ring NT-Xent and ring InfoNCE against the JAX package.

* ``block_lse`` and ``block_grads`` (the ring mode of the general NT-Xent
  kernels #1 and #6) on the CPU, their plain versions, against the JAX
  functions in Pallas interpret mode: 24 local rows against a visiting
  block of 40 columns (D = 32) whose ids are scattered over a global
  batch of 64 and shared in part with the rows (self entries), at the
  JAX package's default blocks and at 16-row blocks that 24 is no
  multiple of, in fp32 and bf16;
* spawned gloo worlds of 2 and 4 (``torch_dist_workers.run_ring``, no JAX
  in the ranks) on a global batch of 16 pairs at D = 32:
  ``make_ring_ntxent`` (fused and jnp) against JAX ``ntxent_loss_ring``
  on a mesh of as many CPU devices, the gradients against ``jax.grad`` of
  it; ``make_ring_infonce`` (dual and twoblock) at a tensor scale against
  JAX ``make_ring_infonce``, the gradients of both embeddings and of the
  scale; every loss's comms against the JAX shims' records;
* the impl names.

Gradient convention (as in test_torch_distributed.py): a rank's gradient
of its shard, and of the replicated scale, is P times its share of the
global gradient.

Tolerances, fp32: the same products summed in another order -> 1e-5 on
the lse (up to 1/T + log 2N ~ 14) and the mean losses, 1e-5 on the block
gradients (rows of P sum to 1 over unit vectors), 1e-6 on the loss
gradients (of size ~1e-2) and 1e-5 on the scale's.
"""

from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ntxent_tpu.ops.ntxent_pallas as jpallas
from ntxent_tpu.parallel import make_ring_infonce as jring_infonce
from ntxent_tpu.parallel import make_ring_ntxent as jring_ntxent
from ntxent_tpu.parallel.mesh import comms_accounting as jcomms
from ntxent_tpu_torch.ops import ntxent as N
from ntxent_tpu_torch.parallel import ring as RING

import torch_dist_workers as workers
from test_torch_distributed import _mesh, _spawn
from test_torch_pair import DTYPES, _as_jax, _as_torch, _tile

torch.set_num_threads(1)  # see test_torch_training.py

WORLDS = (2, 4)
TEMPERATURE, SCALE = 0.1, 14.0
GLOBAL, EMBED = 16, 32
TOTAL = 64  # the global batch of the block tile (see test_torch_pair._tile)
BLOCKS = {"default": {}, "ragged": {"block_rows": 16, "block_cols": 128}}


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("blocks", sorted(BLOCKS))
def test_block_lse_and_grads_plain_match_jax(blocks, dtype):
    zr, zc, rid, cid, lse_r, _ = _tile(dtype)
    # real ids only: the ring's blocks carry no sentinel rows or columns
    rid[3], cid[[5, 7]] = TOTAL - 1, TOTAL - 2
    jargs = (_as_jax(zr, dtype), _as_jax(zc, dtype), jnp.asarray(rid),
             jnp.asarray(cid))
    targs = (_as_torch(zr, dtype), _as_torch(zc, dtype),
             torch.from_numpy(rid), torch.from_numpy(cid))
    want = jpallas.block_lse(*jargs, TEMPERATURE, TOTAL, interpret=True,
                             **BLOCKS[blocks])
    got = N.block_lse(*targs, TEMPERATURE, TOTAL)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=0)
    want_r, want_c = jpallas.block_grads(*jargs, jnp.asarray(lse_r),
                                         TEMPERATURE, TOTAL, interpret=True,
                                         **BLOCKS[blocks])
    got_r, got_c = N.block_grads(*targs, torch.from_numpy(lse_r),
                                 TEMPERATURE, TOTAL)
    np.testing.assert_allclose(got_r.numpy(), np.asarray(want_r), atol=1e-5,
                               rtol=0)
    np.testing.assert_allclose(got_c.numpy(), np.asarray(want_c), atol=1e-5,
                               rtol=0)


def test_ring_impls_are_named():
    with pytest.raises(ValueError, match="impl must be"):
        RING.make_ring_ntxent(None, 0.1, impl="nope")
    with pytest.raises(ValueError, match="unknown ring impl"):
        RING.make_ring_infonce(None, impl="nope")


# ---------------------------------------------------------------------------
# Worlds of 2 and 4
# ---------------------------------------------------------------------------


def _unit(rng, n, d):
    z = rng.normal(size=(n, d)).astype(np.float32)
    return z / np.linalg.norm(z, axis=-1, keepdims=True)


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(21)
    z1, z2 = _unit(rng, GLOBAL, EMBED), _unit(rng, GLOBAL, EMBED)
    za, zb = _unit(rng, GLOBAL, EMBED), _unit(rng, GLOBAL, EMBED)
    return {"z1": z1, "z2": z2, "t": np.float32(TEMPERATURE), "za": za,
            "zb": zb, "scale": np.float32(SCALE)}


@pytest.fixture(scope="module")
def worlds(inputs, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ring_loss_worlds")
    np.savez(tmp / "inputs.npz", **inputs)
    with ThreadPoolExecutor(max_workers=len(WORLDS)) as pool:
        futures = {}
        for world in WORLDS:
            out = tmp / f"world{world}"
            out.mkdir()
            futures[world] = pool.submit(
                _spawn, workers.run_ring, world,
                (str(tmp / "inputs.npz"), str(out), ["losses"]), out)
        results = {}
        for world, future in futures.items():
            future.result()
            results[world] = [dict(np.load(tmp / f"world{world}" /
                                           f"rank{r}.npz"))
                              for r in range(world)]
    return results


def _traced(fn, *args):
    """(value, gradients, comms the shims recorded) of a jitted
    ``value_and_grad`` of ``fn``."""
    mark = jcomms().totals()
    step = jax.jit(jax.value_and_grad(fn, argnums=tuple(range(len(args)))))
    value, grads = step(*(jnp.asarray(a) for a in args))
    comms = {op: rec for (op, _), rec in jcomms().delta(mark).items()
             if op != "pcast"}
    return float(value), [np.asarray(g) for g in grads], comms


def _port_comms(res, key):
    return {name.rsplit(":", 1)[1]: (int(v[0]), float(v[1]))
            for name, v in res.items() if name.startswith(f"{key}:comms:")}


def _rows(ranks, key):
    return np.concatenate([res[key] for res in ranks])


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("impl", ["fused", "jnp"])
def test_ring_ntxent_matches_jax(inputs, worlds, world, impl):
    """Loss, gradients and comms. The JAX ring also sends each block's
    (2n,) int32 ids on every hop and makes a P-th backward hop of the
    fused ring's block that only brings it home; the port derives the ids
    from the hop count and skips that hop."""
    fn = jring_ntxent(_mesh(world), TEMPERATURE,
                      impl="fused" if impl == "fused" else "jnp")
    loss, (g1, g2), comms = _traced(lambda a, b: fn(a, b), inputs["z1"],
                                    inputs["z2"])
    ranks = worlds[world]
    for res in ranks:
        np.testing.assert_allclose(res[f"ntxent:{impl}:loss"], loss,
                                   atol=1e-5, rtol=0)
    np.testing.assert_allclose(_rows(ranks, f"ntxent:{impl}:g1") / world, g1,
                               atol=1e-6, rtol=0)
    np.testing.assert_allclose(_rows(ranks, f"ntxent:{impl}:g2") / world, g2,
                               atol=1e-6, rtol=0)
    p, rows = world, 2 * GLOBAL // world
    block, ids = rows * EMBED * 4, rows * 4
    calls, nbytes = comms["ppermute"]
    if impl == "fused":  # fwd P - 1 hops of (block, ids); bwd P of both
        skipped = (2 * p - 1 + 1, (2 * p - 1) * ids + block)
    else:  # P - 1 hops of (block, ids); the backward is AD's, unrecorded
        skipped = (p - 1, (p - 1) * ids)
    want = {"ppermute": (calls - skipped[0], nbytes - skipped[1]),
            "psum": comms["psum"]}
    for res in ranks:
        got = _port_comms(res, f"ntxent:{impl}")
        assert got == {op: (c, pytest.approx(b))
                       for op, (c, b) in want.items()}


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("impl", ["dual", "twoblock"])
def test_ring_infonce_matches_jax(inputs, worlds, world, impl):
    fn = jring_infonce(_mesh(world), impl=impl)
    loss, (ga, gb, gs), comms = _traced(fn, inputs["za"], inputs["zb"],
                                        np.float32(SCALE))
    ranks = worlds[world]
    for res in ranks:
        np.testing.assert_allclose(res[f"infonce:{impl}:loss"], loss,
                                   atol=1e-5, rtol=0)
        assert _port_comms(res, f"infonce:{impl}") == {
            op: (c, pytest.approx(b)) for op, (c, b) in comms.items()}
    np.testing.assert_allclose(_rows(ranks, f"infonce:{impl}:ga") / world,
                               ga, atol=1e-6, rtol=0)
    np.testing.assert_allclose(_rows(ranks, f"infonce:{impl}:gb") / world,
                               gb, atol=1e-6, rtol=0)
    np.testing.assert_allclose(
        sum(float(res[f"infonce:{impl}:gs"]) for res in ranks) / world, gs,
        atol=1e-5, rtol=0)


def test_rank_processes_import_no_jax(worlds):
    assert not any(bool(res["jax_loaded"]) for world in WORLDS
                   for res in worlds[world])
