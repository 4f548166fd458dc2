"""The port's ring and Ulysses attention against the JAX package.

* ``flash_fold_plain`` (the plain version of the fold kernel #12) against
  JAX ``flash_fold`` in Pallas interpret mode: BH = 2, Lq = 40, Lk = 300,
  D = 16 (JAX tiles of 16 query rows and 128 keys, which neither length
  fills), three folds in a row so that every fold but the first starts
  from a carried state, at the offsets of the card's checks: non-causal,
  causal with q_offset > k_offset (partly masked), q_offset == k_offset,
  and q_offset < k_offset with the whole block in the rows' future (the
  carry comes out bit for bit);
* ``attention_oracle`` and ``blockwise_attention`` against JAX's;
* spawned gloo worlds of 2 and 4 (``torch_dist_workers.run_ring``, no JAX
  in the ranks) at the JAX tests' size (B 2, L 32, H 8, D 8): ring
  attention (``impl`` jnp and flash, causal or not, one or two transfer
  chunks) and Ulysses attention, output and q/k/v gradients of the probe
  ``sum(out^2)``, against JAX ``make_ring_attention`` and
  ``make_ulysses_attention`` on meshes of as many CPU devices; each
  hop's comms against the JAX shims' records;
* the errors: an unknown impl, tiles the kernels do not have, heads that
  do not divide over the ranks.

Tolerances (fp32): the fold's m and l within 1e-5 and acc within 1e-5
relative to its largest entry (the same products summed in another order
and, in JAX, tile by tile); in bf16 (p rounded to bf16 at another running
max) acc within 1e-2 relative. The parallel forms against JAX: 1e-5 on
outputs, 1e-5 on gradients (of size ~1), as the JAX package's own
``assert_same_fn`` holds them to its oracle.
"""

from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from ntxent_tpu.ops.attention_pallas import flash_fold as jfold
from ntxent_tpu.parallel import attention_oracle as joracle
from ntxent_tpu.parallel import blockwise_attention as jblockwise
from ntxent_tpu.parallel import make_ring_attention as jring
from ntxent_tpu.parallel import make_ulysses_attention as julysses
from ntxent_tpu.parallel.mesh import comms_accounting as jcomms
from ntxent_tpu_torch.ops import attention as A
from ntxent_tpu_torch.parallel import ring_attention as R

import torch_dist_workers as workers
from test_torch_distributed import _spawn

torch.set_num_threads(1)  # see test_torch_training.py

WORLDS = (2, 4)
B, L, H, D = 2, 32, 8, 8
# The fold: (BH, Lq, Lk, D) and JAX's tiles.
FOLD_BH, FOLD_LQ, FOLD_LK, FOLD_D = 2, 40, 300, 16
FOLD_BLOCKS = dict(block_q=16, block_kv=128)
# (name, causal, q_offset, k_offsets of three folds in a row)
FOLD_CASES = [
    ("noncausal", False, 0, (0, 300, 600)),
    ("partly_masked", True, 700, (0, 300, 600)),
    ("diagonal", True, 300, (0, 300, 300)),
    ("future", True, 0, (0, 50, 400)),
]
DTYPES = {"float32": (jnp.float32, torch.float32, 1e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 1e-2)}


def _normal(shape, seed, scale=0.5):
    return (np.random.default_rng(seed).normal(size=shape) * scale).astype(
        np.float32)


def _fold_inputs(dtype):
    jdt = DTYPES[dtype][0]
    q = _normal((FOLD_BH, FOLD_LQ, FOLD_D), 1, 1.0)
    kv = [(_normal((FOLD_BH, FOLD_LK, FOLD_D), 10 + i, 1.0),
           _normal((FOLD_BH, FOLD_LK, FOLD_D), 20 + i, 1.0)) for i in range(3)]

    def rnd(x):  # rounded to the dtype, so both sides see the same values
        return np.array(jnp.asarray(x).astype(jdt).astype(jnp.float32))

    return rnd(q), [(rnd(k), rnd(v)) for k, v in kv]


def _carry0():
    return (np.full((FOLD_BH, FOLD_LQ), -1e30, np.float32),
            np.zeros((FOLD_BH, FOLD_LQ), np.float32),
            np.zeros((FOLD_BH, FOLD_LQ, FOLD_D), np.float32))


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("case", FOLD_CASES, ids=[c[0] for c in FOLD_CASES])
def test_flash_fold_plain_matches_jax_with_carried_state(case, dtype):
    _, causal, q_off, k_offs = case
    jdt, tdt, acc_rtol = DTYPES[dtype]
    q, kv = _fold_inputs(dtype)
    sc = 1.0 / np.sqrt(FOLD_D)
    want = tuple(jnp.asarray(x) for x in _carry0())
    got = tuple(torch.from_numpy(x) for x in _carry0())
    for (k, v), k_off in zip(kv, k_offs):
        want = jfold(jnp.asarray(q).astype(jdt), jnp.asarray(k).astype(jdt),
                     jnp.asarray(v).astype(jdt), *want, q_offset=q_off,
                     k_offset=k_off, scale=sc, causal=causal, interpret=True,
                     **FOLD_BLOCKS)
        got = A.flash_fold(*(torch.from_numpy(x).to(tdt) for x in (q, k, v)),
                           *got, q_offset=q_off, k_offset=k_off, scale=sc,
                           causal=causal)
        m_w, l_w, acc_w = (np.asarray(x) for x in want)
        m_g, l_g, acc_g = (x.numpy() for x in got)
        np.testing.assert_allclose(m_g, m_w, atol=1e-5, rtol=0)
        np.testing.assert_allclose(l_g, l_w, atol=0, rtol=1e-5)
        np.testing.assert_allclose(acc_g, acc_w, rtol=0,
                                   atol=acc_rtol * np.abs(acc_w).max())


def test_flash_fold_leaves_the_carry_of_a_wholly_masked_hop_bitwise():
    q, kv = _fold_inputs("float32")
    carry = A.flash_fold(*(torch.from_numpy(x) for x in (q, *kv[0])),
                         *(torch.from_numpy(x) for x in _carry0()),
                         q_offset=500, k_offset=0, causal=True)
    # every key of this block lies after every query row
    after = A.flash_fold(*(torch.from_numpy(x) for x in (q, *kv[1])), *carry,
                         q_offset=500, k_offset=500 + FOLD_LQ, causal=True)
    for a, b in zip(after, carry):
        assert torch.equal(a, b)
    assert a is not b  # new tensors: the carry is not written


def test_flash_fold_checks_its_carry():
    q = torch.zeros(2, 8, 16)
    m, l = torch.zeros(2, 8), torch.zeros(2, 8)
    with pytest.raises(ValueError, match="acc"):
        A.flash_fold(q, q, q, m, l, torch.zeros(2, 8, 8))
    with pytest.raises(TypeError, match="float32"):
        A.flash_fold(q, q, q, m.double(), l, torch.zeros(2, 8, 16))


@pytest.fixture(scope="module")
def qkv():
    return tuple(_normal((B, L, H, D), seed) for seed in (3, 4, 5))


def _grads_jax(fn, q, k, v):
    """fn's output and the gradients of sum(out^2) in q, k, v (jitted)."""

    def probe(q, k, v):
        out, vjp = jax.vjp(fn, q, k, v)
        return out, vjp(2.0 * out.astype(jnp.float32))

    out, grads = jax.jit(probe)(*(jnp.asarray(x) for x in (q, k, v)))
    return np.asarray(out), *(np.asarray(g) for g in grads)


def _grads_port(fn, q, k, v):
    ts = [torch.tensor(x, requires_grad=True) for x in (q, k, v)]
    out = fn(*ts)
    out.float().pow(2).sum().backward()
    return (out.detach().numpy(), *(t.grad.numpy() for t in ts))


@pytest.mark.parametrize("causal", [False, True])
def test_oracle_and_blockwise_match_jax(qkv, causal):
    offs = dict(q_offset=5, k_offset=-3) if causal else {}
    want = np.asarray(joracle(*(jnp.asarray(x) for x in qkv), causal=causal,
                              **offs))
    got = R.attention_oracle(*(torch.from_numpy(x) for x in qkv),
                             causal=causal, **offs)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)
    want = _grads_jax(lambda q, k, v: jblockwise(q, k, v, block_kv=8,
                                                 causal=causal), *qkv)
    got = _grads_port(lambda q, k, v: R.blockwise_attention(
        q, k, v, block_kv=8, causal=causal), *qkv)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, atol=1e-5, rtol=0)


def test_blockwise_rejects_a_block_that_does_not_divide(qkv):
    with pytest.raises(ValueError, match="not divisible"):
        R.blockwise_attention(*(torch.from_numpy(x) for x in qkv),
                              block_kv=5)


# ---------------------------------------------------------------------------
# Worlds of 2 and 4
# ---------------------------------------------------------------------------


def _mesh(world):
    return Mesh(np.array(jax.devices()[:world]), ("data",))


@pytest.fixture(scope="module")
def worlds(qkv, tmp_path_factory):
    """{world: [results of rank 0, rank 1, ...]}, the worlds run side by
    side."""
    tmp = tmp_path_factory.mktemp("ring_attention_worlds")
    np.savez(tmp / "inputs.npz", **{f"ra_{n}": x for n, x in zip("qkv", qkv)})
    with ThreadPoolExecutor(max_workers=len(WORLDS)) as pool:
        futures = {}
        for world in WORLDS:
            out = tmp / f"world{world}"
            out.mkdir()
            futures[world] = pool.submit(
                _spawn, workers.run_ring, world,
                (str(tmp / "inputs.npz"), str(out), ["attention"]), out)
        results = {}
        for world, future in futures.items():
            future.result()
            results[world] = [dict(np.load(tmp / f"world{world}" /
                                           f"rank{r}.npz"))
                              for r in range(world)]
    return results


def _gathered(ranks, key):
    """A quantity of every rank's sequence shard, concatenated along L."""
    return [np.concatenate([res[f"{key}:{name}"] for res in ranks], axis=1)
            for name in ("out", "gq", "gk", "gv")]


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("case", workers.RING_CASES,
                         ids=[f"{i}-{'causal' if c else 'full'}-{n}chunk"
                              for i, c, n in workers.RING_CASES])
def test_ring_attention_matches_jax(qkv, worlds, world, case):
    impl, causal, chunks = case
    fn = jring(_mesh(world), causal=causal, impl=impl,
               transfer_chunks=chunks)
    want = _grads_jax(fn, *qkv)
    got = _gathered(worlds[world], f"ring:{impl}:{causal}:{chunks}")
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, atol=1e-5, rtol=0)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("causal", [False, True])
def test_ulysses_matches_jax(qkv, worlds, world, causal):
    want = _grads_jax(julysses(_mesh(world), causal=causal), *qkv)
    got = _gathered(worlds[world], f"ulysses:{causal}")
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, atol=1e-5, rtol=0)


def _port_comms(res, key):
    """{op: (calls, bytes)} of one case, forward and backward together."""
    out = {}
    for name, value in res.items():
        if name.startswith(f"{key}:fwd_comms:") \
                or name.startswith(f"{key}:bwd_comms:"):
            op = name.rsplit(":", 1)[1]
            calls, nbytes = out.get(op, (0, 0.0))
            out[op] = (calls + int(value[0]), nbytes + float(value[1]))
    return out


def _jax_comms(fn, qkv):
    """The JAX shims' records of tracing ``fn``'s output and gradients."""

    def probe(q, k, v):
        out, vjp = jax.vjp(fn, q, k, v)
        return vjp(2.0 * out.astype(jnp.float32))

    mark = jcomms().totals()
    jax.jit(probe).lower(*(jnp.asarray(x) for x in qkv))
    return {op: rec for (op, _), rec in jcomms().delta(mark).items()
            if op != "pcast"}


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("case", workers.RING_CASES,
                         ids=[f"{i}-{'causal' if c else 'full'}-{n}chunk"
                              for i, c, n in workers.RING_CASES])
def test_ring_comms_follow_the_jax_shims(qkv, worlds, world, case):
    """Each hop records its full payload, one call a chunk. The JAX ring
    also sends each block's positions (the jnp ring (L/P,) int32, the
    flash ring one int32 offset) on every one of its P forward and P
    backward hops, and makes a P-th forward and backward hop of (K, V)
    that only brings the blocks home; the port derives the positions from
    the hop count and skips those two hops."""
    impl, causal, chunks = case
    p, l_loc = world, L // world
    kv_bytes = B * l_loc * H * D * 4
    pos_bytes = 4 * (l_loc if impl == "jnp" else 1)
    jax_rec = _jax_comms(jring(_mesh(world), causal=causal, impl=impl,
                               transfer_chunks=chunks), qkv)
    calls, nbytes = jax_rec["ppermute"]
    skipped = (2 * 2 * chunks + 2 * p,
               2 * 2 * kv_bytes + 2 * p * pos_bytes)
    want = {"ppermute": (calls - skipped[0], nbytes - skipped[1])}
    # forward: P - 1 hops of (K, V); backward: P - 1 of (K, V), P of (dK, dV)
    assert want["ppermute"] == (
        (2 * (p - 1) * 2 + 2 * p) * chunks,
        pytest.approx((4 * (p - 1) + 2 * p) * kv_bytes))
    for res in worlds[world]:
        got = _port_comms(res, f"ring:{impl}:{causal}:{chunks}")
        assert got == {"ppermute": (want["ppermute"][0],
                                    pytest.approx(want["ppermute"][1]))}


@pytest.mark.parametrize("world", WORLDS)
def test_ulysses_comms_equal_the_jax_shims(qkv, worlds, world):
    want = _jax_comms(julysses(_mesh(world)), qkv)
    for res in worlds[world]:
        got = _port_comms(res, "ulysses:False")
        assert got == {op: (c, pytest.approx(b))
                       for op, (c, b) in want.items()}


@pytest.mark.parametrize("world", WORLDS)
def test_ppermute_chunked_is_one_hop_in_chunks(qkv, worlds, world):
    """``ppermute_chunked(x, 1, chunks=3, dim=1)``: rank r receives rank
    r - 1's shard, records three calls of the shard's bytes together; the
    gradient of ``sum(y * (r + 1))`` comes back from rank r + 1."""
    l_loc = L // world
    for r, res in enumerate(worlds[world]):
        src = (r - 1) % world
        np.testing.assert_array_equal(
            res["chunked:y"], qkv[0][:, src * l_loc:(src + 1) * l_loc])
        np.testing.assert_array_equal(res["chunked:grad"],
                                      np.full_like(qkv[0][:, :l_loc],
                                                   (r + 1) % world + 1))
        assert tuple(res["chunked:comms:ppermute"]) == (
            3, B * l_loc * H * D * 4)


def test_rank_processes_import_no_jax(worlds):
    assert not any(bool(res["jax_loaded"]) for world in WORLDS
                   for res in worlds[world])


# ---------------------------------------------------------------------------
# Errors and a world of one
# ---------------------------------------------------------------------------


def test_ring_rejects_what_it_cannot_run():
    with pytest.raises(ValueError, match="unknown ring attention impl"):
        R.make_ring_attention(impl="nope")
    with pytest.raises(ValueError, match="silently"):
        R.make_ring_attention(impl="jnp", block_q=8)
    with pytest.raises(ValueError, match="one tile of 64"):
        R.make_ring_attention(impl="flash", block_q=128)
    with pytest.raises(ValueError, match="one tile of 64"):
        R.make_ring_attention(impl="flash", block_kv=32)
    # the kernels' own tile is accepted
    R.make_ring_attention(impl="flash", block_q=64, block_kv=64)


def test_ulysses_rejects_heads_that_do_not_divide(monkeypatch):
    monkeypatch.setattr(R, "world_size", lambda group=None: 4)
    x = torch.zeros(1, 8, 6, 8)
    with pytest.raises(ValueError, match="divisible"):
        R.make_ulysses_attention()(x, x, x)


@pytest.mark.parametrize("impl", ["jnp", "flash"])
def test_ring_of_one_rank_is_the_oracle(qkv, impl):
    """Without a process group the ring is a world of one: one fold
    forward; backward one fold and the (dK, dV) hop home, which is the
    identity and records its bytes as JAX's ppermute of [(0, 0)] does."""
    fold = A.flash_fold.launches
    got = _grads_port(R.make_ring_attention(causal=True, impl=impl), *qkv)
    want = _grads_port(lambda q, k, v: R.attention_oracle(q, k, v,
                                                           causal=True), *qkv)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, atol=1e-5, rtol=0)
    assert A.flash_fold.launches == fold  # CPU tensors launch nothing
