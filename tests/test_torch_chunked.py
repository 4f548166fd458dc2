"""The port's chunked ring-overlap NT-Xent (``--dp-loss chunked``) and its
ring-chunk autotune against the JAX package, after ``tests/test_overlap.py``.

Spawned gloo worlds of 2 and 4 (``torch_dist_workers.run_wire``, no JAX
in the ranks) on a global batch of 32 views at D = 256 (every chunk of a
rank's 2n = 2 * 32 / P rows clears the int8 floor of 1024 elements):

* ``local_ntxent_chunked`` (``parallel.ring._RingLseSum``: ``block_lse``
  per chunk and hop, ``block_grads`` in the second ring pass; here their
  plain versions) at chunks 1, 3 and 4 in float32 and under int8: the
  loss and the gradients of both views against JAX
  ``make_sharded_ntxent(impl="chunked")`` on a mesh of as many CPU
  devices (float32: 1e-5 on the loss, 1e-6 on gradients of size ~1e-2;
  int8: every hop re-quantizes the chunk it received, in both packages,
  so the folded blocks are the same int8 values and the bars are 1e-5 and
  1e-5, a gradient near a rounding boundary being the only source of a
  larger gap); the plain ring fold with chunks against the same loss;
* the forward's recorded bytes: the ring's ppermutes move exactly the
  strip loss's two all-gathers, (P - 1) 2n D 4 bytes a rank in float32
  and the int8 payload plus its per-row float32 scales under int8, and
  equal the JAX shims' records call for call;
* ``measure_comms_overlap`` end to end in the world;
* ``ntxent-train --dp-loss chunked --ring-chunks 2 --measure-overlap``
  in the world of 2, its parameters after 3 steps within 1e-5 of the
  same world's strip run (chunked is the strip loss summed in another
  order), and ``--ring-chunks`` warned and ignored with ``--dp-loss
  strip``.

And here: the orphan ``ring_chunks`` rejection and the autotune
contract (the heuristic is JAX's and pure, an explicit count is
clamped, the CPU resolution is deterministic, a cached vote is served
without measuring, an off-card sweep measures nothing).

Gradient convention (test_torch_distributed.py): a rank's gradient of
its shard is P times its share of the global gradient.
"""

import json
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ntxent_tpu.ops import autotune as jautotune
from ntxent_tpu.parallel import mesh as jmesh
from ntxent_tpu.parallel.dist_loss import make_sharded_ntxent as jsharded
from ntxent_tpu.parallel.precision import collective_precision as jprec
from ntxent_tpu_torch.ops import autotune
from ntxent_tpu_torch.parallel import dist_loss
from ntxent_tpu_torch.training import trainer as ttrain
from ntxent_tpu_torch.utils import msgpack

import torch_dist_workers as workers
from test_torch_distributed import _mesh, _spawn

torch.set_num_threads(1)  # see test_torch_training.py

WORLDS = (2, 4)
GLOBAL, EMBED = 32, 256
TEMPERATURE = 0.1
CASES = workers.CHUNKED_CASES
CLI_ARGV = ["--device", "cpu", "--model", "tiny", "--image-size", "8",
            "--batch", "8", "--steps", "3", "--log-every", "1",
            "--proj-hidden-dim", "16", "--proj-dim", "8",
            "--synthetic-samples", "16", "--warmup-steps", "1"]


def _unit(rng, n, d):
    z = rng.normal(size=(n, d)).astype(np.float32)
    return z / np.linalg.norm(z, axis=-1, keepdims=True)


def _cli_runs(out):
    """(log name, argv) of the CLI runs in the world of 2."""
    def run(name, *flags):
        return (name, CLI_ARGV + ["--ckpt-dir", str(out / name)] + list(flags))

    return [run("chunked", "--dp-loss", "chunked", "--ring-chunks", "2",
                "--measure-overlap"),
            run("strip", "--ring-chunks", "2")]


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(20)
    return {"z1": _unit(rng, GLOBAL, EMBED), "z2": _unit(rng, GLOBAL, EMBED),
            "t": np.float32(TEMPERATURE)}


@pytest.fixture(scope="module")
def spawned(setup, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("chunked_worlds")
    np.savez(tmp / "inputs.npz", **setup)
    with ThreadPoolExecutor(max_workers=len(WORLDS)) as pool:
        futures = {}
        for world in WORLDS:
            out = tmp / f"world{world}"
            out.mkdir()
            runs = _cli_runs(out) if world == 2 else None
            futures[world] = pool.submit(
                _spawn, workers.run_wire, world,
                (str(tmp / "inputs.npz"), str(out), ["chunked"], runs), out)
        yield tmp, futures


@pytest.fixture(scope="module")
def worlds(spawned):
    tmp, futures = spawned
    results = {}
    for world, future in futures.items():
        future.result()
        results[world] = [dict(np.load(tmp / f"world{world}" /
                                       f"rank{r}.npz"))
                          for r in range(world)]
    results["dir"] = tmp / "world2"
    return results


def _jax_case(world, impl, chunks, wire, z1, z2):
    """(loss, (g1, g2), forward comms) of the JAX loss."""
    loss_fn = jsharded(_mesh(world), TEMPERATURE, impl=impl,
                       ring_chunks=chunks, interpret=True)

    def f(a, b):
        with jprec(wire):
            return loss_fn(a, b)

    mark = jmesh.comms_accounting().totals()
    loss = float(jax.jit(f)(z1, z2))
    comms = {op: (float(c), float(b)) for (op, _), (c, b)
             in jmesh.comms_accounting().delta(mark).items()
             if op != "pcast"}  # a type annotation: no data moves
    grads = jax.jit(jax.grad(f, argnums=(0, 1)))(z1, z2)
    return loss, [np.asarray(g) for g in grads], comms


@pytest.fixture(scope="module")
def jax_refs(setup, spawned):
    z1, z2 = jnp.asarray(setup["z1"]), jnp.asarray(setup["z2"])
    refs = {}
    for world in WORLDS:
        for chunks, wire in CASES:
            refs[world, chunks, wire] = _jax_case(world, "chunked", chunks,
                                                  wire, z1, z2)
        for wire in ("float32", "int8"):
            refs[world, "strip", wire] = _jax_case(world, "strip", None,
                                                   wire, z1, z2)
    return refs


def _rows(ranks, key):
    return np.concatenate([res[key] for res in ranks])


def _port_comms(res, key):
    return {name.rsplit(":", 1)[1]: tuple(float(x) for x in v)
            for name, v in res.items() if name.startswith(f"{key}:comms:")}


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("chunks,wire", CASES)
def test_chunked_loss_and_gradients_match_jax(worlds, jax_refs, world,
                                              chunks, wire):
    loss, (g1, g2), _ = jax_refs[world, chunks, wire]
    ranks = worlds[world]
    key = f"chunked:{chunks}:{wire}"
    for res in ranks:
        np.testing.assert_allclose(res[f"{key}:loss"], loss, atol=1e-5,
                                   rtol=0)
    gtol = 1e-6 if wire == "float32" else 1e-5
    np.testing.assert_allclose(_rows(ranks, f"{key}:g1") / world, g1,
                               atol=gtol, rtol=0)
    np.testing.assert_allclose(_rows(ranks, f"{key}:g2") / world, g2,
                               atol=gtol, rtol=0)


@pytest.mark.parametrize("world", WORLDS)
def test_plain_ring_fold_with_chunks_matches_the_chunked_loss(worlds,
                                                              jax_refs,
                                                              world):
    loss, (g1, _), _ = jax_refs[world, 3, "float32"]
    ranks = worlds[world]
    for res in ranks:
        np.testing.assert_allclose(res["jnp:3:float32:loss"], loss,
                                   atol=1e-5, rtol=0)
    np.testing.assert_allclose(_rows(ranks, "jnp:3:float32:g1") / world, g1,
                               atol=1e-6, rtol=0)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("chunks,wire", CASES)
def test_forward_bytes_equal_the_strip_gathers_and_the_jax_shims(
        worlds, jax_refs, world, chunks, wire):
    res = worlds[world][0]
    got = _port_comms(res, f"chunked:{chunks}:{wire}")
    strip = _port_comms(res, f"strip:None:{wire}")
    assert got == jax_refs[world, chunks, wire][2]
    assert strip == jax_refs[world, "strip", wire][2]
    n_local = GLOBAL // world
    rows = 2 * n_local
    f32 = (world - 1) * rows * EMBED * 4
    want = f32 if wire == "float32" else (world - 1) * rows * (EMBED + 4)
    assert got["ppermute"][1] == strip["all_gather"][1] == want
    hops = (world - 1) * min(chunks, rows)
    assert got["ppermute"][0] == (hops if wire == "float32" else 2 * hops)
    assert set(got) == {"ppermute", "psum"}


@pytest.mark.parametrize("world", WORLDS)
def test_measure_comms_overlap_runs_in_the_world(worlds, world):
    for res in worlds[world]:
        overlap = json.loads(str(res["overlap"]))
        assert set(overlap) == {"monolithic_ms", "chunked_ms", "overlap_ms",
                                "overlap_frac", "chunks", "backend"}
        assert overlap["chunks"] == 2 and overlap["backend"] == "cpu"
        assert overlap["monolithic_ms"] > 0 and overlap["chunked_ms"] > 0
        assert overlap["overlap_ms"] == max(
            overlap["monolithic_ms"] - overlap["chunked_ms"], 0.0)
        assert 0.0 <= overlap["overlap_frac"] < 1.0


def _params(ckpt_dir, step):
    tree = msgpack.from_bytes((ckpt_dir / str(step) / "state.msgpack")
                              .read_bytes())
    out = {}

    def walk(node, path):
        for k, v in node.items():
            if isinstance(v, dict):
                walk(v, path + (k,))
            else:
                out[path + (k,)] = np.asarray(v)

    walk(tree["params"], ())
    return out


def test_train_cli_chunked_in_a_world_of_2_matches_the_strip_run(worlds):
    out = worlds["dir"]
    lead = (out / "chunked.rank0.log").read_text()
    assert "data-parallel over 2 ranks (gloo, chunked loss)" in lead
    assert "comms overlap A/B: {'monolithic_ms'" in lead
    assert "step 3 loss" in lead
    assert (out / "chunked.rank1.log").read_text() == ""
    strip = (out / "strip.rank0.log").read_text()
    assert "--ring-chunks 2 ignored: --dp-loss strip has no ring" in strip
    got, want = _params(out / "chunked", 3), _params(out / "strip", 3)
    assert got.keys() == want.keys()
    for path, value in want.items():
        np.testing.assert_allclose(got[path], value, atol=1e-5, rtol=0,
                                   err_msg="/".join(path))


def test_orphan_ring_chunks_are_rejected():
    with pytest.raises(ValueError, match="ring_chunks"):
        ttrain.make_sharded_train_step(None, 0.1, loss_impl="strip",
                                       ring_chunks=4)
    with pytest.raises(ValueError, match="ring_chunks"):
        ttrain.make_sharded_train_step(None, 0.1, loss_impl="pair",
                                       ring_chunks=2)
    ttrain.make_sharded_train_step(None, 0.1, loss_impl="chunked",
                                   ring_chunks=4)
    assert dist_loss.make_sharded_ntxent(
        None, impl="chunked", ring_chunks=3).keywords["chunks"] == 3
    assert "chunks" not in dist_loss.make_sharded_ntxent(
        None, impl="strip", ring_chunks=3).keywords


@pytest.mark.parametrize("rows,dim,p,itemsize", [
    (4, 8, 1, 4), (64, 128, 8, 4), (512, 128, 4, 4), (2048, 512, 8, 4),
    (1, 512, 4, 4), (3, 65536, 2, 4), (256, 128, 2, 2), (8192, 128, 16, 4)])
def test_ring_chunk_heuristic_is_jax_s_pure_and_capped(rows, dim, p,
                                                       itemsize):
    got = autotune.choose_ring_chunks(rows, dim, p, itemsize)
    assert got == jautotune.choose_ring_chunks(rows, dim, p, itemsize)
    assert got == autotune.choose_ring_chunks(rows, dim, p, itemsize)
    assert 1 <= got <= min(8, max(rows, 1))
    if p <= 1:
        assert got == 1


@pytest.fixture
def fresh_cache(tmp_path, monkeypatch):
    monkeypatch.setenv("NTXENT_TORCH_CACHE", str(tmp_path))
    autotune.clear_cache()
    yield tmp_path
    autotune.clear_cache()


def test_explicit_ring_chunks_are_clamped(fresh_cache):
    assert autotune.resolve_ring_chunks(16, 128, 4, chunks=0) == 1
    assert autotune.resolve_ring_chunks(16, 128, 4, chunks=5) == 5
    assert autotune.resolve_ring_chunks(16, 128, 4, chunks=99) == 16
    assert autotune.resolve_ring_chunks(1, 128, 4, chunks=8) == 1


def test_cpu_resolution_is_the_deterministic_heuristic(fresh_cache):
    for rows, dim, p in [(512, 128, 4), (64, 128, 8), (2048, 512, 8)]:
        want = autotune.choose_ring_chunks(rows, dim, p)
        assert autotune.resolve_ring_chunks(rows, dim, p) == want
        assert autotune.resolve_ring_chunks(rows, dim, p) == want
    assert not autotune.cache_path().exists()


def test_a_cached_vote_is_served_without_measuring(fresh_cache,
                                                   monkeypatch):
    def no_timing(*a, **k):
        raise AssertionError("resolve_ring_chunks must not measure")

    monkeypatch.setattr(autotune, "time_loss", no_timing)
    key = autotune._key(512, 128, 4, torch.float32)
    autotune._store(key, 16)
    autotune.clear_cache()  # only the disk holds the vote now
    assert autotune.resolve_ring_chunks(512, 128, 4) == 16
    assert autotune.resolve_ring_chunks(512, 128, 4, chunks=2) == 2
    assert json.loads(autotune.cache_path().read_text()) == {
        autotune._disk_key(key): 16}
    autotune.clear_cache(disk=True)
    assert not autotune.cache_path().exists()
    assert autotune.resolve_ring_chunks(512, 128, 4) == \
        autotune.choose_ring_chunks(512, 128, 4)


def test_an_off_card_sweep_measures_nothing(fresh_cache, monkeypatch):
    def no_timing(*a, **k):
        raise AssertionError("no measurement off the card")

    monkeypatch.setattr(autotune, "time_loss", no_timing)
    got = autotune.autotune_ring_chunks(None, 256, 128, device="cpu")
    assert got == autotune.choose_ring_chunks(512, 128, 1)
    assert not autotune.cache_path().exists()
