"""The port's collectives under the wire policy (``parallel.mesh`` with
``parallel.precision.collective_precision``) against the JAX shims
(``ntxent_tpu/parallel/mesh.py:412-905``), after ``tests/test_quant.py``.

Spawned gloo worlds of 2 and 4 (``torch_dist_workers.run_wire``, no JAX
in the ranks) run every wire dtype through the shims while the JAX
references run on meshes of as many CPU devices:

* the tiled all-gather: its value (int8: every rank's rows quantized and
  dequantized, bit for bit the JAX gather's; bf16 within bf16
  rounding), its recorded wire bytes and calls (payload plus float32
  scales under int8, half the bytes under bf16), and the gradient of a
  probe through it (int8: the straight-through estimator, equal to the
  float32 gradient; float32 against ``jax.grad``);
* the pmean at P = 2 and 4: the two-phase int8 all-reduce's value
  (JAX's bar: within 5% of the largest float32 value; against the JAX
  int8 pmean within one float32 ulp of the summed chunks) and its
  bytes (under half the float32 wire's at every P), the logical op name
  kept;
* ``psum_scatter`` (int8 within 5% of float32, as JAX's bar);
* a scalar and an int32 psum under int8 exact;
* the dtype-labelled registry series beside the unlabelled totals;
* a backward on another thread than its forward (whose thread-local
  policy is float32) honours the forward's policy: the pair loss under
  int8 (its backward psum quantizes) and a bf16 gather (a bf16
  reduce-scatter) give the same gradient bits as on one thread; the
  pair loss's int8 gradient against ``jax.grad`` of the JAX pair loss
  under the int8 policy.

Gradient convention (test_torch_distributed.py): a rank's gradient of
its shard is P times its share of the global gradient.
"""

from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from ntxent_tpu.parallel import mesh as jmesh
from ntxent_tpu.parallel.pair import make_pair_ntxent as jpair
from ntxent_tpu.parallel.precision import collective_precision as jprec

import torch_dist_workers as workers
from test_torch_distributed import _mesh, _spawn

torch.set_num_threads(1)  # see test_torch_training.py

WORLDS = (2, 4)
ROWS = 2  # rows a rank holds of each payload
WIRES = workers.WIRE_DTYPES
PAIR_N, PAIR_D = 16, 64  # the pair buffer (2N, D) clears the int8 floor


def _inputs(world: int) -> dict:
    rng = np.random.default_rng(world)
    gx = rng.standard_normal((world * ROWS, 1024)).astype(np.float32)
    gx /= np.linalg.norm(gx, axis=-1, keepdims=True)
    z = rng.standard_normal((2, PAIR_N, PAIR_D)).astype(np.float32)
    z /= np.linalg.norm(z, axis=-1, keepdims=True)
    return {"gx": gx,
            "rx": rng.standard_normal((world * ROWS, 2048)).astype(
                np.float32),
            "sx": rng.standard_normal((world * ROWS, 512)).astype(np.float32),
            "bx": rng.standard_normal((world * ROWS, 256)).astype(np.float32),
            "ones": np.ones((world * ROWS, 4), np.float32),
            "z1": z[0], "z2": z[1]}


@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("wire_worlds")
    with ThreadPoolExecutor(max_workers=len(WORLDS)) as pool:
        futures = {}
        for world in WORLDS:
            out = tmp / f"world{world}"
            out.mkdir()
            np.savez(out / "inputs.npz", **_inputs(world))
            futures[world] = pool.submit(
                _spawn, workers.run_wire, world,
                (str(out / "inputs.npz"), str(out),
                 ["collectives", "backward_thread"]), out)
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
    return results


def _comms(res, prefix):
    return {key.rsplit(":", 1)[1]: tuple(float(x) for x in value)
            for key, value in res.items() if key.startswith(prefix + ":")}


def _jax_run(world, body, x, out_specs=P(), in_specs=P("data")):
    """(value, comms the shims recorded) of a jitted shard_map."""
    mark = jmesh.comms_accounting().totals()
    f = jax.jit(jmesh.shard_map(body, mesh=_mesh(world), in_specs=in_specs,
                                out_specs=out_specs, check_vma=False))
    value = np.asarray(f(x))
    return value, {op: (float(c), float(b)) for (op, _), (c, b)
                   in jmesh.comms_accounting().delta(mark).items()}


@pytest.fixture(scope="module")
def jax_refs(spawned):
    """Per world and wire dtype: the JAX gather, pmean and psum_scatter
    values and comms, the gather probe's gradient, the pair loss's int8
    gradient."""
    refs = {}
    for world in WORLDS:
        inp = _inputs(world)
        for wire in WIRES:
            def gather(z, wire=wire):
                with jprec(wire):
                    return jmesh.all_gather(z, "data", tiled=True)

            def mean(z, wire=wire):
                with jprec(wire):
                    return jmesh.pmean(z, "data")

            def scatter(z, wire=wire):
                with jprec(wire):
                    return jmesh.psum_scatter(z, "data", scatter_dimension=0,
                                              tiled=True)

            def probe(z, wire=wire):
                with jprec(wire):
                    g = jmesh.all_gather(z, "data", tiled=True)
                return jmesh.psum(jnp.sum(g * jnp.arange(
                    g.shape[0], dtype=jnp.float32)[:, None]), "data")

            refs[world, wire, "gather"] = _jax_run(world, gather, inp["gx"])
            refs[world, wire, "pmean"] = _jax_run(world, mean, inp["rx"])
            refs[world, wire, "scatter"] = _jax_run(
                world, scatter, inp["sx"], out_specs=P("data"), in_specs=P())
            f = jmesh.shard_map(probe, mesh=_mesh(world), in_specs=P("data"),
                                out_specs=P(), check_vma=False)
            refs[world, wire, "grad"] = np.asarray(jax.jit(jax.grad(f))(
                inp["gx"]))
        loss = jpair(_mesh(world), 0.1, interpret=True)

        def pair_int8(a, b, loss=loss):
            with jprec("int8"):
                return loss(a, b)

        refs[world, "pair"] = np.asarray(jax.grad(pair_int8)(
            jnp.asarray(inp["z1"]), jnp.asarray(inp["z2"])))
    return refs


def _global(ranks, key):
    return np.concatenate([res[key] for res in ranks])


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("wire", WIRES)
def test_gather_value_and_wire_bytes_match_jax(worlds, jax_refs, world,
                                               wire):
    want, jax_comms = jax_refs[world, wire, "gather"]
    for res in worlds[world]:
        got = res[f"gather:{wire}"]
        if wire == "bf16":
            np.testing.assert_allclose(got, want, atol=4e-3, rtol=0)
        else:  # float32 moves the rows, int8 the same quantized rows
            np.testing.assert_array_equal(got, want)
        assert _comms(res, f"gather_comms:{wire}") == jax_comms
    x = _inputs(world)["gx"]
    if wire == "int8":
        assert 0 < np.abs(worlds[world][0]["gather:int8"] - x).max() < 0.02
    f32 = (world - 1) * ROWS * 1024 * 4
    nbytes = jax_comms["all_gather"][1]
    assert nbytes == {"float32": f32, "bf16": f32 / 2,
                      "int8": (world - 1) * ROWS * (1024 + 4)}[wire]


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("wire", WIRES)
def test_gather_gradient_matches_jax_and_int8_is_straight_through(
        worlds, jax_refs, world, wire):
    got = _global(worlds[world], f"gather_grad:{wire}") / world
    want = jax_refs[world, wire, "grad"]
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    if wire == "int8":  # the STE backward is the float32 reduce-scatter
        np.testing.assert_array_equal(
            got, _global(worlds[world], "gather_grad:float32") / world)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("wire", WIRES)
def test_pmean_value_and_bytes_match_jax(worlds, jax_refs, world, wire):
    want, jax_comms = jax_refs[world, wire, "pmean"]
    f32 = jax_refs[world, "float32", "pmean"][0]
    for res in worlds[world]:
        got = res[f"pmean:{wire}"]
        tol = {"float32": 1e-6, "bf16": 3e-2, "int8": 1e-6}[wire]
        np.testing.assert_allclose(got, want, atol=tol * np.abs(want).max(),
                                   rtol=0)
        assert _comms(res, f"pmean_comms:{wire}") == jax_comms
    got = worlds[world][0][f"pmean:{wire}"]
    assert np.abs(got - f32).max() / np.abs(f32).max() < 0.05
    if wire == "int8":
        assert set(jax_comms) == {"pmean"}  # the op name survives
        f32_bytes = jax_refs[world, "float32", "pmean"][1]["pmean"][1]
        assert f32_bytes / jax_comms["pmean"][1] >= 2.0
        assert jax_comms["pmean"][0] == 4  # two phases, payload + scales


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("wire", WIRES)
def test_psum_scatter_matches_jax(worlds, jax_refs, world, wire):
    want = jax_refs[world, wire, "scatter"][0]
    got = _global(worlds[world], f"scatter:{wire}")
    assert got.shape == want.shape
    tol = {"float32": 1e-6, "bf16": 3e-2, "int8": 1e-6}[wire]
    np.testing.assert_allclose(got, want, atol=tol * np.abs(want).max(),
                               rtol=0)
    f32 = jax_refs[world, "float32", "scatter"][0]
    assert np.abs(got - f32).max() / np.abs(f32).max() < 0.05


@pytest.mark.parametrize("world", WORLDS)
def test_small_and_integer_payloads_pass_through_exact(worlds, world):
    for res in worlds[world]:
        assert float(res["exact"]) == world * ROWS * 4 + world * 6


@pytest.mark.parametrize("world", WORLDS)
def test_bf16_halves_the_bytes_and_keeps_the_dtype(worlds, world):
    res = worlds[world][0]
    assert str(res["bf16_gather_dtype"]) == "torch.float32"
    calls, nbytes = _comms(res, "bf16_comms")["all_gather"]
    assert (calls, nbytes) == (1, (world - 1) * ROWS * 256 * 2)


@pytest.mark.parametrize("world", WORLDS)
def test_dtype_labels_itemize_and_the_unlabelled_totals_survive(worlds,
                                                                world):
    prom = str(worlds[world][0]["prometheus"]).splitlines()
    lines = [ln for ln in prom if ln.startswith("collective_bytes_total")
             and 'op="pmean"' in ln]
    assert any('dtype="int8"' in ln for ln in lines), lines
    assert any('dtype="float32"' in ln for ln in lines), lines
    assert any('dtype="bfloat16"' in ln for ln in lines), lines
    unlabelled = [ln for ln in lines if "dtype=" not in ln]
    labelled = [ln for ln in lines if "dtype=" in ln]
    assert len(unlabelled) == 1 and float(unlabelled[0].rsplit(" ", 1)[1]) \
        == pytest.approx(sum(float(ln.rsplit(" ", 1)[1])
                             for ln in labelled))


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("name", ["pair", "gather"])
def test_a_backward_on_another_thread_keeps_the_forward_policy(worlds, world,
                                                               name):
    for res in worlds[world]:
        same, thread = res[f"{name}:same:g1"], res[f"{name}:thread:g1"]
        np.testing.assert_array_equal(thread, same)
        assert np.abs(same - res[f"{name}:float32:g1"]).max() > 0


@pytest.mark.parametrize("world", WORLDS)
def test_pair_loss_int8_gradient_matches_jax(worlds, jax_refs, world):
    """The int8 pair loss: a gathered z quantized per row and the
    backward's (2N, D) psum on the two-phase schedule, in both packages;
    a gradient element near a rounding boundary may take the other int8
    step, so the bar is 1% of the largest gradient."""
    got = _global(worlds[world], "pair:same:g1") / world
    want = jax_refs[world, "pair"]
    assert np.abs(got - want).max() <= 1e-2 * np.abs(want).max()
