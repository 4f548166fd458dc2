"""The port's data-parallel path over ``torch.distributed`` against the JAX
package's ``shard_map`` path on a CPU mesh.

Worlds of 2 and 4 gloo ranks, each a spawned process that meets the
others over a ``FileStore`` in ``tmp_path`` (no TCP port) and imports no
JAX (``torch_dist_workers.py``), run:

* ``ntxent_loss_distributed`` of the same global views and its
  gradients, held to the JAX ``ntxent_loss_distributed`` on a mesh of as
  many CPU devices (the Pallas kernels in interpret mode);
* two ``make_sharded_train_step`` steps of the ``tiny`` ResNet SimCLR
  model from the same flax weights on the same global views, held to the
  JAX ``make_sharded_train_step`` on a 4-device mesh, to each other and to
  the single-card step (a world of one): cross-replica BatchNorm makes
  the step device-count invariant;
* the per-step comms accounting, held to the JAX shims' records;
* ``ntxent-train`` itself under a world of 2.

Gradient convention: every rank differentiates its own copy of the
psum'd loss, so a rank's gradient of its shard is P times its share of
the global gradient, as inside JAX's ``shard_map`` (its psum transposes
to a psum); the train step's pmean divides it back.

Tolerances (fp32): the same arithmetic summed in another order -> 1e-5
on losses, 1e-6 on the loss gradients (of size ~1e-2); the train steps as
in ``test_torch_resnet.py``. Ranks of one world hold bitwise-identical
parameters after a step.
"""

import multiprocessing
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, NamedSharding
from jax.sharding import PartitionSpec as P

from ntxent_tpu.parallel.dist_loss import ntxent_loss_distributed as jdist
from ntxent_tpu.parallel.mesh import comms_accounting as jcomms
from ntxent_tpu.parallel.mesh import replicate_state
from ntxent_tpu.training.trainer import make_sharded_train_step as jsharded
from ntxent_tpu_torch.training import trainer as ttrain

import torch_dist_workers as workers
from test_torch_resnet import (
    STEP_CONFIG,
    TINY_PROJ,
    _np,
    assert_same_update,
    jax_tiny_state,
    step_views,
    tiny_port_model,
    tiny_simclr_pair,
)

torch.set_num_threads(1)  # see test_torch_training.py

WORLDS = (2, 4)
TEMPERATURE = 0.1
# One deadline for a whole world, shared by all its ranks (a world of 2
# takes under 15 s alone); each rank's collectives give up after
# workers.PG_TIMEOUT, well before it.
WORLD_DEADLINE_S = 120


def _spawn(target, world, args, tmp):
    """Start ``world`` ranks of ``target(rank, world, store, *args)`` and
    wait for all of them until one shared deadline, WORLD_DEADLINE_S after
    the start. At the deadline every rank still running is killed and the
    test fails naming them; a rank that exits non-zero fails it too."""
    ctx = multiprocessing.get_context("spawn")
    store = str(tmp / "store")
    procs = [ctx.Process(target=target, args=(r, world, store, *args))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + WORLD_DEADLINE_S
    try:
        for p in procs:
            p.join(max(0.0, deadline - time.monotonic()))
        hung = [r for r, p in enumerate(procs) if p.is_alive()]
        if hung:
            pytest.fail(f"ranks {hung} of a world of {world} did not finish "
                        f"within the world's deadline of {WORLD_DEADLINE_S} "
                        "s; all were killed")
        codes = [p.exitcode for p in procs]
        assert codes == [0] * world, f"rank exit codes {codes}"
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
        for p in procs:
            p.join()


def _flatten(tree, prefix):
    out = {}
    for key, node in tree.items():
        path = f"{prefix}/{key}"
        out |= _flatten(node, path) if isinstance(node, dict) else {
            path: np.asarray(node)}
    return out


@pytest.fixture(scope="module")
def setup():
    """The flax tiny SimCLR model with cross-replica BatchNorm, its
    variables, two steps of global views and the loss inputs."""
    jmodel, variables, _ = tiny_simclr_pair(seed=3, axis_name="data")
    rng = np.random.default_rng(4)
    z = rng.normal(size=(2, 16, 24)).astype(np.float32)
    z /= np.linalg.norm(z, axis=-1, keepdims=True)
    views = step_views(2, seed=5)
    inputs = {"z1": z[0], "z2": z[1], "t": np.float32(TEMPERATURE),
              "proj": np.array(TINY_PROJ),
              "v1": np.stack([v[0] for v in views]),
              "v2": np.stack([v[1] for v in views]),
              **_flatten(variables["params"], "params"),
              **_flatten(variables["batch_stats"], "batch_stats"),
              **{f"cfg:{k}": np.asarray(v) for k, v in STEP_CONFIG.items()}}
    return jmodel, variables, views, inputs


@pytest.fixture(scope="module")
def worlds(setup, tmp_path_factory):
    """{world: [results of rank 0, rank 1, ...]} of the port."""
    inputs = setup[3]
    tmp = tmp_path_factory.mktemp("worlds")
    np.savez(tmp / "inputs.npz", **inputs)
    results = {}
    for world in WORLDS:
        out = tmp / f"world{world}"
        out.mkdir()
        _spawn(workers.run, world, (str(tmp / "inputs.npz"), str(out)), out)
        results[world] = [dict(np.load(out / f"rank{r}.npz"))
                          for r in range(world)]
    return results


def _mesh(world):
    return Mesh(np.array(jax.devices()[:world]), ("data",))


@pytest.mark.parametrize("world", WORLDS)
def test_distributed_loss_and_gradients_match_jax(setup, worlds, world):
    inputs = setup[3]
    z1, z2 = jnp.asarray(inputs["z1"]), jnp.asarray(inputs["z2"])
    loss_j, (g1_j, g2_j) = jax.value_and_grad(
        lambda a, b: jdist(a, b, _mesh(world), TEMPERATURE, interpret=True),
        argnums=(0, 1))(z1, z2)
    ranks = worlds[world]
    n = z1.shape[0] // world
    for r, res in enumerate(ranks):
        np.testing.assert_allclose(res["loss"], float(loss_j), atol=1e-5,
                                   rtol=0)
        rows = slice(r * n, (r + 1) * n)
        np.testing.assert_allclose(res["g1"] / world, np.asarray(g1_j)[rows],
                                   atol=1e-6, rtol=0)
        np.testing.assert_allclose(res["g2"] / world, np.asarray(g2_j)[rows],
                                   atol=1e-6, rtol=0)


@pytest.fixture(scope="module")
def jax_steps(setup):
    """Two JAX sharded steps on a 4-device mesh: (losses, final flax
    variables, the comms the step's trace recorded)."""
    jmodel, variables, views, _ = setup
    mesh = _mesh(4)
    state = replicate_state(jax_tiny_state(jmodel, variables), mesh)
    step = jsharded(mesh, STEP_CONFIG["temperature"], interpret=True)
    shard = NamedSharding(mesh, P("data"))
    losses, comms = [], None
    for v1, v2 in views:
        mark = jcomms().totals()
        state, metrics = step(state, jax.device_put(v1, shard),
                              jax.device_put(v2, shard))
        comms = comms or jcomms().delta(mark)  # the first call traces
        losses.append(float(metrics["loss"]))
    return losses, {"params": _np(state.params),
                    "batch_stats": _np(state.batch_stats)}, comms


def _rank_model(res, variables):
    """A port model holding the state a rank wrote."""
    model = tiny_port_model(variables)
    model.load_state_dict({k[len("state:"):]: torch.from_numpy(v)
                           for k, v in res.items()
                           if k.startswith("state:")})
    return model


def _initial(variables):
    return {k: v.detach().clone()
            for k, v in tiny_port_model(variables).named_parameters()}


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_train_step_matches_jax(setup, worlds, jax_steps, world):
    """JAX on a 4-device mesh; the port in worlds of 2 and 4 (the loss and
    the update are the same at every device count)."""
    variables = setup[1]
    losses_j, want, _ = jax_steps
    res = worlds[world][0]
    np.testing.assert_allclose(res["losses"], losses_j, atol=1e-5, rtol=0)
    assert_same_update(_rank_model(res, variables), _initial(variables),
                       tiny_port_model(want))


@pytest.mark.parametrize("world", WORLDS)
def test_ranks_end_with_identical_state(worlds, world):
    ranks = worlds[world]
    for res in ranks[1:]:
        for key, value in ranks[0].items():
            if key.startswith(("state:", "losses")):
                np.testing.assert_array_equal(res[key], value, err_msg=key)


def test_world_of_4_equals_a_world_of_one(setup, worlds):
    """The single-card step (what a world of one runs) from the same
    weights on the same global views."""
    _, variables, views, _ = setup
    model = tiny_port_model(variables)
    state = ttrain.create_train_state(
        model, ttrain.TrainerConfig(**STEP_CONFIG), torch.device("cpu"))
    step = ttrain.make_train_step(STEP_CONFIG["temperature"], use_fused=True)
    losses = [float(step(state, torch.from_numpy(v1),
                         torch.from_numpy(v2))[1]["loss"])
              for v1, v2 in views]
    res = worlds[4][0]
    np.testing.assert_allclose(res["losses"], losses, atol=1e-5, rtol=0)
    assert_same_update(_rank_model(res, variables), _initial(variables),
                       model)


def _step_comms(res):
    return {key.split(":", 1)[1]: tuple(value) for key, value in res.items()
            if key.startswith("step_comms:")}


def test_comms_accounting_matches_the_jax_shims(worlds, jax_steps):
    """A world of 4 against the JAX step on 4 devices: the loss's
    all-gathers and psum and the step's gradient and statistics pmeans,
    calls and bytes, as the shims record them."""
    step = _step_comms(worlds[4][0])
    _, _, jax_comms = jax_steps
    assert {op for op, _ in jax_comms} == {"all_gather", "psum", "pmean"}
    for (op, axis), (calls, nbytes) in jax_comms.items():
        assert axis == "data"
        assert step[op] == (calls, nbytes), op


@pytest.mark.parametrize("world", WORLDS)
def test_comms_accounting_follows_the_shim_formulas(setup, worlds, world):
    """Per step: two all-gathers of a (B/P, D) fp32 view, (P - 1) shards
    each; the psum of the loss and, as all-reduces at 2 (P - 1) / P of
    the payload, the pmean of every gradient and of every running
    statistic, and cross-replica BatchNorm's mean and variance of each of
    its 6 norms (stem, the block's 3, its shortcut's, the head's), which
    flax issues past the shims."""
    step = _step_comms(worlds[world][0])
    p, ar = world, 2 * (world - 1) / world
    model = tiny_port_model(setup[1])
    rows = STEP_CONFIG["batch_size"] // p
    params = sum(t.numel() for t in model.parameters())
    stats = sum(t.numel() for t in model.buffers())
    channels = [m.weight.numel() for m in model.modules()
                if type(m).__name__ == "BatchNorm"]
    assert len(channels) == 6
    assert step == {
        "all_gather": (2, 2 * (p - 1) * rows * TINY_PROJ[1] * 4),
        "psum": (1, ar * 4),
        "pmean": (2, ar * 4 * (params + stats)),
        "bn_pmean": (2 * len(channels), ar * 4 * 2 * sum(channels))}


def test_rank_processes_import_no_jax(worlds):
    assert not any(bool(res["jax_loaded"]) for ranks in worlds.values()
                   for res in ranks)


CLI_ARGV = ["train", "--device", "cpu", "--model", "tiny", "--image-size",
            "8", "--batch", "8", "--steps", "2", "--log-every", "1",
            "--proj-hidden-dim", "16", "--proj-dim", "8",
            "--synthetic-samples", "16"]


def test_train_cli_runs_in_a_world_of_2_and_logs_only_on_rank_0(tmp_path):
    _spawn(workers.run_cli, 2, (CLI_ARGV[1:], str(tmp_path)), tmp_path)
    lead = (tmp_path / "rank0.log").read_text()
    assert "data-parallel over 2 ranks (gloo, strip loss)" in lead
    assert lead.count("loss") >= 3 and "step 2 loss" in lead
    assert (tmp_path / "rank1.log").read_text() == ""
