"""The port's pair-parallel NT-Xent (``--dp-loss pair``) against the JAX
package.

* The plain versions of the shard-pair kernels, ``block_lse_dual`` (#7)
  and ``block_grads_dual`` (#8), against the Pallas functions in
  interpret mode on a tile of 24 rows by 40 columns (D = 32, 64 global
  ids) with scattered ids, shared ids (self entries) and sentinel rows
  and columns, at the JAX package's default blocks and at 16-row blocks
  that R is no multiple of, in fp32 and bf16.
* Spawned gloo worlds of 2, 3 and 4 (``torch_dist_workers.run_pair``, no
  JAX in the ranks; worlds 2 and 4 take the even branch with its
  half-weighted antipodal tile, world 3 the odd one) on a global batch of
  24 views at D = 32: the loss against JAX ``ntxent_loss_pair`` on a mesh
  of as many CPU devices, the gradients against ``jax.grad`` of the JAX
  oracle on the global views, the loss against the port's strip loss in
  the same world; in worlds 2 and 4, two ``make_sharded_train_step(...,
  loss_impl="pair")`` steps of the ``tiny`` ResNet against the same
  world's strip steps, and the step's comms against the JAX pair step's
  shim records on as many devices; ``ntxent-train --dp-loss pair`` in the
  world of 2.
* The schedule's coverage, the dispatch, and a world of one.

Gradient convention (as in test_torch_distributed.py): a rank's gradient
of its shard is P times its share of the global gradient.

Tolerances, fp32: the same fp32 products summed in another order ->
1e-5 on the lse (up to 1/T + log 2N ~ 14) and on the mean losses, 1e-5
on the dual G products (rows of G sum to at most 2 over unit vectors) and
1e-6 on the loss gradients (of size ~1e-2); the train steps as in
``test_torch_resnet.py``, the losses within 1e-5 relative.
"""

from collections import defaultdict
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as P

import ntxent_tpu.ops.ntxent_pallas as jpallas
from ntxent_tpu.ops import oracle as joracle
from ntxent_tpu.parallel.mesh import comms_accounting as jcomms
from ntxent_tpu.parallel.mesh import replicate_state
from ntxent_tpu.parallel.pair import ntxent_loss_pair as jpair
from ntxent_tpu.training.trainer import make_sharded_train_step as jsharded
from ntxent_tpu_torch import cli
from ntxent_tpu_torch.ops import ntxent as N
from ntxent_tpu_torch.parallel import dist_loss, pair

import torch_dist_workers as workers
from test_torch_distributed import _flatten, _mesh, _spawn
from test_torch_resnet import (
    STEP_CONFIG,
    TINY_PROJ,
    assert_same_update,
    jax_tiny_state,
    step_views,
    tiny_port_model,
    tiny_simclr_pair,
)

torch.set_num_threads(1)  # see test_torch_training.py

WORLDS = (2, 3, 4)
STEP_WORLDS = (2, 4)  # the train steps' batch of 8 divides over these
TEMPERATURE = 0.1
GLOBAL, EMBED = 24, 32

# The shard-pair tile: rows 24, columns 40, D = 32, ids out of 64.
TILE_ROWS, TILE_COLS, TILE_D, TOTAL = 24, 40, 32, 64
# JAX blocks: its defaults (columns padded to 128), and 16-row blocks that
# the 24 rows are no multiple of.
BLOCKS = {"default": {}, "ragged": {"block_rows": 16, "block_cols": 128}}
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
CLI_ARGV = ["--device", "cpu", "--model", "tiny", "--image-size", "8",
            "--batch", "8", "--steps", "2", "--log-every", "1",
            "--proj-hidden-dim", "16", "--proj-dim", "8",
            "--synthetic-samples", "16", "--dp-loss", "pair"]


def _unit(rng, n, d):
    z = rng.normal(size=(n, d)).astype(np.float32)
    return z / np.linalg.norm(z, axis=-1, keepdims=True)


def _tile(dtype):
    """(z_rows, z_cols, row ids, column ids, lse_rows, lse_cols) as numpy,
    z rounded to ``dtype``: 8 ids shared by rows and columns (self
    entries), a sentinel row and two sentinel columns."""
    rng = np.random.default_rng(0)
    zr, zc = _unit(rng, TILE_ROWS, TILE_D), _unit(rng, TILE_COLS, TILE_D)
    perm = rng.permutation(TOTAL)
    rid = perm[:TILE_ROWS].astype(np.int32)
    cid = np.concatenate([perm[TILE_ROWS - 8:TILE_ROWS],
                          perm[TILE_ROWS:TILE_ROWS + TILE_COLS - 8]])
    cid = cid.astype(np.int32)
    rid[3] = TOTAL
    cid[[5, 7]] = TOTAL
    lse_r = (rng.normal(size=TILE_ROWS) + 5).astype(np.float32)
    lse_c = (rng.normal(size=TILE_COLS) + 5).astype(np.float32)
    jdt, tdt = DTYPES[dtype]
    zr = np.array(jnp.asarray(zr).astype(jdt).astype(jnp.float32))
    zc = np.array(jnp.asarray(zc).astype(jdt).astype(jnp.float32))
    return zr, zc, rid, cid, lse_r, lse_c


def _as_jax(x, dtype):
    return jnp.asarray(x).astype(DTYPES[dtype][0])


def _as_torch(x, dtype):
    return torch.from_numpy(x).to(DTYPES[dtype][1])


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("blocks", sorted(BLOCKS))
def test_block_lse_dual_plain_matches_jax(blocks, dtype):
    zr, zc, rid, cid, _, _ = _tile(dtype)
    want_r, want_c = jpallas.block_lse_dual(
        _as_jax(zr, dtype), _as_jax(zc, dtype), jnp.asarray(rid),
        jnp.asarray(cid), TEMPERATURE, TOTAL, interpret=True,
        **BLOCKS[blocks])
    got_r, got_c = N.block_lse_dual(
        _as_torch(zr, dtype), _as_torch(zc, dtype), torch.from_numpy(rid),
        torch.from_numpy(cid), TEMPERATURE, TOTAL)
    np.testing.assert_allclose(got_r.numpy(), np.asarray(want_r), atol=1e-5,
                               rtol=0)
    np.testing.assert_allclose(got_c.numpy(), np.asarray(want_c), atol=1e-5,
                               rtol=0)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("blocks", sorted(BLOCKS))
def test_block_grads_dual_plain_matches_jax(blocks, dtype):
    zr, zc, rid, cid, lse_r, lse_c = _tile(dtype)
    want_r, want_c = jpallas.block_grads_dual(
        _as_jax(zr, dtype), _as_jax(zc, dtype), jnp.asarray(rid),
        jnp.asarray(cid), jnp.asarray(lse_r), jnp.asarray(lse_c),
        TEMPERATURE, TOTAL, interpret=True, **BLOCKS[blocks])
    got_r, got_c = N.block_grads_dual(
        _as_torch(zr, dtype), _as_torch(zc, dtype), torch.from_numpy(rid),
        torch.from_numpy(cid), torch.from_numpy(lse_r),
        torch.from_numpy(lse_c), TEMPERATURE, TOTAL)
    np.testing.assert_allclose(got_r.numpy(), np.asarray(want_r), atol=1e-5,
                               rtol=0)
    np.testing.assert_allclose(got_c.numpy(), np.asarray(want_c), atol=1e-5,
                               rtol=0)


def test_dual_kernels_reject_what_they_cannot_take():
    z = torch.zeros(4, 8)
    ids = torch.arange(4, dtype=torch.int32)
    with pytest.raises(ValueError, match="share D"):
        N.block_lse_dual(z, torch.zeros(4, 6), ids, ids, 0.1, 8)
    with pytest.raises(ValueError, match="col_gid"):
        N.block_lse_dual(z, z, ids, ids[:3], 0.1, 8)
    with pytest.raises(ValueError, match="lse_rows"):
        N.block_grads_dual(z, z, ids, ids, torch.zeros(3), torch.zeros(4),
                           0.1, 8)


def test_pair_schedule_covers_every_pair_with_unit_weight():
    """Every unordered pair of shards is walked with total weight 1 over
    the world, at every world size (``tests/test_distributed.py``'s check
    of the JAX schedule), and the port's schedule is the JAX one."""
    from ntxent_tpu.parallel.pair import _tile_schedule as jschedule

    for p in (1, 2, 3, 4, 5, 7, 8, 12, 16):
        assert pair._tile_schedule(p) == jschedule(p)
        weight = defaultdict(float)
        for d in range(p):
            for k, w in pair._tile_schedule(p):
                weight[frozenset((d, (d + k) % p))] += w
        for a in range(p):
            for b in range(a, p):
                assert weight[frozenset((a, b))] == pytest.approx(1.0)


def test_pair_is_resolved_and_only_chunked_is_not_ported():
    """Every schedule resolves since chunked was ported (Queue A 3(d)):
    ``NOT_PORTED`` is gone."""
    assert dist_loss.resolve_local_ntxent("pair") is pair.pair_body
    assert dist_loss.resolve_local_ntxent("chunked") is \
        dist_loss.local_ntxent_chunked
    assert not hasattr(dist_loss, "NOT_PORTED")


# ---------------------------------------------------------------------------
# Worlds of 2, 3 and 4
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def setup():
    """The flax tiny SimCLR model with cross-replica BatchNorm, its
    variables, two steps of global views and the loss inputs."""
    jmodel, variables, _ = tiny_simclr_pair(seed=3, axis_name="data")
    rng = np.random.default_rng(11)
    z = np.stack([_unit(rng, GLOBAL, EMBED) for _ in range(2)])
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
def spawned(setup, tmp_path_factory):
    """Every world started in the background, each waited for by a thread
    through ``_spawn`` (the JAX references run meanwhile); the world of 2
    also runs the CLI. Yields (directory, {world: future})."""
    inputs = setup[3]
    tmp = tmp_path_factory.mktemp("pair_worlds")
    np.savez(tmp / "inputs.npz", **inputs)
    with ThreadPoolExecutor(max_workers=len(WORLDS)) as pool:
        futures = {}
        for world in WORLDS:
            out = tmp / f"world{world}"
            out.mkdir()
            argv = CLI_ARGV if world == 2 else None
            futures[world] = pool.submit(
                _spawn, workers.run_pair, world,
                (str(tmp / "inputs.npz"), str(out), world in STEP_WORLDS,
                 argv), out)
        yield tmp, futures


@pytest.fixture(scope="module")
def worlds(spawned):
    """{world: [results of rank 0, rank 1, ...]} of the port, and the
    ranks' CLI logs of the world of 2 under ``"logs"``."""
    tmp, futures = spawned
    results = {}
    for world, future in futures.items():
        future.result()  # a failed or late world fails here
        results[world] = [dict(np.load(tmp / f"world{world}" /
                                       f"rank{r}.npz"))
                          for r in range(world)]
    results["logs"] = [(tmp / "world2" / f"rank{r}.log").read_text()
                       for r in range(2)]
    return results


@pytest.fixture(scope="module")
def jax_losses(setup, spawned):
    """{world: JAX ``ntxent_loss_pair`` of the global views on a mesh of
    ``world`` devices}, and the JAX oracle's gradient of the global
    views."""
    inputs = setup[3]
    z1, z2 = jnp.asarray(inputs["z1"]), jnp.asarray(inputs["z2"])
    losses = {world: float(jpair(z1, z2, _mesh(world), TEMPERATURE,
                                 interpret=True))
              for world in WORLDS}
    grad = jax.grad(lambda z: joracle.ntxent_loss(z, TEMPERATURE))(
        jnp.concatenate([z1, z2]))
    return losses, np.asarray(grad)


@pytest.fixture(scope="module")
def jax_pair_step_comms(setup, spawned):
    """{world: the JAX pair step's comms on ``world`` devices}, as its
    shims record them while the step is traced (lowered, not run)."""
    jmodel, variables, views, _ = setup
    out = {}
    for world in STEP_WORLDS:
        mesh = _mesh(world)
        state = replicate_state(jax_tiny_state(jmodel, variables), mesh)
        step = jsharded(mesh, STEP_CONFIG["temperature"], interpret=True,
                        loss_impl="pair")
        shard = NamedSharding(mesh, P("data"))
        v1, v2 = (jax.device_put(v, shard) for v in views[0])
        mark = jcomms().totals()
        step.lower(state, v1, v2)
        out[world] = jcomms().delta(mark)
    return out


@pytest.mark.parametrize("world", WORLDS)
def test_pair_loss_matches_jax_pair_loss(worlds, jax_losses, world):
    losses, _ = jax_losses
    for res in worlds[world]:
        np.testing.assert_allclose(res["pair_loss"], losses[world],
                                   atol=1e-5, rtol=0)


@pytest.mark.parametrize("world", WORLDS)
def test_pair_gradients_match_the_jax_oracle(worlds, jax_losses, world):
    _, grad = jax_losses
    n = GLOBAL // world
    for r, res in enumerate(worlds[world]):
        rows = slice(r * n, (r + 1) * n)
        np.testing.assert_allclose(res["pair_g1"] / world, grad[:GLOBAL][rows],
                                   atol=1e-6, rtol=0)
        np.testing.assert_allclose(res["pair_g2"] / world, grad[GLOBAL:][rows],
                                   atol=1e-6, rtol=0)


@pytest.mark.parametrize("world", WORLDS)
def test_pair_loss_equals_the_strip_loss(worlds, world):
    for res in worlds[world]:
        np.testing.assert_allclose(res["pair_loss"], res["strip_loss"],
                                   atol=1e-5, rtol=0)


@pytest.mark.parametrize("world", WORLDS)
def test_pair_loss_comms_follow_the_shim_formulas(worlds, world):
    """One all-gather of the rank's (2n, D) fp32 views, one pmax and one
    psum of the (2N,) lse shares, the psum of the loss and, in the
    backward, the psum of the (2N, D) gradient buffer."""
    p, ar = world, 2 * (world - 1) / world
    two_n, rows = 2 * GLOBAL, 2 * GLOBAL // world
    comms = {key.split(":", 1)[1]: tuple(value)
             for key, value in worlds[world][0].items()
             if key.startswith("pair_loss_comms:")}
    assert comms == {
        "all_gather": (1, (p - 1) * rows * EMBED * 4),
        "pmax": (1, pytest.approx(ar * two_n * 4)),
        "psum": (3, pytest.approx(ar * (two_n * 4 + 4
                                        + two_n * EMBED * 4)))}


def _step_comms(res, prefix):
    return {key.split(":", 1)[1]: tuple(value) for key, value in res.items()
            if key.startswith(f"{prefix}step_comms:")}


@pytest.mark.parametrize("world", STEP_WORLDS)
def test_pair_step_comms_match_the_jax_shims(worlds, jax_pair_step_comms,
                                             world):
    step = _step_comms(worlds[world][0], "pair_")
    jax_comms = jax_pair_step_comms[world]
    assert {op for op, _ in jax_comms} == {"all_gather", "pmax", "psum",
                                           "pmean"}
    # bytes to the last bit of the JAX side's difference of running totals
    for (op, axis), (calls, nbytes) in jax_comms.items():
        assert axis == "data"
        assert step[op] == (calls, pytest.approx(nbytes, rel=1e-12)), op


@pytest.mark.parametrize("world", STEP_WORLDS)
def test_pair_train_steps_equal_the_strip_steps(setup, worlds, world):
    """Two steps from the same flax weights on the same global views
    (``tests/test_distributed.py:330-366`` in JAX): the losses, every
    parameter's change and every running statistic; every rank ends with
    the same state."""
    variables = setup[1]
    ranks = worlds[world]
    res = ranks[0]
    np.testing.assert_allclose(res["pair_losses"], res["strip_losses"],
                               rtol=1e-5, atol=0)

    def model(prefix):
        m = tiny_port_model(variables)
        m.load_state_dict({k[len(prefix) + 6:]: torch.from_numpy(v)
                           for k, v in res.items()
                           if k.startswith(prefix + "state:")})
        return m

    before = {k: v.detach().clone()
              for k, v in tiny_port_model(variables).named_parameters()}
    assert_same_update(model("pair_"), before, model("strip_"))
    for other in ranks[1:]:
        for key, value in res.items():
            if key.startswith(("pair_state:", "pair_losses")):
                np.testing.assert_array_equal(other[key], value, err_msg=key)


def test_rank_processes_import_no_jax(worlds):
    assert not any(bool(res["jax_loaded"]) for world in WORLDS
                   for res in worlds[world])


def test_train_cli_runs_the_pair_loss_in_a_world_of_2(worlds):
    lead, other = worlds["logs"]
    assert "data-parallel over 2 ranks (gloo, pair loss)" in lead
    assert lead.count("loss") >= 3 and "step 2 loss" in lead
    assert "ntxent_tpu_torch.cli" not in other


def test_train_cli_pair_in_a_world_of_one_takes_the_single_card_step(
        monkeypatch, caplog):
    """As the JAX CLI (``cli.py:916-918``): a warning, then the
    single-card step, which launches no shard-pair kernel."""
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    args = cli.build_train_parser().parse_args(CLI_ARGV)
    launches = N.block_lse_dual.launches
    with caplog.at_level("WARNING"):
        _, history = cli.train(args)
    assert "--dp-loss pair ignored: single-device run" in caplog.text
    assert [h["step"] for h in history] == [1, 2]
    assert N.block_lse_dual.launches == launches


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_cuda_dual_kernels_match_plain_versions(dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the shard-pair kernels have no CPU "
                    "mode")
    zr, zc, rid, cid, lse_r, lse_c = (torch.from_numpy(x).cuda()
                                      for x in _tile(dtype))
    zr, zc = zr.to(DTYPES[dtype][1]), zc.to(DTYPES[dtype][1])
    got = (*N.block_lse_dual(zr, zc, rid, cid, TEMPERATURE, TOTAL),
           *N.block_grads_dual(zr, zc, rid, cid, lse_r, lse_c, TEMPERATURE,
                               TOTAL))
    want = (*N.block_lse_dual_plain(zr, zc, rid, cid, TEMPERATURE, TOTAL),
            *N.block_grads_dual_plain(zr, zc, rid, cid, lse_r, lse_c,
                                      TEMPERATURE, TOTAL))
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, atol=2e-4, rtol=0)
