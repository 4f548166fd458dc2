"""The port's two-pass data-parallel InfoNCE (``loss_impl="twopass"``)
against the JAX package.

* The plain versions of #1 and #6 in their InfoNCE mode (``diag_pos=True``
  and a logit scale: ``ntxent_fwd_general_plain``,
  ``ntxent_bwd_general_rows_plain``, ``ntxent_bwd_general_cols_plain``)
  against the Pallas calls themselves in interpret mode (``_fwd_call``,
  ``_bwd_general_call(..., diag_pos=True, scale=)``), on a strip of the
  last rank, on scattered row ids with a padding row (the sentinel id C)
  and on a shape that is no block multiple, in fp32 and bf16.
* ``info_nce_partial_fused``: the partial loss sum and the gradients of
  both operands and of the scale against JAX's, on the CPU's plain
  versions.
* Spawned gloo worlds of 2 and 4 (``torch_dist_workers.run_clip`` with
  ``loss_impl`` "twopass", no JAX in the ranks), one world per size: the
  distributed loss and its gradients against ``make_sharded_infonce(mesh,
  impl="twopass")``; two ``make_sharded_clip_train_step(loss_impl=
  "twopass")`` steps of the tiny CLIP from the same flax weights on the
  same global batches against JAX's step on meshes of as many devices;
  the collective calls and bytes against the JAX shims and their
  formulas: two (N, D) gathers.
* ``resolve_local_infonce("twopass")`` and the exports.

Tolerances, as ``test_torch_clip_dp.py`` states them (bf16 inputs are
exact in fp32 on both sides and are held to the same bounds): the same
fp32 products summed in another order -> 1e-5 absolute plus 1e-5
relative on lse (up to scale + log N ~ 17), on the gradient products and
on the loss sums; the distributed loss 1e-5, the gradients of za and zb
1e-6 (of size ~1e-2), the scale's 1e-5; the train steps 1e-5 on the
losses and each parameter's change within 1e-3 of its norm plus 1e-5
(see ``test_torch_clip_dp.py`` for the AdamW reason).
"""

from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as P

from ntxent_tpu.ops.blocks import choose_blocks
from ntxent_tpu.ops.infonce_pallas import info_nce_partial_fused as jpartial
from ntxent_tpu.ops.ntxent_pallas import (
    _bwd_general_call,
    _fwd_call,
    _gid_column,
    _pad_rows,
)
from ntxent_tpu.parallel.dist_loss import make_sharded_infonce as jinfonce_dp
from ntxent_tpu.parallel.mesh import comms_accounting as jcomms
from ntxent_tpu.parallel.mesh import replicate_state
from ntxent_tpu.training.trainer import make_sharded_clip_train_step as jstep
from ntxent_tpu_torch import ops, parallel
from ntxent_tpu_torch.ops import infonce as I
from ntxent_tpu_torch.ops import ntxent as N
from ntxent_tpu_torch.parallel import dist_loss
from ntxent_tpu_torch.weights import load_flax_variables

import torch_dist_workers as workers
from test_torch_clip import _inputs, _jax_clip, _np, _variables
from test_torch_clip_dp import (
    STEP_CONFIG,
    _assert_same_update,
    _comms,
    _jax_state,
    _rank_model,
    _unit,
)
from test_torch_distributed import _flatten, _mesh, _spawn

torch.set_num_threads(1)  # see test_torch_training.py

WORLDS = (2, 4)
SCALE = np.float32(14.3)  # about CLIP's initial exp(logit_scale)
TOL = dict(atol=1e-5, rtol=1e-5)
N_PAIRS, EMBED = 16, 24  # the distributed loss's global pairs

# (rows, cols, D, ids): the last rank's strip, scattered ids with a
# padding row, rows and columns that are no block multiple.
KERNEL_CASES = {"strip": (8, 24, 16, "strip"),
                "scattered": (12, 20, 48, "scattered"),
                "ragged": (10, 17, 32, "scattered")}


def _row_ids(rows, cols, kind, seed):
    if kind == "strip":
        return np.arange(cols - rows, cols, dtype=np.int32)
    ids = np.random.default_rng(seed).permutation(cols)[:rows]
    ids[-1] = cols  # a padding row: valid_row = 0, no positive
    return ids.astype(np.int32)


def _kernel_inputs(case, dtype):
    rows, cols, d, kind = KERNEL_CASES[case]
    rng = np.random.default_rng(rows + cols + d)
    za, zb = _unit(rng, rows, d), _unit(rng, cols, d)
    if dtype == "bfloat16":  # the same bf16 values on both sides
        za = np.array(jnp.asarray(za, jnp.bfloat16).astype(jnp.float32))
        zb = np.array(jnp.asarray(zb, jnp.bfloat16).astype(jnp.float32))
    return za, zb, _row_ids(rows, cols, kind, seed=d)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(KERNEL_CASES))
def test_plain_infonce_mode_matches_the_pallas_calls(case, dtype):
    za, zb, gid = _kernel_inputs(case, dtype)
    (rows, d), cols = za.shape, zb.shape[0]
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    br, bc = choose_blocks(rows, cols, d, jdt)
    zap, zbp = _pad_rows(jnp.asarray(za, jdt), br), _pad_rows(
        jnp.asarray(zb, jdt), bc)
    common = dict(br=br, bc=bc, inv_t=1.0, cols_actual=cols,
                  n_half=cols // 2, interpret=True, diag_pos=True,
                  scale=jnp.float32(SCALE))
    gid_col = _gid_column(jnp.asarray(gid), br, sentinel=cols)
    loss_j, lse_j = _fwd_call(zap, zbp, gid_col, **common)
    g_rows_j, g_cols_j = _bwd_general_call(zap, zbp, gid_col, lse_j,
                                           **common)

    tdt = getattr(torch, dtype)
    ta, tb = torch.from_numpy(za).to(tdt), torch.from_numpy(zb).to(tdt)
    kw = dict(diag_pos=True, scale=torch.tensor(SCALE))
    args = (ta, tb, torch.from_numpy(gid))
    loss, lse = N.ntxent_fwd_general_plain(*args, 1.0, **kw)
    np.testing.assert_allclose(loss.item(), float(loss_j), **TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(lse_j)[:rows, 0],
                               **TOL)
    # the backward from the same lse on both sides
    lse = torch.from_numpy(np.asarray(lse_j)[:rows, 0].copy())
    np.testing.assert_allclose(
        N.ntxent_bwd_general_rows_plain(*args, lse, 1.0, **kw).numpy(),
        np.asarray(g_rows_j)[:rows], **TOL)
    np.testing.assert_allclose(
        N.ntxent_bwd_general_cols_plain(*args, lse, 1.0, **kw).numpy(),
        np.asarray(g_cols_j)[:cols], **TOL)


def test_wrappers_take_the_infonce_mode_on_cpu_tensors_without_counting():
    za, zb, gid = (torch.from_numpy(x) for x in _kernel_inputs(
        "scattered", "float32"))
    kw = dict(diag_pos=True, scale=torch.tensor(SCALE))
    wrappers = (N.ntxent_fwd_general, N.ntxent_bwd_general_rows,
                N.ntxent_bwd_general_cols)
    counts = [w.launches for w in wrappers]
    loss, lse = N.ntxent_fwd_general(za, zb, gid, 1.0, **kw)
    g_cols = N.ntxent_bwd_general_cols(za, zb, gid, lse, 1.0, **kw)
    assert [w.launches for w in wrappers] == counts
    want = N.ntxent_fwd_general_plain(za, zb, gid, 1.0, **kw)
    torch.testing.assert_close(loss, want[0], atol=0, rtol=0)
    torch.testing.assert_close(
        g_cols, N.ntxent_bwd_general_cols_plain(za, zb, gid, lse, 1.0, **kw),
        atol=0, rtol=0)
    # the NT-Xent mode is the default: the diagonal is masked there
    assert not torch.equal(N.ntxent_fwd_general(za, zb, gid, 1.0)[1], lse)
    with pytest.raises(ValueError, match="scale"):
        N.ntxent_fwd_general(za, zb, gid, 1.0, scale=torch.ones(2))


@pytest.mark.parametrize("case", ["strip", "scattered"])
def test_info_nce_partial_fused_matches_jax(case):
    """The loss sum and the gradients of za, zb and the scale."""
    za, zb, gid = _kernel_inputs(case, "float32")

    def jloss(a, b, s):
        return jpartial(a, b, jnp.asarray(gid), scale=s, interpret=True)

    want_loss, want = jax.value_and_grad(jloss, argnums=(0, 1, 2))(
        jnp.asarray(za), jnp.asarray(zb), jnp.float32(SCALE))
    a, b, s = (torch.from_numpy(za).requires_grad_(),
               torch.from_numpy(zb).requires_grad_(),
               torch.tensor(SCALE, requires_grad=True))
    part = I.info_nce_partial_fused(a, b, torch.from_numpy(gid), scale=s)
    part.backward()
    np.testing.assert_allclose(part.item(), float(want_loss), **TOL)
    for got, ref in zip((a.grad, b.grad, s.grad), want):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


def test_info_nce_partial_fused_skips_unneeded_kernels():
    """Without a scale gradient the columns-only backward runs no rows
    kernel: its gradient reaches z_cols alone."""
    za, zb, gid = (torch.from_numpy(x) for x in _kernel_inputs(
        "strip", "float32"))
    b = zb.clone().requires_grad_()
    I.info_nce_partial_fused(za, b, gid, scale=torch.tensor(SCALE)).backward()
    want = N.ntxent_bwd_general_cols_plain(
        za, zb, gid, N.ntxent_fwd_general_plain(
            za, zb, gid, 1.0, diag_pos=True, scale=torch.tensor(SCALE))[1],
        1.0, diag_pos=True, scale=torch.tensor(SCALE)) * SCALE
    torch.testing.assert_close(b.grad, want, atol=1e-6, rtol=0)


def test_resolve_local_infonce_twopass_and_exports():
    assert dist_loss.resolve_local_infonce("twopass") is \
        dist_loss.local_infonce_allgather
    assert dist_loss.make_sharded_infonce(impl="twopass").func is \
        dist_loss.local_infonce_allgather
    assert parallel.local_infonce_allgather is \
        dist_loss.local_infonce_allgather
    assert ops.info_nce_partial_fused is I.info_nce_partial_fused
    assert not hasattr(dist_loss, "INFONCE_NOT_PORTED")


# ---------------------------------------------------------------------------
# Worlds of 2 and 4
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def setup():
    """The flax tiny CLIP, its variables, two steps of global batches and
    the loss inputs, with the two-pass body named for the ranks."""
    jmodel = _jax_clip()
    variables = _variables(jmodel, seed=18)
    batches = [_inputs(seed=19 + i) for i in range(2)]
    rng = np.random.default_rng(20)
    inputs = {"za": _unit(rng, N_PAIRS, EMBED),
              "zb": _unit(rng, N_PAIRS, EMBED), "scale": SCALE,
              "loss_impl": np.array("twopass"),
              "images": np.stack([b[0] for b in batches]),
              "tokens": np.stack([b[1] for b in batches]),
              **_flatten(variables["params"], "params"),
              **{f"cfg:{k}": np.asarray(v) for k, v in STEP_CONFIG.items()}}
    return jmodel, variables, inputs


@pytest.fixture(scope="module")
def spawned(setup, tmp_path_factory):
    """Both worlds started in the background, each waited for by a thread
    through ``_spawn`` (the JAX references run meanwhile). Yields
    (directory, {world: future})."""
    inputs = setup[2]
    tmp = tmp_path_factory.mktemp("twopass_worlds")
    np.savez(tmp / "inputs.npz", **inputs)
    with ThreadPoolExecutor(max_workers=len(WORLDS)) as pool:
        futures = {}
        for world in WORLDS:
            out = tmp / f"world{world}"
            out.mkdir()
            futures[world] = pool.submit(
                _spawn, workers.run_clip, world,
                (str(tmp / "inputs.npz"), str(out), None), out)
        yield tmp, futures


@pytest.fixture(scope="module")
def worlds(spawned):
    """{world: [results of rank 0, rank 1, ...]} of the port."""
    tmp, futures = spawned
    results = {}
    for world, future in futures.items():
        future.result()  # a failed or late world fails here
        results[world] = [dict(np.load(tmp / f"world{world}" /
                                       f"rank{r}.npz"))
                          for r in range(world)]
    return results


@pytest.fixture(scope="module")
def jax_losses(setup, spawned):
    """{world: (loss, [grad za, grad zb, grad scale], comms of the trace)}
    of JAX's ``make_sharded_infonce(impl="twopass")`` on a mesh of
    ``world`` devices."""
    inputs = setup[2]
    out = {}
    for world in WORLDS:
        loss_fn = jinfonce_dp(_mesh(world), impl="twopass", interpret=True)
        mark = jcomms().totals()
        loss, grads = jax.value_and_grad(
            lambda a, b, s: loss_fn(a, b, s), argnums=(0, 1, 2))(
                jnp.asarray(inputs["za"]), jnp.asarray(inputs["zb"]),
                jnp.float32(SCALE))
        out[world] = (float(loss), [np.asarray(g) for g in grads],
                      jcomms().delta(mark))
    return out


@pytest.fixture(scope="module")
def jax_steps(setup, spawned):
    """{world: (losses, final flax params, the comms of the step's trace)}
    of two JAX sharded CLIP steps with ``loss_impl="twopass"``."""
    jmodel, variables, inputs = setup
    out = {}
    for world in WORLDS:
        m = _mesh(world)
        state = replicate_state(_jax_state(jmodel, variables["params"]), m)
        step = jstep(m, interpret=True, loss_impl="twopass")
        shard = NamedSharding(m, P("data"))
        losses, comms = [], None
        for images, tokens in zip(inputs["images"], inputs["tokens"]):
            mark = jcomms().totals()
            state, metrics = step(state, jax.device_put(images, shard),
                                  jax.device_put(tokens, shard))
            comms = comms or jcomms().delta(mark)  # the first call traces
            losses.append(float(metrics["loss"]))
        out[world] = (losses, _np(state.params), comms)
    return out


@pytest.mark.parametrize("world", WORLDS)
def test_twopass_loss_and_gradients_match_jax(jax_losses, worlds, world):
    loss_j, (ga, gb, gs), _ = jax_losses[world]
    ranks = worlds[world]
    n = N_PAIRS // world
    for r, res in enumerate(ranks):
        np.testing.assert_allclose(res["loss"], loss_j, atol=1e-5, rtol=0)
        rows = slice(r * n, (r + 1) * n)
        # each rank differentiates its own copy of the psum'd loss: P
        # times its share (test_torch_clip_dp.py)
        np.testing.assert_allclose(res["ga"] / world, ga[rows], atol=1e-6,
                                   rtol=0)
        np.testing.assert_allclose(res["gb"] / world, gb[rows], atol=1e-6,
                                   rtol=0)
    np.testing.assert_allclose(np.mean([res["gs"] for res in ranks]), gs,
                               atol=1e-5, rtol=0)


@pytest.mark.parametrize("world", WORLDS)
def test_twopass_clip_step_matches_jax(setup, jax_steps, worlds, world):
    """Two steps from the same flax weights on the same global batches:
    the port's world against JAX on a mesh of as many devices; every rank
    ends with the same parameters."""
    variables = setup[1]
    losses_j, params_j, _ = jax_steps[world]
    ranks = worlds[world]
    np.testing.assert_allclose(ranks[0]["losses"], losses_j, atol=1e-5,
                               rtol=0)
    want = load_flax_variables(workers.tiny_clip(), {"params": params_j})
    _assert_same_update(_rank_model(ranks[0]), variables, want)
    for res in ranks[1:]:
        for key, value in ranks[0].items():
            if key.startswith(("state:", "losses", "loss")):
                np.testing.assert_array_equal(res[key], value, err_msg=key)


@pytest.mark.parametrize("world", WORLDS)
def test_twopass_comms_match_the_jax_shims_and_their_formulas(
        worlds, jax_losses, jax_steps, world):
    """Calls and bytes per device as the JAX shims record them, and their
    formulas: two all-gathers of a (B/P, D) fp32 shard, (P - 1) shards
    each, the psum of the loss (an all-reduce, 2 (P - 1) / P of the
    payload) and, in the step, one pmean of every gradient."""
    res = worlds[world][0]
    for got, want in ((_comms(res, "loss_comms"), jax_losses[world][2]),
                      (_comms(res, "step_comms"), jax_steps[world][2])):
        assert {op for op, _ in want} == set(got)
        for (op, axis), (calls, nbytes) in want.items():
            assert axis == "data"
            assert got[op] == (calls, nbytes), op
    p, ar = world, 2 * (world - 1) / world
    gather = (p - 1) * N_PAIRS // p * EMBED * 4
    assert _comms(res, "loss_comms") == {"all_gather": (2, 2 * gather),
                                         "psum": (1, ar * 4)}
    batch, embed = STEP_CONFIG["batch_size"], workers.TINY_CLIP["width"]
    params = sum(t.numel() for t in workers.tiny_clip().parameters())
    assert _comms(res, "step_comms") == {
        "all_gather": (2, 2 * (p - 1) * batch // p * embed * 4),
        "psum": (1, ar * 4),
        "pmean": (1, ar * 4 * params)}


def test_rank_processes_import_no_jax(worlds):
    assert not any(bool(res["jax_loaded"]) for world in WORLDS
                   for res in worlds[world])
