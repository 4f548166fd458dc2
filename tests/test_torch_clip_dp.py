"""The port's data-parallel CLIP slice against the JAX package.

* The plain versions of the data-parallel InfoNCE kernels
  (``ops.infonce``: the rectangular stats-only forward of #9, the
  cross-modal rows backward of #5, the columns backward #4) against the
  Pallas calls themselves in interpret mode (``_dual_fwd_call(...,
  stats_only=True)``, ``_bwd_sym_call(..., diag_pos=True, z_cols=,
  lse_cols=)``, ``_bwd_sym_cols_call``) on padded, ragged and
  scattered-id shapes (one row a padding row with the sentinel id N), in
  fp32 and bf16.
* ``info_nce_dual_partial`` (the partial loss sum and the gradients of
  za, zb and the scale) in a gloo world of one joined by this process,
  against JAX's inside a one-device ``shard_map``, under both of JAX's
  backward branches: the shared-G kernel (#10) and, with the VMEM budget
  patched to 0 inside the test, the two-kernel fallback (#5 cross-modal
  and #4) that the port runs at every N.
* Spawned gloo worlds of 2 and 4 (``torch_dist_workers.run_clip``, no
  JAX in the ranks), one world per size: the distributed loss and its
  gradients against ``make_sharded_infonce(impl="dual")`` on 2- and
  4-device meshes; two ``make_sharded_clip_train_step``
  steps of the tiny CLIP (the JAX CLI's ``--model tiny`` towers, width
  32) from the same flax weights on the same global batches against
  JAX's step on meshes of as many devices; the world of 4 against the
  single-card loss and step; identical ranks; comms counts and bytes
  against the JAX shims and their formulas; ``ntxent-train --objective
  clip`` in the world of 2, logging only on rank 0.
* The rank-sharded paired loader against JAX's ``shard_index`` /
  ``shard_count``, and the CLI's refusals.

Gradient convention (as in test_torch_distributed.py): every rank
differentiates its own copy of the psum'd loss, so a rank's gradient of
its shard, and of the replicated scale, is P times its share; the train
step's pmean divides it back.

Tolerances, fp32 (bf16 inputs are exact in fp32 on both sides and are
held to the same bounds):

* kernels and ``info_nce_dual_partial``: the same fp32 products summed
  in another order -> 1e-5 absolute plus 1e-5 relative on lse (up to
  scale + log N ~ 19), on the G products and on the loss sums;
* the distributed loss: 1e-5 on the mean loss, 1e-6 on the gradients of
  za and zb (of size ~1e-2) and 1e-5 on the scale's;
* the train steps: 1e-5 on the losses; each parameter's change over the
  two steps within 1e-3 of its norm plus 1e-5: step 1 runs at the
  warmup's lr of 0, and AdamW's step 2 divides each gradient by its own
  root mean square, so a gradient entry near 0 turns a summation-order
  difference of 1e-7 relative into an update difference of up to the lr
  (1e-3) on that entry. The attention key biases have a gradient of 0
  in exact arithmetic (each row's softmax is invariant to the shift
  q . b_k common to all its keys), so both frameworks' updates of them
  are AdamW steps of rounding noise: they are held to AdamW's step bound,
  2 lr an entry, not to each other. Every other parameter measured within
  7e-5 of its norm.
"""

import datetime
import re
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import Mesh, NamedSharding
from jax.sharding import PartitionSpec as P

import ntxent_tpu.ops.infonce_pallas as jinfonce
from ntxent_tpu.ops.blocks import choose_blocks, round_up
from ntxent_tpu.ops.infonce_pallas import _dual_bwd_fits, _dual_fwd_call
from ntxent_tpu.ops.infonce_pallas import info_nce_dual_partial as jpartial
from ntxent_tpu.ops.ntxent_pallas import (
    _bwd_sym_call,
    _bwd_sym_cols_call,
    _gid_column,
    _pad_rows,
)
from ntxent_tpu.parallel.dist_loss import make_sharded_infonce as jinfonce_dp
from ntxent_tpu.parallel.mesh import comms_accounting as jcomms
from ntxent_tpu.parallel.mesh import replicate_state
from ntxent_tpu.parallel.mesh import shard_map as jshard_map
from ntxent_tpu.training.datasets import PairedArrayLoader as JaxPaired
from ntxent_tpu.training.lars import cosine_warmup_schedule as jax_schedule
from ntxent_tpu.training.trainer import TrainState
from ntxent_tpu.training.trainer import make_sharded_clip_train_step as jstep
from ntxent_tpu_torch import cli
from ntxent_tpu_torch.ops import infonce as I
from ntxent_tpu_torch.parallel import dist_loss, mesh
from ntxent_tpu_torch.training import datasets as tdata
from ntxent_tpu_torch.training import trainer as ttrain
from ntxent_tpu_torch.weights import load_flax_variables

import torch_dist_workers as workers
from test_torch_clip import _inputs, _jax_clip, _np, _variables
from test_torch_distributed import _flatten, _mesh, _spawn

torch.set_num_threads(1)  # see test_torch_training.py

WORLDS = (2, 4)
BRANCHES = ("shared_g", "fallback")
SCALE = np.float32(1 / 0.07)  # CLIP's initial exp(logit_scale)
TOL = dict(atol=1e-5, rtol=1e-5)
STEP_CONFIG = dict(batch_size=8, base_lr=1e-3, weight_decay=1e-4,
                   warmup_steps=1, total_steps=10)
N_PAIRS, EMBED = 16, 24  # the distributed loss's global pairs


def _unit(rng, n, d):
    z = rng.normal(size=(n, d)).astype(np.float32)
    return z / np.linalg.norm(z, axis=-1, keepdims=True)


def _branch(monkeypatch, branch):
    """JAX's backward branch of the dual partial: the shared-G kernel
    (the default VMEM budget) or the two-kernel fallback (budget 0)."""
    if branch == "fallback":
        monkeypatch.setattr(jinfonce, "VMEM_BUDGET_BYTES", 0)


# ---------------------------------------------------------------------------
# The plain kernels against the Pallas calls
# ---------------------------------------------------------------------------

# (rows, cols, D, ids): block-aligned rows of the last rank, a padded
# strip whose sizes are no block multiple, scattered ids with a padding
# row.
KERNEL_CASES = {"aligned": (16, 64, 32, "strip"),
                "padded": (10, 40, 24, "strip"),
                "scattered": (12, 50, 16, "scattered")}


def _row_ids(rows, cols, kind, seed):
    if kind == "strip":
        return np.arange(cols - rows, cols, dtype=np.int32)
    ids = np.random.default_rng(seed).permutation(cols)[:rows]
    ids[-1] = cols  # a padding row: valid_row = 0, no positive
    return ids.astype(np.int32)


def _kernel_inputs(case, dtype):
    rows, cols, d, kind = KERNEL_CASES[case]
    rng = np.random.default_rng(rows + cols)
    za, zb = _unit(rng, rows, d), _unit(rng, cols, d)
    if dtype == "bfloat16":  # the same bf16 values on both sides
        za = np.array(jnp.asarray(za, jnp.bfloat16).astype(jnp.float32))
        zb = np.array(jnp.asarray(zb, jnp.bfloat16).astype(jnp.float32))
    return za, zb, _row_ids(rows, cols, kind, seed=d)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(KERNEL_CASES))
def test_plain_kernels_match_the_pallas_calls(case, dtype):
    za, zb, gid = _kernel_inputs(case, dtype)
    (rows, d), cols = za.shape, zb.shape[0]
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    br, bc = choose_blocks(rows, cols, d, jdt)
    zap, zbp = _pad_rows(jnp.asarray(za, jdt), br), _pad_rows(
        jnp.asarray(zb, jdt), bc)
    _, lse_a, lse_b = _dual_fwd_call(
        zap, zbp, jnp.float32(SCALE), br=br, bc=bc, rows_actual=rows,
        cols_actual=cols, interpret=True, stats_only=True)
    lse_a, lse_b = np.array(lse_a[:rows, 0]), np.array(lse_b[:cols, 0])
    common = dict(br=br, bc=bc, inv_t=1.0, cols_actual=cols, n_half=0,
                  interpret=True, diag_pos=True, scale=jnp.float32(SCALE))
    gid_col = _gid_column(jnp.asarray(gid), br, sentinel=cols)
    lse_ap = _pad_rows(jnp.asarray(lse_a).reshape(rows, 1), br)
    lse_bp = _pad_rows(jnp.asarray(lse_b).reshape(cols, 1), bc)
    o_a = _bwd_sym_call(zap, gid_col, lse_ap, z_cols=zbp, lse_cols=lse_bp,
                        **common)[:rows]
    o_b = _bwd_sym_cols_call(zap, zbp, gid_col, lse_ap, lse_bp,
                             **common)[:cols]

    tdt = getattr(torch, dtype)
    ta, tb = torch.from_numpy(za).to(tdt), torch.from_numpy(zb).to(tdt)
    tg, scale = torch.from_numpy(gid), torch.tensor(SCALE)
    got_a, got_b = I.infonce_dual_fwd_rect_plain(ta, tb, scale)
    np.testing.assert_allclose(got_a.numpy(), lse_a, **TOL)
    np.testing.assert_allclose(got_b.numpy(), lse_b, **TOL)
    # the backward from the same lse on both sides
    la, lb = torch.from_numpy(lse_a), torch.from_numpy(lse_b)
    np.testing.assert_allclose(
        I.infonce_bwd_rows_plain(ta, tb, tg, scale, la, lb).numpy(),
        np.asarray(o_a), **TOL)
    np.testing.assert_allclose(
        I.infonce_bwd_cols_plain(ta, tb, tg, scale, la, lb).numpy(),
        np.asarray(o_b), **TOL)


def test_cpu_tensors_take_the_plain_versions_without_counting():
    za, zb, gid = (torch.from_numpy(x) for x in _kernel_inputs(
        "scattered", "float32"))
    scale = torch.tensor(SCALE)
    wrappers = (I.infonce_dual_fwd_rect, I.infonce_bwd_rows,
                I.infonce_bwd_cols)
    counts = [w.launches for w in wrappers]
    lse_a, lse_b = I.infonce_dual_fwd_rect(za, zb, scale)
    o_a = I.infonce_bwd_rows(za, zb, gid, scale, lse_a, lse_b)
    o_b = I.infonce_bwd_cols(za, zb, gid, scale, lse_a, lse_b)
    assert [w.launches for w in wrappers] == counts
    assert o_a.shape == za.shape and o_b.shape == zb.shape
    want = I.infonce_dual_fwd_rect_plain(za, zb, scale)
    torch.testing.assert_close(lse_b, want[1], atol=0, rtol=0)
    torch.testing.assert_close(
        o_b, I.infonce_bwd_cols_plain(za, zb, gid, scale, *want), atol=0,
        rtol=0)


def test_input_checks():
    za, zb, gid, s = (torch.zeros(4, 8), torch.zeros(9, 8),
                      torch.zeros(4, dtype=torch.int32), torch.tensor(1.0))
    with pytest.raises(ValueError):
        I.infonce_dual_fwd_rect(za, torch.zeros(9, 7), s)
    with pytest.raises(ValueError):
        I.infonce_dual_fwd_rect(torch.zeros(0, 8), zb, s)
    with pytest.raises(ValueError):
        I.info_nce_dual_partial(za, zb, gid[:3], scale=s)
    # what only the CUDA wrappers check
    with pytest.raises(ValueError, match=r"\(9,\)"):
        I._bwd_side("cols", I.infonce_bwd_cols, za, zb, gid, s,
                    torch.zeros(4), torch.zeros(8))


# ---------------------------------------------------------------------------
# info_nce_dual_partial in a world of one
# ---------------------------------------------------------------------------


@pytest.fixture
def group_of_one(tmp_path):
    """A gloo world of one joined by this process for one test."""
    mesh.init_from_file(tmp_path / "store", 0, 1, device="cpu",
                        timeout=datetime.timedelta(seconds=60))
    yield
    mesh.shutdown()


def _jax_partial(za, zb, gid):
    """JAX's info_nce_dual_partial in a one-device shard_map: the loss
    part and its gradients for za, zb and the scale."""
    one = Mesh(np.array(jax.devices()[:1]), ("data",))

    def loss(a, b, s):
        body = jshard_map(
            lambda a, b, g, s: jpartial(a, b, g, "data", scale=s,
                                        interpret=True),
            mesh=one, in_specs=(P(), P(), P(), P()), out_specs=P(),
            check_vma=False)
        return body(a, b, jnp.asarray(gid), s)

    value, grads = jax.value_and_grad(loss, argnums=(0, 1, 2))(
        jnp.asarray(za), jnp.asarray(zb), jnp.float32(SCALE))
    return float(value), [np.asarray(g) for g in grads]


@pytest.mark.parametrize("branch", BRANCHES)
def test_info_nce_dual_partial_matches_jax(group_of_one, monkeypatch,
                                           branch):
    """Ragged rows x columns with scattered global row ids."""
    za, zb, gid = _kernel_inputs("scattered", "float32")
    # every row of a partial loss is a real pair: no padding row here
    gid[-1] = np.setdiff1d(np.arange(zb.shape[0]), gid)[0]
    _branch(monkeypatch, branch)
    (rows, d), cols = za.shape, zb.shape[0]
    br, bc = choose_blocks(rows, cols, d, jnp.float32)
    assert _dual_bwd_fits(round_up(rows, br), round_up(cols, bc), d, br,
                          bc) == (branch == "shared_g")
    want_loss, want = _jax_partial(za, zb, gid)

    a, b, s = (torch.from_numpy(za).requires_grad_(),
               torch.from_numpy(zb).requires_grad_(),
               torch.tensor(SCALE, requires_grad=True))
    mark = mesh.comms_accounting().totals()
    part = I.info_nce_dual_partial(a, b, torch.from_numpy(gid), scale=s)
    part.backward()
    np.testing.assert_allclose(part.item(), want_loss, **TOL)
    for got, ref in zip((a.grad, b.grad, s.grad), want):
        np.testing.assert_allclose(got.numpy(), ref, **TOL)
    # the column-lse merge, recorded once (by the forward)
    assert {op: c for (op, _), (c, _) in
            mesh.comms_accounting().delta(mark).items()} == {"pmax": 1,
                                                             "psum": 1}


# ---------------------------------------------------------------------------
# Worlds of 2 and 4
# ---------------------------------------------------------------------------

CLI_ARGV = ["--objective", "clip", "--model", "tiny", "--device", "cpu",
            "--image-size", "16", "--token-len", "16", "--vocab-size",
            "100", "--batch", "8", "--steps", "2", "--synthetic-samples",
            "24", "--warmup-steps", "1", "--base-lr", "1e-3",
            "--log-every", "1"]


@pytest.fixture(scope="module")
def setup():
    """The flax tiny CLIP, its variables, two steps of global batches and
    the loss inputs."""
    jmodel = _jax_clip()
    variables = _variables(jmodel, seed=8)
    batches = [_inputs(seed=9 + i) for i in range(2)]
    rng = np.random.default_rng(10)
    inputs = {"za": _unit(rng, N_PAIRS, EMBED),
              "zb": _unit(rng, N_PAIRS, EMBED), "scale": SCALE,
              "images": np.stack([b[0] for b in batches]),
              "tokens": np.stack([b[1] for b in batches]),
              **_flatten(variables["params"], "params"),
              **{f"cfg:{k}": np.asarray(v) for k, v in STEP_CONFIG.items()}}
    return jmodel, variables, inputs


@pytest.fixture(scope="module")
def spawned(setup, tmp_path_factory):
    """Both worlds started in the background, each waited for by a thread
    through ``_spawn`` (the JAX references run meanwhile); the world of 2
    also runs the CLI. Yields (directory, {world: future})."""
    inputs = setup[2]
    tmp = tmp_path_factory.mktemp("clip_worlds")
    np.savez(tmp / "inputs.npz", **inputs)
    with ThreadPoolExecutor(max_workers=len(WORLDS)) as pool:
        futures = {}
        for world in WORLDS:
            out = tmp / f"world{world}"
            out.mkdir()
            argv = CLI_ARGV if world == 2 else None
            futures[world] = pool.submit(
                _spawn, workers.run_clip, world,
                (str(tmp / "inputs.npz"), str(out), argv), out)
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
    """{world: (loss, [grad za, grad zb, grad scale], comms of the trace)}
    of JAX's ``make_sharded_infonce(impl="dual")`` on a mesh of ``world``
    devices (the shared-G branch: the fallback's function is held to the
    port's in a world of one above)."""
    inputs = setup[2]
    out = {}
    for world in WORLDS:
        loss_fn = jinfonce_dp(_mesh(world), impl="dual", interpret=True)
        mark = jcomms().totals()
        loss, grads = jax.value_and_grad(
            lambda a, b, s: loss_fn(a, b, s), argnums=(0, 1, 2))(
                jnp.asarray(inputs["za"]), jnp.asarray(inputs["zb"]),
                jnp.float32(SCALE))
        out[world] = (float(loss), [np.asarray(g) for g in grads],
                      jcomms().delta(mark))
    return out


@pytest.mark.parametrize("world", WORLDS)
def test_distributed_loss_and_gradients_match_jax(jax_losses, worlds,
                                                  world):
    loss_j, (ga, gb, gs), _ = jax_losses[world]
    ranks = worlds[world]
    n = N_PAIRS // world
    for r, res in enumerate(ranks):
        np.testing.assert_allclose(res["loss"], loss_j, atol=1e-5, rtol=0)
        rows = slice(r * n, (r + 1) * n)
        np.testing.assert_allclose(res["ga"] / world, ga[rows], atol=1e-6,
                                   rtol=0)
        np.testing.assert_allclose(res["gb"] / world, gb[rows], atol=1e-6,
                                   rtol=0)
    # each rank holds P times its share of the scale's gradient
    np.testing.assert_allclose(np.mean([res["gs"] for res in ranks]), gs,
                               atol=1e-5, rtol=0)


def _jax_state(jmodel, params):
    tx = optax.adamw(jax_schedule(STEP_CONFIG["base_lr"],
                                  STEP_CONFIG["warmup_steps"],
                                  STEP_CONFIG["total_steps"]),
                     weight_decay=STEP_CONFIG["weight_decay"])
    return TrainState.create(apply_fn=jmodel.apply,
                             params=jax.tree.map(jnp.array, params), tx=tx)


@pytest.fixture(scope="module")
def jax_steps(setup, spawned):
    """{world: (losses, final flax params, the comms of the step's trace)}
    of two JAX sharded CLIP steps on a mesh of ``world`` devices."""
    jmodel, variables, inputs = setup
    out = {}
    for world in WORLDS:
        m = _mesh(world)
        state = replicate_state(_jax_state(jmodel, variables["params"]), m)
        step = jstep(m, interpret=True)
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


def _rank_model(res):
    model = workers.tiny_clip()
    model.load_state_dict({k[len("state:"):]: torch.from_numpy(v)
                           for k, v in res.items()
                           if k.startswith("state:")})
    return model


def _assert_same_update(model, variables, want):
    """Each parameter's change from the flax variables equals that of the
    port model ``want`` (see the module docstring for the bound)."""
    before = dict(load_flax_variables(workers.tiny_clip(),
                                      variables).named_parameters())
    want_params = dict(want.named_parameters())
    for name, p in model.named_parameters():
        delta = (p - before[name]).detach()
        want_delta = (want_params[name] - before[name]).detach()
        if name.endswith("attn.key.bias"):  # a gradient of 0: noise
            bound = 2 * STEP_CONFIG["base_lr"]
            assert float(delta.abs().max()) <= bound, name
            assert float(want_delta.abs().max()) <= bound, name
            continue
        err = float((delta - want_delta).norm())
        assert err <= 1e-3 * float(want_delta.norm()) + 1e-5, (name, err)


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_clip_step_matches_jax(setup, jax_steps, worlds, world):
    """Two steps from the same flax weights on the same global batches:
    the port's world against JAX on a mesh of as many devices."""
    variables = setup[1]
    losses_j, params_j, _ = jax_steps[world]
    res = worlds[world][0]
    np.testing.assert_allclose(res["losses"], losses_j, atol=1e-5, rtol=0)
    want = load_flax_variables(workers.tiny_clip(), {"params": params_j})
    _assert_same_update(_rank_model(res), variables, want)


@pytest.mark.parametrize("world", WORLDS)
def test_ranks_end_with_identical_state(worlds, world):
    ranks = worlds[world]
    for res in ranks[1:]:
        for key, value in ranks[0].items():
            if key.startswith(("state:", "losses", "loss")):
                np.testing.assert_array_equal(res[key], value, err_msg=key)


def test_world_of_4_equals_a_world_of_one(setup, worlds):
    """The single-card loss (``info_nce_fused``) of the same global pairs
    and the single-card CLIP step (what a world of one runs) from the
    same weights on the same global batches, its kernels' plain
    versions on the CPU."""
    _, variables, inputs = setup
    ranks = worlds[4]
    a, b, s = (torch.from_numpy(inputs["za"]).requires_grad_(),
               torch.from_numpy(inputs["zb"]).requires_grad_(),
               torch.tensor(SCALE, requires_grad=True))
    loss = I.info_nce_fused(a, b, scale=s)
    loss.backward()
    np.testing.assert_allclose(ranks[0]["loss"], loss.item(), atol=1e-5,
                               rtol=0)
    np.testing.assert_allclose(
        np.concatenate([res["ga"] for res in ranks]) / 4, a.grad.numpy(),
        atol=1e-6, rtol=0)
    np.testing.assert_allclose(
        np.concatenate([res["gb"] for res in ranks]) / 4, b.grad.numpy(),
        atol=1e-6, rtol=0)
    np.testing.assert_allclose(np.mean([res["gs"] for res in ranks]),
                               s.grad.item(), atol=1e-5, rtol=0)

    model = load_flax_variables(workers.tiny_clip(), variables)
    state = ttrain.create_clip_train_state(
        model, ttrain.TrainerConfig(**STEP_CONFIG), torch.device("cpu"))
    step = ttrain.make_clip_train_step(use_fused=True)
    losses = [float(step(state, torch.from_numpy(images),
                         torch.from_numpy(tokens).long())[1]["loss"])
              for images, tokens in zip(inputs["images"], inputs["tokens"])]
    np.testing.assert_allclose(ranks[0]["losses"], losses, atol=1e-5,
                               rtol=0)
    _assert_same_update(_rank_model(ranks[0]), variables, model)


def _comms(res, prefix):
    return {key.split(":", 1)[1]: tuple(value) for key, value in res.items()
            if key.startswith(prefix + ":")}


@pytest.mark.parametrize("world", WORLDS)
def test_comms_accounting_matches_the_jax_shims(worlds, jax_losses,
                                                jax_steps, world):
    """Calls and bytes per device of the loss alone and of the train step,
    as the JAX shims record them on a mesh of as many devices."""
    res = worlds[world][0]
    want_loss = jax_losses[world][2]
    for got, want in ((_comms(res, "loss_comms"), want_loss),
                      (_comms(res, "step_comms"), jax_steps[world][2])):
        assert {op for op, _ in want} == set(got)
        for (op, axis), (calls, nbytes) in want.items():
            assert axis == "data"
            assert got[op] == (calls, nbytes), op


@pytest.mark.parametrize("world", WORLDS)
def test_comms_accounting_follows_the_shim_formulas(worlds, world):
    """Per step: one all-gather of a (B/P, D) fp32 shard of the text
    embeddings, (P - 1) shards each; as all-reduces at 2 (P - 1) / P of
    the payload, the pmax and the psum of the (B,) column-lse vector, the
    psum of the loss and one pmean of every gradient."""
    res = worlds[world][0]
    p, ar = world, 2 * (world - 1) / world
    batch, embed = STEP_CONFIG["batch_size"], workers.TINY_CLIP["width"]
    params = sum(t.numel() for t in workers.tiny_clip().parameters())
    assert _comms(res, "step_comms") == {
        "all_gather": (1, (p - 1) * batch // p * embed * 4),
        "pmax": (1, ar * batch * 4),
        "psum": (2, ar * (batch * 4 + 4)),
        "pmean": (1, ar * 4 * params)}


def test_rank_processes_import_no_jax(worlds):
    assert not any(bool(res["jax_loaded"]) for world in WORLDS
                   for res in worlds[world])


def test_train_cli_clip_runs_in_a_world_of_2_and_logs_only_on_rank_0(
        worlds, monkeypatch):
    """The world of 2 ran ``ntxent-train --objective clip`` after its jobs:
    rank 0 logs, rank 1 does not, and the losses are a single process's."""
    lead, other = worlds["logs"]
    assert "data-parallel over 2 ranks (gloo, dual InfoNCE)" in lead
    assert "global batch 8" in lead
    assert other == ""
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    _, history = cli.train(cli.build_train_parser().parse_args(CLI_ARGV))
    logged = {int(step): float(loss) for step, loss in
              re.findall(r"step (\d+) loss ([0-9.]+)", lead)}
    assert sorted(logged) == [h["step"] for h in history] == [1, 2]
    for h in history:  # the log rounds to 4 decimals
        assert abs(logged[h["step"]] - h["loss"]) <= 5e-5 + 1e-6


# ---------------------------------------------------------------------------
# The loader, the loss registry and the CLI
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("world", WORLDS)
def test_paired_loader_rank_shards_match_jax(world):
    rng = np.random.default_rng(world)
    images = rng.integers(0, 255, (40, 4, 4, 3)).astype(np.uint8)
    tokens = rng.integers(0, 100, (40, 5)).astype(np.int32)
    batch = 4 * world
    for rank in range(world):
        jax_loader = JaxPaired(images, tokens, batch // world, seed=3,
                               shard_index=rank, shard_count=world)
        port = iter(tdata.PairedArrayLoader(images, tokens, batch, seed=3,
                                            rank=rank, world_size=world))
        for _ in range(5):  # crosses an epoch
            (ji, jt), (ti, tt) = next(jax_loader), next(port)
            np.testing.assert_array_equal(ti, ji)
            np.testing.assert_array_equal(tt, jt)
    with pytest.raises(ValueError):
        tdata.PairedArrayLoader(images, tokens, 6, rank=0, world_size=4)


def test_resolve_local_infonce():
    assert dist_loss.resolve_local_infonce("dual") is \
        dist_loss.local_infonce_dual
    assert dist_loss.make_sharded_infonce().func is \
        dist_loss.local_infonce_dual
    assert dist_loss.resolve_local_infonce("twopass") is \
        dist_loss.local_infonce_allgather
    with pytest.raises(ValueError):
        dist_loss.resolve_local_infonce("ring")


@pytest.mark.parametrize("flags,match", [
    (["--clip-parallel", "tp", "--model-par", "1"], "ROADMAP.md Queue A 9"),
    (["--fsdp"], "ROADMAP.md Queue A 9"),
    (["--collective-dtype", "bf16"], r"ROADMAP.md Queue A 3\(e\)"),
])
def test_train_cli_clip_data_parallel_refusals(flags, match, tmp_path,
                                               caplog):
    """Queue A 9's flags (ported since) train their branch in a world of
    one: ``--clip-parallel tp`` Megatron TP on the (1, 1) grid, ``--fsdp``
    ZeRO-3; 3(e), the wire dtypes, is ported too: ``--collective-dtype
    bf16`` trains the data-parallel CLIP step in a world of one, its
    gathers and gradient pmean in bf16."""
    args = cli.build_train_parser().parse_args(CLI_ARGV + flags)
    mesh.init_from_file(tmp_path / "store", 0, 1, device="cpu",
                        timeout=datetime.timedelta(seconds=60))
    if "Queue A 9" in match:
        try:
            with caplog.at_level("INFO"):
                state, history = cli.train(args, data_parallel=True)
        finally:
            mesh.shutdown()
        branch = ("Megatron TP over the (1, 1) (data, model) grid"
                  if flags[0] == "--clip-parallel"
                  else "FSDP (ZeRO-3) over 1 ranks")
        assert branch in caplog.text and state.sharding is not None
        assert [h["step"] for h in history] == [1, 2]
        assert all(np.isfinite(h["loss"]) for h in history)
        return
    try:
        mark = mesh.comms_accounting().totals()
        with caplog.at_level("INFO"):
            _, history = cli.train(args, data_parallel=True)
        comms = mesh.comms_accounting().delta(mark)
    finally:
        mesh.shutdown()
    assert "quantized collectives: bf16 wire payloads" in caplog.text
    assert [h["step"] for h in history] == [1, 2]
    assert all(np.isfinite(h["loss"]) for h in history)
    assert comms[("all_gather", "data")][0] == 2  # one a step


def test_train_cli_clip_batch_must_divide_across_the_world(monkeypatch):
    monkeypatch.setenv("WORLD_SIZE", "3")
    args = cli.build_train_parser().parse_args(CLI_ARGV)
    with pytest.raises(SystemExit, match="must divide across 3"):
        cli.train(args)


def test_train_cli_clip_data_parallel_raises_without_a_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("WORLD_SIZE", "1")
    argv = [a for a in CLI_ARGV if a not in ("--device", "cpu")]
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.train(cli.build_train_parser().parse_args(argv),
                  data_parallel=True)
