"""Error feedback of the int8 gradient all-reduce
(``mesh.quantized_grad_reduce_``, ``training.init_error_feedback``) and
the int8 data-parallel steps against the JAX package, after
``tests/test_quant.py:258-535``.

Spawned gloo worlds of 2 and 4 (``torch_dist_workers.run_wire``, no JAX
in the ranks):

* three steps of the residual carry on ``theta - target[rank]`` (4096
  values a rank, plus a 3-value leaf below the int8 floor) against JAX
  ``quantized_grad_reduce`` on a mesh of as many CPU devices: the reduced
  mean, the residual and the wire bytes. The two packages quantize the
  same float32 values with the same rules, so they agree to 1e-6 of the
  largest value (a sum of P products in another order is the only
  difference);
* two ``make_sharded_train_step(collective_dtype="int8")`` steps of the
  ``tiny`` ResNet SimCLR model and two of the tiny CLIP
  (``make_sharded_clip_train_step``), both with a residual, from the same
  flax weights on the same global batches, against the JAX sharded steps
  with ``init_error_feedback`` on as many devices: the losses (1e-5),
  every parameter's change (SimCLR: the fp32 step's bound in
  ``test_torch_resnet.py``; CLIP: AdamW's first steps move an element by
  about the learning rate whatever its gradient's size, so an element
  whose int8 step flipped (below) may move up to 2 lr apart: 2 lr on
  every element, 1e-5 on all but 0.5%) and each rank's residual. Both chunk every gradient in the flax layout
  (``weights.flax_orders``). The gradients reach the quantizer through
  different float32 sums in the two packages, so a value within a
  rounding of a step boundary may take the neighbouring int8 step,
  moving its residual by up to one step (its chunk's amax / 127): the
  bar is one step on every element, a quarter step on all but 0.5% of
  them and 1e-3 of a step at the median (chunking in the torch layout
  instead misses it on 75-99% of the elements);
* ``ntxent-train --collective-dtype int8 --ckpt-save-ef`` in the world of
  2: the saved residual is every rank's, in the JAX layout, and the JAX
  package's ``CheckpointManager`` restores it into a JAX state on two
  devices; a run stopped at step 2 and resumed ends at the uninterrupted
  run's parameters and residual bit for bit.

And in this process (a gloo world of one): a guarded NaN step keeps the
pre-step residual, with the host guard and under the lag-1 guard;
checkpoints are slim by default (no ``ef_residual`` field, restored as
zeros with a warning), ``save_ef_residual`` round-trips in the JAX
layout both ways, and a residual saved at another world size restores
as zeros with a warning.
"""

import datetime
import functools
import logging
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import Mesh, NamedSharding
from jax.sharding import PartitionSpec as P

from ntxent_tpu.parallel import mesh as jmesh
from ntxent_tpu.parallel.mesh import replicate_state
from ntxent_tpu.training import init_error_feedback as jinit_ef
from ntxent_tpu.training.checkpoint import CheckpointManager as JaxManager
from ntxent_tpu.training.lars import cosine_warmup_schedule as jax_schedule
from ntxent_tpu.training.trainer import TrainState as JaxTrainState
from ntxent_tpu.training.trainer import make_sharded_clip_train_step as jclip
from ntxent_tpu.training.trainer import make_sharded_train_step as jsharded
from ntxent_tpu_torch.models import cross_replica_batch_norm
from ntxent_tpu_torch.parallel import mesh
from ntxent_tpu_torch.training import checkpoint as tckpt
from ntxent_tpu_torch.training import trainer as ttrain
from ntxent_tpu_torch.utils import msgpack
from ntxent_tpu_torch.weights import _torch_tensors, load_flax_variables

import torch_dist_workers as workers
from test_torch_clip import _inputs as clip_inputs
from test_torch_clip import _jax_clip, _np, _variables
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

WORLDS = (2, 4)
DIM, LR = 4096, 0.2
CLIP_CONFIG = dict(batch_size=8, base_lr=1e-3, weight_decay=1e-4,
                   warmup_steps=1, total_steps=10)
CLI_ARGV = ["--device", "cpu", "--model", "tiny", "--image-size", "8",
            "--batch", "8", "--log-every", "1", "--proj-hidden-dim", "16",
            "--proj-dim", "8", "--synthetic-samples", "16",
            "--warmup-steps", "1", "--collective-dtype", "int8",
            "--ckpt-save-ef", "--ckpt-every", "2"]


@pytest.fixture(scope="module")
def setup():
    jmodel, variables, _ = tiny_simclr_pair(seed=3, axis_name="data")
    views = step_views(2, seed=5)
    cmodel = _jax_clip()
    cvars = _variables(cmodel, seed=8)
    batches = [clip_inputs(seed=9 + i) for i in range(2)]
    rng = np.random.default_rng(30)
    inputs = {"targets": rng.standard_normal((4, DIM)).astype(np.float32),
              "small": rng.standard_normal(3).astype(np.float32),
              "lr": np.float32(LR), "proj": np.array(TINY_PROJ),
              "v1": np.stack([v[0] for v in views]),
              "v2": np.stack([v[1] for v in views]),
              **_flatten(variables["params"], "params"),
              **_flatten(variables["batch_stats"], "batch_stats"),
              **{f"cfg:{k}": np.asarray(v) for k, v in STEP_CONFIG.items()},
              "images": np.stack([b[0] for b in batches]),
              "tokens": np.stack([b[1] for b in batches]),
              **_flatten(cvars["params"], "clip_params"),
              **{f"clip_cfg:{k}": np.asarray(v)
                 for k, v in CLIP_CONFIG.items()}}
    return (jmodel, variables, views), (cmodel, cvars, batches), inputs


def _cli_runs(out):
    def run(name, steps):
        return (name, CLI_ARGV + ["--steps", str(steps), "--ckpt-dir",
                                  str(out / name)])

    # "resumed" runs to step 2, then again to step 3 from its checkpoint
    return [run("resumed", 2), run("resumed", 3), run("whole", 3)]


@pytest.fixture(scope="module")
def spawned(setup, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ef_worlds")
    np.savez(tmp / "inputs.npz", **setup[2])
    with ThreadPoolExecutor(max_workers=len(WORLDS)) as pool:
        futures = {}
        for world in WORLDS:
            out = tmp / f"world{world}"
            out.mkdir()
            futures[world] = pool.submit(
                _spawn, workers.run_wire, world,
                (str(tmp / "inputs.npz"), str(out),
                 ["ef_carry", "wire_steps"],
                 _cli_runs(out) if world == 2 else None), out)
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


# ---------------------------------------------------------------------------
# The residual carry
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_carry(setup, spawned):
    inputs = setup[2]
    out = {}
    for world in WORLDS:
        m = _mesh(world)

        def body(tgt, theta, small, e_stacked):
            d = jax.lax.axis_index("data")
            grads = (theta - tgt[0], small * (d + 1).astype(jnp.float32))
            e = (e_stacked[0], jnp.zeros_like(small))
            red, new_e = jmesh.quantized_grad_reduce(grads, e, "data")
            return red, new_e[0][None]

        f = jax.jit(jmesh.shard_map(
            body, mesh=m, in_specs=(P("data"), P(), P(), P("data")),
            out_specs=((P(), P()), P("data")), check_vma=False))
        theta = jnp.zeros((DIM,), jnp.float32)
        e = jnp.zeros((world, DIM), jnp.float32)
        steps = []
        for k in range(3):
            mark = jmesh.comms_accounting().totals()
            (red, small), e = f(inputs["targets"][:world], theta,
                                inputs["small"], e)
            comms = jmesh.comms_accounting().delta(mark)
            steps.append((np.asarray(red), np.asarray(small),
                          np.asarray(e), comms))
            theta = theta - LR * red
        out[world] = steps
    return out


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("step", [0, 1, 2])
def test_residual_carry_matches_jax_quantized_grad_reduce(worlds, jax_carry,
                                                          world, step):
    red, small, e, comms = jax_carry[world][step]
    for r, res in enumerate(worlds[world]):
        got = res[f"ef:{step}:reduced"]
        np.testing.assert_allclose(got, red, atol=1e-6 * np.abs(red).max(),
                                   rtol=0)
        np.testing.assert_allclose(res[f"ef:{step}:small"], small,
                                   atol=1e-6, rtol=0)
        np.testing.assert_allclose(res[f"ef:{step}:residual"], e[r],
                                   atol=1e-6 * np.abs(red).max(), rtol=0)
        assert np.abs(res[f"ef:{step}:residual"]).max() > 0
    if step == 0:  # the comms are JAX's trace; the port records each call
        port = {key.rsplit(":", 1)[1]: tuple(v) for key, v in
                worlds[world][0].items() if key.startswith("ef:0:comms:")}
        assert port == {op: (c, pytest.approx(b))
                        for (op, _), (c, b) in comms.items()}


def test_error_feedback_tracks_the_float32_trajectory(worlds):
    """The JAX test's claim, on the port: 3 carried steps land close to
    the float32 trajectory of the same toy problem."""
    res = worlds[4][0]
    targets = np.load(worlds["dir"].parent / "inputs.npz")["targets"]
    theta = np.zeros(DIM, np.float32)
    theta_ef = np.zeros(DIM, np.float32)
    for k in range(3):
        theta = theta - LR * (theta - targets).mean(axis=0)
        theta_ef = theta_ef - LR * res[f"ef:{k}:reduced"]
    assert np.linalg.norm(theta_ef - theta) / np.linalg.norm(theta) < 5e-3


# ---------------------------------------------------------------------------
# The int8 steps against JAX
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_steps(setup, spawned):
    (jmodel, variables, views), (cmodel, cvars, batches), _ = setup
    out = {}
    for world in WORLDS:
        m = _mesh(world)
        shard = NamedSharding(m, P("data"))
        state = jinit_ef(replicate_state(jax_tiny_state(jmodel, variables),
                                         m), m)
        step = jsharded(m, STEP_CONFIG["temperature"], interpret=True,
                        collective_dtype="int8")
        losses = []
        for v1, v2 in views:
            state, metrics = step(state, jax.device_put(v1, shard),
                                  jax.device_put(v2, shard))
            losses.append(float(metrics["loss"]))
        out[world, "simclr"] = (losses, {"params": _np(state.params),
                                         "batch_stats":
                                         _np(state.batch_stats)},
                                _np(state.ef_residual))
        tx = optax.adamw(jax_schedule(CLIP_CONFIG["base_lr"],
                                      CLIP_CONFIG["warmup_steps"],
                                      CLIP_CONFIG["total_steps"]),
                         weight_decay=CLIP_CONFIG["weight_decay"])
        cstate = JaxTrainState.create(
            apply_fn=cmodel.apply,
            params=jax.tree.map(jnp.array, cvars["params"]), tx=tx)
        cstate = jinit_ef(replicate_state(cstate, m), m)
        cstep = jclip(m, interpret=True, collective_dtype="int8")
        losses = []
        for images, tokens in batches:
            cstate, metrics = cstep(cstate, jax.device_put(images, shard),
                                    jax.device_put(tokens, shard))
            losses.append(float(metrics["loss"]))
        out[world, "clip"] = (losses, {"params": _np(cstate.params)},
                              _np(cstate.ef_residual))
    return out


def _residual_slices(model, stacked_tree, stats, rank):
    """The JAX residual's slice of ``rank`` in the port's layout."""
    sliced = jax.tree.map(lambda x: np.asarray(x)[rank], stacked_tree)
    return _torch_tensors(model, sliced, stats)


def _assert_residuals_close(res, prefix, model, stacked, stats, rank):
    want = _residual_slices(model, stacked, stats, rank)
    moved, names = 0.0, [n for n, _ in model.named_parameters()]
    for name in names:
        got, w = res[f"{prefix}:ef:{name}"], want[name]
        moved = max(moved, float(np.abs(got).max()))
        gap = np.abs(got - w)
        # |e| <= half an int8 step, so a step is at least 2 max |e|
        step = np.abs(w).max() * 2 + 1e-6
        assert gap.max() <= step, (name, gap.max(), step)
        flips = np.mean(gap > 0.25 * step)
        assert flips <= 5e-3, (name, flips)
        assert np.median(gap) <= 1e-3 * step, (name, np.median(gap), step)
    assert moved > 0  # the residual carries


@pytest.mark.parametrize("world", WORLDS)
def test_int8_simclr_step_matches_jax(setup, worlds, jax_steps, world):
    (_, variables, _), _, _ = setup
    losses_j, want, residual_j = jax_steps[world, "simclr"]
    for r, res in enumerate(worlds[world]):
        np.testing.assert_allclose(res["simclr:losses"], losses_j,
                                   atol=1e-5, rtol=0)
        model = tiny_port_model(variables)
        before = {k: v.detach().clone()
                  for k, v in model.named_parameters()}
        model.load_state_dict({k[len("simclr:state:"):]: torch.from_numpy(v)
                               for k, v in res.items()
                               if k.startswith("simclr:state:")})
        assert_same_update(model, before, tiny_port_model(want))
        _assert_residuals_close(res, "simclr", model, residual_j,
                                variables["batch_stats"], r)


@pytest.mark.parametrize("world", WORLDS)
def test_int8_clip_step_matches_jax(setup, worlds, jax_steps, world):
    _, (_, cvars, _), _ = setup
    losses_j, want, residual_j = jax_steps[world, "clip"]
    for r, res in enumerate(worlds[world]):
        np.testing.assert_allclose(res["clip:losses"], losses_j, atol=1e-5,
                                   rtol=0)
        model = workers.tiny_clip()
        model.load_state_dict({k[len("clip:state:"):]: torch.from_numpy(v)
                               for k, v in res.items()
                               if k.startswith("clip:state:")})
        before = dict(load_flax_variables(workers.tiny_clip(),
                                          cvars).named_parameters())
        want_params = dict(load_flax_variables(
            workers.tiny_clip(), want).named_parameters())
        for name, p in model.named_parameters():
            delta = (p - before[name]).detach()
            want_delta = (want_params[name] - before[name]).detach()
            if name.endswith("attn.key.bias"):  # a gradient of 0: noise
                continue
            gap = (delta - want_delta).abs()
            assert float(gap.max()) <= 2 * CLIP_CONFIG["base_lr"], name
            assert float((gap > 1e-5).float().mean()) <= 5e-3, name
        _assert_residuals_close(res, "clip", model, residual_j, {}, r)


@pytest.mark.parametrize("world", WORLDS)
def test_ranks_hold_the_same_state_and_their_own_residual(worlds, world):
    ranks = worlds[world]
    for res in ranks[1:]:
        for key, value in ranks[0].items():
            if ":state:" in key or key.endswith("losses"):
                np.testing.assert_array_equal(res[key], value, err_msg=key)
    key = next(k for k in ranks[0] if k.startswith("simclr:ef:")
               and ranks[0][k].size >= 1024)
    assert not np.array_equal(ranks[0][key], ranks[1][key])


# ---------------------------------------------------------------------------
# The CLI in the world of 2
# ---------------------------------------------------------------------------


def _state(ckpt_dir, step):
    return msgpack.from_bytes((ckpt_dir / str(step) / "state.msgpack")
                              .read_bytes())


def _leaves(tree, path=()):
    for k, v in sorted(tree.items()):
        if isinstance(v, dict):
            yield from _leaves(v, path + (k,))
        else:
            yield path + (k,), np.asarray(v)


def test_train_cli_int8_saves_every_rank_s_residual_in_the_jax_layout(
        worlds):
    out = worlds["dir"]
    lead = (out / "whole.rank0.log").read_text()
    assert "quantized collectives: int8 wire payloads + gradient error " \
        "feedback" in lead
    state = _state(out / "whole", 3)
    ef = dict(_leaves(state["ef_residual"]))
    params = dict(_leaves(state["params"]))
    assert ef.keys() == params.keys()
    for path, value in ef.items():
        assert value.shape == (2,) + params[path].shape, path
        assert value.dtype == np.float32
    assert max(np.abs(v).max() for v in ef.values()) > 0


def test_train_cli_int8_resume_ends_where_the_whole_run_does(worlds):
    out = worlds["dir"]
    assert "resumed from checkpoint at step 2" in \
        (out / "resumed.rank0.log").read_text()
    got = dict(_leaves(_state(out / "resumed", 3)))
    want = dict(_leaves(_state(out / "whole", 3)))
    assert got.keys() == want.keys()
    for path, value in want.items():
        np.testing.assert_array_equal(got[path], value,
                                      err_msg="/".join(path))


def test_jax_restores_the_port_s_int8_checkpoint_with_its_residual(
        setup, worlds):
    """The CLI's step 3 restored by the JAX package's manager into a JAX
    SimCLR state with a residual on two devices: the residual is the saved
    one, params too."""
    from ntxent_tpu.models import ResNet, SimCLRModel
    from ntxent_tpu.training import TrainerConfig, create_train_state

    out = worlds["dir"] / "whole"
    m = Mesh(np.array(jax.devices()[:2]), ("data",))
    model = SimCLRModel(encoder=functools.partial(
        ResNet, stage_sizes=(1,), small_images=True, axis_name="data"),
        proj_hidden_dim=16, proj_dim=8, axis_name="data")
    cfg = TrainerConfig(batch_size=8, total_steps=3, warmup_steps=1)
    template = jinit_ef(replicate_state(create_train_state(
        model, jax.random.PRNGKey(0), (1, 8, 8, 3), cfg), m), m)
    mgr = JaxManager(str(out))
    try:
        restored = mgr.restore(template, step=3)
    finally:
        mgr.close()
    saved = _state(out, 3)
    for (path, value), (_, got) in zip(
            _leaves(saved["ef_residual"]),
            _leaves(jax.tree.map(np.asarray, restored.ef_residual))):
        np.testing.assert_array_equal(got, value, err_msg="/".join(path))
    for (path, value), (_, got) in zip(
            _leaves(saved["params"]),
            _leaves(jax.tree.map(np.asarray, restored.params))):
        np.testing.assert_array_equal(got, value, err_msg="/".join(path))


# ---------------------------------------------------------------------------
# A world of one in this process: the guards, the checkpoints
# ---------------------------------------------------------------------------


@pytest.fixture
def group_of_one(tmp_path):
    mesh.init_from_file(tmp_path / "store", 0, 1, device="cpu",
                        timeout=datetime.timedelta(seconds=60))
    yield
    mesh.shutdown()


def _int8_state(setup):
    (_, variables, _), _, _ = setup
    model = cross_replica_batch_norm(tiny_port_model(variables),
                                     torch.distributed.group.WORLD)
    state = ttrain.create_train_state(
        model, ttrain.TrainerConfig(**STEP_CONFIG), torch.device("cpu"))
    return ttrain.init_error_feedback(state)


@pytest.mark.parametrize("lag", [False, True])
def test_a_skipped_step_keeps_the_pre_step_residual(setup, group_of_one,
                                                    lag):
    (_, _, views), _, _ = setup
    state = _int8_state(setup)
    step = ttrain.make_sharded_train_step(None, STEP_CONFIG["temperature"],
                                          guard=True,
                                          collective_dtype="int8")
    v1, v2 = (torch.from_numpy(v) for v in views[0])
    state, metrics = step(state, v1, v2, 1.0, lag=lag)
    assert bool(metrics["step_ok"])
    before = [e.clone() for e in state.ef_residual]
    assert max(float(e.abs().max()) for e in before) > 0
    bad = v1.clone()
    bad[0, 0, 0, 0] = float("nan")
    state, metrics = step(state, bad, v2, 1.0, lag=lag)
    assert not bool(metrics["step_ok"])
    for a, b in zip(before, state.ef_residual):
        torch.testing.assert_close(b, a, rtol=0, atol=0)
    state, metrics = step(state, v1, v2, 1.0, lag=lag)  # moves again
    assert bool(metrics["step_ok"])
    assert any(not torch.equal(a, b) for a, b in zip(before,
                                                     state.ef_residual))


def _stored(path, step):
    return msgpack.from_bytes((path / str(step) / "state.msgpack")
                              .read_bytes())


def test_saves_are_slim_by_default_and_restore_zeros_with_a_warning(
        setup, group_of_one, tmp_path, caplog):
    state = _int8_state(setup)
    for e in state.ef_residual:
        e.add_(1.0)
    slim = tckpt.CheckpointManager(tmp_path / "slim")
    full = tckpt.CheckpointManager(tmp_path / "full", save_ef_residual=True)
    assert slim.save(1, state, force=True) and full.save(1, state, force=True)
    assert "ef_residual" not in _stored(tmp_path / "slim", 1)
    assert "ef_residual" not in tckpt.snapshot_state(state).state_dict
    size = {name: sum(p.stat().st_size for p in (tmp_path / name).rglob("*")
                      if p.is_file()) for name in ("slim", "full")}
    params = sum(p.numel() * 4 for p in state.model.parameters())
    assert size["full"] - size["slim"] > 0.8 * params
    template = _int8_state(setup)
    for e in template.ef_residual:
        e.fill_(5.0)
    with caplog.at_level(logging.WARNING):
        slim.restore(template)
    assert "starting at zero residual" in caplog.text
    assert all(not e.any() for e in template.ef_residual)
    full.restore(template)
    for a, b in zip(state.ef_residual, template.ef_residual):
        torch.testing.assert_close(b, a, rtol=0, atol=0)


def _jax_state_with_residual(setup, world, fill):
    (jmodel, variables, _), _, _ = setup
    m = Mesh(np.array(jax.devices()[:world]), ("data",))
    state = jinit_ef(replicate_state(jax_tiny_state(jmodel, variables), m), m)
    leaves, treedef = jax.tree_util.tree_flatten(state.ef_residual)
    rng = np.random.default_rng(world)
    filled = [jax.device_put(rng.standard_normal(x.shape).astype(np.float32)
                             * fill, x.sharding) for x in leaves]
    return state.replace(ef_residual=jax.tree_util.tree_unflatten(
        treedef, filled))


def test_save_ef_round_trips_in_the_jax_layout_both_ways(setup, group_of_one,
                                                         tmp_path):
    """The port's world-of-one residual restored by JAX on one device, and
    a JAX residual saved on one device restored by the port."""
    state = _int8_state(setup)
    gen = torch.Generator().manual_seed(0)
    for e in state.ef_residual:
        e.copy_(torch.randn(e.shape, generator=gen))
    port = tckpt.CheckpointManager(tmp_path / "port", save_ef_residual=True)
    assert port.save(2, state, force=True)
    template = _jax_state_with_residual(setup, 1, 0.0)
    mgr = JaxManager(str(tmp_path / "port"))
    try:
        restored = mgr.restore(template, step=2)
    finally:
        mgr.close()
    names = [n for n, _ in state.model.named_parameters()]
    got = _residual_slices(state.model, _np(restored.ef_residual),
                           _stored(tmp_path / "port", 2)["batch_stats"], 0)
    for name, e in zip(names, state.ef_residual):
        np.testing.assert_array_equal(got[name], e.numpy(), err_msg=name)

    jstate = _jax_state_with_residual(setup, 1, 1.0)
    jmgr = JaxManager(str(tmp_path / "jax"), save_ef_residual=True)
    try:
        jmgr.save(4, jstate, force=True)
        jmgr.wait_until_finished()
    finally:
        jmgr.close()
    into = _int8_state(setup)
    tckpt.CheckpointManager(tmp_path / "jax").restore(into)
    want = _residual_slices(into.model, _np(jstate.ef_residual),
                            _np(jstate.batch_stats), 0)
    for name, e in zip(names, into.ef_residual):
        np.testing.assert_array_equal(e.numpy(), want[name], err_msg=name)


def test_a_residual_of_another_world_restores_zeros_with_a_warning(
        setup, group_of_one, tmp_path, caplog):
    jstate = _jax_state_with_residual(setup, 2, 1.0)
    jmgr = JaxManager(str(tmp_path / "jax2"), save_ef_residual=True)
    try:
        jmgr.save(4, jstate, force=True)
        jmgr.wait_until_finished()
    finally:
        jmgr.close()
    into = _int8_state(setup)
    for e in into.ef_residual:
        e.fill_(3.0)
    into.model.backbone.stem_conv.weight.data.zero_()
    with caplog.at_level(logging.WARNING):
        tckpt.CheckpointManager(tmp_path / "jax2").restore(into)
    assert "does not match the current topology" in caplog.text
    assert all(not e.any() for e in into.ef_residual)
    # the rest of the state restored
    assert into.model.backbone.stem_conv.weight.abs().max() > 0


def test_a_float32_run_drops_a_saved_residual_with_a_warning(
        setup, group_of_one, tmp_path, caplog):
    state = _int8_state(setup)
    tckpt.CheckpointManager(tmp_path / "ef", save_ef_residual=True).save(
        1, state, force=True)
    plain = _int8_state(setup)
    plain.ef_residual = None
    with caplog.at_level(logging.WARNING):
        tckpt.CheckpointManager(tmp_path / "ef").restore(plain)
    assert "dropping it" in caplog.text and plain.ef_residual is None


def test_several_ranks_need_the_gathered_residual_to_save_it(setup,
                                                             monkeypatch):
    monkeypatch.setattr(mesh, "world_size", lambda group=None: 2)
    (_, variables, _), _, _ = setup
    state = ttrain.init_error_feedback(ttrain.create_train_state(
        tiny_port_model(variables), ttrain.TrainerConfig(**STEP_CONFIG),
        torch.device("cpu")))
    with pytest.raises(ValueError, match="gather_ef_residual"):
        tckpt.snapshot_state(state, keep_ef_residual=True)
    stacked = {n: np.stack([e.numpy()] * 2) for (n, _), e in
               zip(state.model.named_parameters(), state.ef_residual)}
    snap = tckpt.snapshot_state(state, keep_ef_residual=True,
                                ef_residual=stacked)
    leaves = dict(_leaves(snap.state_dict["ef_residual"]))
    assert all(v.shape[0] == 2 for v in leaves.values())
