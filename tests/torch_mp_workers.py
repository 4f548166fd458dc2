"""Rank processes of ``test_torch_moe.py``, ``test_torch_tp.py``,
``test_torch_fsdp.py``, ``test_torch_pp.py`` and
``test_torch_multiprocess.py``: worlds of gloo ranks on the CPU that meet
over a ``FileStore`` (``torch_dist_workers._join``) or, for the CLI's
``--coordinator``, over ``tcp://localhost``.

This module imports torch and the port, never JAX. Inputs come from an
``.npz`` the test wrote (flax variables flattened as ``params/a/b``, the
SimCLR and CLIP configs as ``cfg:<field>`` and ``clipcfg:<field>``);
each rank writes ``<out>/rank<r>.npz``. Every parameter a job returns is
whole (``Sharding.gather``), under its torch name.
"""

from __future__ import annotations

import dataclasses
import os
import sys
from pathlib import Path

import numpy as np
import torch

from ntxent_tpu_torch import cli
from ntxent_tpu_torch.models import (
    CLIPModel,
    EncoderBlock,
    LongContextTransformer,
    ResNet,
    SimCLRModel,
    TextTransformer,
    VisionTransformer,
    make_pipelined_apply,
)
from ntxent_tpu_torch.parallel import (
    MoEParams,
    make_expert_parallel_moe,
    make_fsdp_clip_train_step,
    make_fsdp_train_step,
    make_gpipe,
    make_tp_clip_train_step,
    make_tp_simclr_train_step,
    mesh,
    param_bytes_per_device,
    shard_train_state,
    shard_train_state_fsdp,
    shard_train_state_tp_fsdp,
)
from ntxent_tpu_torch.parallel.ring_attention import attention_oracle
from ntxent_tpu_torch.training import (
    create_clip_train_state,
    create_train_state,
    fit,
    make_sharded_train_step,
)
from ntxent_tpu_torch.weights import load_flax_variables

from torch_dist_workers import _config, _join, nest

# The tiny towers of the tests, fp32: the JAX tests' sizes.
TINY_VIT = dict(image_size=16, patch_size=8, hidden_dim=32, depth=2,
                num_heads=2, mlp_dim=64)
TINY_PROJ = (64, 32)
TINY_CLIP_TEXT = dict(vocab_size=32, max_len=8, hidden_dim=16, depth=1,
                      num_heads=2)
TINY_CLIP_VIT = dict(image_size=16, patch_size=8, hidden_dim=16, depth=2,
                     num_heads=2, mlp_dim=32)
TINY_CLIP_EMBED = 8
MIN_SHARD = 64  # small enough that the tiny models' weights are cut


def vit_simclr(moe: int = 0) -> SimCLRModel:
    return SimCLRModel(VisionTransformer(**TINY_VIT, dtype=torch.float32,
                                         moe_experts=moe),
                       *TINY_PROJ, dtype=torch.float32)


def resnet_simclr() -> SimCLRModel:
    return SimCLRModel(ResNet((1, 1), small_images=True, dtype=torch.float32),
                       *TINY_PROJ, dtype=torch.float32)


def tiny_clip(moe: int = 0) -> CLIPModel:
    return CLIPModel(
        VisionTransformer(**TINY_CLIP_VIT, dtype=torch.float32,
                          moe_experts=moe),
        TextTransformer(**TINY_CLIP_TEXT, dtype=torch.float32),
        embed_dim=TINY_CLIP_EMBED)


def loaded(model, inp, prefix: str = "params"):
    """``model`` holding the flax params under ``prefix`` of the input
    (and the batch_stats under its ``batch_stats`` twin, if any)."""
    variables = {"params": nest(inp, prefix)}
    if "params" in prefix:
        stats = nest(inp, prefix.replace("params", "batch_stats"))
        if stats:
            variables["batch_stats"] = stats
    return load_flax_variables(model, variables)


def _rows(x: np.ndarray, rank: int, world: int) -> torch.Tensor:
    n = x.shape[0] // world
    return torch.from_numpy(np.ascontiguousarray(x[rank * n:(rank + 1) * n]))


def _whole(state, prefix: str) -> dict:
    """Every parameter and buffer of the whole state, ``prefix:name``."""
    if state.sharding is not None:
        state = state.sharding.gather(state)
    return {f"{prefix}:{n}": t.detach().numpy().copy()
            for n, t in state.model.state_dict().items()}


def _steps(state, step, batches, prefix: str, rank: int, world: int,
           metrics_keys=("loss",)) -> dict:
    """Run ``step`` over ``batches`` (global arrays, this rank's rows of
    each); the losses (and other metrics) and the whole final state."""
    out = {k: [] for k in metrics_keys}
    for batch in batches:
        state, metrics = step(state, *(_rows(b, rank, world)
                                       for b in batch))
        for k in metrics_keys:
            out[k].append(float(metrics[k]))
    return {f"{prefix}{k}": np.array(v) for k, v in out.items()} \
        | _whole(state, prefix) \
        | {f"{prefix}bytes": np.array(param_bytes_per_device(state))}


def _simclr_state(inp, model, accum: int = 1):
    cfg = dataclasses.replace(_config(inp), accum_steps=accum)
    return create_train_state(model, cfg, torch.device("cpu"))


def _clip_state(inp, model):
    return create_clip_train_state(model, _config(inp, "clipcfg:"),
                                   torch.device("cpu"))


def _views(inp, key: str = "views"):
    return [(v[0], v[1]) for v in inp[key]]


# ---------------------------------------------------------------------------
# MoE (world 8)
# ---------------------------------------------------------------------------


def ep_job(rank: int, world: int, inp) -> dict:
    """Expert parallelism over the world: this rank's rows of x through
    ``make_expert_parallel_moe``; the rank's loss is ``sum(y^2) + aux / P``
    so the sum over ranks is the global loss, whose summed gradients are
    returned."""
    params = MoEParams(*(torch.from_numpy(inp[f"moe/{k}"]).requires_grad_()
                         for k in ("router", "w_up", "b_up", "w_down",
                                   "b_down")))
    ep = make_expert_parallel_moe(None, capacity_factor=float(inp["cf"]))
    x = _rows(inp["x"], rank, world)
    y, aux = ep(params, x)
    (y.square().sum() + aux / world).backward()
    grads = {}
    for k in ("router", "w_up", "b_up", "w_down", "b_down"):
        g = getattr(params, k).grad.clone()
        torch.distributed.all_reduce(g)
        grads[f"ep_g:{k}"] = g.numpy()
    four = MoEParams(params.router[:, :4], params.w_up[:4], params.b_up[:4],
                     params.w_down[:4], params.b_down[:4])
    try:  # 4 experts over 8 ranks
        make_expert_parallel_moe(None)(four, x)
        divisible = np.array("no error")
    except ValueError as e:
        divisible = np.array(str(e))
    return {"ep_y": y.detach().numpy(), "ep_aux": aux.detach().numpy(),
            "ep_divisible": divisible, **grads}


def dp_moe_job(rank: int, world: int, inp) -> dict:
    """The data-parallel MoE step (``make_sharded_train_step(
    moe_aux_weight=0.01)``) over ranks 0-3, two steps of the tiny MoE
    ViT; the other ranks only make the group."""
    group = torch.distributed.new_group([0, 1, 2, 3])
    if rank >= 4:
        return {}
    state = _simclr_state(inp, loaded(vit_simclr(moe=2), inp))
    step = make_sharded_train_step(group, _config(inp).temperature,
                                   moe_aux_weight=0.01)
    return _steps(state, step, _views(inp), "dp_moe_", rank, 4,
                  ("loss", "moe_aux"))


def run_moe(rank: int, world: int, store: str, inputs: str, out: str
            ) -> None:
    _join(store, rank, world)
    try:
        _run((ep_job, dp_moe_job), rank, world, inputs, out)
    finally:
        mesh.shutdown()


# ---------------------------------------------------------------------------
# Tensor parallelism (world 8 as the (4, 2) grid)
# ---------------------------------------------------------------------------


def tp_job(rank: int, world: int, inp) -> dict:
    """Two steps of the tiny ViT SimCLR under Megatron TP (strip loss over
    'data' and over both axes, the oracle loss), Megatron + ZeRO-3, and
    the tiny MoE CLIP under TP; each data row's rows."""
    data, model = mesh.grid_groups(4, 2)
    d = rank // 2
    temperature = _config(inp).temperature
    out = {}
    runs = {"tp_": ("strip", None, False), "tpboth_": ("strip", "both",
                                                       False),
            "tporacle_": ("oracle", None, False),
            "tpfsdp_": ("strip", None, True)}
    for prefix, (impl, axes, zero3) in runs.items():
        state = _simclr_state(inp, loaded(vit_simclr(), inp))
        state = (shard_train_state_tp_fsdp(state, model, data,
                                           min_shard_elems=MIN_SHARD)
                 if zero3 else shard_train_state(state, model, data))
        step = make_tp_simclr_train_step(temperature, loss_impl=impl,
                                         loss_axes=axes)
        out |= _steps(state, step, _views(inp), prefix, d, 4)
    clip = shard_train_state(_clip_state(inp, loaded(tiny_clip(moe=2), inp,
                                                     "clip_params")),
                             model, data)
    out |= _steps(clip, make_tp_clip_train_step(moe_aux_weight=0.01),
                  [(i, t) for i, t in zip(inp["images"], inp["tokens"])],
                  "tpclip_", d, 4, ("loss", "moe_aux"))
    return out


def run_tp(rank: int, world: int, store: str, inputs: str, out: str
           ) -> None:
    _join(store, rank, world)
    try:
        _run((tp_job,), rank, world, inputs, out)
    finally:
        mesh.shutdown()


# ---------------------------------------------------------------------------
# ZeRO-3 (world 8; hybrid on the (2, 4) ('dcn', 'data') grid)
# ---------------------------------------------------------------------------


def fsdp_job(rank: int, world: int, inp) -> dict:
    """Two steps of the tiny ResNet SimCLR under ZeRO-3 (strip, pair,
    oracle; hybrid ZeRO on (2, 4)), two micro-steps under accumulation,
    the tiny MoE ViT, the tiny CLIP; a ``fit`` of the strip run with a
    checkpoint; the parameter bytes a rank keeps."""
    temperature = _config(inp).temperature
    out = {}
    for impl in ("strip", "pair", "oracle"):
        state = shard_train_state_fsdp(
            _simclr_state(inp, loaded(resnet_simclr(), inp)),
            min_shard_elems=MIN_SHARD)
        out |= _steps(state, make_fsdp_train_step(temperature,
                                                  loss_impl=impl),
                      _views(inp), f"fsdp_{impl}_", rank, world)
    dcn, data = mesh.grid_groups(2, 4)
    state = shard_train_state_fsdp(
        _simclr_state(inp, loaded(resnet_simclr(), inp)), data,
        dcn_group=dcn, min_shard_elems=MIN_SHARD)
    out |= _steps(state, make_fsdp_train_step(temperature), _views(inp),
                  "hybrid_", rank, world)
    try:
        shard_train_state_fsdp(_simclr_state(inp, resnet_simclr()),
                               batch_group=dcn)
        out["outside_batch"] = np.array("no error")
    except ValueError as e:
        out["outside_batch"] = np.array(str(e))
    state = shard_train_state_fsdp(
        _simclr_state(inp, loaded(resnet_simclr(), inp), accum=2),
        min_shard_elems=MIN_SHARD)
    out |= _steps(state, make_fsdp_train_step(temperature), _views(inp),
                  "accum_", rank, world)
    state = shard_train_state_fsdp(
        _simclr_state(inp, loaded(vit_simclr(moe=2), inp, "moe_params")),
        min_shard_elems=MIN_SHARD)
    out |= _steps(state, make_fsdp_train_step(temperature,
                                              moe_aux_weight=0.01),
                  _views(inp), "fsdp_moe_", rank, world, ("loss", "moe_aux"))
    state = shard_train_state_fsdp(
        _clip_state(inp, loaded(tiny_clip(), inp, "clip_params")),
        min_shard_elems=MIN_SHARD)
    out |= _steps(state, make_fsdp_clip_train_step(),
                  [(i, t) for i, t in zip(inp["images"], inp["tokens"])],
                  "fsdp_clip_", rank, world)
    # the default threshold (2**14 elements): the JAX layout's bytes
    state = shard_train_state_fsdp(
        _simclr_state(inp, loaded(resnet_simclr(), inp)))
    out["default_bytes"] = np.array(param_bytes_per_device(state))
    # a fit that saves, in the single-card format
    state = shard_train_state_fsdp(
        _simclr_state(inp, loaded(resnet_simclr(), inp)),
        min_shard_elems=MIN_SHARD)
    views = _views(inp)

    class Batches:
        i = 0

        def __next__(self):
            v = views[Batches.i % len(views)]
            Batches.i += 1
            return _rows(v[0], rank, world), _rows(v[1], rank, world)

    fit(state, Batches(), make_fsdp_train_step(temperature),
        len(views), checkpoint_dir=str(inp["ckpt"]), checkpoint_every=1,
        log=False)
    return out


def run_fsdp(rank: int, world: int, store: str, inputs: str, out: str
             ) -> None:
    _join(store, rank, world)
    try:
        _run((fsdp_job,), rank, world, inputs, out)
    finally:
        mesh.shutdown()


# ---------------------------------------------------------------------------
# GPipe (world 8 as the (2, 4) (data, stage) grid)
# ---------------------------------------------------------------------------


def _dense_stage(p, x):
    return torch.relu(x @ p["w"] + p["b"])


def pp_job(rank: int, world: int, inp) -> dict:
    """Each data row of the (2, 4) grid runs GPipe over its 4 stages on
    its half of the batch; every rank returns the pipeline's outputs of
    its row and its stage's gradients."""
    data, stages = mesh.grid_groups(2, 4)
    d, s = rank // 4, rank % 4
    out = {}
    stage = {k: torch.from_numpy(inp[f"stage{s}/{k}"]).requires_grad_()
             for k in ("w", "b")}
    x = _rows(inp["x"], d, 2).requires_grad_()
    for m, remat in ((4, False), (4, True), (1, False), (2, False)):
        pipe = make_gpipe(_dense_stage, stages, num_microbatches=m,
                          remat=remat)
        y = pipe(stage, x)
        y.square().sum().backward()
        key = f"gpipe_m{m}{'_remat' if remat else ''}"
        out[f"{key}_y"] = y.detach().numpy()
        out[f"{key}_gx"] = x.grad.numpy().copy()
        for k, t in stage.items():
            out[f"{key}_g{k}"] = t.grad.numpy().copy()
            t.grad = None
        x.grad = None
    try:
        make_gpipe(_dense_stage, stages, num_microbatches=3)(stage, x)
        out["uneven"] = np.array("no error")
    except ValueError as e:
        out["uneven"] = np.array(str(e))
    # real encoder blocks, two a stage
    blocks = [loaded(EncoderBlock(16, 2, 32, torch.float32), inp,
                     f"block{2 * s + j}") for j in range(2)]

    def blocks_fn(bs, acts):
        for b in bs:
            acts = b(acts)
        return acts

    pipe = make_gpipe(blocks_fn, stages, num_microbatches=2)
    out["blocks_y"] = pipe(blocks, _rows(inp["acts"], d, 2)).detach().numpy()
    # the pipelined long-context tower (the whole batch on each row)
    tower = loaded(LongContextTransformer(
        vocab_size=64, hidden_dim=16, depth=4, num_heads=2, mlp_dim=32,
        max_len=32, dtype=torch.float32, attention_fn=attention_oracle),
        inp, "lc")
    apply = make_pipelined_apply(tower, stages, num_microbatches=4,
                                 remat=True)
    y = apply(torch.from_numpy(inp["tokens"]).long())
    y.square().sum().backward()
    out["lc_y"] = y.detach().numpy()
    for n, p in tower.named_parameters():
        if p.grad is not None:
            out[f"lc_g:{n}"] = p.grad.numpy()
    try:  # 6 blocks over 4 stages
        make_pipelined_apply(LongContextTransformer(
            vocab_size=64, hidden_dim=16, depth=6, num_heads=2, mlp_dim=32,
            max_len=32, dtype=torch.float32, attention_fn=attention_oracle),
            stages, num_microbatches=1)
        out["lc_depth"] = np.array("no error")
    except ValueError as e:
        out["lc_depth"] = np.array(str(e))
    return out


def run_pp(rank: int, world: int, store: str, inputs: str, out: str
           ) -> None:
    _join(store, rank, world)
    try:
        _run((pp_job,), rank, world, inputs, out)
    finally:
        mesh.shutdown()


# ---------------------------------------------------------------------------
# Multi-process pipeline and flags (world 2)
# ---------------------------------------------------------------------------


def _global_views(v: torch.Tensor) -> torch.Tensor:
    """Every rank's rows of view ``v``, in rank order."""
    parts = [torch.empty_like(v)
             for _ in range(torch.distributed.get_world_size())]
    torch.distributed.all_gather(parts, v.contiguous())
    return torch.cat(parts)


def views_job(rank: int, world: int, inp) -> dict:
    """``TwoViewPipeline`` on this rank's loader shard: its views of three
    global batches, joined in rank order (bit for bit a one-rank run's)."""
    from ntxent_tpu_torch.training import (
        ArraySource,
        StreamingLoader,
        TwoViewPipeline,
    )

    loader = StreamingLoader(ArraySource(inp["store"]), int(inp["batch"]),
                             seed=3, rank=rank, world_size=world)
    pipe = TwoViewPipeline(loader, torch.device("cpu"), seed=4)
    out = {}
    for i in range(3):
        v1, v2 = next(pipe)
        out[f"v1_{i}"] = _global_views(v1).numpy()
        out[f"v2_{i}"] = _global_views(v2).numpy()
    return out


def run_views(rank: int, world: int, store: str, inputs: str, out: str
              ) -> None:
    _join(store, rank, world)
    try:
        _run((views_job,), rank, world, inputs, out)
    finally:
        mesh.shutdown()


def comms_job(rank: int, world: int, inp) -> dict:
    """One step of the tiny ViT SimCLR under Megatron TP at the (data 1,
    model 2) grid (the loss over both axes), one of the tiny ResNet
    SimCLR under ZeRO-3 and one of it data-parallel, on the same views:
    each step's recorded collectives (``"<run>:<op>:<axis>"``: calls,
    bytes), and the sizes ZeRO-3's records follow from."""
    from ntxent_tpu_torch.models import cross_replica_batch_norm
    from ntxent_tpu_torch.training import TrainerConfig

    rng = np.random.default_rng(0)
    views = [torch.from_numpy(rng.uniform(size=(
        int(inp["batch"]), 16, 16, 3)).astype(np.float32))
        for _ in range(2)]
    cfg = TrainerConfig(batch_size=int(inp["batch"]), warmup_steps=1)
    cpu = torch.device("cpu")
    acct = mesh.comms_accounting()
    out = {}

    def record(run, state, step, batch):
        mark = acct.totals()
        step(state, *batch)
        for (op, axis), (calls, nbytes) in acct.delta(mark).items():
            out[f"{run}:{op}:{axis}"] = np.array([calls, nbytes])

    data, model = mesh.grid_groups(1, 2)
    state = shard_train_state(create_train_state(vit_simclr(), cfg, cpu),
                              model, data)
    record("tp", state, make_tp_simclr_train_step(0.1, loss_axes="both"),
           views)
    rows = [_rows(v.numpy(), rank, world) for v in views]
    state = shard_train_state_fsdp(create_train_state(resnet_simclr(), cfg,
                                                      cpu),
                                   min_shard_elems=MIN_SHARD)
    zero3 = state.sharding.zero3()
    params = dict(state.model.named_parameters())
    mask = state.optimizer.mask
    out["zero3_calls"] = np.array(len(zero3))
    out["zero3_slice_bytes"] = np.array(sum(
        state.optimizer.params[n].numel() * 4 for n in zero3))
    out["zero3_masked"] = np.array(sum(bool(mask[n]) for n in zero3))
    out["rest_bytes"] = np.array(sum(p.numel() * 4 for n, p in
                                     params.items() if n not in zero3))
    record("fsdp", state, make_fsdp_train_step(0.1), rows)
    out["zero3_whole_bytes"] = np.array(sum(
        params[n].grad.numel() * 4 if params[n].grad is not None else 0
        for n in zero3))
    dp = create_train_state(resnet_simclr(), cfg, cpu)
    cross_replica_batch_norm(dp.model, torch.distributed.group.WORLD)
    out["all_bytes"] = np.array(sum(p.numel() * 4
                                    for p in dp.model.parameters()))
    record("dp", dp, make_sharded_train_step(None, 0.1), rows)
    return out


def run_comms(rank: int, world: int, store: str, inputs: str, out: str
              ) -> None:
    _join(store, rank, world)
    try:
        _run((comms_job,), rank, world, inputs, out)
    finally:
        mesh.shutdown()


def run_coordinator(rank: int, world: int, store: str, port: int,
                    argvs: list, out: str) -> None:
    """``ntxent-train`` runs joined through ``--coordinator localhost:port
    --num-processes world --process-id rank`` (no launcher environment and
    no ``store``: the first run joins over TCP, the later ones find the
    group); each run's losses and the log lines in ``<out>/rank<r>.npz``."""
    del store
    import logging

    torch.set_num_threads(1)
    for key in ("RANK", "WORLD_SIZE", "LOCAL_RANK"):
        os.environ.pop(key, None)
    records = []

    class Keep(logging.Handler):
        def emit(self, record):
            records.append(record.getMessage())

    handler = Keep()
    logging.getLogger().addHandler(handler)
    logging.getLogger().setLevel(logging.INFO)
    results = {}
    try:
        for i, argv in enumerate(argvs):
            args = cli.build_train_parser().parse_args(
                argv + ["--coordinator", f"localhost:{port}",
                        "--num-processes", str(world), "--process-id",
                        str(rank)])
            _, history = cli.train(args)
            results[f"losses{i}"] = np.array([h["loss"] for h in history])
        results["backend"] = np.array(torch.distributed.get_backend())
        results["log"] = np.array("\n".join(records))
        np.savez(Path(out) / f"rank{rank}.npz", **results)
    finally:
        logging.getLogger().removeHandler(handler)
        mesh.shutdown()


# ---------------------------------------------------------------------------


def _run(jobs, rank: int, world: int, inputs: str, out: str) -> None:
    inp = np.load(inputs)
    results = {"jax_loaded": np.array("jax" in sys.modules)}
    for job in jobs:
        results |= job(rank, world, inp)
    np.savez(Path(out) / f"rank{rank}.npz", **results)

