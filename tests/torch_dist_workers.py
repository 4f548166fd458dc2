"""Rank processes of ``test_torch_distributed.py`` and
``test_torch_clip_dp.py``: worlds of gloo ranks on the CPU that meet over
a ``FileStore``.

This module imports torch and the port, never JAX: each rank is a fresh
interpreter that imports only what it unpickles (``run``, ``run_clip``,
``run_cli`` and this module). Inputs come from an ``.npz`` the test wrote;
each rank writes its results to ``<out>/rank<r>.npz``. A rank's
collectives give up after ``PG_TIMEOUT``, well inside the test's deadline
for the whole world.
"""

from __future__ import annotations

import datetime
import logging
import os
import sys
from pathlib import Path

import numpy as np
import torch

from ntxent_tpu_torch import cli
from ntxent_tpu_torch.models import (
    CLIPModel,
    ResNet,
    SimCLRModel,
    TextTransformer,
    VisionTransformer,
    cross_replica_batch_norm,
)
from ntxent_tpu_torch.parallel import (
    local_infonce_dual,
    mesh,
    ntxent_loss_distributed,
)
from ntxent_tpu_torch.training import (
    TrainerConfig,
    create_clip_train_state,
    create_train_state,
    make_sharded_clip_train_step,
    make_sharded_train_step,
)
from ntxent_tpu_torch.weights import load_flax_variables

PG_TIMEOUT = datetime.timedelta(seconds=60)
# The tiny CLIP of the tests (the JAX CLI's ``--model tiny`` towers at
# width 32, 16 px images, 16 tokens of a 100-id vocabulary).
TINY_CLIP = dict(image=16, tokens=16, vocab=100, width=32)


def nest(flat: dict, prefix: str) -> dict:
    """``{"params/a/b": x}`` -> ``{"a": {"b": x}}`` for one prefix."""
    out: dict = {}
    for key, value in flat.items():
        if not key.startswith(prefix + "/"):
            continue
        node = out
        *path, leaf = key[len(prefix) + 1:].split("/")
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = np.asarray(value)
    return out


def _shard(x: np.ndarray, rank: int, world: int) -> torch.Tensor:
    n = x.shape[0] // world
    return torch.from_numpy(np.ascontiguousarray(x[rank * n:(rank + 1) * n]))


def _config(inp) -> TrainerConfig:
    """The ``TrainerConfig`` of the input's ``cfg:<field>`` entries."""
    return TrainerConfig(**{key[len("cfg:"):]: inp[key].item()
                            for key in inp.files if key.startswith("cfg:")})


def _comms(delta: dict, prefix: str) -> dict:
    return {f"{prefix}:{op}": np.array([calls, nbytes])
            for (op, _), (calls, nbytes) in delta.items()}


def loss_job(rank: int, world: int, inp) -> dict:
    """The distributed loss of the global views z1, z2 and the gradients
    of this rank's shards."""
    z1 = _shard(inp["z1"], rank, world).requires_grad_()
    z2 = _shard(inp["z2"], rank, world).requires_grad_()
    mark = mesh.comms_accounting().totals()
    loss = ntxent_loss_distributed(z1, z2, temperature=float(inp["t"]))
    loss.backward()
    return {"loss": loss.detach().numpy(), "g1": z1.grad.numpy(),
            "g2": z2.grad.numpy(),
            **_comms(mesh.comms_accounting().delta(mark), "loss_comms")}


def step_job(rank: int, world: int, inp) -> dict:
    """Train steps of the ``tiny`` SimCLR model (fp32) from the flax
    variables of the input on this rank's rows of each step's views."""
    variables = {"params": nest(inp, "params"),
                 "batch_stats": nest(inp, "batch_stats")}
    proj = [int(x) for x in inp["proj"]]
    model = load_flax_variables(
        SimCLRModel(ResNet((1,), small_images=True, dtype=torch.float32),
                    *proj, dtype=torch.float32), variables)
    cross_replica_batch_norm(model, torch.distributed.group.WORLD)
    cfg = _config(inp)
    state = create_train_state(model, cfg, torch.device("cpu"))
    step = make_sharded_train_step(None, cfg.temperature)
    losses, delta = [], {}
    for v1, v2 in zip(inp["v1"], inp["v2"]):
        mark = mesh.comms_accounting().totals()
        state, metrics = step(state, _shard(v1, rank, world),
                              _shard(v2, rank, world))
        delta = mesh.comms_accounting().delta(mark)
        losses.append(float(metrics["loss"]))
    out = {"losses": np.array(losses), **_comms(delta, "step_comms")}
    for name, t in state.model.state_dict().items():
        out["state:" + name] = t.numpy()
    return out


def tiny_clip() -> CLIPModel:
    """The fp32 tiny CLIP model (random weights until loaded)."""
    c = TINY_CLIP
    image = VisionTransformer(image_size=c["image"], patch_size=8,
                              hidden_dim=c["width"], depth=2, num_heads=2,
                              mlp_dim=64, dtype=torch.float32)
    text = TextTransformer(vocab_size=c["vocab"], max_len=c["tokens"],
                           hidden_dim=c["width"], depth=2, num_heads=2,
                           dtype=torch.float32)
    return CLIPModel(image, text, embed_dim=c["width"])


def clip_loss_job(rank: int, world: int, inp) -> dict:
    """The data-parallel InfoNCE of the global pairs za, zb at a tensor
    scale, and the gradients of this rank's shards and of the scale."""
    za = _shard(inp["za"], rank, world).requires_grad_()
    zb = _shard(inp["zb"], rank, world).requires_grad_()
    scale = torch.tensor(float(inp["scale"]), requires_grad=True)
    mark = mesh.comms_accounting().totals()
    loss = local_infonce_dual(za, zb, scale)
    loss.backward()
    return {"loss": loss.detach().numpy(), "ga": za.grad.numpy(),
            "gb": zb.grad.numpy(), "gs": scale.grad.numpy(),
            **_comms(mesh.comms_accounting().delta(mark), "loss_comms")}


def clip_step_job(rank: int, world: int, inp) -> dict:
    """Train steps of the tiny CLIP from the flax parameters of the input
    on this rank's rows of each step's images and tokens."""
    model = load_flax_variables(tiny_clip(), {"params": nest(inp, "params")})
    cfg = _config(inp)
    state = create_clip_train_state(model, cfg, torch.device("cpu"))
    step = make_sharded_clip_train_step(None)
    losses, delta = [], {}
    for images, tokens in zip(inp["images"], inp["tokens"]):
        mark = mesh.comms_accounting().totals()
        state, metrics = step(state, _shard(images, rank, world),
                              _shard(tokens, rank, world).long())
        delta = mesh.comms_accounting().delta(mark)
        losses.append(float(metrics["loss"]))
    out = {"losses": np.array(losses), **_comms(delta, "step_comms")}
    for name, t in state.model.state_dict().items():
        out["state:" + name] = t.numpy()
    return out


def _join(store: str, rank: int, world: int) -> None:
    torch.set_num_threads(1)
    mesh.init_from_file(store, rank, world, device="cpu", timeout=PG_TIMEOUT)


def _run_jobs(jobs, rank: int, world: int, inputs: str, out: str) -> None:
    inp = np.load(inputs)
    results = {"jax_loaded": np.array("jax" in sys.modules)}
    for job in jobs:
        results |= job(rank, world, inp)
    np.savez(Path(out) / f"rank{rank}.npz", **results)


def run(rank: int, world: int, store: str, inputs: str, out: str) -> None:
    """One rank: join the world, run the SimCLR jobs, write the results."""
    _join(store, rank, world)
    try:
        _run_jobs((loss_job, step_job), rank, world, inputs, out)
    finally:
        mesh.shutdown()


def _train_main(rank: int, world: int, argv: list, out: str) -> int:
    """``ntxent-train`` in the joined group under a launcher's environment,
    its log records written to ``<out>/rank<r>.log``."""
    os.environ.update(RANK=str(rank), LOCAL_RANK=str(rank),
                      WORLD_SIZE=str(world))
    handler = logging.FileHandler(Path(out) / f"rank{rank}.log")
    handler.setFormatter(logging.Formatter("%(name)s: %(message)s"))
    logging.getLogger().addHandler(handler)
    logging.getLogger().setLevel(logging.INFO)
    # the group a launcher would have set up: train_main finds it joined
    # and leaves it at its end
    return cli.train_main(argv)


def run_clip(rank: int, world: int, store: str, inputs: str, out: str,
             cli_argv: list | None = None) -> None:
    """One rank: join the world, run the CLIP jobs, write the results,
    then, given ``cli_argv``, run ``ntxent-train`` in the same world."""
    _join(store, rank, world)
    try:
        _run_jobs((clip_loss_job, clip_step_job), rank, world, inputs, out)
        if cli_argv is not None and _train_main(rank, world, cli_argv, out):
            sys.exit(1)
    finally:
        mesh.shutdown()


def run_cli(rank: int, world: int, store: str, argv: list, out: str) -> None:
    """One rank of ``ntxent-train`` under a launcher's environment, its log
    records written to ``<out>/rank<r>.log``."""
    _join(store, rank, world)
    sys.exit(_train_main(rank, world, argv, out))
