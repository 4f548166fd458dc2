"""Rank processes of ``test_torch_distributed.py``: worlds of gloo ranks on
the CPU that meet over a ``FileStore``.

This module imports torch and the port, never JAX: each rank is a fresh
interpreter that imports only what it unpickles (``run`` and this
module). Inputs come from an ``.npz`` the test wrote; each rank writes
its results to ``<out>/rank<r>.npz``.
"""

from __future__ import annotations

import logging
import os
import sys
from pathlib import Path

import numpy as np
import torch

from ntxent_tpu_torch import cli
from ntxent_tpu_torch.models import (
    ResNet,
    SimCLRModel,
    cross_replica_batch_norm,
)
from ntxent_tpu_torch.parallel import mesh, ntxent_loss_distributed
from ntxent_tpu_torch.training import (
    TrainerConfig,
    create_train_state,
    make_sharded_train_step,
)
from ntxent_tpu_torch.weights import load_flax_variables


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
    cfg = TrainerConfig(**{k: inp["cfg:" + k].item() for k in (
        "batch_size", "temperature", "base_lr", "weight_decay",
        "warmup_steps", "total_steps")})
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


def run(rank: int, world: int, store: str, inputs: str, out: str) -> None:
    """One rank: join the world, run the jobs, write the results."""
    torch.set_num_threads(1)
    mesh.init_from_file(store, rank, world, device="cpu")
    try:
        inp = np.load(inputs)
        results = {"jax_loaded": np.array("jax" in sys.modules)}
        for job in (loss_job, step_job):
            results |= job(rank, world, inp)
        np.savez(Path(out) / f"rank{rank}.npz", **results)
    finally:
        mesh.shutdown()


def run_cli(rank: int, world: int, store: str, argv: list, out: str) -> None:
    """One rank of ``ntxent-train`` under a launcher's environment, its log
    records written to ``<out>/rank<r>.log``."""
    torch.set_num_threads(1)
    os.environ.update(RANK=str(rank), LOCAL_RANK=str(rank),
                      WORLD_SIZE=str(world))
    handler = logging.FileHandler(Path(out) / f"rank{rank}.log")
    handler.setFormatter(logging.Formatter("%(name)s: %(message)s"))
    logging.getLogger().addHandler(handler)
    logging.getLogger().setLevel(logging.INFO)
    # the group a launcher would have set up (train_main joins it or, as
    # here, finds it joined)
    mesh.init_from_file(store, rank, world, device="cpu")
    sys.exit(cli.train_main(argv))
