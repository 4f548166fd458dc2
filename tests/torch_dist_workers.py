"""Rank processes of ``test_torch_distributed.py``,
``test_torch_clip_dp.py``, ``test_torch_infonce_twopass.py``,
``test_torch_pair.py``, ``test_torch_resilience_dp.py``,
``test_torch_ring_attention.py``, ``test_torch_long_context.py``,
``test_torch_ring.py``, ``test_torch_quant_collectives.py``,
``test_torch_error_feedback.py``, ``test_torch_chunked.py`` and
``test_torch_graph_audit.py``: worlds of gloo ranks on the CPU that meet
over a ``FileStore``.

This module imports torch and the port, never JAX: each rank is a fresh
interpreter that imports only what it unpickles (``run``, ``run_clip``,
``run_pair``, ``run_ring``, ``run_guard``, ``run_cli``, ``run_wire``,
``run_audit`` and this module). Inputs come from an ``.npz`` the test wrote; each rank
writes its results to ``<out>/rank<r>.npz``. A rank's collectives give
up after ``PG_TIMEOUT``, well inside the test's deadline for the whole
world.
"""

from __future__ import annotations

import datetime
import json
import logging
import os
import sys
from pathlib import Path

import numpy as np
import torch

from ntxent_tpu_torch import cli
from ntxent_tpu_torch.models import (
    CLIPModel,
    LongContextTransformer,
    ResNet,
    SimCLRModel,
    TextTransformer,
    VisionTransformer,
    cross_replica_batch_norm,
)
from ntxent_tpu_torch.parallel import (
    collective_precision,
    make_ring_attention,
    make_ring_infonce,
    make_ring_ntxent,
    make_sharded_ntxent,
    make_ulysses_attention,
    mesh,
    ntxent_loss_distributed,
    ntxent_loss_pair,
    resolve_local_infonce,
)
from ntxent_tpu_torch.training import (
    TrainerConfig,
    create_clip_train_state,
    create_train_state,
    init_error_feedback,
    make_sharded_clip_train_step,
    make_sharded_train_step,
    measure_comms_overlap,
)
from ntxent_tpu_torch.weights import load_flax_variables

PG_TIMEOUT = datetime.timedelta(seconds=60)
# The long-context tower of the tests (the JAX package's
# tests/test_long_context.py sizes), fp32.
TINY_LONG_CONTEXT = dict(vocab_size=64, hidden_dim=32, depth=2, num_heads=8,
                         mlp_dim=64, max_len=32)
# Ring attention (impl, causal, transfer chunks) cases of the rank jobs.
RING_CASES = [(impl, causal, chunks) for impl in ("jnp", "flash")
              for causal in (False, True) for chunks in (1, 2)]
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


def _config(inp, prefix: str = "cfg:") -> TrainerConfig:
    """The ``TrainerConfig`` of the input's ``<prefix><field>`` entries."""
    return TrainerConfig(**{key[len(prefix):]: inp[key].item()
                            for key in inp.files if key.startswith(prefix)})


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


def _steps(rank: int, world: int, inp, loss_impl: str,
           prefix: str = "") -> dict:
    """Train steps of the ``tiny`` SimCLR model (fp32) from the flax
    variables of the input on this rank's rows of each step's views, with
    the NT-Xent schedule ``loss_impl``; result keys start with
    ``prefix``."""
    variables = {"params": nest(inp, "params"),
                 "batch_stats": nest(inp, "batch_stats")}
    proj = [int(x) for x in inp["proj"]]
    model = load_flax_variables(
        SimCLRModel(ResNet((1,), small_images=True, dtype=torch.float32),
                    *proj, dtype=torch.float32), variables)
    cross_replica_batch_norm(model, torch.distributed.group.WORLD)
    cfg = _config(inp)
    state = create_train_state(model, cfg, torch.device("cpu"))
    step = make_sharded_train_step(None, cfg.temperature,
                                   loss_impl=loss_impl)
    losses, delta = [], {}
    for v1, v2 in zip(inp["v1"], inp["v2"]):
        mark = mesh.comms_accounting().totals()
        state, metrics = step(state, _shard(v1, rank, world),
                              _shard(v2, rank, world))
        delta = mesh.comms_accounting().delta(mark)
        losses.append(float(metrics["loss"]))
    out = {f"{prefix}losses": np.array(losses),
           **_comms(delta, f"{prefix}step_comms")}
    for name, t in state.model.state_dict().items():
        out[f"{prefix}state:" + name] = t.numpy()
    return out


def step_job(rank: int, world: int, inp) -> dict:
    """Train steps of the ``tiny`` SimCLR model with the strip loss."""
    return _steps(rank, world, inp, "strip")


def guard_steps_job(rank: int, world: int, inp) -> dict:
    """Guarded data-parallel steps of the ``tiny`` SimCLR model from the
    input's flax variables; at step ``nan_step`` rank ``nan_rank``'s view-1
    rows are NaN. Returns each step's loss and ``step_ok``, the LARS count
    and the final state."""
    variables = {"params": nest(inp, "params"),
                 "batch_stats": nest(inp, "batch_stats")}
    proj = [int(x) for x in inp["proj"]]
    model = load_flax_variables(
        SimCLRModel(ResNet((1,), small_images=True, dtype=torch.float32),
                    *proj, dtype=torch.float32), variables)
    cross_replica_batch_norm(model, torch.distributed.group.WORLD)
    cfg = _config(inp)
    state = create_train_state(model, cfg, torch.device("cpu"))
    step = make_sharded_train_step(None, cfg.temperature, guard=True)
    losses, ok = [], []
    for i, (v1, v2) in enumerate(zip(inp["v1"], inp["v2"])):
        a = _shard(v1, rank, world)
        if i == int(inp["nan_step"]) and rank == int(inp["nan_rank"]):
            a = torch.full_like(a, float("nan"))
        state, metrics = step(state, a, _shard(v2, rank, world))
        losses.append(float(metrics["loss"]))
        ok.append(bool(metrics["step_ok"]))
    out = {"guard_losses": np.array(losses), "guard_ok": np.array(ok),
           "guard_count": np.array(state.optimizer.count),
           "guard_step": np.array(state.step)}
    for name, t in state.model.state_dict().items():
        out["state:" + name] = t.numpy()
    return out


def pair_loss_job(rank: int, world: int, inp) -> dict:
    """The pair-parallel loss of the global views z1, z2, the gradients of
    this rank's shards and the loss's comms; and the strip loss of the
    same views in the same world."""
    z1 = _shard(inp["z1"], rank, world).requires_grad_()
    z2 = _shard(inp["z2"], rank, world).requires_grad_()
    t = float(inp["t"])
    mark = mesh.comms_accounting().totals()
    loss = ntxent_loss_pair(z1, z2, temperature=t)
    loss.backward()
    delta = mesh.comms_accounting().delta(mark)
    strip = ntxent_loss_distributed(z1.detach(), z2.detach(), temperature=t)
    return {"pair_loss": loss.detach().numpy(), "pair_g1": z1.grad.numpy(),
            "pair_g2": z2.grad.numpy(), "strip_loss": strip.numpy(),
            **_comms(delta, "pair_loss_comms")}


def pair_steps_job(rank: int, world: int, inp) -> dict:
    """Train steps of the ``tiny`` SimCLR model with the pair loss and,
    from the same weights, with the strip loss."""
    return {**_steps(rank, world, inp, "pair", "pair_"),
            **_steps(rank, world, inp, "strip", "strip_")}


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


def _loss_impl(inp) -> str:
    """The InfoNCE body of the input (``loss_impl``; default "dual")."""
    return str(inp["loss_impl"]) if "loss_impl" in inp.files else "dual"


def clip_loss_job(rank: int, world: int, inp) -> dict:
    """The data-parallel InfoNCE (the input's ``loss_impl``) of the global
    pairs za, zb at a tensor scale, and the gradients of this rank's
    shards and of the scale."""
    za = _shard(inp["za"], rank, world).requires_grad_()
    zb = _shard(inp["zb"], rank, world).requires_grad_()
    scale = torch.tensor(float(inp["scale"]), requires_grad=True)
    mark = mesh.comms_accounting().totals()
    loss = resolve_local_infonce(_loss_impl(inp))(za, zb, scale, None)
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
    step = make_sharded_clip_train_step(None, _loss_impl(inp))
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


def _seq_shard(x: np.ndarray, rank: int, world: int) -> torch.Tensor:
    n = x.shape[1] // world
    return torch.from_numpy(
        np.ascontiguousarray(x[:, rank * n:(rank + 1) * n]))


def _attention_result(key, fn, rank, world, inp) -> dict:
    """Output and q/k/v gradients of ``fn`` on this rank's sequence shard
    of the inputs for the probe ``sum(out^2)``, and the comms of the
    forward and of the backward."""
    q, k, v = (_seq_shard(inp[f"ra_{n}"], rank, world).requires_grad_()
               for n in "qkv")
    mark = mesh.comms_accounting().totals()
    out = fn(q, k, v)
    fwd = mesh.comms_accounting().delta(mark)
    mark = mesh.comms_accounting().totals()
    out.float().pow(2).sum().backward()
    bwd = mesh.comms_accounting().delta(mark)
    return {f"{key}:out": out.detach().numpy(), f"{key}:gq": q.grad.numpy(),
            f"{key}:gk": k.grad.numpy(), f"{key}:gv": v.grad.numpy(),
            **_comms(fwd, f"{key}:fwd_comms"),
            **_comms(bwd, f"{key}:bwd_comms")}


def ring_attention_job(rank: int, world: int, inp) -> dict:
    """Ring attention (both impls, causal or not, one or two transfer
    chunks) and Ulysses attention on the sequence shards."""
    out = {}
    for impl, causal, chunks in RING_CASES:
        fn = make_ring_attention(causal=causal, impl=impl,
                                 transfer_chunks=chunks)
        out |= _attention_result(f"ring:{impl}:{causal}:{chunks}", fn, rank,
                                 world, inp)
    for causal in (False, True):
        out |= _attention_result(f"ulysses:{causal}",
                                 make_ulysses_attention(causal=causal), rank,
                                 world, inp)
    # a hop in three chunks along dim 1, and its gradient (the inverse hop)
    x = _seq_shard(inp["ra_q"], rank, world).requires_grad_()
    mark = mesh.comms_accounting().totals()
    y = mesh.ppermute_chunked(x, 1, None, chunks=3, dim=1)
    (y * (rank + 1)).sum().backward()
    return out | {"chunked:y": y.detach().numpy(),
                  "chunked:grad": x.grad.numpy(),
                  **_comms(mesh.comms_accounting().delta(mark),
                           "chunked:comms")}


def long_context_job(rank: int, world: int, inp) -> dict:
    """The tiny long-context tower from the flax parameters under the ring
    (jnp and flash) and Ulysses plans on this rank's token shard: its
    output shard and its share of every parameter's gradient of the probe
    ``sum(out^2)``."""
    out = {}
    plans = {"ring_jnp": make_ring_attention(causal=True),
             "ring_flash": make_ring_attention(causal=True, impl="flash"),
             "ulysses": make_ulysses_attention(causal=True)}
    tokens = _seq_shard(inp["lc_tokens"], rank, world).long()
    for name, plan in plans.items():
        model = load_flax_variables(
            LongContextTransformer(**TINY_LONG_CONTEXT, dtype=torch.float32,
                                   attention_fn=plan),
            {"params": nest(inp, "lc")})
        y = model(tokens)
        y.pow(2).sum().backward()
        out[f"lc:{name}:out"] = y.detach().numpy()
        for pname, param in model.named_parameters():
            out[f"lc:{name}:grad:{pname}"] = param.grad.numpy()
    return out


def ring_loss_job(rank: int, world: int, inp) -> dict:
    """The ring NT-Xent (fused and jnp) of the global views z1, z2 and the
    ring InfoNCE (dual and twoblock) of za, zb at a tensor scale: losses,
    gradients of this rank's shards (and of the scale), comms."""
    out = {}
    t = float(inp["t"])
    for impl in ("fused", "jnp"):
        z1 = _shard(inp["z1"], rank, world).requires_grad_()
        z2 = _shard(inp["z2"], rank, world).requires_grad_()
        mark = mesh.comms_accounting().totals()
        loss = make_ring_ntxent(None, t, impl=impl)(z1, z2)
        loss.backward()
        out |= {f"ntxent:{impl}:loss": loss.detach().numpy(),
                f"ntxent:{impl}:g1": z1.grad.numpy(),
                f"ntxent:{impl}:g2": z2.grad.numpy(),
                **_comms(mesh.comms_accounting().delta(mark),
                         f"ntxent:{impl}:comms")}
    for impl in ("dual", "twoblock"):
        za = _shard(inp["za"], rank, world).requires_grad_()
        zb = _shard(inp["zb"], rank, world).requires_grad_()
        scale = torch.tensor(float(inp["scale"]), requires_grad=True)
        mark = mesh.comms_accounting().totals()
        loss = make_ring_infonce(None, impl=impl)(za, zb, scale)
        loss.backward()
        out |= {f"infonce:{impl}:loss": loss.detach().numpy(),
                f"infonce:{impl}:ga": za.grad.numpy(),
                f"infonce:{impl}:gb": zb.grad.numpy(),
                f"infonce:{impl}:gs": scale.grad.numpy(),
                **_comms(mesh.comms_accounting().delta(mark),
                         f"infonce:{impl}:comms")}
    return out


# ---------------------------------------------------------------------------
# The data-parallel wire: quantized collectives, error feedback, the chunked
# ring (test_torch_quant_collectives.py, test_torch_error_feedback.py,
# test_torch_chunked.py)
# ---------------------------------------------------------------------------

WIRE_DTYPES = ("float32", "bf16", "int8")
# (chunks, wire) of the chunked loss's rank jobs
CHUNKED_CASES = [(c, w) for c in (1, 3, 4) for w in ("float32", "int8")]


def _tiny_simclr(inp, prefix: str = "") -> SimCLRModel:
    variables = {"params": nest(inp, prefix + "params"),
                 "batch_stats": nest(inp, prefix + "batch_stats")}
    proj = [int(x) for x in inp["proj"]]
    model = load_flax_variables(
        SimCLRModel(ResNet((1,), small_images=True, dtype=torch.float32),
                    *proj, dtype=torch.float32), variables)
    return cross_replica_batch_norm(model, torch.distributed.group.WORLD)


def collectives_job(rank: int, world: int, inp) -> dict:
    """Every wire dtype through the shims: the gather of ``gx``'s rows
    (value, comms, the gradient of the probe ``psum(sum(g * row index))``),
    the pmean of ``rx``, the psum_scatter of the replicated ``sx``, a
    scalar and an int32 psum under int8, the bf16 gather of ``bx``, and
    the registry's collective series."""
    out = {}
    for wire in WIRE_DTYPES:
        x = _shard(inp["gx"], rank, world).requires_grad_()
        mark = mesh.comms_accounting().totals()
        with collective_precision(wire):
            g = mesh.all_gather(x)
            d = mesh.comms_accounting().delta(mark)
            rows = torch.arange(g.shape[0], dtype=torch.float32)[:, None]
            mesh.psum((g * rows).sum()).backward()
        out |= {f"gather:{wire}": g.detach().numpy(),
                f"gather_grad:{wire}": x.grad.numpy(),
                **_comms(d, f"gather_comms:{wire}")}
        r = _shard(inp["rx"], rank, world)
        mark = mesh.comms_accounting().totals()
        with collective_precision(wire):
            y = mesh.pmean(r)
        out |= {f"pmean:{wire}": y.numpy(),
                **_comms(mesh.comms_accounting().delta(mark),
                         f"pmean_comms:{wire}")}
        with collective_precision(wire):
            out[f"scatter:{wire}"] = mesh.psum_scatter(
                torch.from_numpy(inp["sx"])).numpy()
    ones = _shard(inp["ones"], rank, world)
    with collective_precision("int8"):
        total = mesh.psum(ones.sum())
        ids = mesh.psum(torch.arange(4, dtype=torch.int32))
    out["exact"] = (total + ids.sum()).numpy()
    b = _shard(inp["bx"], rank, world)
    mark = mesh.comms_accounting().totals()
    with collective_precision("bf16"):
        gb = mesh.all_gather(b)
    out |= {"bf16_gather_dtype": np.array(str(gb.dtype)),
            **_comms(mesh.comms_accounting().delta(mark), "bf16_comms")}
    from ntxent_tpu_torch.obs.registry import default_registry

    out["prometheus"] = np.array(default_registry().render_prometheus())
    return out


def backward_thread_job(rank: int, world: int, inp) -> dict:
    """The pair loss under int8 (its backward psum quantizes) and a bf16
    gather (its backward is a bf16 reduce-scatter): gradients with the
    backward on this thread and on another one, whose thread-local policy
    is float32."""
    import threading

    out = {}
    for name, wire in (("pair", "int8"), ("gather", "bf16")):
        for where in ("same", "thread"):
            z1 = _shard(inp["z1"], rank, world).requires_grad_()
            z2 = _shard(inp["z2"], rank, world).requires_grad_()
            with collective_precision(wire):
                if name == "pair":
                    loss = ntxent_loss_pair(z1, z2, temperature=0.1)
                else:
                    loss = (mesh.all_gather(z1).pow(2).sum()
                            + mesh.all_gather(z2).sum())
            if where == "same":
                with collective_precision(wire):
                    loss.backward()
            else:
                worker = threading.Thread(target=loss.backward)
                worker.start()
                worker.join()
            out[f"{name}:{where}:g1"] = z1.grad.numpy()
        with collective_precision("float32"):
            z1 = _shard(inp["z1"], rank, world).requires_grad_()
            z2 = _shard(inp["z2"], rank, world)
            loss = (ntxent_loss_pair(z1, z2, temperature=0.1)
                    if name == "pair" else mesh.all_gather(z1).pow(2).sum())
            loss.backward()
        out[f"{name}:float32:g1"] = z1.grad.numpy()
    return out


def ef_carry_job(rank: int, world: int, inp) -> dict:
    """Three steps of the int8 gradient all-reduce with error feedback on
    ``theta - target[rank]`` (theta moved by the reduced mean at lr
    ``lr``): each step's reduced value and residual."""
    target = torch.from_numpy(inp["targets"][rank])
    theta = torch.zeros_like(target)
    small = torch.from_numpy(inp["small"])
    residual = [torch.zeros_like(target), torch.zeros_like(small)]
    out = {}
    for k in range(3):
        mark = mesh.comms_accounting().totals()
        grads, residual = mesh.quantized_grad_reduce(
            [theta - target, small * (rank + 1)], residual)
        out |= {f"ef:{k}:reduced": grads[0].numpy().copy(),
                f"ef:{k}:small": grads[1].numpy().copy(),
                f"ef:{k}:residual": residual[0].numpy().copy(),
                **_comms(mesh.comms_accounting().delta(mark),
                         f"ef:{k}:comms")}
        theta = theta - float(inp["lr"]) * grads[0]
    return out


def wire_steps_job(rank: int, world: int, inp) -> dict:
    """Two int8 steps of the ``tiny`` SimCLR model (error feedback, the
    strip loss) and two of the tiny CLIP (error feedback, the dual loss)
    from the input's flax weights: losses, final state, this rank's
    residual, the step's comms."""
    out = {}
    cfg = _config(inp)
    state = init_error_feedback(create_train_state(
        _tiny_simclr(inp), cfg, torch.device("cpu")))
    step = make_sharded_train_step(None, cfg.temperature,
                                   collective_dtype="int8")
    losses = []
    for v1, v2 in zip(inp["v1"], inp["v2"]):
        mark = mesh.comms_accounting().totals()
        state, metrics = step(state, _shard(v1, rank, world),
                              _shard(v2, rank, world))
        delta = mesh.comms_accounting().delta(mark)
        losses.append(float(metrics["loss"]))
    out |= {"simclr:losses": np.array(losses),
            **_comms(delta, "simclr:comms")}
    names = [n for n, _ in state.model.named_parameters()]
    for name, t in state.model.state_dict().items():
        out["simclr:state:" + name] = t.numpy()
    for name, e in zip(names, state.ef_residual):
        out["simclr:ef:" + name] = e.numpy()

    model = load_flax_variables(tiny_clip(),
                                {"params": nest(inp, "clip_params")})
    cstate = init_error_feedback(create_clip_train_state(
        model, _config(inp, "clip_cfg:"), torch.device("cpu")))
    cstep = make_sharded_clip_train_step(None, collective_dtype="int8")
    losses = []
    for images, tokens in zip(inp["images"], inp["tokens"]):
        cstate, metrics = cstep(cstate, _shard(images, rank, world),
                                _shard(tokens, rank, world).long())
        losses.append(float(metrics["loss"]))
    out["clip:losses"] = np.array(losses)
    names = [n for n, _ in cstate.model.named_parameters()]
    for name, t in cstate.model.state_dict().items():
        out["clip:state:" + name] = t.numpy()
    for name, e in zip(names, cstate.ef_residual):
        out["clip:ef:" + name] = e.numpy()
    return out


def chunked_job(rank: int, world: int, inp) -> dict:
    """The chunked loss of the global views z1, z2 at each of
    ``CHUNKED_CASES`` and the strip loss under each wire: loss, gradients
    of this rank's shards, the forward's comms; the plain ring fold with
    chunks (``make_ring_ntxent(impl="jnp")``); the overlap A/B."""
    out = {}
    t = float(inp["t"])
    cases = [("chunked", c, w) for c, w in CHUNKED_CASES] + \
        [("strip", None, w) for w in ("float32", "int8")] + \
        [("jnp", 3, "float32")]
    for impl, chunks, wire in cases:
        z1 = _shard(inp["z1"], rank, world).requires_grad_()
        z2 = _shard(inp["z2"], rank, world).requires_grad_()
        mark = mesh.comms_accounting().totals()
        with collective_precision(wire):
            if impl == "jnp":
                loss = make_ring_ntxent(None, t, impl="jnp",
                                        chunks=chunks)(z1, z2)
            else:
                loss = make_sharded_ntxent(None, t, impl=impl,
                                           ring_chunks=chunks)(z1, z2)
            fwd = mesh.comms_accounting().delta(mark)
            loss.backward()
        key = f"{impl}:{chunks}:{wire}"
        out |= {f"{key}:loss": loss.detach().numpy(),
                f"{key}:g1": z1.grad.numpy(), f"{key}:g2": z2.grad.numpy(),
                **_comms(fwd, f"{key}:comms")}
    overlap = measure_comms_overlap(None, int(inp["z1"].shape[0]) // world,
                                    int(inp["z1"].shape[1]), repeats=2,
                                    warmup=1, ring_chunks=2)
    out["overlap"] = np.array(json.dumps(overlap))
    return out


# the chunks of the chunked backward's rank job, one case a wire
CHUNKED_AD_CHUNKS = 2


def chunked_ad_job(rank: int, world: int, inp) -> dict:
    """The chunked loss's backward under each wire at
    ``CHUNKED_AD_CHUNKS`` chunks: the gradients of this rank's shards and
    the collective census of the backward alone (``[op, dtype, bytes]``
    an entry: autograd's traffic, which the accounting never declares)."""
    from ntxent_tpu_torch.analysis.graph.census import CollectiveCensus

    out = {}
    t = float(inp["t"])
    for wire in WIRE_DTYPES:
        z1 = _shard(inp["z1"], rank, world).requires_grad_()
        z2 = _shard(inp["z2"], rank, world).requires_grad_()
        with collective_precision(wire):
            loss = make_sharded_ntxent(None, t, impl="chunked",
                                       ring_chunks=CHUNKED_AD_CHUNKS)(z1, z2)
            with CollectiveCensus() as census:
                loss.backward()
        key = f"chunked_ad:{wire}"
        out |= {f"{key}:loss": loss.detach().numpy(),
                f"{key}:g1": z1.grad.numpy(), f"{key}:g2": z2.grad.numpy(),
                f"{key}:census": np.array(json.dumps(
                    [[e.op, e.dtype, e.total_bytes]
                     for e in census.entries]))}
    return out


WIRE_JOBS = {"collectives": collectives_job,
             "backward_thread": backward_thread_job,
             "ef_carry": ef_carry_job, "wire_steps": wire_steps_job,
             "chunked": chunked_job, "chunked_ad": chunked_ad_job}


def run_wire(rank: int, world: int, store: str, inputs: str, out: str,
             jobs: list, cli_runs: list | None = None) -> None:
    """One rank: join the world, run the named wire jobs (``WIRE_JOBS``),
    write the results, then each ``(log name, argv)`` of ``cli_runs``
    through ``ntxent-train`` in the same world, logging to
    ``<out>/<log name>.rank<r>.log``."""
    _join(store, rank, world)
    try:
        _run_jobs([WIRE_JOBS[name] for name in jobs], rank, world, inputs,
                  out)
        for name, argv in cli_runs or []:
            _train_main(rank, world, argv, out, f"{name}.rank{rank}.log")
    finally:
        mesh.shutdown()


RING_JOBS = {"attention": ring_attention_job,
             "long_context": long_context_job, "losses": ring_loss_job}


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


def _train_main(rank: int, world: int, argv: list, out: str,
                log: str | None = None) -> int:
    """``ntxent-train`` in the joined group under a launcher's environment,
    its log records written to ``<out>/<log>`` (default
    ``rank<r>.log``)."""
    os.environ.update(RANK=str(rank), LOCAL_RANK=str(rank),
                      WORLD_SIZE=str(world))
    handler = logging.FileHandler(Path(out) / (log or f"rank{rank}.log"))
    handler.setFormatter(logging.Formatter("%(name)s: %(message)s"))
    logging.getLogger().addHandler(handler)
    logging.getLogger().setLevel(logging.INFO)
    # the group a launcher would have set up: train_main finds it joined
    # and leaves it at its end, unless ``log`` names one run of several,
    # which trains in the group and leaves it joined for the next
    try:
        if log is None:
            return cli.train_main(argv)
        cli.train(cli.build_train_parser().parse_args(argv))
        return 0
    finally:
        logging.getLogger().removeHandler(handler)
        handler.close()


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


def run_pair(rank: int, world: int, store: str, inputs: str, out: str,
             steps: bool, cli_argv: list | None = None) -> None:
    """One rank: join the world, run the pair loss (and, with ``steps``,
    the pair and strip train steps), write the results, then, given
    ``cli_argv``, run ``ntxent-train`` in the same world."""
    _join(store, rank, world)
    try:
        jobs = (pair_loss_job, pair_steps_job) if steps else (pair_loss_job,)
        _run_jobs(jobs, rank, world, inputs, out)
        if cli_argv is not None and _train_main(rank, world, cli_argv, out):
            sys.exit(1)
    finally:
        mesh.shutdown()


def run_guard(rank: int, world: int, store: str, inputs: str, out: str,
              cli_argv: list) -> None:
    """One rank: join the world, run the guarded steps, write the results,
    then run ``ntxent-train`` with ``cli_argv`` in the same world."""
    _join(store, rank, world)
    try:
        _run_jobs((guard_steps_job,), rank, world, inputs, out)
        if _train_main(rank, world, cli_argv, out):
            sys.exit(1)
    finally:
        mesh.shutdown()


def run_ring(rank: int, world: int, store: str, inputs: str, out: str,
             jobs: list) -> None:
    """One rank: join the world, run the named ring jobs (``RING_JOBS``),
    write the results."""
    _join(store, rank, world)
    try:
        _run_jobs([RING_JOBS[name] for name in jobs], rank, world, inputs,
                  out)
    finally:
        mesh.shutdown()


def run_cli(rank: int, world: int, store: str, argv: list, out: str) -> None:
    """One rank of ``ntxent-train`` under a launcher's environment, its log
    records written to ``<out>/rank<r>.log``."""
    _join(store, rank, world)
    sys.exit(_train_main(rank, world, argv, out))


def _audit_jobs(rank: int, world: int) -> dict:
    """``tests/test_torch_graph_audit.py``'s rank work: every analyzer
    over the default audit targets, each census-fwd/grad and wire-dtype
    target's census entries, a doctored float32 all-reduce under int8, a
    snapshot of ``.numpy()`` views under the donation analyzer, and two
    sharded train steps of the tiny audit model with a timeline."""
    from ntxent_tpu_torch import obs
    from ntxent_tpu_torch.analysis.graph import cli as audit_cli
    from ntxent_tpu_torch.analysis.graph.census import census_of_callable
    from ntxent_tpu_torch.analysis.graph.donation import donation_findings
    from ntxent_tpu_torch.analysis.graph.targets import (
        default_targets,
        tiny_state,
    )
    from ntxent_tpu_torch.analysis.graph.wiredtype import (
        wire_dtype_findings,
    )
    from ntxent_tpu_torch.training import make_train_step, train_loop

    targets = default_targets()
    findings, report = audit_cli.run_analyzers(
        targets, ("collective-census", "wire-dtype", "donation"),
        publish=False)
    entries = {}
    for t in targets:
        if t.kind in ("census-fwd", "census-grad", "wire-dtype"):
            built = t.build()
            got, _ = census_of_callable(built["fn"], *built["args"])
            entries[t.name] = [[e.op, e.dtype, list(e.shape), e.calls,
                                e.total_bytes, e.thread] for e in got]

    def leak():  # a float32 payload the int8 policy should have cut
        with collective_precision("int8"):
            torch.distributed.all_reduce(torch.ones(2048))

    leaked, _ = census_of_callable(leak)
    doctored = wire_dtype_findings(leaked, "int8", "doctored/f32")

    def views(state):  # zero-copy: aliases the live parameters
        return {k: t.detach().numpy()
                for k, t in state.model.state_dict().items()}

    state = tiny_state()
    rng = np.random.default_rng(1)
    args = tuple(torch.from_numpy(rng.standard_normal(
        (4, 8, 8, 3)).astype(np.float32)) for _ in range(2))
    bad = donation_findings(make_train_step(0.1, use_fused=False), state,
                            args, views, "doctored/views")

    registry = obs.MetricsRegistry()
    timeline = obs.StepTimeline(registry=registry)
    state = tiny_state()
    batches = [tuple(torch.from_numpy(rng.standard_normal(
        (2, 8, 8, 3)).astype(np.float32)) for _ in range(2))
        for _ in range(2)]
    train_loop(state, iter(batches), make_sharded_train_step(), 2,
               log=False, timeline=timeline)
    graph = registry.collect().get("collective_graph_bytes_total", {})
    return {"findings": [vars(f) for f in findings], "report": report,
            "entries": entries,
            "doctored": [vars(f) for f in doctored],
            "views": [vars(f) for f in bad],
            "train_ad_bytes": graph.get('{source="ad"}'),
            "jax_loaded": "jax" in sys.modules}


def run_audit(rank: int, world: int, store: str, out: str) -> None:
    """One rank: join the world, run ``_audit_jobs``, write
    ``<out>/rank<r>.json``."""
    _join(store, rank, world)
    try:
        result = _audit_jobs(rank, world)
        with open(Path(out) / f"rank{rank}.json", "w") as f:
            json.dump(result, f)
    finally:
        mesh.shutdown()
