"""The audited entry points: small, real instances of every collective
class the suite must see, the port's counterpart of
``ntxent_tpu/analysis/graph/targets.py``.

Each target is a *build function* (construction deferred so ``--list`` and
argument parsing never build a model) returning the callable and its
arguments for one audit, on this rank's shard. Every rank of the group
runs every target in the same order: the census RUNS the collectives.

* **census-fwd** -- forward losses whose census must EXACTLY match the
  declared ring formulas per wire op (``dist_loss`` strip, the ``ring``
  path, the chunked ring-overlap schedule), the row-parallel product of
  tensor parallelism (``tp/matmul``: the port's counterpart of JAX's
  GSPMD target, an explicit ``reduce_from_group``) and the serving int8
  rung (its census must be empty);
* **census-grad** -- the gradient of the same losses with respect to
  the first view only (``jax.grad`` of ``lambda a, b`` differentiates
  ``a``): the census sees autograd's collectives, which the helpers never
  declare; the remainder is ``collective_graph_bytes_total{source="ad"}``;
* **wire-dtype** -- the gradient reduce under ``collective_precision(
  "int8"|"bf16")`` and the chunked schedule under int8 at D = 512: every
  eligible-sized collective must carry a compressed payload;
* **donation** -- one in-place train step of a tiny model after a host
  snapshot through the port's ``snapshot_state``.

The inputs are ``_loss_args``'s numpy arrays, the JAX targets' own:
``default_rng(0)``, (P n_local, dim) float32 z1 then z2, each rank
taking its rows. Sizes are tiny by default; ``chip_smoke.py`` runs the
loss targets at B = 256, D = 128 on the card.
"""

from __future__ import annotations

import dataclasses
from collections.abc import Callable

__all__ = ["AuditTarget", "default_targets", "loss_args"]


@dataclasses.dataclass(frozen=True)
class AuditTarget:
    """One audited entry point. ``build()`` -> dict with ``fn`` and
    ``args`` (census and wire-dtype targets; wire-dtype targets set
    ``policy``) or ``step``, ``state``, ``args`` and ``snapshot``
    (donation targets)."""

    name: str
    kind: str  # census-fwd | census-grad | wire-dtype | donation
    build: Callable[[], dict]
    policy: str | None = None


def loss_args(group=None, dim: int = 8, n_local: int = 2, device="cpu",
              grad: bool = False):
    """This rank's rows of the JAX targets' ``_loss_args``: (n_local,
    dim) float32 of z1 and z2 (z1 a leaf that requires grad when
    ``grad``)."""
    import numpy as np
    import torch

    from ...parallel.mesh import rank, world_size

    p, r = world_size(group), rank(group)
    rng = np.random.default_rng(0)
    z1 = rng.standard_normal((p * n_local, dim)).astype(np.float32)
    z2 = rng.standard_normal((p * n_local, dim)).astype(np.float32)
    rows = slice(r * n_local, (r + 1) * n_local)
    a = torch.from_numpy(z1[rows].copy()).to(device)
    b = torch.from_numpy(z2[rows].copy()).to(device)
    return a.requires_grad_(grad), b


def _grad_of(loss):
    """``fn(a, b)``: the gradient of ``loss(a, b)`` with respect to
    ``a`` only."""
    import torch

    def fn(a, b):
        return torch.autograd.grad(loss(a, b), a)[0]

    return fn


def _dist_loss(group, grad: bool, impl: str, device, dim: int,
               n_local: int):
    def build():
        from ...parallel.dist_loss import make_sharded_ntxent

        loss = make_sharded_ntxent(group, temperature=0.1, impl=impl,
                                   ring_chunks=2)
        return {"fn": _grad_of(loss) if grad else loss,
                "args": loss_args(group, dim, n_local, device, grad)}

    return build


def _dist_loss_chunked_int8(group, device):
    """The chunked schedule under the int8 wire policy: every circulating
    embedding chunk (2 rows x 512 dims = 1024 elems, exactly at the
    quantization floor) must be int8 on the wire; the per-row scale
    columns ride float32 legally below the floor."""

    def build():
        from ...parallel.dist_loss import make_sharded_ntxent
        from ...parallel.precision import collective_precision

        loss = make_sharded_ntxent(group, temperature=0.1, impl="chunked",
                                   ring_chunks=2)

        def fn(a, b):
            with collective_precision("int8"):
                return loss(a, b)

        return {"fn": fn, "args": loss_args(group, 512, 2, device)}

    return build


def _ring_loss(group, grad: bool, device):
    def build():
        from ...parallel.ring import make_ring_ntxent

        loss = make_ring_ntxent(group, temperature=0.1, impl="jnp")
        return {"fn": _grad_of(loss) if grad else loss,
                "args": loss_args(group, 8, 2, device, grad)}

    return build


def _grad_reduce(group, policy: str, device):
    def build():
        import torch

        from ...parallel import mesh as pm
        from ...parallel.precision import collective_precision

        tree = [torch.ones(4096, device=device),
                torch.ones(4, device=device)]
        if policy == "int8":
            residual = [torch.zeros_like(t) for t in tree]

            def fn(t, r):
                return pm.quantized_grad_reduce(t, r, group)[0]

            return {"fn": fn, "args": (tree, residual)}

        def fn(t):
            out = [x.clone() for x in t]
            with collective_precision(policy):
                pm.pmean_(out, group)
            return out

        return {"fn": fn, "args": (tree,)}

    return build


def _tp_matmul(group, device):
    """A row-parallel product (Megatron's ``g``): each rank multiplies its
    column block of x (4, 16) by its row block of w (16, 8) and
    ``reduce_from_group`` sums the partial outputs, the collective GSPMD
    inserts for the JAX target's row-sharded weight."""

    def build():
        import torch

        from ...parallel.mesh import rank, reduce_from_group, world_size

        p, r = world_size(group), rank(group)
        k = 16 // p
        x = torch.ones(4, 16, device=device)[:, r * k:(r + 1) * k]
        w = torch.ones(16, 8, device=device)[r * k:(r + 1) * k]

        def fn(a, b):
            return reduce_from_group(a @ b, group)

        return {"fn": fn, "args": (x.contiguous(), w.contiguous())}

    return build


def _serving_rung_int8(device):
    """The engine's quantized rung forward, exactly as it runs (the
    dequant over an int8 payload and per-example scales): its census
    must be EMPTY -- a serving forward that grew a collective would pay
    the wire on every request."""

    def build():
        import torch

        from ...serving.engine import InferenceEngine

        model = torch.nn.Linear(4, 8, bias=False)
        torch.nn.init.ones_(model.weight)
        eng = InferenceEngine(model, example_shape=(4,), buckets=(4,),
                              dtype=torch.int8, device=device)
        args = tuple(a.to(device) for a in eng._dummy_args(4))
        return {"fn": eng._make_run(eng.model), "args": args}

    return build


def tiny_state(device="cpu"):
    """A real TrainState over the smallest honest SimCLR model (a ResNet
    of one block at 8 px, a 16/8 projection) with the port's LARS: the
    train-step factories under audit are the package's own, only the
    encoder is shrunk."""
    import torch

    from ...models import ResNet, SimCLRModel
    from ...training.trainer import TrainerConfig, create_train_state

    torch.manual_seed(0)
    model = SimCLRModel(ResNet((1,), small_images=True,
                               dtype=torch.float32), 16, 8,
                        dtype=torch.float32)
    cfg = TrainerConfig(batch_size=4, total_steps=10, warmup_steps=2)
    return create_train_state(model, cfg, torch.device(device))


def _donated_train_step(device):
    def build():
        import numpy as np
        import torch

        from ...training.checkpoint import snapshot_state
        from ...training.trainer import make_train_step

        state = tiny_state(device)
        step = make_train_step(temperature=0.1, use_fused=False)
        rng = np.random.default_rng(1)
        v1, v2 = (torch.from_numpy(rng.standard_normal(
            (4, 8, 8, 3)).astype(np.float32)).to(device) for _ in range(2))
        return {"step": step, "state": state, "args": (v1, v2),
                "snapshot": snapshot_state}

    return build


def default_targets(group=None, device="cpu", dim: int = 8,
                    n_local: int = 2) -> list[AuditTarget]:
    """The standing audit suite (tests, ``ntxent-audit`` and
    ``chip_smoke.py`` share it) over ``group`` (None: the default
    group) on ``device``; ``dim`` and ``n_local`` size the ``dist_loss``
    targets."""
    sized = dict(device=device, dim=dim, n_local=n_local)
    return [
        AuditTarget("dist_loss/fwd", "census-fwd",
                    _dist_loss(group, False, "strip", **sized)),
        AuditTarget("dist_loss/grad", "census-grad",
                    _dist_loss(group, True, "strip", **sized)),
        AuditTarget("dist_loss_chunked/fwd", "census-fwd",
                    _dist_loss(group, False, "chunked", device, 8, 2)),
        AuditTarget("dist_loss_chunked/grad", "census-grad",
                    _dist_loss(group, True, "chunked", device, 8, 2)),
        AuditTarget("ring/fwd", "census-fwd",
                    _ring_loss(group, False, device)),
        AuditTarget("ring/grad", "census-grad",
                    _ring_loss(group, True, device)),
        AuditTarget("tp/matmul", "census-fwd", _tp_matmul(group, device)),
        AuditTarget("serving/rung_int8", "census-fwd",
                    _serving_rung_int8(device)),
        AuditTarget("grad_reduce/int8", "wire-dtype",
                    _grad_reduce(group, "int8", device), policy="int8"),
        AuditTarget("dist_loss_chunked/int8", "wire-dtype",
                    _dist_loss_chunked_int8(group, device), policy="int8"),
        AuditTarget("grad_reduce/bf16", "wire-dtype",
                    _grad_reduce(group, "bf16", device), policy="bf16"),
        AuditTarget("train_step/donated", "donation",
                    _donated_train_step(device)),
    ]
