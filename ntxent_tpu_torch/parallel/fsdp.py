"""Fully-sharded data parallelism (ZeRO-3), counterpart of
``ntxent_tpu/parallel/fsdp.py``.

The JAX package places every leaf with ``fsdp_param_spec`` and lets
GSPMD gather weights at use and reduce-scatter their gradients. The
port holds the slices explicitly (``parallel.shards.Sharding``):

* ``fsdp_param_spec`` (``fsdp.py:86``): the largest dimension the data
  group divides (``largest_divisible_dim``, ``:68``; trailing wins ties)
  of a leaf of at least ``MIN_SHARD_ELEMS`` (2**14) elements; smaller
  leaves and leaves nothing divides stay whole on every rank. The rule
  reads the torch shape: the same dimensions as the flax shape, in
  another order, so the same leaves are cut and
  ``param_bytes_per_device`` (``:132``) is JAX's.
* ``shard_train_state_fsdp`` (``:109``) cuts the parameters and the
  optimizer's per-parameter tensors (LARS trace, AdamW moments, the
  ``MultiSteps`` accumulator) over the data group.
* ``make_fsdp_train_step`` (``:194``) / ``make_fsdp_clip_train_step``
  (``:312``): a step gathers the cut parameters into the module, runs
  the data-parallel loss body over the batch group, reduce-scatters the
  mean gradient into the slices, updates the slices (LARS's norms psum'd
  over the data group) and frees the gathered parameters. The gather is
  one per step, not one per layer at use as GSPMD schedules it: between
  steps a rank keeps its slices only.
* Hybrid ZeRO (``_resolve_batch_axes``, ``:163``): on a ('dcn', 'data')
  grid the parameters are cut over the intra-slice ``data`` group and
  replicated across slices; the batch spans every rank.

BatchNorm statistics are those of the global batch (cross-replica over
the batch group) and switch-MoE layers route over the global token
order, as in JAX's one global-batch program; the MoE aux loss is then
global on every rank (``metrics["moe_aux"]``).
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from .mesh import world_size
from .moe import set_global_routing
from .shards import (
    Leaf,
    Sharding,
    param_bytes_per_device,
    sharded_step,
    step_metrics,
    with_aux,
)
from .tp import clip_body, simclr_body

__all__ = ["MIN_SHARD_ELEMS", "fsdp_param_spec", "largest_divisible_dim",
           "make_fsdp_clip_train_step", "make_fsdp_train_step",
           "param_bytes_per_device", "shard_train_state_fsdp"]

# Leaves smaller than this many elements stay whole (fsdp.py:65)
MIN_SHARD_ELEMS = 2 ** 14


def largest_divisible_dim(shape, axis_size: int, taken=()) -> int | None:
    """Index of the largest ``axis_size``-divisible dimension not in
    ``taken``, the trailing one on ties; None when none divides."""
    best = None
    for i, d in enumerate(shape):
        if i in taken or d % axis_size:
            continue
        if best is None or d >= best[0]:
            best = (d, i)
    return None if best is None else best[1]


def fsdp_param_spec(shape, *, axis: str = "data", axis_size: int,
                    min_shard_elems: int = MIN_SHARD_ELEMS) -> tuple:
    """The JAX rule as a tuple (``PartitionSpec`` entries): ``axis`` at
    the cut dimension, ``()`` for a whole leaf."""
    numel = 1
    for d in shape:
        numel *= int(d)
    if not shape or numel < min_shard_elems:
        return ()
    i = largest_divisible_dim(shape, axis_size)
    if i is None:
        return ()
    return tuple(axis if j == i else None for j in range(len(shape)))


def shard_train_state_fsdp(state, data_group=None, *, dcn_group=None,
                           batch_group=None,
                           min_shard_elems: int = MIN_SHARD_ELEMS):
    """Cut the whole ``state`` over ``data_group`` (None: the default
    group) in place and return it. ``dcn_group``: the slices of hybrid
    ZeRO (each cut replicated over it); ``batch_group`` (None: the
    default group) must hold the data group's ranks: the cut's gradient
    reduce-scatter rides the batch (``fsdp.py:163-180``)."""
    group = data_group if data_group is not None else dist.group.WORLD
    if batch_group is not None:
        inside = set(dist.get_process_group_ranks(batch_group))
        if not set(dist.get_process_group_ranks(group)) <= inside:
            raise ValueError("the parameter group must be one of the batch "
                             "group's ranks (its gradient reduce-scatter "
                             "rides the batch program)")
    size = world_size(group)
    leaves = {}
    for name, p in state.model.named_parameters():
        spec = fsdp_param_spec(tuple(p.shape), axis_size=size,
                               min_shard_elems=min_shard_elems)
        if spec:
            leaves[name] = Leaf(dp_dim=spec.index("data"))
    from ..models.layers import cross_replica_batch_norm

    batch = batch_group if batch_group is not None else dist.group.WORLD
    cross_replica_batch_norm(state.model, batch)
    return Sharding(leaves, data_group=group, batch_group=batch,
                    dcn_group=dcn_group).apply(state)


def make_fsdp_train_step(temperature: float = 0.1, *,
                         loss_impl: str = "strip", remat: bool = False,
                         moe_aux_weight: float = 0.0,
                         ring_chunks: int | None = None):
    """``train_step(state, v1, v2) -> (state, {"loss"})`` of a state
    placed by ``shard_train_state_fsdp``: ``v1``, ``v2`` are this rank's
    rows of the global batch; ``loss_impl`` ``"strip"``, ``"pair"``,
    ``"chunked"`` or ``"oracle"`` over the batch group.
    ``moe_aux_weight`` > 0 adds the global load-balance loss and
    reports ``metrics["moe_aux"]`` (``fsdp.py:194-310``)."""
    from ..training.trainer import apply_two_views

    body = simclr_body(loss_impl, ring_chunks)
    collect = moe_aux_weight > 0.0

    def train_step(state, v1: torch.Tensor, v2: torch.Tensor):
        sh = state.sharding
        seen = {}

        def loss_of(model):
            set_global_routing(model, sh.batch_group, 2)
            z = apply_two_views(model, v1, v2, remat)
            n = v1.shape[0]
            loss = body(z[:n], z[n:], temperature, sh.batch_group)
            return with_aux(loss, model, moe_aux_weight, seen)

        return state, step_metrics(sharded_step(state, loss_of), collect,
                                   seen)

    return train_step


def make_fsdp_clip_train_step(*, loss_impl: str = "dual",
                              remat: bool = False,
                              moe_aux_weight: float = 0.0):
    """``train_step(state, images, tokens) -> (state, {"loss"})`` of a
    CLIP state placed by ``shard_train_state_fsdp`` (``fsdp.py:312``):
    ``loss_impl`` ``"dual"``, ``"twopass"`` or ``"oracle"`` over the
    batch group; ``moe_aux_weight`` as in ``make_fsdp_train_step``."""
    from ..training.trainer import _forward

    body = clip_body(loss_impl)
    collect = moe_aux_weight > 0.0

    def train_step(state, images: torch.Tensor, tokens: torch.Tensor):
        sh = state.sharding
        seen = {}

        def loss_of(model):
            set_global_routing(model, sh.batch_group, 1)
            zi, zt, scale = _forward(remat, model, images, tokens)
            loss = body(zi, zt, scale, sh.batch_group)
            return with_aux(loss, model, moe_aux_weight, seen)

        return state, step_metrics(sharded_step(state, loss_of), collect,
                                   seen)

    return train_step

