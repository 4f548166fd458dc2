"""Tensor parallelism on a (data, model) grid of ranks, counterpart of
``ntxent_tpu/parallel/tp.py``.

The JAX package annotates shardings and GSPMD inserts the collectives.
The port has no GSPMD, so it runs Megatron's layout with explicit local
slices (DTensor could not pass through the ``ctypes`` kernel launches
inside the port's ``autograd.Function``s):

* ``tp_leaves(model, M)``: the JAX rule (``tp_param_spec`` and
  ``_drop_indivisible``, ``tp.py:71``, ``:242``) on the port's modules,
  the one layout decision of the package. Attention q/k/v hold ``H / M``
  heads and ``out`` the matching input columns (needs ``H % M == 0``);
  the dense MLP's fc1 its columns, fc2 its rows (``mlp_dim % M``); a
  switch-MoE layer the same slice of every expert's hidden axis f
  (``f % M``; the router and the expert axis stay whole). A dimension the
  model group does not divide stays whole, as in JAX.
* The modules run Megatron's ``f`` (``mesh.copy_to_group``) before each
  column-sharded product and ``g`` (``mesh.reduce_from_group``) after
  each row-sharded one, the row-sharded product's bias after the sum;
  flash attention (#11, #13, #14) runs on the rank's heads.
* ``shard_train_state`` (``tp.py:261``) cuts a state
  (``parallel.shards.Sharding``); ``shard_train_state_tp_fsdp``
  (``:197``, with ``tp_fsdp_param_spec`` ``:129``) also cuts the largest
  remaining divisible dimension over the data group (ZeRO-3).
* ``make_tp_simclr_train_step`` (``:290``) and ``make_tp_clip_train_step``
  (``:404``): the loss is the data-parallel body (``dist_loss``'s strip,
  pair or chunked NT-Xent; dual or two-pass InfoNCE) over the data group,
  every model rank computing the same rows (``loss_axes="data"``), or
  over every rank with each model rank taking its share of the data
  group's rows (``"both"``, ``mesh.split_rows``); ``"oracle"`` is the
  plain global loss over gathered embeddings. Gradients are averaged
  over the data group; a parameter the model group slices needs no more,
  a whole one has the same gradient on every model rank.

BatchNorm statistics are those of the global batch (cross-replica over
the data group), as in JAX's one global-batch program; switch-MoE layers
route over the global token order (``parallel.moe``).
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ..ops import oracle
from .dist_loss import resolve_local_infonce, resolve_local_ntxent
from .mesh import all_gather, split_rows, world_size
from .moe import set_global_routing
from .shards import Leaf, Sharding, sharded_step, step_metrics, with_aux

__all__ = ["make_tp_clip_train_step", "make_tp_simclr_train_step",
           "shard_train_state", "shard_train_state_tp_fsdp",
           "tp_fsdp_param_spec", "tp_leaves"]


def tp_leaves(model: torch.nn.Module, model_size: int) -> dict[str, int]:
    """``{parameter name: dimension cut over the model group}``: the JAX
    rule on the port's modules (module docstring)."""
    from ..models.layers import SeqParallelSelfAttention
    from ..models.vit import MlpBlock
    from .moe import MoEMlp

    out = {}
    for prefix, m in model.named_modules():
        pre = f"{prefix}." if prefix else ""
        if isinstance(m, SeqParallelSelfAttention) \
                and m.num_heads % model_size == 0:
            for proj in ("query", "key", "value"):
                out[f"{pre}{proj}.weight"] = 0
                out[f"{pre}{proj}.bias"] = 0
            out[f"{pre}out.weight"] = 1
        elif isinstance(m, MlpBlock) and m.fc1.out_features % model_size == 0:
            out |= {f"{pre}fc1.weight": 0, f"{pre}fc1.bias": 0,
                    f"{pre}fc2.weight": 1}
        elif isinstance(m, MoEMlp) and m.mlp_dim % model_size == 0:
            out |= {f"{pre}w_up": 2, f"{pre}b_up": 1, f"{pre}w_down": 1}
    return out


def _tp_modules(model: torch.nn.Module, cut: dict, group) -> None:
    """Set the tensor-parallel attributes of every module whose
    parameters ``cut`` slices."""
    from ..models.layers import SeqParallelSelfAttention
    from ..models.vit import MlpBlock
    from .moe import MoEMlp

    m_size = world_size(group)
    for prefix, m in model.named_modules():
        pre = f"{prefix}." if prefix else ""
        if isinstance(m, SeqParallelSelfAttention) \
                and f"{pre}query.weight" in cut:
            m.tp_group, m.local_heads = group, m.num_heads // m_size
        elif isinstance(m, MlpBlock) and f"{pre}fc1.weight" in cut:
            m.tp_group = group
        elif isinstance(m, MoEMlp) and f"{pre}w_up" in cut:
            m.tp_group = group


def shard_train_state(state, model_group, data_group=None):
    """Place the whole ``state`` on the (data, model) grid in place:
    parameters (and the optimizer's per-parameter tensors) sliced over
    ``model_group`` by ``tp_leaves``, BatchNorm statistics across
    ``data_group`` (None: the default group, a grid of one data row).
    Returns ``state``."""
    from ..models.layers import cross_replica_batch_norm

    cut = tp_leaves(state.model, world_size(model_group))
    _tp_modules(state.model, cut, model_group)
    cross_replica_batch_norm(state.model, data_group)
    leaves = {n: Leaf(tp_dim=d) for n, d in cut.items()}
    return Sharding(leaves, model_group=model_group,
                    batch_group=data_group).apply(state)


def tp_fsdp_param_spec(shape, tp_dim: int | None, data_size: int,
                       min_shard_elems: int | None = None) -> int | None:
    """The dimension the data group cuts under Megatron + ZeRO-3
    (``tp.py:129``): the largest ``data_size``-divisible dimension other
    than ``tp_dim`` (trailing wins ties), for a leaf of at least
    ``min_shard_elems`` elements; None: whole over the data group."""
    from .fsdp import MIN_SHARD_ELEMS, largest_divisible_dim

    if min_shard_elems is None:
        min_shard_elems = MIN_SHARD_ELEMS
    numel = 1
    for d in shape:
        numel *= int(d)
    if not shape or numel < min_shard_elems:
        return None
    taken = () if tp_dim is None else (tp_dim,)
    return largest_divisible_dim(shape, data_size, taken=taken)


def shard_train_state_tp_fsdp(state, model_group, data_group,
                              min_shard_elems: int | None = None):
    """Place the whole ``state`` with Megatron + ZeRO-3 (``tp.py:197``):
    the tensor-parallel slices of ``shard_train_state``, then each leaf's
    ``tp_fsdp_param_spec`` dimension cut over ``data_group``: the
    optimizer holds that slice, the step gathers it. Returns ``state``."""
    from ..models.layers import cross_replica_batch_norm

    cut = tp_leaves(state.model, world_size(model_group))
    d_size = world_size(data_group)
    leaves = {}
    for name, p in state.model.named_parameters():
        tp = cut.get(name)
        dp = tp_fsdp_param_spec(tuple(p.shape), tp, d_size, min_shard_elems)
        if tp is not None or dp is not None:
            leaves[name] = Leaf(tp_dim=tp, dp_dim=dp)
    _tp_modules(state.model, cut, model_group)
    cross_replica_batch_norm(state.model, data_group)
    return Sharding(leaves, model_group=model_group, data_group=data_group,
                    batch_group=data_group).apply(state)


def _loss_group(sh, loss_axes: str):
    if loss_axes not in ("data", "both"):
        raise ValueError(f"loss_axes must be 'data' or 'both', got "
                         f"{loss_axes!r}")
    return sh.batch_group if loss_axes == "data" else dist.group.WORLD


def _rows(x: torch.Tensor, sh, loss_axes: str) -> torch.Tensor:
    """``x`` (the data group's rows, the same on every model rank) as the
    loss takes it: whole, or this model rank's share under ``"both"``."""
    return split_rows(x, sh.model_group) if loss_axes == "both" else x


def oracle_ntxent(z1: torch.Tensor, z2: torch.Tensor, temperature: float,
                  group) -> torch.Tensor:
    """The plain global NT-Xent over the ranks' gathered rows
    (``loss_impl="oracle"``)."""
    z = torch.cat([all_gather(z1, group), all_gather(z2, group)])
    return oracle.ntxent_loss(z, temperature)


def oracle_infonce(zi: torch.Tensor, zt: torch.Tensor, scale: torch.Tensor,
                   group) -> torch.Tensor:
    """The plain global InfoNCE over the ranks' gathered rows."""
    return oracle.info_nce_loss(all_gather(zi, group), all_gather(zt, group),
                                temperature=1.0 / scale)


def simclr_body(loss_impl: str, ring_chunks: int | None = None):
    """``body(z1, z2, temperature, group)`` of ``loss_impl``: the
    data-parallel NT-Xent bodies, or ``"oracle"``."""
    if loss_impl == "oracle":
        return oracle_ntxent
    body = resolve_local_ntxent(loss_impl)
    if loss_impl == "chunked":
        def chunked(z1, z2, temperature, group):
            return body(z1, z2, temperature, group, chunks=ring_chunks)
        return chunked
    return body


def clip_body(loss_impl: str):
    """``body(zi, zt, scale, group)`` of ``loss_impl``: the data-parallel
    InfoNCE bodies, or ``"oracle"``."""
    return oracle_infonce if loss_impl == "oracle" \
        else resolve_local_infonce(loss_impl)


def _check_oracle(loss_impl: str, loss_axes) -> str:
    if loss_axes is None:
        return "data"
    if loss_impl == "oracle":
        # silently dropping the requested sharding would let an A/B pass
        # on one arm with no hint (tp.py:370-375)
        raise ValueError("loss_axes applies only to the fused impls; the "
                         "oracle loss is the global loss over every rank")
    return loss_axes


def make_tp_simclr_train_step(temperature: float = 0.1, *,
                              loss_impl: str = "strip",
                              loss_axes: str | None = None,
                              remat: bool = False,
                              ring_chunks: int | None = None):
    """``train_step(state, v1, v2) -> (state, {"loss"})`` of a state
    placed by ``shard_train_state`` (or ``shard_train_state_tp_fsdp``):
    ``v1``, ``v2`` are the data group's rows (the same on every model
    rank). ``loss_impl``: ``"strip"``, ``"pair"``, ``"chunked"`` or
    ``"oracle"``; ``loss_axes``: ``"data"`` (None) or ``"both"``
    (``tp.py:290-360``). Every rank returns the global loss."""
    from ..training.trainer import apply_two_views

    loss_axes = _check_oracle(loss_impl, loss_axes)
    body = simclr_body(loss_impl, ring_chunks)

    def train_step(state, v1: torch.Tensor, v2: torch.Tensor):
        sh = state.sharding
        group = _loss_group(sh, loss_axes)

        def loss_of(model):
            set_global_routing(model, sh.batch_group, 2)
            z = apply_two_views(model, v1, v2, remat)
            n = v1.shape[0]
            return body(_rows(z[:n], sh, loss_axes),
                        _rows(z[n:], sh, loss_axes), temperature, group)

        return state, {"loss": sharded_step(state, loss_of)}

    return train_step


def make_tp_clip_train_step(*, loss_impl: str = "dual",
                            loss_axes: str | None = None,
                            remat: bool = False,
                            moe_aux_weight: float = 0.0):
    """``train_step(state, images, tokens) -> (state, {"loss"})`` of a
    CLIP state placed by ``shard_train_state`` (``tp.py:404``):
    ``loss_impl`` ``"dual"``, ``"twopass"`` or ``"oracle"``;
    ``loss_axes`` as in ``make_tp_simclr_train_step``.
    ``moe_aux_weight`` > 0 adds the image tower's load-balance loss,
    routed over the global batch (one global program in JAX, so no
    pmean estimator), and reports ``metrics["moe_aux"]``."""
    from ..training.trainer import _forward

    loss_axes = _check_oracle(loss_impl, loss_axes)
    body = clip_body(loss_impl)

    def train_step(state, images: torch.Tensor, tokens: torch.Tensor):
        sh = state.sharding
        group = _loss_group(sh, loss_axes)
        seen = {}

        def loss_of(model):
            set_global_routing(model, sh.batch_group, 1)
            zi, zt, scale = _forward(remat, model, images, tokens)
            loss = body(_rows(zi, sh, loss_axes), _rows(zt, sh, loss_axes),
                        scale, group)
            return with_aux(loss, model, moe_aux_weight, seen)

        return state, step_metrics(sharded_step(state, loss_of),
                                   moe_aux_weight > 0.0, seen)

    return train_step
