"""Switch-MoE MLP and its expert-parallel form, counterpart of
``ntxent_tpu/parallel/moe.py``.

* **Routing** (``route``) is top-1: router logits and softmax in fp32,
  the expert of a token the first maximum of its probabilities, its gate
  that probability, its slot the number of earlier tokens (row-major
  token order) routed to the same expert. Tokens whose slot reaches the
  capacity ``C = ceil(T / E * capacity_factor)`` are dropped: their
  output is zero, so they pass through the residual stream.
* **Dispatch and combine by index.** The JAX layer builds a ``(T, E, C)``
  one-hot dispatch mask and runs two einsums over it; at the ViT-B/16
  step's shape (T = 100,864, E = 8, C = 15,760) that mask alone is 51 GB
  in fp32. The port gathers the kept tokens' rows into the ``(E, C, d)``
  expert batch (empty slots zero) and gathers each kept token's output
  row back, times its gate, in fp32. A one-hot einsum sums one nonzero
  product, so both give the same values.
* **Expert FFNs** are plain batched products (``torch.bmm``), as the JAX
  layer's are plain einsums outside any Pallas kernel.
* **Expert parallelism** (``make_expert_parallel_moe``): each rank routes
  its own tokens against all E experts (capacity from the LOCAL token
  count), one ``mesh.all_to_all`` moves the ``(E, C, d)`` batch from
  token-sharded to expert-sharded ``(E/P, P C, d)``, the rank's experts
  run, and the inverse all-to-all brings the rows home. The aux
  statistics are ``mesh.pmean``'d, so every rank's aux is the global one.
* **Global routing** (``MoEMlp.route_group``): under tensor or
  fully-sharded data parallelism the JAX layer runs inside one
  global-batch program, so capacity and slots are those of the GLOBAL
  token order. A rank that holds a slice of that order (its rows of each
  of ``route_segments`` equal segments, e.g. the two SimCLR views)
  all-gathers its per-segment expert counts, offsets its slots by the
  tokens that precede it globally and routes with the global capacity;
  the aux statistics are ``pmean``'d. Each rank then runs the experts
  only on its own tokens.
* **Load-balance aux loss** (Switch eq. 4): ``E * sum_e f_e p_e``,
  differentiable through ``p`` only.

``MoEMlp`` is the ``nn.Module`` the towers mount in place of the dense
MLP of every other block; it keeps the aux loss of its last forward
(flax ``sow``), and ``moe_aux_from(model)`` sums those of the ``MoEMlp``
modules only (``moe.py:57-72`` selects ``moe_aux_loss`` by name).
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F
from torch import nn

from .mesh import (
    all_gather,
    all_to_all,
    copy_to_group,
    pmean,
    rank,
    reduce_from_group,
    world_size,
)

__all__ = ["MoEMlp", "MoEParams", "init_moe_params",
           "make_expert_parallel_moe", "moe_aux_from", "route",
           "switch_moe"]


@dataclasses.dataclass
class MoEParams:
    """Weights of one switch-MoE layer (E experts, width d, hidden f), in
    the flax layout: no transposes between the packages."""

    router: torch.Tensor  # (d, E)
    w_up: torch.Tensor    # (E, d, f)
    b_up: torch.Tensor    # (E, f)
    w_down: torch.Tensor  # (E, f, d)
    b_down: torch.Tensor  # (E, d)


def _lecun_(t: torch.Tensor, generator) -> torch.Tensor:
    """flax ``lecun_normal()`` (fan_in = shape[-2]) from ``generator``."""
    from ..models.layers import lecun_normal_

    return lecun_normal_(t, t.shape[-2], generator)


def init_moe_params(generator: torch.Generator, num_experts: int, d: int,
                    mlp_dim: int, device=None) -> MoEParams:
    """``init_moe_params`` (``moe.py:90``): LeCun-normal router and expert
    kernels, zero biases, fp32, drawn from ``generator``."""
    def zeros(*shape):
        return torch.zeros(*shape, device=device)

    with torch.no_grad():
        return MoEParams(
            router=_lecun_(zeros(d, num_experts), generator),
            w_up=_lecun_(zeros(num_experts, d, mlp_dim), generator),
            b_up=zeros(num_experts, mlp_dim),
            w_down=_lecun_(zeros(num_experts, mlp_dim, d), generator),
            b_down=zeros(num_experts, d))


def capacity(tokens: int, num_experts: int, capacity_factor: float) -> int:
    return max(1, math.ceil(tokens / num_experts * capacity_factor))


def route(x2d: torch.Tensor, router: torch.Tensor, capacity_: int,
          route_group=None, segments: int = 1):
    """``_route`` (``moe.py:103``) by index: ``(expert, slot, kept, gate,
    frac, mean_p)``, each token's expert id, slot and kept flag, its gate
    (fp32), and the per-expert token fraction and mean probability (the
    aux inputs; under ``route_group`` already averaged over its ranks).
    With ``route_group``, ``x2d``'s tokens are this rank's rows of each of
    ``segments`` equal segments of the global token order (segment-major,
    then rank) and the slots are global."""
    e = router.shape[1]
    logits = x2d.float() @ router.float()
    probs = torch.softmax(logits, dim=-1)                     # (T, E)
    expert = torch.argmax(probs, dim=-1)                      # first max
    gate = probs.gather(1, expert[:, None])[:, 0]
    onehot = F.one_hot(expert, e)                             # (T, E) int
    # the rank of each token among its expert's: a scan along the inner
    # dimension of the (E, T) layout (a scan along T of the (T, E) one
    # runs E sequential columns: 19 ms at the ViT-B/16 path's shape)
    slot = (torch.cumsum(onehot.T.contiguous(), 1) - 1).gather(
        0, expert[None])[0]
    frac = onehot.float().mean(dim=0)
    mean_p = probs.mean(dim=0)
    if route_group is not None and world_size(route_group) > 1:
        t = x2d.shape[0]
        if t % segments:
            raise ValueError(f"{t} tokens do not split into {segments} "
                             "segments")
        seg_counts = onehot.view(segments, t // segments, e).sum(dim=1)
        with torch.no_grad():
            counts = all_gather(seg_counts.float()[None], route_group)
        counts = counts.round().long()                        # (R, S, E)
        r, nr = rank(route_group), world_size(route_group)
        order = counts.transpose(0, 1).reshape(segments * nr, e)
        before = torch.cumsum(order, 0) - order               # exclusive
        offset = before.view(segments, nr, e)[:, r]           # (S, E)
        local_before = torch.cumsum(seg_counts, 0) - seg_counts
        seg = torch.arange(t, device=x2d.device) // (t // segments)
        slot = slot + (offset - local_before)[seg, expert]
        frac = pmean(frac, route_group)
        mean_p = pmean(mean_p, route_group)
    kept = slot < capacity_
    return expert, slot, kept, gate, frac, mean_p


def _slots(expert, slot, kept, e: int, c: int):
    """(src, dest) gather maps with no repeated index, so that neither
    backward (an ``index_add``) collides: ``src[j]`` the token in flat
    slot j, or row ``T + j`` of a zero block when the slot is empty;
    ``dest[t]`` token t's flat slot ``expert * C + slot``, or row ``E C +
    t`` of a zero block when it was dropped. No host sync."""
    t = expert.shape[0]
    dev = expert.device
    tokens = torch.arange(t, device=dev)
    dest = torch.where(kept, expert * c + slot, e * c + tokens)
    # kept tokens land in their slots, dropped ones in a spare entry
    src = torch.cat([t + torch.arange(e * c, device=dev),
                     torch.zeros(1, dtype=torch.long, device=dev)])
    src.scatter_(0, torch.where(kept, dest, e * c), tokens)
    return src[:e * c], dest


def _dispatch(x2d: torch.Tensor, src, e: int, c: int) -> torch.Tensor:
    """The ``(E, C, d)`` expert batch: each kept token's row at its slot,
    zeros elsewhere (empty slots read their own zero row)."""
    d = x2d.shape[1]
    rows = torch.cat([x2d, x2d.new_zeros(e * c, d)]).index_select(0, src)
    return rows.view(e, c, d)


def _combine(yout: torch.Tensor, dest, gate) -> torch.Tensor:
    """Each token's output row in fp32: its gate times its slot's row,
    zero when it was dropped (it reads its own zero row)."""
    t, d = dest.shape[0], yout.shape[-1]
    flat = torch.cat([yout.reshape(-1, d), yout.new_zeros(t, d)])
    return flat.index_select(0, dest).float() * gate[:, None]


def _experts(params: MoEParams, xin: torch.Tensor, tp_group=None):
    """The expert FFNs on the ``(E', C', d)`` batch in its dtype; under
    ``tp_group`` each rank holds a slice of the hidden axis f (Megatron
    within each expert: the up-projection column-sharded, the down one
    row-sharded, a psum after it)."""
    dt = xin.dtype
    if tp_group is not None:
        xin = copy_to_group(xin, tp_group)
    h = torch.bmm(xin, params.w_up.to(dt)) + params.b_up[:, None, :].to(dt)
    h = F.gelu(h, approximate="tanh")
    y = torch.bmm(h, params.w_down.to(dt))
    if tp_group is not None:
        y = reduce_from_group(y, tp_group)
    return y + params.b_down[:, None, :].to(dt)


def switch_moe(params: MoEParams, x: torch.Tensor, *,
               capacity_factor: float = 1.25, group=None,
               route_group=None, segments: int = 1, tp_group=None,
               stats: dict | None = None):
    """One switch-MoE layer (``moe.py:130``); returns ``(y, aux)``.

    ``x`` is ``(..., d)``; the leading axes are the token axis. ``group``:
    expert parallelism over its ranks (``E % P == 0``; two all-to-alls;
    capacity from the local token count; aux statistics pmean'd).
    ``route_group``/``segments``: global routing (module docstring).
    ``tp_group``: the expert weights hold this rank's slice of f.
    ``stats`` (a dict) receives ``"dropped"``, the share of this rank's
    tokens past capacity (a device scalar, not read here)."""
    d = x.shape[-1]
    lead = x.shape[:-1]
    x2d = x.reshape(-1, d)
    e = params.router.shape[1]
    total = x2d.shape[0]
    if route_group is not None:
        total *= world_size(route_group)
    c = capacity(total, e, capacity_factor)
    expert, slot, kept, gate, frac, mean_p = route(
        x2d, params.router, c, route_group, segments)
    if stats is not None:
        stats["dropped"] = 1.0 - kept.float().mean().detach()
    if group is not None:
        frac = pmean(frac, group)
        mean_p = pmean(mean_p, group)
    aux = e * torch.sum(frac * mean_p)

    src, dest = _slots(expert, slot, kept, e, c)
    xin = _dispatch(x2d, src, e, c)
    w = params
    if group is not None:
        p = world_size(group)
        if e % p:
            raise ValueError(f"{e} experts not divisible over {p} devices")
        sl = e // p
        i = rank(group)
        # token-sharded (E, C, d) -> expert-sharded (E/P, P C, d)
        xin = all_to_all(xin, 0, 1, group)
        w = MoEParams(params.router, params.w_up[i * sl:(i + 1) * sl],
                      params.b_up[i * sl:(i + 1) * sl],
                      params.w_down[i * sl:(i + 1) * sl],
                      params.b_down[i * sl:(i + 1) * sl])
    yout = _experts(w, xin, tp_group)
    if group is not None:
        yout = all_to_all(yout, 1, 0, group)
    y = _combine(yout, dest, gate).to(x.dtype)
    return y.reshape(*lead, d), aux


def make_expert_parallel_moe(group=None, *, capacity_factor: float = 1.25):
    """``fn(params, x) -> (y, aux)`` with the experts sharded over the
    ranks of ``group`` (``moe.py:193``): ``x`` is this rank's tokens,
    ``params`` the whole layer's weights (each rank slices its experts);
    ``aux`` is the global load-balance loss on every rank."""
    if group is None:
        group = torch.distributed.group.WORLD

    def fn(params: MoEParams, x: torch.Tensor):
        return switch_moe(params, x, capacity_factor=capacity_factor,
                          group=group)

    return fn


class MoEMlp(nn.Module):
    """Switch-MoE MLP (``moe.py:217``), drop-in for the towers' dense
    ``MlpBlock``: fp32 parameters ``router``, ``w_up``, ``b_up``,
    ``w_down``, ``b_down`` in the flax layout, the layer in ``dtype``.
    ``aux`` holds the load-balance loss of the last forward.

    ``route_group``/``route_segments`` turn on global routing and
    ``tp_group`` Megatron within the experts; ``parallel.tp`` and
    ``parallel.fsdp`` set them."""

    def __init__(self, hidden: int, num_experts: int, mlp_dim: int,
                 dtype: torch.dtype = torch.bfloat16,
                 capacity_factor: float = 1.25):
        super().__init__()
        self.num_experts, self.mlp_dim = num_experts, mlp_dim
        self.dtype = dtype
        self.capacity_factor = capacity_factor
        self.router = nn.Parameter(torch.zeros(hidden, num_experts))
        self.w_up = nn.Parameter(torch.zeros(num_experts, hidden, mlp_dim))
        self.b_up = nn.Parameter(torch.zeros(num_experts, mlp_dim))
        self.w_down = nn.Parameter(torch.zeros(num_experts, mlp_dim, hidden))
        self.b_down = nn.Parameter(torch.zeros(num_experts, hidden))
        self.route_group = None
        self.route_segments = 1
        self.tp_group = None
        self.aux: torch.Tensor | None = None
        self.dropped: torch.Tensor | None = None  # share of the last forward

    def init_weights(self, generator: torch.Generator) -> None:
        with torch.no_grad():
            for w in (self.router, self.w_up, self.w_down):
                _lecun_(w, generator)
            self.b_up.zero_()
            self.b_down.zero_()

    def params(self) -> MoEParams:
        return MoEParams(self.router, self.w_up, self.b_up, self.w_down,
                         self.b_down)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        stats = {}
        y, self.aux = switch_moe(
            self.params(), x.to(self.dtype),
            capacity_factor=self.capacity_factor,
            route_group=self.route_group, segments=self.route_segments,
            tp_group=self.tp_group, stats=stats)
        self.dropped = stats["dropped"]
        return y


def moe_aux_from(model: nn.Module) -> torch.Tensor | float:
    """The summed load-balance loss of the ``MoEMlp`` modules' last
    forward (``moe.py:57``); 0.0 for a model without one."""
    aux = [m.aux for m in model.modules()
           if isinstance(m, MoEMlp) and m.aux is not None]
    return torch.stack(aux).sum() if aux else 0.0


def set_global_routing(model: nn.Module, group, segments: int) -> None:
    """Route every ``MoEMlp`` of ``model`` over the global token order of
    ``group``'s ranks (None: each rank's tokens alone)."""
    on = group is not None and world_size(group) > 1
    for m in model.modules():
        if isinstance(m, MoEMlp):
            m.route_group = group if on else None
            m.route_segments = segments
