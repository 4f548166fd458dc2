"""The layout of a tensor-parallel or fully-sharded train state: which
slice of each parameter a rank holds, and the moves between that layout
and whole tensors. The JAX package places such a state with
``NamedSharding`` and lets GSPMD move it; the port holds explicit local
tensors and moves them here.

A ``Sharding`` names, for each parameter (by its ``named_parameters``
name), ``Leaf(tp_dim, dp_dim)``: the dimension of the whole tensor cut
over the model group (Megatron, ``parallel.tp``; the module keeps that
slice as its parameter) and the dimension of that tensor cut over the
data group (ZeRO-3, ``parallel.fsdp``; the optimizer holds that slice,
the module parameter is gathered at the start of a step and freed at its
end). Each cut is ``size / P`` contiguous elements, rank ``r`` the
``r``-th, as a ``PartitionSpec`` lays a divisible dimension out.

* ``apply(state)`` cuts a whole state (parameters and the optimizer's
  per-parameter tensors) in place;
* ``materialize``, ``reduce_grads`` and ``release`` are a step's moves:
  gather the ZeRO-3 slices into the module, reduce the gradients (a
  reduce-scatter of the mean for the ZeRO-3 slices, after a mean over
  the ``dcn`` group of hybrid ZeRO; a pmean over the batch group for the
  rest), free the gathered tensors;
* ``gather(state)`` returns a whole copy (a ``TrainState`` of the plain
  model with an optimizer over whole tensors), which is what a
  checkpoint saves: the single-card format, which either package and
  either layout resumes; ``scatter(whole, state)`` loads one back;
* ``norm_groups`` tells ``LARS`` which groups (each with its mesh axis)
  complete a sliced parameter's norms.

A step's collectives are recorded in ``mesh.comms_accounting()``: the
ZeRO-3 all-gather of the parameters and the reduce-scatter of their
gradients over the data axis, besides the pmean of the rest and what
the modules and ``LARS`` issue.

``gather`` and ``scatter`` are collectives of every rank.
"""

from __future__ import annotations

import copy
import dataclasses

import torch
import torch.distributed as dist
from torch import nn

from .mesh import (
    AXIS,
    comms_accounting,
    pmean_,
    psum_scatter,
    rank,
    world_size,
)

__all__ = ["Leaf", "Sharding", "param_bytes_per_device", "sharded_step",
           "step_metrics", "with_aux"]

# module attributes that hold a process group or a forward's output: a
# whole copy clears them (a deep copy cannot take either)
_CLEARED_ATTRS = ("tp_group", "route_group", "group", "aux", "dropped")


@dataclasses.dataclass(frozen=True)
class Leaf:
    tp_dim: int | None = None
    dp_dim: int | None = None


def _cut(t: torch.Tensor, dim: int | None, group) -> torch.Tensor:
    """This rank's contiguous slice of ``t`` along ``dim`` over ``group``
    (a copy of its own)."""
    p = world_size(group)
    if dim is None or p == 1:
        return t.detach().clone()
    n = t.shape[dim] // p
    return t.detach().narrow(dim, rank(group) * n, n).clone()


def _join(t: torch.Tensor, dim: int | None, group,
          record: bool = False) -> torch.Tensor:
    """The ranks' slices of ``group`` joined along ``dim``. ``record``:
    a step's all-gather (ZeRO-3's parameters), recorded over the data
    axis; the whole copies a checkpoint saves are not."""
    p = world_size(group)
    if dim is None or p == 1:
        return t.detach().clone()
    if record:
        comms_accounting().record(
            "all_gather", AXIS, (p - 1) * t.numel() * t.element_size(),
            dtype=str(t.dtype).removeprefix("torch."))
    parts = [torch.empty_like(t) for _ in range(p)]
    dist.all_gather(parts, t.detach().contiguous(), group=group)
    return torch.cat(parts, dim=dim)


def _clone_optimizer(opt, named: dict, convert):
    """An optimizer of ``opt``'s kind and settings over ``named``
    parameters, each per-parameter tensor ``convert(name, tensor)`` of
    ``opt``'s, the counters ``opt``'s."""
    from ..training.accum import MultiSteps
    from ..training.adamw import AdamW
    from ..training.lars import LARS

    if isinstance(opt, MultiSteps):
        new = MultiSteps(_clone_optimizer(opt.inner, named, convert),
                         opt.every_k)
        new.mini_step, new.gradient_step = opt.mini_step, opt.gradient_step
        new.acc = {n: convert(n, a) for n, a in opt.acc.items()}
        return new
    if isinstance(opt, LARS):
        new = LARS(named.items(), opt.schedule, opt.weight_decay,
                   opt.momentum, opt.trust_coefficient, opt.mask)
        new.count = opt.count
        new.trace = {n: convert(n, t) for n, t in opt.trace.items()}
        return new
    if not isinstance(opt, AdamW):
        raise TypeError(f"cannot shard the state of {type(opt).__name__}")
    group = opt.optimizer.param_groups[0]
    new = AdamW(named.items(), opt.schedule, group["weight_decay"],
                group["betas"][0], group["betas"][1], group["eps"])
    new.count = opt.count
    for n, p in opt.params.items():
        st = opt.optimizer.state.get(p)
        if st:
            new.optimizer.state[named[n]] = {
                "step": st["step"].clone(),
                "exp_avg": convert(n, st["exp_avg"]),
                "exp_avg_sq": convert(n, st["exp_avg_sq"])}
    return new


def _lars(opt):
    from ..training.lars import LARS

    inner = getattr(opt, "inner", opt)
    return inner if isinstance(inner, LARS) else None


def _whole_model(model: nn.Module) -> nn.Module:
    """A deep copy of ``model`` with no process group and every module
    whole again (its parameters still this rank's; the caller fills
    them)."""
    saved = []
    for m in model.modules():
        for attr in _CLEARED_ATTRS:
            if getattr(m, attr, None) is not None:
                saved.append((m, attr, getattr(m, attr)))
                setattr(m, attr, None)
    try:
        out = copy.deepcopy(model)
    finally:
        for m, attr, value in saved:
            setattr(m, attr, value)
    for m in out.modules():
        if hasattr(m, "local_heads"):
            m.local_heads = m.num_heads
    return out


class Sharding:
    """The layout of one state (module docstring). ``model_group``: the
    tensor-parallel group (None: no tensor parallelism); ``data_group``:
    the group ZeRO-3 cuts over (None: no ZeRO-3); ``batch_group``: the
    ranks the global batch spans, whose gradient mean each step takes
    (None: the default group); ``dcn_group``: the replicas of a
    ZeRO-3 slice under hybrid ZeRO (None: flat)."""

    def __init__(self, leaves: dict[str, Leaf], *, model_group=None,
                 data_group=None, batch_group=None, dcn_group=None):
        self.leaves = leaves
        self.model_group, self.data_group = model_group, data_group
        self.batch_group = (batch_group if batch_group is not None
                            else dist.group.WORLD)
        self.dcn_group = dcn_group

    # -- the cuts ---------------------------------------------------------

    def _tp(self, name):
        return self.leaves.get(name, Leaf()).tp_dim \
            if self.model_group is not None else None

    def _dp(self, name):
        return self.leaves.get(name, Leaf()).dp_dim \
            if self.data_group is not None else None

    def local(self, name: str, whole: torch.Tensor) -> torch.Tensor:
        """This rank's slice of the whole tensor of parameter ``name``."""
        t = _cut(whole, self._tp(name), self.model_group)
        return _cut(t, self._dp(name), self.data_group)

    def whole(self, name: str, local: torch.Tensor) -> torch.Tensor:
        """The whole tensor of parameter ``name`` from every rank's slice
        (a collective)."""
        t = _join(local, self._dp(name), self.data_group)
        return _join(t, self._tp(name), self.model_group)

    def zero3(self) -> list[str]:
        """The names the optimizer holds a ZeRO-3 slice of."""
        return [n for n in self.leaves if self._dp(n) is not None]

    def norm_groups(self) -> dict[str, tuple]:
        out = {}
        for name in self.leaves:
            groups = tuple((axis, g) for axis, g, d in (
                ("model", self.model_group, self._tp(name)),
                (AXIS, self.data_group, self._dp(name)))
                if d is not None and world_size(g) > 1)
            if groups:
                out[name] = groups
        return out

    def _spread(self) -> bool:
        """Whether the ZeRO-3 slices are gathered and freed each step (a
        data group of one rank holds the whole tensor in its slice)."""
        return self.data_group is not None and world_size(self.data_group) > 1

    # -- placement --------------------------------------------------------

    def apply(self, state):
        """Cut the whole ``state`` in place: the model's parameters to
        their tensor-parallel slices, the optimizer's parameters and
        per-parameter tensors to their slices. Returns ``state``."""
        params = dict(state.model.named_parameters())
        with torch.no_grad():
            for name, p in params.items():
                if self._tp(name) is not None:
                    p.data = _cut(p.data, self._tp(name), self.model_group)
        named = {}
        for name, p in params.items():
            if self._dp(name) is None:
                named[name] = p
                continue
            named[name] = _cut(p.data, self._dp(name), self.data_group)
        state.optimizer = _clone_optimizer(state.optimizer, named,
                                           self.local)
        self._set_norm_groups(state.optimizer)
        state.sharding = self
        self.release(state)
        return state

    def _set_norm_groups(self, opt) -> None:
        lars = _lars(opt)
        if lars is not None:
            lars.norm_groups = self.norm_groups()

    # -- a step's moves ---------------------------------------------------

    def materialize(self, state) -> None:
        """The module's ZeRO-3 parameters gathered from the slices (a data
        group of one aliases the slice)."""
        params = dict(state.model.named_parameters())
        opt = state.optimizer.params
        with torch.no_grad():
            for name in self.zero3():
                params[name].data = (_join(opt[name], self._dp(name),
                                           self.data_group, record=True)
                                     if self._spread() else opt[name].data)

    def release(self, state) -> None:
        """Free the gathered ZeRO-3 parameters and their gradients."""
        if not self._spread():
            return
        params = dict(state.model.named_parameters())
        for name in self.zero3():
            p = params[name]
            p.data = torch.empty(0, dtype=p.dtype, device=p.device)
            p.grad = None

    @torch.no_grad()
    def reduce_grads(self, state) -> None:
        """The gradient mean of the step: each ZeRO-3 slice's gradient
        the reduce-scatter of the mean over the data group (after a mean
        over the ``dcn`` group), every other gradient pmean'd over the
        batch group."""
        params = dict(state.model.named_parameters())
        opt = state.optimizer.params
        zero3 = self.zero3()  # a list: every rank in the same order
        if self.dcn_group is not None and zero3:
            pmean_([params[n].grad for n in zero3], self.dcn_group)
        for name in zero3:
            g, dim = params[name].grad, self._dp(name)
            p = world_size(self.data_group)
            if p == 1:
                opt[name].grad = g
                continue
            moved = g.movedim(dim, 0).contiguous()
            part = psum_scatter(moved, self.data_group) / p
            opt[name].grad = part.movedim(0, dim).contiguous()
        cut = set(zero3)
        rest = [p.grad for n, p in params.items() if n not in cut]
        if rest:
            pmean_(rest, self.batch_group)

    # -- whole copies (checkpoints) ---------------------------------------

    def gather(self, state):
        """A whole copy of the sharded ``state``: a ``TrainState`` of the
        plain model, its parameters and optimizer state whole (a
        collective of every rank)."""
        from ..training.trainer import TrainState

        model = _whole_model(state.model)
        opt = state.optimizer
        named = dict(model.named_parameters())
        with torch.no_grad():
            for name, p in named.items():
                p.data = self.whole(name, opt.params[name])
        new_opt = _clone_optimizer(opt, named, self.whole)
        return TrainState(model=model, optimizer=new_opt, step=state.step)

    def scatter(self, whole, state) -> None:
        """Load the whole copy ``whole`` (as ``gather`` gives it) into the
        sharded ``state``: every rank takes its slices."""
        opt = state.optimizer
        wparams = dict(whole.model.named_parameters())
        with torch.no_grad():
            for name, t in opt.params.items():
                t.copy_(self.local(name, wparams[name]))
            buffers = dict(state.model.named_buffers())
            for name, b in whole.model.named_buffers():
                buffers[name].copy_(b)
        state.optimizer = _clone_optimizer(whole.optimizer,
                                           dict(opt.params), self.local)
        self._set_norm_groups(state.optimizer)
        state.step = whole.step


def param_bytes_per_device(state) -> int:
    """Bytes of the parameter tensors this rank keeps between steps
    (``fsdp.py:132``): the slices of a sharded state, every parameter of
    a whole one."""
    seen, total = set(), 0
    for t in state.optimizer.params.values():
        if id(t) not in seen:
            seen.add(id(t))
            total += t.numel() * t.element_size()
    return total


def sharded_step(state, loss_of) -> torch.Tensor:
    """One optimizer step of the sharded ``state``: the ZeRO-3 parameters
    gathered, ``loss_of(model)`` and its backward, the gradient mean
    (``Sharding.reduce_grads``), the update on this rank's slices, the
    gathered parameters freed. Returns the detached loss."""
    sh = state.sharding
    if sh is None:
        raise ValueError("the state is not sharded: place it with "
                         "parallel.tp.shard_train_state, "
                         "parallel.fsdp.shard_train_state_fsdp or "
                         "parallel.tp.shard_train_state_tp_fsdp first")
    sh.materialize(state)
    state.optimizer.zero_grad()
    for p in state.model.parameters():
        p.grad = None
    loss = loss_of(state.model)
    loss.backward()
    sh.reduce_grads(state)
    state.optimizer.step()
    sh.release(state)
    state.step += 1
    return loss.detach()


def with_aux(loss: torch.Tensor, model: nn.Module, weight: float,
             seen: dict) -> torch.Tensor:
    """``loss`` plus ``weight`` times the model's MoE load-balance loss
    (kept in ``seen["aux"]``); ``loss`` itself at weight 0."""
    from .moe import moe_aux_from

    if weight <= 0.0:
        return loss
    aux = moe_aux_from(model)
    if not torch.is_tensor(aux):
        return loss
    seen["aux"] = aux.detach()
    return loss + weight * aux


def step_metrics(loss: torch.Tensor, collect: bool, seen: dict) -> dict:
    metrics = {"loss": loss}
    if collect:
        metrics["moe_aux"] = seen.get("aux", torch.zeros_like(loss))
    return metrics
