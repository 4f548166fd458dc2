"""LARS and SimCLR's learning-rate schedule, counterpart of
``ntxent_tpu/training/lars.py`` (which builds on ``optax.lars``).

One step equals ``optax.lars`` with SimCLR's masks, leaf by leaf:

1. ``u = g + wd * p`` where the mask applies (``add_decayed_weights``);
2. where the mask applies, ``u *= tc * |p| / |u|`` (``scale_by_trust_ratio``
   with ``eps = 0``; the ratio is 1 where either norm is 0);
3. ``u *= -lr(count)`` with ``count`` the step count *before* this step
   (``scale_by_learning_rate``), so step 0 runs at ``lr(0) = 0``;
4. ``trace = u + momentum * trace``; ``p += trace`` (``trace``: momentum
   is applied after the learning rate).

A parameter that a rank holds only a slice of (tensor parallelism,
ZeRO-3; ``parallel.shards``) takes its norms over the whole tensor: its
squared sums are psum'd over the groups ``norm_groups`` names for it
(each recorded as a ``"lars_norms"`` all-reduce over its mesh axis), the
norms GSPMD computes on the JAX side without being asked.

The mask excludes BatchNorm parameters and every ``bias`` from weight
decay and the trust ratio, decided on the parameter's flax path
(``weights.flax_paths``) exactly as ``_is_excluded`` decides it: LayerNorm
``scale``, ``cls_token`` and ``pos_embed`` stay in.
"""

from __future__ import annotations

import math
import re
from collections.abc import Callable

import torch
from torch import nn

from ..weights import flax_paths

__all__ = ["LARS", "cosine_warmup_schedule", "exclusion_mask",
           "is_excluded", "simclr_learning_rate"]


def is_excluded(path: tuple[str, ...]) -> bool:
    """BN params and biases are excluded from weight decay and the trust
    ratio: any path segment that is, starts or ends with a batch-norm
    marker, or a leaf named ``bias``."""
    names = [str(p).lower() for p in path]

    def is_bn_segment(s: str) -> bool:
        return bool(re.fullmatch(r"(bn|batch_?norm)[_\d]*", s)) \
            or s.endswith("_bn") or "batchnorm" in s

    return any(is_bn_segment(s) for s in names) or names[-1] == "bias"


def exclusion_mask(model: nn.Module) -> dict[str, bool]:
    """``{parameter name: True where decay and trust ratio APPLY}``,
    from the flax path of each parameter."""
    return {name: not is_excluded(path)
            for name, path in flax_paths(model).items()}


def cosine_warmup_schedule(base_lr: float, warmup_steps: int,
                           total_steps: int) -> Callable[[int], float]:
    """``optax.warmup_cosine_decay_schedule(0, base_lr, max(warmup, 1),
    max(total, warmup + 1))``: linear from 0 over the warmup, then cosine
    decay to 0 over the remaining steps."""
    warmup = max(warmup_steps, 1)
    decay = max(total_steps, warmup_steps + 1) - warmup

    def schedule(count: int) -> float:
        if count < warmup:
            return base_lr * (count / warmup)
        t = min(count - warmup, decay)
        return base_lr * 0.5 * (1.0 + math.cos(math.pi * t / decay))

    return schedule


def simclr_learning_rate(batch_size: int, base: float = 0.3) -> float:
    """SimCLR linear scaling: lr = base * batch / 256."""
    return base * batch_size / 256.0


class LARS:
    """LARS over named parameters with an apply-mask per parameter.

    ``step()`` reads each parameter's ``.grad`` (fp32) and updates the
    parameter in place; the momentum trace lives on the parameter's
    device. The schedule is read on the host from the step count, so a
    step does not synchronize with the device.
    """

    def __init__(self, named_params, schedule: Callable[[int], float],
                 weight_decay: float = 1e-6, momentum: float = 0.9,
                 trust_coefficient: float = 0.001,
                 mask: dict[str, bool] | None = None):
        self.params = dict(named_params)
        self.schedule = schedule
        self.weight_decay = weight_decay
        self.momentum = momentum
        self.trust_coefficient = trust_coefficient
        self.mask = ({name: True for name in self.params} if mask is None
                     else dict(mask))
        if set(self.mask) != set(self.params):
            raise ValueError("the mask must name every parameter")
        self._count = 0
        # the count on the device while kept steps run (step_kept), an
        # upper bound of it on the host and the table of -lr it indexes
        self._device_count = None
        self._count_bound = 0
        self._neg_lr = None
        self.trace = {name: torch.zeros_like(p)
                      for name, p in self.params.items()}
        self._saved = None  # snapshot()'s buffers
        # {name: ((mesh axis, process group), ...)}: a sliced parameter's
        # norms are summed over these groups (``parallel.shards``); empty
        # for whole tensors
        self.norm_groups: dict[str, tuple] = {}

    @property
    def count(self) -> int:
        """The update count (the schedule's step). After kept steps it
        lives on the device, and reading it here waits for them."""
        if self._device_count is not None:
            self._count = int(self._device_count)
            self._device_count = None
        return self._count

    @count.setter
    def count(self, value: int) -> None:
        self._count = int(value)
        self._device_count = None

    @torch.no_grad()
    def step(self) -> float:
        """One update from the parameters' ``.grad``; returns the lr used."""
        lr = self.schedule(self.count)
        self._update(-lr)
        self._count += 1
        return lr

    @torch.no_grad()
    def step_kept(self, ok: torch.Tensor) -> None:
        """One update at the learning rate of the count on the device, which
        then advances by ``ok`` (a device bool), so the host never waits:
        the lag-1 guard's step, whose caller keeps the update out of the
        parameters and momentum where ``ok`` is false. The rate is read
        from a float32 table of ``-schedule(count)``, the value ``step()``
        multiplies by, so both give the same bits."""
        if self._device_count is None:
            self._device_count = torch.full((), self._count,
                                            dtype=torch.int64,
                                            device=ok.device)
            self._count_bound = self._count
        if self._neg_lr is None or len(self._neg_lr) <= self._count_bound:
            n = max(1024, 2 * (self._count_bound + 1))
            self._neg_lr = torch.tensor(
                [-self.schedule(c) for c in range(n)], dtype=torch.float32,
                device=ok.device)
        self._update(torch.index_select(
            self._neg_lr, 0, self._device_count.view(1)).view(()))
        self._device_count.add_(ok.to(torch.int64))
        self._count_bound += 1

    def _update(self, neg_lr) -> None:
        """The update of every parameter at ``-lr`` (a float, or a 0-dim
        float32 tensor on the parameters' device)."""
        for name, p in self.params.items():
            if p.grad is None:
                raise RuntimeError(f"{name} has no gradient")
            u = p.grad.float()
            if self.mask[name]:
                u = u + self.weight_decay * p
                p_norm, u_norm = self._norms(name, p, u)
                ratio = torch.where((p_norm == 0) | (u_norm == 0),
                                    torch.ones_like(p_norm),
                                    self.trust_coefficient * p_norm / u_norm)
                u = u * ratio
            trace = self.trace[name]
            trace.mul_(self.momentum).add_(u * neg_lr)
            p.add_(trace)

    def _norms(self, name: str, p: torch.Tensor, u: torch.Tensor):
        groups = self.norm_groups.get(name)
        if not groups:
            return torch.linalg.vector_norm(p), torch.linalg.vector_norm(u)
        from ..parallel.mesh import all_reduce_

        sq = torch.stack([p.float().square().sum(), u.square().sum()])
        for axis, group in groups:
            all_reduce_(sq, group, "lars_norms", axis)
        return sq[0].sqrt(), sq[1].sqrt()

    @torch.no_grad()
    def snapshot(self) -> tuple:
        """Copies of what ``step()`` moves (the count, the parameters and
        the momentum), for ``restore``. One multi-tensor copy into
        buffers made at the first call, which the next snapshot reuses."""
        moved = self._moved()
        if self._saved is None:
            self._saved = [torch.empty_like(t) for t in moved]
        torch._foreach_copy_(self._saved, moved)
        return self.count, self._saved

    @torch.no_grad()
    def restore(self, snapshot: tuple) -> None:
        """Put back, bit for bit, what ``snapshot()`` copied."""
        self.count, saved = snapshot
        torch._foreach_copy_(self._moved(), saved)

    def _moved(self) -> list[torch.Tensor]:
        return [*self.params.values(), *self.trace.values()]

    def zero_grad(self) -> None:
        for p in self.params.values():
            p.grad = None
