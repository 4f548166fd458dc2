"""AdamW on a schedule, counterpart of the CLIP path's
``optax.adamw(cosine_warmup_schedule(base_lr, warmup, steps),
weight_decay=wd)`` (``ntxent_tpu/cli.py:1255-1257``).

``torch.optim.AdamW`` computes optax's update: Adam's bias-corrected
``m / (sqrt(v) + eps)`` plus ``wd * p``, on every parameter (no mask),
times ``-lr``. Only the learning rate needs driving: it is
``schedule(count)`` with ``count`` the steps taken *before* this one, as
optax's ``scale_by_learning_rate`` reads it, so step 0 runs at
``schedule(0)``. The schedule is evaluated on the host from the count, so
a step does not synchronize with the device.
"""

from __future__ import annotations

from collections.abc import Callable

import torch

__all__ = ["AdamW"]


class AdamW:
    """``optax.adamw`` (b1 0.9, b2 0.999, eps 1e-8) over named parameters,
    with the learning rate from ``schedule``."""

    def __init__(self, named_params, schedule: Callable[[int], float],
                 weight_decay: float = 1e-4, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8):
        self.params = dict(named_params)
        self.schedule = schedule
        self.count = 0
        self.optimizer = torch.optim.AdamW(
            self.params.values(), lr=0.0, betas=(b1, b2), eps=eps,
            weight_decay=weight_decay)

    def step(self) -> float:
        """One update from the parameters' ``.grad``; returns the lr used."""
        for name, p in self.params.items():
            if p.grad is None:
                raise RuntimeError(f"{name} has no gradient")
        lr = self.schedule(self.count)
        for group in self.optimizer.param_groups:
            group["lr"] = lr
        self.optimizer.step()
        self.count += 1
        return lr

    def zero_grad(self) -> None:
        self.optimizer.zero_grad(set_to_none=True)
