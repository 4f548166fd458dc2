"""Gradient accumulation, counterpart of ``optax.MultiSteps(opt,
every_k_schedule=k)`` (optax 0.2.6, ``use_grad_mean=True``) over the
port's ``LARS`` and ``AdamW``, as ``TrainerConfig.accum_steps`` builds it
(``ntxent_tpu/training/trainer.py:163-164``, ``ntxent_tpu/cli.py:1258``).

Each train step is one micro-batch. ``MultiSteps.step()`` folds the
parameters' ``.grad`` into a running mean, ``acc + (g - acc) /
(mini_step + 1)`` (optax's Welford form, in the same fp32 operations);
on the k-th micro-step (``mini_step == k - 1``) the inner optimizer
steps once on the mean, with its own ``count`` (so its schedule counts
updates, not micro-steps), ``acc`` returns to zero and ``gradient_step``
advances; ``mini_step`` runs 0 .. k - 1. Between updates the parameters
do not move (optax emits zero updates). The state is ``optax``'s
``MultiStepsState`` (``mini_step``, ``gradient_step``,
``inner_opt_state``, ``acc_grads``, an empty ``skip_state``), which
``weights.train_state_dict`` writes and ``load_train_state_dict``
reads, so either package resumes the other mid-accumulation.

Contrastive semantics, as in the reference: the negatives stay within
each micro-batch; accumulation grows the optimizer's batch, not the
loss's negative pool.
"""

from __future__ import annotations

import torch

__all__ = ["MultiSteps"]


class MultiSteps:
    """Accumulate ``every_k`` micro-batches' gradients (their mean) before
    each step of ``inner`` (a ``LARS`` or an ``AdamW``)."""

    def __init__(self, inner, every_k: int):
        if every_k < 1:
            raise ValueError(f"every_k must be >= 1, got {every_k}")
        self.inner = inner
        self.every_k = int(every_k)
        self.params = inner.params
        self.mini_step = 0
        self.gradient_step = 0
        self.acc = {name: torch.zeros_like(p)
                    for name, p in self.params.items()}
        self._saved = None  # snapshot()'s buffers

    @property
    def count(self) -> int:
        """The inner optimizer's update count (its schedule's step)."""
        return self.inner.count

    @torch.no_grad()
    def step(self) -> bool:
        """Fold this micro-batch's gradients in; step the inner optimizer
        on the k-th. Returns True when the parameters moved."""
        n = float(self.mini_step + 1)
        for name, p in self.params.items():
            if p.grad is None:
                raise RuntimeError(f"{name} has no gradient")
            acc = self.acc[name]
            acc.add_((p.grad.float() - acc) / n)
        if self.mini_step < self.every_k - 1:
            self.mini_step += 1
            return False
        for name, p in self.params.items():
            p.grad = self.acc[name].clone()
        self.inner.step()
        for acc in self.acc.values():
            acc.zero_()
        self.mini_step = 0
        self.gradient_step += 1
        return True

    @torch.no_grad()
    def snapshot(self) -> tuple:
        """Copies of what ``step()`` moves: the counters, the accumulator
        and, when this micro-step updates, the inner optimizer's state.
        The copies go into buffers that the next snapshot reuses."""
        inner = (self.inner.snapshot()
                 if self.mini_step == self.every_k - 1 else None)
        acc = list(self.acc.values())
        if self._saved is None:
            self._saved = [torch.empty_like(a) for a in acc]
        torch._foreach_copy_(self._saved, acc)
        return self.mini_step, self.gradient_step, self._saved, inner

    @torch.no_grad()
    def restore(self, snapshot: tuple) -> None:
        """Put back, bit for bit, what ``snapshot()`` copied."""
        self.mini_step, self.gradient_step, acc, inner = snapshot
        torch._foreach_copy_(list(self.acc.values()), acc)
        if inner is not None:
            self.inner.restore(inner)

    def zero_grad(self) -> None:
        self.inner.zero_grad()
