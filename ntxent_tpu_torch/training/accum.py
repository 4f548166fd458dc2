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

Under the lag-1 guard (``step_kept``) the host never learns in time
whether a micro-step was kept, so the counters move to the device
(``counters``: ``[mini_step, gradient_step]`` in float32, read back on the
host only by a save or ``train_state_dict``) and every micro-step runs
the inner update, as optax's ``MultiSteps`` runs it under ``jit``: the
caller keeps that update only where ``mini_step == k - 1`` (``emit``) and
resets the accumulator under the same select
(``training.trainer._KeptUpdate``).

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
        self._mini_step = 0
        self._gradient_step = 0
        # [mini_step, gradient_step] on the device once kept steps run
        self.counters: torch.Tensor | None = None
        self.acc = {name: torch.zeros_like(p)
                    for name, p in self.params.items()}
        self._saved = None  # snapshot()'s buffers

    @property
    def mini_step(self) -> int:
        """Micro-steps folded since the last update (0 .. k - 1). After
        kept steps it lives on the device, and reading it waits for
        them."""
        if self.counters is not None:
            return int(self.counters[0])
        return self._mini_step

    @mini_step.setter
    def mini_step(self, value: int) -> None:
        self._mini_step = int(value)
        if self.counters is not None:
            self.counters[0] = self._mini_step

    @property
    def gradient_step(self) -> int:
        """Inner updates so far (as ``mini_step``, on the device after
        kept steps)."""
        if self.counters is not None:
            return int(self.counters[1])
        return self._gradient_step

    @gradient_step.setter
    def gradient_step(self, value: int) -> None:
        self._gradient_step = int(value)
        if self.counters is not None:
            self.counters[1] = self._gradient_step

    def device_counters(self, device: torch.device) -> torch.Tensor:
        """The counters on ``device`` (made from the host's at the first
        call), for the kept steps and the flat buffer that keeps them."""
        if self.counters is None:
            self.counters = torch.tensor(
                [self._mini_step, self._gradient_step], dtype=torch.float32,
                device=device)
        return self.counters

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
    def step_kept(self, ok: torch.Tensor) -> torch.Tensor:
        """The lag-1 guard's micro-step, decided on the device: fold the
        gradients in at the device count, run the inner update on the
        new mean (``LARS.step_kept``, its count advancing by ``ok`` and
        ``emit``) and advance the counters; returns ``emit`` (a device
        bool: this micro-step is the k-th). The caller keeps the inner
        update only where ``emit``, zeroes the accumulator there, and
        drops the whole micro-step where ``ok`` is false. Bit for bit the
        fold of ``step()``."""
        counters = self.device_counters(ok.device)
        mini = counters[0]
        n = mini + 1
        emit = mini == self.every_k - 1
        grads = []
        for name, p in self.params.items():
            if p.grad is None:
                raise RuntimeError(f"{name} has no gradient")
            grads.append(p.grad.float())
        accs = list(self.acc.values())
        diffs = torch._foreach_sub(grads, accs)
        if diffs[0].is_cuda:
            # ``step()`` divides by a host scalar, which CUDA computes as
            # a product with its float32 reciprocal
            torch._foreach_mul_(diffs, torch.reciprocal(n))
        else:
            torch._foreach_div_(diffs, n)
        torch._foreach_add_(accs, diffs)
        for name, p in self.params.items():
            p.grad = self.acc[name]
        self.inner.step_kept(ok & emit)
        counters.copy_(torch.stack([torch.where(emit, torch.zeros_like(n),
                                                n),
                                    counters[1] + emit.float()]))
        return emit

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
