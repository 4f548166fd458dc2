"""The NT-Xent loss as a native PyTorch module, counterpart of
``ntxent_tpu/torch_compat.py``'s ``NTXentLoss`` and
``ntxent_loss_torch``.

The JAX package hands torch tensors to JAX and back; here the loss is
``ops.ntxent.ntxent_loss_fused`` itself: on a CUDA tensor the
hand-written kernels (forward and exact backward), on a CPU tensor their
plain versions, differentiable by autograd either way. The JAX package's
``to_jax`` / ``to_torch`` converters have no counterpart: nothing here
leaves torch.
"""

from __future__ import annotations

import torch
from torch import nn

from .ops.ntxent import ntxent_loss_fused

__all__ = ["NTXentLoss", "ntxent_loss_torch"]


def ntxent_loss_torch(z: torch.Tensor,
                      temperature: float = 0.07) -> torch.Tensor:
    """Canonical NT-Xent of stacked views z (2N, D), positives at offset
    N, differentiable through autograd (``torch_compat.py:97``)."""
    if z.ndim != 2 or z.shape[0] % 2 != 0:
        raise ValueError(f"z must be (2N, D) with even 2N, got "
                         f"{tuple(z.shape)}")
    return ntxent_loss_fused(z, float(temperature))


class NTXentLoss(nn.Module):
    """``NTXentLoss(T)(z1, z2)`` on the two views (N, D) each, or
    ``NTXentLoss(T)(z)`` on stacked views (2N, D) (``torch_compat.py:
    112``)."""

    def __init__(self, temperature: float = 0.07):
        super().__init__()
        self.temperature = temperature

    def forward(self, z1: torch.Tensor,
                z2: torch.Tensor | None = None) -> torch.Tensor:
        z = z1 if z2 is None else torch.cat([z1, z2], dim=0)
        return ntxent_loss_torch(z, self.temperature)

    def extra_repr(self) -> str:
        return f"temperature={self.temperature}"
