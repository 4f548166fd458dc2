"""Layers shared by the port's towers, with the JAX package's dtype policy.

Parameters are fp32; ``Dense`` computes in its ``dtype`` (bf16 by
default) as flax's ``nn.Dense(dtype=..., param_dtype=float32)`` does;
``LayerNorm`` computes and returns fp32 with flax's epsilon of 1e-6.
``BatchNorm`` is flax's ``nn.BatchNorm(momentum=0.9, epsilon=1e-5,
use_fast_variance=False)``, statistics in fp32, over every dimension but
dim 1, optionally across the ranks of a process group.

Initialization mirrors flax's initializers (LeCun-normal truncated at
two standard deviations for kernels, zeros for biases) and draws from an
explicit ``torch.Generator``: ``init_weights(model, generator)``.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..parallel.mesh import pmean

__all__ = ["BatchNorm", "Dense", "LayerNorm", "cross_replica_batch_norm",
           "init_weights", "lecun_normal_"]

# Standard deviation of a unit normal truncated to [-2, 2]: flax divides
# by it so that the truncated draw keeps variance 1/fan_in.
_TRUNC_STD = 0.87962566103423978


def lecun_normal_(weight: torch.Tensor, fan_in: int,
                  generator: torch.Generator | None = None) -> torch.Tensor:
    std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
    return nn.init.trunc_normal_(weight, 0.0, std, -2.0 * std, 2.0 * std,
                                 generator=generator)


class Dense(nn.Module):
    """``y = x W^T + b`` computed in ``dtype`` over fp32 parameters."""

    def __init__(self, in_features: int, out_features: int,
                 bias: bool = True, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.in_features, self.out_features = in_features, out_features
        self.dtype = dtype
        self.weight = nn.Parameter(torch.zeros(out_features, in_features))
        self.bias = (nn.Parameter(torch.zeros(out_features)) if bias
                     else None)

    def init_weights(self, generator: torch.Generator) -> None:
        with torch.no_grad():
            lecun_normal_(self.weight, self.in_features, generator)
            if self.bias is not None:
                self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bias = None if self.bias is None else self.bias.to(self.dtype)
        return F.linear(x.to(self.dtype), self.weight.to(self.dtype), bias)


class LayerNorm(nn.LayerNorm):
    """fp32 LayerNorm (flax ``nn.LayerNorm(dtype=float32)``, eps 1e-6)."""

    def __init__(self, features: int, eps: float = 1e-6):
        super().__init__(features, eps=eps)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x.float(), self.normalized_shape, self.weight,
                            self.bias, self.eps)


class BatchNorm(nn.Module):
    """flax ``nn.BatchNorm`` over dim 1 (features of (B, F), channels of
    (B, C, H, W)); returns fp32, which the caller casts to its dtype.

    * eval (``module.eval()``; flax ``use_running_average=True``):
      normalize with the running statistics;
    * train: the batch mean, then the biased variance of the centred
      values (two passes, flax ``use_fast_variance=False``), in fp32; with
      a process group (``self.group``, flax ``axis_name``), each is averaged
      over the ranks by a differentiable ``pmean``, so the backward carries
      the cross-rank terms. The running statistics move as flax's do:
      ``running = 0.9 running + 0.1 batch``, the *biased* variance kept
      (``torch.nn.SyncBatchNorm`` keeps the unbiased one).

    Both normalize as flax's ``_normalize``: ``(x - mean) * (rsqrt(var +
    eps) * scale) + bias``. ``zero_init`` starts the scale at 0 (the last
    norm of a residual branch)."""

    momentum = 0.9  # flax BatchNorm(momentum=0.9): weight of the old value

    def __init__(self, features: int, eps: float = 1e-5,
                 zero_init: bool = False):
        super().__init__()
        self.eps = eps
        self.zero_init = zero_init
        self.group = None
        self.weight = nn.Parameter(torch.zeros(features) if zero_init
                                   else torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def init_weights(self, generator: torch.Generator) -> None:
        with torch.no_grad():
            self.weight.fill_(0.0 if self.zero_init else 1.0)
            self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        shape = [1, -1] + [1] * (x.ndim - 2)
        if self.training:
            axes = [d for d in range(x.ndim) if d != 1]
            mean = self._average(xf.mean(dim=axes))
            centered = xf - mean.view(shape)
            var = self._average(centered.square().mean(dim=axes))
            with torch.no_grad():
                self.running_mean.mul_(self.momentum).add_(
                    (1.0 - self.momentum) * mean.detach())
                self.running_var.mul_(self.momentum).add_(
                    (1.0 - self.momentum) * var.detach())
        else:
            var = self.running_var
            centered = xf - self.running_mean.view(shape)
        mul = torch.rsqrt(var + self.eps) * self.weight
        return centered * mul.view(shape) + self.bias.view(shape)

    def _average(self, stat: torch.Tensor) -> torch.Tensor:
        if self.group is None:
            return stat
        return pmean(stat, self.group, op="bn_pmean")


def cross_replica_batch_norm(model: nn.Module, group) -> nn.Module:
    """Average every ``BatchNorm``'s batch statistics of ``model`` over the
    ranks of the process group ``group`` (e.g.
    ``torch.distributed.group.WORLD``; ``None``: local statistics again),
    as flax's ``axis_name`` does. Returns ``model``."""
    for module in model.modules():
        if isinstance(module, BatchNorm):
            module.group = group
    return model


def init_weights(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Draw every randomly initialized parameter of ``model`` from
    ``generator``, in module order (deterministic for a seed). Each
    module's own ``init_weights(generator)`` covers its own parameters."""
    for module in model.modules():
        if hasattr(module, "init_weights"):
            module.init_weights(generator)
    return model
