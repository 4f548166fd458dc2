"""Layers shared by the port's towers, with the JAX package's dtype policy.

Parameters are fp32; ``Dense`` computes in its ``dtype`` (bf16 by
default) as flax's ``nn.Dense(dtype=..., param_dtype=float32)`` does;
``LayerNorm`` computes and returns fp32 with flax's epsilon of 1e-6.

Initialization mirrors flax's initializers (LeCun-normal truncated at
two standard deviations for kernels, zeros for biases) and draws from an
explicit ``torch.Generator``: ``init_weights(model, generator)``.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

__all__ = ["Dense", "LayerNorm", "init_weights", "lecun_normal_"]

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


def init_weights(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Draw every randomly initialized parameter of ``model`` from
    ``generator``, in module order (deterministic for a seed). Each
    module's own ``init_weights(generator)`` covers its own parameters."""
    for module in model.modules():
        if hasattr(module, "init_weights"):
            module.init_weights(generator)
    return model
