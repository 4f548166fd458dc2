"""SimCLR projection head and model, counterpart of
``ntxent_tpu/models/projection.py``.

BatchNorm follows ``module.train()`` / ``.eval()`` as flax's follows
``train``:

* eval (serving): normalize with the running statistics (flax
  ``use_running_average=True``);
* train: normalize with the batch statistics over every row (all 2B rows
  of the two views), in fp32, with a two-pass biased variance (flax
  ``use_fast_variance=False``), and update the running statistics as
  flax does with ``momentum=0.9``: ``running = 0.9 * running + 0.1 *
  batch``, storing the *biased* variance (``F.batch_norm`` would store
  the unbiased one, so the update is written out here).

Both compute in fp32 and return the head's dtype.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.oracle import cosine_normalize
from .layers import Dense

__all__ = ["ProjectionHead", "SimCLRModel"]


class ProjectionHead(nn.Module):
    """2-layer MLP (in -> hidden -> BN+ReLU -> out), SimCLR-standard."""

    def __init__(self, in_dim: int, hidden_dim: int = 2048,
                 out_dim: int = 128, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        self.fc1 = Dense(in_dim, hidden_dim, dtype=dtype)
        self.bn1 = nn.BatchNorm1d(hidden_dim, eps=1e-5)
        self.fc2 = Dense(hidden_dim, out_dim, bias=False, dtype=dtype)

    momentum = 0.9  # flax BatchNorm(momentum=0.9): weight of the old value

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.fc1(x.to(self.dtype))
        bn = self.bn1
        if self.training:
            x = self._batch_norm_train(x.float())
        else:
            x = F.batch_norm(x.float(), bn.running_mean, bn.running_var,
                             bn.weight, bn.bias, training=False, eps=bn.eps)
        x = F.relu(x.to(self.dtype))
        return self.fc2(x).float()

    def _batch_norm_train(self, x: torch.Tensor) -> torch.Tensor:
        bn = self.bn1
        mean = x.mean(dim=0)
        centered = x - mean
        var = centered.square().mean(dim=0)
        with torch.no_grad():
            bn.running_mean.mul_(self.momentum).add_(
                (1.0 - self.momentum) * mean.detach())
            bn.running_var.mul_(self.momentum).add_(
                (1.0 - self.momentum) * var.detach())
        return centered * (torch.rsqrt(var + bn.eps) * bn.weight) + bn.bias


class SimCLRModel(nn.Module):
    """Encoder + projection head -> L2-normalized contrastive embeddings.

    ``forward`` returns the normalized embedding; ``features`` the
    encoder output (linear-evaluation space).
    """

    def __init__(self, encoder: nn.Module, proj_hidden_dim: int = 2048,
                 proj_dim: int = 128, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.backbone = encoder
        self.projector = ProjectionHead(encoder.hidden_dim, proj_hidden_dim,
                                        proj_dim, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return cosine_normalize(self.projector(self.backbone(x)))

    def features(self, x: torch.Tensor) -> torch.Tensor:
        return self.backbone(x)
