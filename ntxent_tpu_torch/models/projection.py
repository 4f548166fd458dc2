"""SimCLR projection head and model, counterpart of
``ntxent_tpu/models/projection.py``.

BatchNorm (``layers.BatchNorm``) follows ``module.train()`` / ``.eval()``
as flax's follows ``train``: batch statistics over every row (all 2B rows
of the two views) in train mode, across ranks when it has a process
group (flax ``axis_name``), running statistics in eval mode. It computes
in fp32; the head casts its output to the head's dtype.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.oracle import cosine_normalize
from .layers import BatchNorm, Dense

__all__ = ["ProjectionHead", "SimCLRModel"]


class ProjectionHead(nn.Module):
    """2-layer MLP (in -> hidden -> BN+ReLU -> out), SimCLR-standard."""

    def __init__(self, in_dim: int, hidden_dim: int = 2048,
                 out_dim: int = 128, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        self.fc1 = Dense(in_dim, hidden_dim, dtype=dtype)
        self.bn1 = BatchNorm(hidden_dim)
        self.fc2 = Dense(hidden_dim, out_dim, bias=False, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.bn1(self.fc1(x.to(self.dtype)))
        x = F.relu(x.to(self.dtype))
        return self.fc2(x).float()


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
