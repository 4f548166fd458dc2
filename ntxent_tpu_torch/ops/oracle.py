"""Plain-PyTorch counterparts of ``ntxent_tpu/ops/oracle.py``.

Only ``cosine_normalize`` so far: the serving path L2-normalizes the
projection head's output. The loss oracles come with the training slice.
"""

from __future__ import annotations

import torch

__all__ = ["cosine_normalize"]


def cosine_normalize(z: torch.Tensor, dim: int = -1,
                     eps: float = 1e-12) -> torch.Tensor:
    """L2-normalize embeddings along ``dim``: ``z / max(||z||, eps)``."""
    norm = torch.sqrt(torch.sum(torch.square(z), dim=dim, keepdim=True))
    return z / torch.clamp(norm, min=eps)
