"""Plain-PyTorch NT-Xent oracles, counterparts of ``ntxent_tpu/ops/oracle.py``.

The gold standard the fused kernels are held to, with the same two
semantics:

* ``ntxent_loss`` / ``ntxent_loss_paired``: canonical SimCLR NT-Xent over
  2N stacked embeddings, positive of row i at ``(i + N) mod 2N``, the
  self-similarity diagonal masked to -1e30;
* ``ntxent_loss_compat``: the reference's as-written behaviour, for
  comparison only (rows duplicated, no mask, the diagonal as positive).

Every oracle is differentiable by torch autograd; ``ntxent_grad_oracle``
is the gradient gold standard. Similarities accumulate in fp32 whatever
the input dtype.
"""

from __future__ import annotations

import torch

__all__ = [
    "cosine_normalize",
    "info_nce_loss",
    "ntxent_grad_oracle",
    "ntxent_loss",
    "ntxent_loss_and_softmax",
    "ntxent_loss_compat",
    "ntxent_loss_paired",
    "similarity_matrix",
]

_NEG_INF = -1e30  # large-negative mask value; avoids inf - inf NaNs


def cosine_normalize(z: torch.Tensor, dim: int = -1,
                     eps: float = 1e-12) -> torch.Tensor:
    """L2-normalize embeddings along ``dim``: ``z / max(||z||, eps)``."""
    norm = torch.sqrt(torch.sum(torch.square(z), dim=dim, keepdim=True))
    return z / torch.clamp(norm, min=eps)


def similarity_matrix(z: torch.Tensor, temperature) -> torch.Tensor:
    """(2N, 2N) scaled similarity ``z @ z.T / T``, accumulated in fp32."""
    zf = z.float()
    return (zf @ zf.T) / torch.as_tensor(temperature, dtype=torch.float32,
                                         device=z.device)


def _masked_logits(z: torch.Tensor, temperature):
    """(masked logits, positive-pair logits) for canonical NT-Xent."""
    two_n = z.shape[0]
    if two_n % 2 != 0:
        raise ValueError(f"canonical NT-Xent needs an even row count, got "
                         f"{two_n}")
    logits = similarity_matrix(z, temperature)
    rows = torch.arange(two_n, device=z.device)
    logits = logits.masked_fill(
        torch.eye(two_n, dtype=torch.bool, device=z.device), _NEG_INF)
    positives = logits[rows, (rows + two_n // 2) % two_n]
    return logits, positives


def ntxent_loss(z: torch.Tensor, temperature=0.07) -> torch.Tensor:
    """Canonical NT-Xent on stacked views ``z = cat([view1, view2])``:
    ``mean_i [logsumexp_{j != i} s_ij - s_i,pos(i)]``."""
    logits, positives = _masked_logits(z, temperature)
    return torch.mean(torch.logsumexp(logits, dim=-1) - positives)


def ntxent_loss_paired(z1: torch.Tensor, z2: torch.Tensor,
                       temperature=0.07) -> torch.Tensor:
    """Canonical NT-Xent on the two views given separately, (N, D) each."""
    return ntxent_loss(torch.cat([z1, z2], dim=0), temperature)


def ntxent_loss_and_softmax(z: torch.Tensor, temperature=0.07):
    """The loss and the (2N, 2N) masked softmax matrix."""
    logits, positives = _masked_logits(z, temperature)
    lse = torch.logsumexp(logits, dim=-1)
    softmax = torch.exp(logits - lse[:, None])
    return torch.mean(lse - positives), softmax


def ntxent_loss_compat(z: torch.Tensor, temperature=0.07) -> torch.Tensor:
    """The reference's as-written semantics, for comparison only: z (B, D)
    duplicated, no diagonal mask, positive = self."""
    logits = similarity_matrix(torch.cat([z, z], dim=0), temperature)
    lse = torch.logsumexp(logits, dim=-1)
    return torch.mean(lse - torch.diagonal(logits))


def ntxent_grad_oracle(z: torch.Tensor, temperature=0.07) -> torch.Tensor:
    """Exact ``d ntxent_loss / d z`` by autograd."""
    zz = z.detach().requires_grad_(True)
    with torch.enable_grad():
        (grad,) = torch.autograd.grad(ntxent_loss(zz, temperature), zz)
    return grad


def info_nce_loss(za: torch.Tensor, zb: torch.Tensor,
                  temperature=0.07) -> torch.Tensor:
    """Cross-modal InfoNCE (CLIP-style): positives on the a-b diagonal,
    symmetric cross-entropy over rows and columns of ``za @ zb.T / T``."""
    logits = (za.float() @ zb.float().T) / torch.as_tensor(
        temperature, dtype=torch.float32, device=za.device)
    diag = torch.diagonal(logits)
    loss_a = torch.mean(torch.logsumexp(logits, dim=1) - diag)
    loss_b = torch.mean(torch.logsumexp(logits, dim=0) - diag)
    return 0.5 * (loss_a + loss_b)
