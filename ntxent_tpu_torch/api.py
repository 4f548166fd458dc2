"""Reference-compatible API surface, counterpart of ``ntxent_tpu/api.py``.

Mirrors the reference's bindings: ``forward(z, temperature,
use_mixed_precision=False)``, ``backward(z, softmax_output, grad_output,
temperature, use_mixed_precision=False)``, ``check_tensor_core_support()``
and the ``ntxent`` object. It takes torch tensors natively (numpy arrays
are converted) and returns torch tensors on the input's device.

As in the JAX package: semantics are canonical NT-Xent unless
``compat="reference"``; ``return_softmax=True`` returns the softmax
residual too; ``backward`` computes the exact dense gradient and honours
``grad_output``; ``use_mixed_precision=True`` casts z to bf16 (fp32
similarity accumulation). ``forward(..., fused=True)`` goes through
``ntxent_loss_fused``: the CUDA kernels on a GPU tensor, their plain
versions on a CPU tensor.

As ``ntxent_tpu`` does, it also exports the rest of the loss core: the
fused NT-Xent (``ntxent_loss_fused``, rectangular or triangular;
``ntxent_loss_and_lse``; the data-parallel building block
``ntxent_partial_fused``), the oracles (``ntxent_loss``,
``ntxent_loss_paired``, ``ntxent_loss_compat``, ``cosine_normalize``) and
the cross-modal (CLIP) losses, ``info_nce_fused`` (the InfoNCE kernels)
and ``info_nce_loss`` (the oracle).
"""

from __future__ import annotations

import torch

from .ops import oracle
from .ops.infonce import info_nce_fused
from .ops.ntxent import (
    ntxent_loss_and_lse,
    ntxent_loss_fused,
    ntxent_partial_fused,
)
from .ops.oracle import (
    cosine_normalize,
    info_nce_loss,
    ntxent_loss,
    ntxent_loss_compat,
    ntxent_loss_paired,
)
from .utils.capability import check_tensor_core_support

__all__ = ["backward", "check_tensor_core_support", "cosine_normalize",
           "forward", "info_nce_fused", "info_nce_loss", "ntxent",
           "ntxent_loss", "ntxent_loss_and_lse", "ntxent_loss_compat",
           "ntxent_loss_fused", "ntxent_loss_paired",
           "ntxent_partial_fused"]


def _prep(z, use_mixed_precision: bool) -> torch.Tensor:
    z = torch.as_tensor(z)
    return z.to(torch.bfloat16) if use_mixed_precision else z


def forward(z, temperature: float = 0.07, use_mixed_precision: bool = False,
            *, return_softmax: bool = False, compat: str = "canonical",
            fused: bool = True):
    """NT-Xent forward: the scalar loss, or (loss, softmax) with
    ``return_softmax=True``."""
    z = _prep(z, use_mixed_precision)
    if compat == "reference":
        loss = oracle.ntxent_loss_compat(z, temperature)
        if return_softmax:
            logits = oracle.similarity_matrix(torch.cat([z, z], dim=0),
                                              temperature)
            return loss, torch.softmax(logits, dim=-1)
        return loss
    if compat != "canonical":
        raise ValueError(f"unknown compat mode: {compat!r}")
    if return_softmax:
        return oracle.ntxent_loss_and_softmax(z, temperature)
    if fused:
        return ntxent_loss_fused(z, float(temperature))
    return oracle.ntxent_loss(z, temperature)


def backward(z, softmax_output=None, grad_output=1.0,
             temperature: float = 0.07, use_mixed_precision: bool = False):
    """NT-Xent backward: (grad_z, grad_logits), exact.

    ``softmax_output`` is accepted for signature parity and ignored: the
    gradient is recomputed from ``z``."""
    z = _prep(z, use_mixed_precision)
    del softmax_output  # recomputed exactly; kept for signature parity
    g = torch.as_tensor(grad_output, dtype=torch.float32, device=z.device)
    zf = z.float()
    logits, _ = oracle._masked_logits(zf, temperature)
    p = torch.softmax(logits, dim=-1)
    two_n = z.shape[0]
    rows = torch.arange(two_n, device=z.device)
    e = torch.zeros_like(p)
    e[rows, (rows + two_n // 2) % two_n] = 1.0
    grad_logits = (p - e) / two_n * g
    # d loss / d z = (1/T) (G + G^T) z with G = grad_logits (diagonal 0).
    grad_z = (grad_logits + grad_logits.T) @ zf / temperature
    return grad_z.to(z.dtype), grad_logits


class _NtxentModule:
    """Object-style access mirroring the bindings: ``ntxent.forward``."""

    forward = staticmethod(forward)
    backward = staticmethod(backward)
    check_tensor_core_support = staticmethod(check_tensor_core_support)


ntxent = _NtxentModule()
