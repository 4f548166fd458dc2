"""Fused cross-modal InfoNCE (CLIP): the hand-written Hopper kernels and
their plain versions.

Counterpart of the single-device path of ``ntxent_tpu/ops/infonce_pallas.py``
(``info_nce_fused``): paired embeddings za, zb (N, D), logits
``s = scale * za @ zb.T`` in fp32, positives on the diagonal (NOT masked:
za_i and zb_i are different modalities), the symmetric cross-entropy
``0.5 * (mean_i [lse_a_i - s_ii] + mean_j [lse_b_j - s_jj])``
(= ``ops.oracle.info_nce_loss``), O(N) residuals (the row and column
logsumexp). The logit scale is a differentiable fp32 tensor on the
embeddings' device (CLIP's learnable ``exp(logit_scale)``); the kernels
read it through a pointer, so no step waits on the host for it.

* ``infonce_dual_fwd(za, zb, scale) -> (loss_sum, lse_a, lse_b)``
  launches ``csrc/infonce_dual_fwd.cu`` on CUDA tensors;
  ``infonce_dual_fwd_plain`` is the same function in plain PyTorch;
* ``infonce_dual_bwd(za, zb, scale, lse_a, lse_b) -> (o_a, o_b)``, fp32
  ``G @ zb`` and ``G.T @ za`` with ``G = P_row + P_col - 2I`` (the total
  dL/ds before ``g / 2N``), launches ``csrc/infonce_dual_bwd.cu``;
  ``infonce_dual_bwd_plain`` is its plain version;
* ``info_nce_fused(za, zb, temperature, scale=None)`` is the
  differentiable mean loss, with gradients for za, zb and the scale.

A CUDA tensor launches the kernel or raises; a CPU tensor takes the plain
version. Each wrapper counts its launches in ``.launches`` (one per call:
each kernel covers both directions in one launch). The TPU package's
two-pass backward for large N (``_bwd_sym_call`` in cross-modal mode,
taken when its accumulators outgrow VMEM) is the same function; the
backward kernel here serves every N, so it has no counterpart. The
distributed partial losses of that module (``info_nce_dual_partial``,
``info_nce_partial_fused``) are not ported yet (ROADMAP.md Queue A 3).
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from . import _build

__all__ = ["info_nce_fused", "infonce_dual_bwd", "infonce_dual_bwd_plain",
           "infonce_dual_fwd", "infonce_dual_fwd_plain", "resolve_scale"]

MAX_DIM = 512  # widest embedding the kernels take (CLIP's is 512)
ROWS_PER_CTA = 64  # rows of one thread block in csrc/infonce_dual_fwd.cu
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def resolve_scale(temperature: float, scale, device=None) -> torch.Tensor:
    """Logit scale as an fp32 tensor: ``scale`` if given (a tensor keeps
    its autograd graph), else ``1/T`` rounded to fp32."""
    if scale is None:
        scale = float(np.float32(1.0 / float(temperature)))
    return torch.as_tensor(scale, dtype=torch.float32, device=device)


def _exp0(x: torch.Tensor) -> torch.Tensor:
    """``exp(min(x, 0))``: every argument is mathematically <= 0."""
    return torch.exp(torch.clamp(x, max=0.0))


def _check(za: torch.Tensor, zb: torch.Tensor) -> None:
    if za.ndim != 2 or za.shape != zb.shape:
        raise ValueError(f"paired embeddings must be (N, D) each and match: "
                         f"{tuple(za.shape)} vs {tuple(zb.shape)}")
    if za.shape[0] < 1:
        raise ValueError("InfoNCE needs at least one pair")
    if za.device != zb.device:
        raise ValueError(f"za on {za.device}, zb on {zb.device}")


def _similarity(za, zb, scale) -> torch.Tensor:
    """fp32 ``(za @ zb.T) * scale`` of the (widened) inputs."""
    return (za.float() @ zb.float().T) * scale.float()


def infonce_dual_fwd_plain(za: torch.Tensor, zb: torch.Tensor,
                           scale: torch.Tensor):
    """(loss_sum, lse_a, lse_b) with the kernel's numerics: max-shifted
    ``_exp0`` sums and ``log(max(l, 1e-37))`` in each direction."""
    _check(za, zb)
    s = _similarity(za, zb, scale)
    pos = torch.diagonal(s)

    def lse(dim):
        m = s.amax(dim=dim, keepdim=True)
        l = _exp0(s - m).sum(dim=dim)
        return m.squeeze(dim) + torch.log(torch.clamp(l, min=1e-37))

    lse_a, lse_b = lse(1), lse(0)
    return (lse_a - pos).sum() + (lse_b - pos).sum(), lse_a, lse_b


def infonce_dual_bwd_plain(za: torch.Tensor, zb: torch.Tensor,
                           scale: torch.Tensor, lse_a: torch.Tensor,
                           lse_b: torch.Tensor):
    """fp32 ``(G @ zb, G.T @ za)`` with ``G = (p_row - I) + (p_col - I)``,
    ``p_row = exp0(s - lse_a[row])``, ``p_col = exp0(s - lse_b[col])``."""
    _check(za, zb)
    s = _similarity(za, zb, scale)
    eye = torch.eye(s.shape[0], dtype=s.dtype, device=s.device)
    g = (_exp0(s - lse_a[:, None]) - eye) + (_exp0(s - lse_b[None, :]) - eye)
    return g @ zb.float(), g.T @ za.float()


def _check_kernel_input(za: torch.Tensor, zb: torch.Tensor,
                        scale: torch.Tensor) -> torch.Tensor:
    """Validate what the kernels take; returns the scale as a contiguous
    one-element fp32 tensor on the embeddings' device."""
    if za.dtype not in _DTYPE_CODES or zb.dtype != za.dtype:
        raise TypeError(f"the InfoNCE kernels take float32 or bfloat16 za "
                        f"and zb of one dtype, got {za.dtype}, {zb.dtype}")
    if not 1 <= za.shape[1] <= MAX_DIM:
        raise ValueError(f"the InfoNCE kernels take 1 <= D <= {MAX_DIM}, "
                         f"got {za.shape[1]}")
    if not (za.is_contiguous() and zb.is_contiguous()):
        raise ValueError("za and zb must be contiguous")
    if scale.numel() != 1 or scale.device != za.device:
        raise ValueError(f"scale must be one value on {za.device}, got "
                         f"shape {tuple(scale.shape)} on {scale.device}")
    return scale.detach().to(torch.float32).reshape(1).contiguous()


@functools.cache
def _fwd_kernel():
    fn = _build.load("infonce_dual_fwd").ntx_infonce_dual_fwd
    # za, zb, scale, lse_a, lse_b, partial, loss; n, d, dtype, device; stream
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _bwd_kernel():
    fn = _build.load("infonce_dual_bwd").ntx_infonce_dual_bwd
    # za, zb, scale, lse_a, lse_b, o_a, o_b; n, d, dtype, device; stream
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _on_cuda(name: str, t: torch.Tensor) -> bool:
    """False for a CPU tensor (plain version), True for CUDA; raises for
    any other device."""
    if t.device.type == "cpu":
        return False
    if t.device.type != "cuda":
        raise ValueError(f"{name} runs on cuda or cpu, got {t.device}")
    return True


def infonce_dual_fwd(za: torch.Tensor, zb: torch.Tensor,
                     scale: torch.Tensor):
    """(loss_sum, lse_a, lse_b): an fp32 scalar and two (N,) fp32 vectors.

    A CUDA tensor launches ``csrc/infonce_dual_fwd.cu`` (counted in
    ``infonce_dual_fwd.launches``); a CPU tensor runs the plain version."""
    _check(za, zb)
    if not _on_cuda("infonce_dual_fwd", za):
        return infonce_dual_fwd_plain(za, zb, scale)
    scale = _check_kernel_input(za, zb, scale)
    n, d = za.shape
    dev = za.device
    lse_a = torch.empty(n, dtype=torch.float32, device=dev)
    lse_b = torch.empty(n, dtype=torch.float32, device=dev)
    partial = torch.empty(2 * -(-n // ROWS_PER_CTA), dtype=torch.float32,
                          device=dev)
    loss = torch.empty((), dtype=torch.float32, device=dev)
    err = _fwd_kernel()(za.data_ptr(), zb.data_ptr(), scale.data_ptr(),
                        lse_a.data_ptr(), lse_b.data_ptr(),
                        partial.data_ptr(), loss.data_ptr(), n, d,
                        _DTYPE_CODES[za.dtype], dev.index,
                        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"infonce_dual_fwd launch failed: CUDA error "
                           f"{err}")
    infonce_dual_fwd.launches += 1
    return loss, lse_a, lse_b


infonce_dual_fwd.launches = 0


def infonce_dual_bwd(za: torch.Tensor, zb: torch.Tensor, scale: torch.Tensor,
                     lse_a: torch.Tensor, lse_b: torch.Tensor):
    """(o_a, o_b): (N, D) fp32 ``G @ zb`` and ``G.T @ za``.

    A CUDA tensor launches ``csrc/infonce_dual_bwd.cu`` (counted in
    ``infonce_dual_bwd.launches``); a CPU tensor runs the plain version."""
    _check(za, zb)
    n = za.shape[0]
    for name, lse in (("lse_a", lse_a), ("lse_b", lse_b)):
        if lse.shape != (n,) or lse.device != za.device:
            raise ValueError(f"{name} must be ({n},) on {za.device}, got "
                             f"{tuple(lse.shape)} on {lse.device}")
    if not _on_cuda("infonce_dual_bwd", za):
        return infonce_dual_bwd_plain(za, zb, scale, lse_a, lse_b)
    scale = _check_kernel_input(za, zb, scale)
    lse_a = lse_a.float().contiguous()
    lse_b = lse_b.float().contiguous()
    o_a = torch.empty(za.shape, dtype=torch.float32, device=za.device)
    o_b = torch.empty(za.shape, dtype=torch.float32, device=za.device)
    err = _bwd_kernel()(za.data_ptr(), zb.data_ptr(), scale.data_ptr(),
                        lse_a.data_ptr(), lse_b.data_ptr(), o_a.data_ptr(),
                        o_b.data_ptr(), n, za.shape[1],
                        _DTYPE_CODES[za.dtype], za.device.index,
                        torch.cuda.current_stream(za.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"infonce_dual_bwd launch failed: CUDA error "
                           f"{err}")
    infonce_dual_bwd.launches += 1
    return o_a, o_b


infonce_dual_bwd.launches = 0


class _InfoNce(torch.autograd.Function):
    """The mean loss with the kernels' exact backward
    (infonce_pallas.py:331-378): the forward saves (za, zb, scale, lse_a,
    lse_b); the backward returns ``o * (g / 2N) * scale`` cast to each
    input's dtype and ``grad_scale = (g / 2N) * sum(o_a * za)``."""

    @staticmethod
    def forward(ctx, za, zb, scale):
        loss_sum, lse_a, lse_b = infonce_dual_fwd(za, zb, scale)
        ctx.save_for_backward(za, zb, scale, lse_a, lse_b)
        return loss_sum / (2 * za.shape[0])

    @staticmethod
    def backward(ctx, g):
        za, zb, scale, lse_a, lse_b = ctx.saved_tensors
        o_a, o_b = infonce_dual_bwd(za, zb, scale, lse_a, lse_b)
        coef = g.float() / (2 * za.shape[0])
        factor = coef * scale.float()
        grad_za = (o_a * factor).to(za.dtype)
        grad_zb = (o_b * factor).to(zb.dtype)
        # dL/dscale = coef * sum_ij G_ij (za_i . zb_j)
        #          = coef * sum_i o_a[i] . za[i]
        grad_scale = (coef * torch.sum(o_a * za.float())).reshape(
            scale.shape).to(scale.dtype)
        return grad_za, grad_zb, grad_scale


def info_nce_fused(za: torch.Tensor, zb: torch.Tensor,
                   temperature: float = 0.07, *,
                   scale: torch.Tensor | float | None = None) -> torch.Tensor:
    """Fused symmetric InfoNCE over paired embeddings za, zb: (N, D) each.

    Same semantics as ``ops.oracle.info_nce_loss``, O(N) memory, exact
    gradients for za, zb AND the logit scale. Pass ``scale`` (= 1/T, e.g.
    CLIP's learnable ``exp(logit_scale)``) as a tensor to train it;
    otherwise ``temperature`` is used."""
    _check(za, zb)
    scale = resolve_scale(temperature, scale, za.device)
    return _InfoNce.apply(za.contiguous(), zb.contiguous(), scale)
