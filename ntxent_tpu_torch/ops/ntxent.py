"""Fused NT-Xent: the hand-written Hopper kernels and their plain versions.

Counterpart of the symmetric path of ``ntxent_tpu/ops/ntxent_pallas.py``
(``ntxent_loss_fused`` with ``triangular=False``): canonical NT-Xent over
stacked views z (2N, D), positive of row i at (i + N) mod 2N, the
self-similarity diagonal masked to -1e30, O(N) residuals (only the row
logsumexp survives the forward).

* ``ntxent_fwd(z, temperature) -> (loss_sum, lse)`` launches
  ``csrc/ntxent_fwd.cu`` on a CUDA tensor; ``ntxent_fwd_plain`` is the
  same function in plain PyTorch;
* ``ntxent_bwd_sym(z, lse, temperature) -> grad`` (fp32, before the
  ``g / T`` scale) launches ``csrc/ntxent_bwd_sym.cu``;
  ``ntxent_bwd_sym_plain`` is its plain version;
* ``ntxent_loss_fused(z, temperature)`` is the differentiable mean loss.

A CUDA tensor launches the kernel or raises; a CPU tensor takes the plain
version. Each wrapper counts its launches in ``.launches``. The tile
shape belongs to the CUDA kernels: there is no block chooser here.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from . import _build

__all__ = ["ntxent_bwd_sym", "ntxent_bwd_sym_plain", "ntxent_fwd",
           "ntxent_fwd_plain", "ntxent_loss_fused"]

_NEG_INF = -1e30
MAX_DIM = 256  # widest embedding the kernels stage in shared memory
ROWS_PER_CTA = 32  # rows of one thread block in csrc/ntxent_fwd.cu
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def _inv_t(temperature: float) -> float:
    """1/T rounded to fp32, as the TPU kernel multiplies by it."""
    return float(np.float32(1.0 / float(temperature)))


def _exp0(x: torch.Tensor) -> torch.Tensor:
    """``exp(min(x, 0))``: every argument is mathematically <= 0."""
    return torch.exp(torch.clamp(x, max=0.0))


def _check(z: torch.Tensor) -> None:
    if z.ndim != 2:
        raise ValueError(f"NT-Xent takes stacked views (2N, D), got shape "
                         f"{tuple(z.shape)}")
    if z.shape[0] % 2 != 0 or z.shape[0] < 2:
        raise ValueError(f"NT-Xent needs an even number of rows, got "
                         f"{z.shape[0]}")


def _masked_similarity(z: torch.Tensor, temperature: float):
    """(masked scaled similarity, positive logits, positive one-hot)."""
    zf = z.float()
    two_n = z.shape[0]
    s = (zf @ zf.T) * _inv_t(temperature)
    rows = torch.arange(two_n, device=z.device)
    pos_idx = (rows + two_n // 2) % two_n
    positives = s[rows, pos_idx]
    masked = s.masked_fill(torch.eye(two_n, dtype=torch.bool,
                                     device=z.device), _NEG_INF)
    onehot = torch.zeros_like(s)
    onehot[rows, pos_idx] = 1.0
    return masked, positives, onehot


def ntxent_fwd_plain(z: torch.Tensor, temperature: float):
    """(loss_sum, lse) with the kernel's numerics: fp32 similarity of the
    (widened) inputs, max-shifted ``_exp0`` sum, ``log(max(l, 1e-37))``."""
    _check(z)
    s, positives, _ = _masked_similarity(z, temperature)
    m = s.amax(dim=1)
    l = _exp0(s - m[:, None]).sum(dim=1)
    lse = m + torch.log(torch.clamp(l, min=1e-37))
    return (lse - positives).sum(), lse


def ntxent_bwd_sym_plain(z: torch.Tensor, lse: torch.Tensor,
                         temperature: float) -> torch.Tensor:
    """fp32 ``G @ z`` with ``G = (p_row - pos) + (p_col - pos)``,
    ``p_row = exp0(s - lse[row])``, ``p_col = exp0(s - lse[col])``."""
    _check(z)
    s, _, onehot = _masked_similarity(z, temperature)
    g = (_exp0(s - lse[:, None]) - onehot) + (_exp0(s - lse[None, :])
                                              - onehot)
    return g @ z.float()


def _check_kernel_input(z: torch.Tensor) -> None:
    if z.dtype not in _DTYPE_CODES:
        raise TypeError(f"the NT-Xent kernels take float32 or bfloat16 z, "
                        f"got {z.dtype}")
    if not 1 <= z.shape[1] <= MAX_DIM:
        raise ValueError(f"the NT-Xent kernels take 1 <= D <= {MAX_DIM}, "
                         f"got {z.shape[1]}")
    if not z.is_contiguous():
        raise ValueError("z must be contiguous")


@functools.cache
def _fwd_kernel():
    fn = _build.load("ntxent_fwd").ntx_ntxent_fwd
    # z, lse, partial, loss; rows, d, dtype; inv_t; device; stream
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 3
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _bwd_kernel():
    fn = _build.load("ntxent_bwd_sym").ntx_ntxent_bwd_sym
    # z, lse, grad; rows, d, dtype; inv_t; device; stream
    fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 3
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def ntxent_fwd(z: torch.Tensor, temperature: float):
    """(loss_sum, lse): fp32 scalar and (2N,) fp32 row logsumexp.

    A CUDA tensor launches ``csrc/ntxent_fwd.cu`` (counted in
    ``ntxent_fwd.launches``); a CPU tensor runs ``ntxent_fwd_plain``."""
    _check(z)
    if z.device.type == "cpu":
        return ntxent_fwd_plain(z, temperature)
    if z.device.type != "cuda":
        raise ValueError(f"ntxent_fwd runs on cuda or cpu, got {z.device}")
    _check_kernel_input(z)
    rows, d = z.shape
    lse = torch.empty(rows, dtype=torch.float32, device=z.device)
    partial = torch.empty(-(-rows // ROWS_PER_CTA), dtype=torch.float32,
                          device=z.device)
    loss = torch.empty((), dtype=torch.float32, device=z.device)
    err = _fwd_kernel()(z.data_ptr(), lse.data_ptr(), partial.data_ptr(),
                        loss.data_ptr(), rows, d, _DTYPE_CODES[z.dtype],
                        _inv_t(temperature), z.device.index,
                        torch.cuda.current_stream(z.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"ntxent_fwd launch failed: CUDA error {err}")
    ntxent_fwd.launches += 1
    return loss, lse


ntxent_fwd.launches = 0


def ntxent_bwd_sym(z: torch.Tensor, lse: torch.Tensor,
                   temperature: float) -> torch.Tensor:
    """(2N, D) fp32 ``G @ z`` (the gradient of loss_sum before ``1 / T``).

    A CUDA tensor launches ``csrc/ntxent_bwd_sym.cu`` (counted in
    ``ntxent_bwd_sym.launches``); a CPU tensor runs the plain version."""
    _check(z)
    if lse.shape != (z.shape[0],) or lse.device != z.device:
        raise ValueError(f"lse must be ({z.shape[0]},) on {z.device}, got "
                         f"{tuple(lse.shape)} on {lse.device}")
    if z.device.type == "cpu":
        return ntxent_bwd_sym_plain(z, lse, temperature)
    if z.device.type != "cuda":
        raise ValueError(f"ntxent_bwd_sym runs on cuda or cpu, got "
                         f"{z.device}")
    _check_kernel_input(z)
    lse = lse.float().contiguous()
    grad = torch.empty(z.shape, dtype=torch.float32, device=z.device)
    err = _bwd_kernel()(z.data_ptr(), lse.data_ptr(), grad.data_ptr(),
                        z.shape[0], z.shape[1], _DTYPE_CODES[z.dtype],
                        _inv_t(temperature), z.device.index,
                        torch.cuda.current_stream(z.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"ntxent_bwd_sym launch failed: CUDA error {err}")
    ntxent_bwd_sym.launches += 1
    return grad


ntxent_bwd_sym.launches = 0


class _NtxentSym(torch.autograd.Function):
    """loss_sum with the kernels' exact backward (ntxent_pallas.py:724-774):
    the forward saves (z, lse); the backward returns
    ``grad * (g / T)`` cast to z's dtype."""

    @staticmethod
    def forward(ctx, z, temperature):
        loss_sum, lse = ntxent_fwd(z, temperature)
        ctx.save_for_backward(z, lse)
        ctx.temperature = temperature
        return loss_sum

    @staticmethod
    def backward(ctx, g):
        z, lse = ctx.saved_tensors
        grad = ntxent_bwd_sym(z, lse, ctx.temperature)
        return (grad * (g.float() / ctx.temperature)).to(z.dtype), None


def ntxent_loss_fused(z: torch.Tensor,
                      temperature: float = 0.07) -> torch.Tensor:
    """Fused canonical NT-Xent mean loss over stacked views z (2N, D).

    Same semantics as ``ops.oracle.ntxent_loss``, O(N) memory, exact
    gradient through the backward kernel. ``temperature`` is a Python
    float."""
    return _NtxentSym.apply(z.contiguous(), float(temperature)) / z.shape[0]
