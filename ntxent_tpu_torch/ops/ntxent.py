"""Fused NT-Xent: the hand-written Hopper kernels and their plain versions.

Counterpart of ``ntxent_tpu/ops/ntxent_pallas.py`` in two modes.

Symmetric (``ntxent_loss_fused`` with ``triangular=False``): canonical
NT-Xent over stacked views z (2N, D), positive of row i at (i + N) mod 2N,
the self-similarity diagonal masked to -1e30, O(N) residuals (only the
row logsumexp survives the forward).

* ``ntxent_fwd(z, temperature) -> (loss_sum, lse)`` launches
  ``csrc/ntxent_fwd.cu`` on a CUDA tensor; ``ntxent_fwd_plain`` is the
  same function in plain PyTorch;
* ``ntxent_bwd_sym(z, lse, temperature) -> grad`` (fp32, before the
  ``g / T`` scale) launches ``csrc/ntxent_bwd_sym.cu``;
  ``ntxent_bwd_sym_plain`` is its plain version;
* ``ntxent_loss_fused(z, temperature)`` is the differentiable mean loss.

General (``ntxent_partial_fused``, ``block_lse``, ``block_grads``): rows
z_rows (R, D) with global ids ``row_gid``, columns z_cols (C, D) with
global ids ``col_gid`` (default: the column index); a column is masked
where its id is >= ``cols_actual`` or equals the row's id, the positive
of a row is the column whose id is ``_pos_gid`` of the row's id, and a
row whose id is >= ``cols_actual`` (the padding sentinel 2N) adds no loss.

* ``ntxent_fwd_general(...) -> (loss_sum, lse)`` launches the general
  mode of ``csrc/ntxent_fwd.cu`` (its own launch counter);
  ``ntxent_fwd_general_plain`` is its plain version;
* ``ntxent_bwd_general_rows(...) -> (P - E) @ z_cols`` and
  ``ntxent_bwd_general_cols(...) -> (P - E)^T @ z_rows`` (fp32, before
  ``g / T``; ``P`` from the row lse) launch the two kernels of
  ``csrc/ntxent_bwd_general.cu``; ``ntxent_bwd_general_rows_plain`` and
  ``ntxent_bwd_general_cols_plain`` are their plain versions;
* ``ntxent_partial_fused(z_rows, z_cols, row_gid, temperature)`` is the
  differentiable partial loss SUM over the local rows, the data-parallel
  strip loss's building block (``ntxent_pallas.py:871``).

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

__all__ = ["ntxent_bwd_general_cols", "ntxent_bwd_general_cols_plain",
           "ntxent_bwd_general_rows", "ntxent_bwd_general_rows_plain",
           "ntxent_bwd_sym", "ntxent_bwd_sym_plain", "ntxent_fwd",
           "ntxent_fwd_general", "ntxent_fwd_general_plain",
           "ntxent_fwd_plain", "ntxent_loss_fused", "ntxent_partial_fused"]

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


# ---------------------------------------------------------------------------
# General mode: rows x columns with global ids
# ---------------------------------------------------------------------------


def _general_args(z_rows, z_cols, row_gid, col_gid, cols_actual, n_half):
    """Check the general-mode inputs; fill the defaults of cols_actual
    (C) and n_half (C // 2) as ``ntxent_partial_fused`` sets them."""
    if z_rows.ndim != 2 or z_cols.ndim != 2 \
            or z_rows.shape[1] != z_cols.shape[1]:
        raise ValueError(f"rows (R, D) and columns (C, D) must share D, got "
                         f"{tuple(z_rows.shape)} and {tuple(z_cols.shape)}")
    if z_rows.shape[0] < 1 or z_cols.shape[0] < 1:
        raise ValueError("the general NT-Xent needs at least one row and "
                         "one column")
    if z_rows.dtype != z_cols.dtype or z_rows.device != z_cols.device:
        raise ValueError(f"rows and columns must share dtype and device, got "
                         f"{z_rows.dtype} on {z_rows.device} and "
                         f"{z_cols.dtype} on {z_cols.device}")
    for name, ids, n in (("row_gid", row_gid, z_rows.shape[0]),
                         ("col_gid", col_gid, z_cols.shape[0])):
        if ids is None:
            continue
        if ids.shape != (n,) or ids.device != z_rows.device \
                or ids.is_floating_point():
            raise ValueError(f"{name} must be ({n},) integers on "
                             f"{z_rows.device}, got {tuple(ids.shape)} "
                             f"{ids.dtype} on {ids.device}")
    cols = z_cols.shape[0]
    return (cols if cols_actual is None else int(cols_actual),
            cols // 2 if n_half is None else int(n_half))


def _general_terms(z_rows, z_cols, row_gid, temperature, col_gid,
                   cols_actual, n_half):
    """(masked scaled similarity, raw scaled similarity, positive one-hot
    E, valid-row mask) of ``_masked_sim_tile`` / ``_pos_gid``."""
    s = (z_rows.float() @ z_cols.float().T) * _inv_t(temperature)
    rid = row_gid.long()[:, None]
    cid = (torch.arange(z_cols.shape[0], device=z_rows.device)
           if col_gid is None else col_gid.long())[None, :]
    masked = s.masked_fill((cid >= cols_actual) | (cid == rid), _NEG_INF)
    pos = torch.where(rid < n_half, rid + n_half, rid - n_half)
    return masked, s, (cid == pos).float(), rid[:, 0] < cols_actual


def ntxent_fwd_general_plain(z_rows, z_cols, row_gid, temperature,
                             col_gid=None, cols_actual=None, n_half=None):
    """(loss_sum, lse (R,)) of the general mode with the kernel's numerics:
    fp32 similarity of the (widened) inputs, max-shifted ``_exp0`` sum,
    ``log(max(l, 1e-37))``; rows with ids >= cols_actual add no loss."""
    cols_actual, n_half = _general_args(z_rows, z_cols, row_gid, col_gid,
                                        cols_actual, n_half)
    masked, raw, onehot, valid = _general_terms(
        z_rows, z_cols, row_gid, temperature, col_gid, cols_actual, n_half)
    m = masked.amax(dim=1)
    l = _exp0(masked - m[:, None]).sum(dim=1)
    lse = m + torch.log(torch.clamp(l, min=1e-37))
    positives = (raw * onehot).sum(dim=1)
    loss = torch.where(valid, lse - positives, torch.zeros_like(lse))
    return loss.sum(), lse


def _general_g(z_rows, z_cols, row_gid, lse, temperature, col_gid,
               cols_actual, n_half):
    """G = (P - E) * valid_row with P = exp0(s - lse[row])."""
    cols_actual, n_half = _general_args(z_rows, z_cols, row_gid, col_gid,
                                        cols_actual, n_half)
    if lse.shape != (z_rows.shape[0],) or lse.device != z_rows.device:
        raise ValueError(f"lse must be ({z_rows.shape[0]},) on "
                         f"{z_rows.device}, got {tuple(lse.shape)} on "
                         f"{lse.device}")
    masked, _, onehot, valid = _general_terms(
        z_rows, z_cols, row_gid, temperature, col_gid, cols_actual, n_half)
    p = _exp0(masked - lse.float()[:, None])
    return (p - onehot) * valid.float()[:, None]


def ntxent_bwd_general_rows_plain(z_rows, z_cols, row_gid, lse, temperature,
                                  col_gid=None, cols_actual=None,
                                  n_half=None) -> torch.Tensor:
    """(R, D) fp32 ``G @ z_cols`` (``_bwd_rows_kernel``)."""
    return _general_g(z_rows, z_cols, row_gid, lse, temperature, col_gid,
                      cols_actual, n_half) @ z_cols.float()


def ntxent_bwd_general_cols_plain(z_rows, z_cols, row_gid, lse, temperature,
                                  col_gid=None, cols_actual=None,
                                  n_half=None) -> torch.Tensor:
    """(C, D) fp32 ``G^T @ z_rows`` (``_bwd_cols_kernel``)."""
    return _general_g(z_rows, z_cols, row_gid, lse, temperature, col_gid,
                      cols_actual, n_half).T @ z_rows.float()


def _ids(ids):
    return None if ids is None else ids.to(torch.int32).contiguous()


def _ptr(t) -> int | None:
    return None if t is None else t.data_ptr()


@functools.cache
def _fwd_general_kernel():
    fn = _build.load("ntxent_fwd").ntx_ntxent_fwd_general
    # z_rows, z_cols, row_gid, col_gid, lse, partial, loss; rows, cols, d,
    # dtype; inv_t; cols_actual, n_half, device; stream
    fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 4
                   + [ctypes.c_float] + [ctypes.c_int] * 3
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _bwd_general_kernel(side: str):
    fn = getattr(_build.load("ntxent_bwd_general"),
                 f"ntx_ntxent_bwd_general_{side}")
    # z_rows, z_cols, row_gid, col_gid, lse, grad; rows, cols, d, dtype;
    # inv_t; cols_actual, n_half, device; stream
    fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 4
                   + [ctypes.c_float] + [ctypes.c_int] * 3
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def ntxent_fwd_general(z_rows, z_cols, row_gid, temperature, col_gid=None,
                       cols_actual=None, n_half=None):
    """(loss_sum, lse): fp32 scalar and (R,) fp32 row logsumexp of the
    general mode.

    A CUDA tensor launches the general mode of ``csrc/ntxent_fwd.cu``
    (counted in ``ntxent_fwd_general.launches``); a CPU tensor runs
    ``ntxent_fwd_general_plain``."""
    cols_actual, n_half = _general_args(z_rows, z_cols, row_gid, col_gid,
                                        cols_actual, n_half)
    if z_rows.device.type == "cpu":
        return ntxent_fwd_general_plain(z_rows, z_cols, row_gid, temperature,
                                        col_gid, cols_actual, n_half)
    if z_rows.device.type != "cuda":
        raise ValueError(f"ntxent_fwd_general runs on cuda or cpu, got "
                         f"{z_rows.device}")
    _check_kernel_input(z_rows)
    _check_kernel_input(z_cols)
    rows, d = z_rows.shape
    row_gid, col_gid = _ids(row_gid), _ids(col_gid)
    lse = torch.empty(rows, dtype=torch.float32, device=z_rows.device)
    partial = torch.empty(-(-rows // ROWS_PER_CTA), dtype=torch.float32,
                          device=z_rows.device)
    loss = torch.empty((), dtype=torch.float32, device=z_rows.device)
    err = _fwd_general_kernel()(
        z_rows.data_ptr(), z_cols.data_ptr(), row_gid.data_ptr(),
        _ptr(col_gid), lse.data_ptr(), partial.data_ptr(), loss.data_ptr(),
        rows, z_cols.shape[0], d, _DTYPE_CODES[z_rows.dtype],
        _inv_t(temperature), cols_actual, n_half, z_rows.device.index,
        torch.cuda.current_stream(z_rows.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"ntxent_fwd_general launch failed: CUDA error "
                           f"{err}")
    ntxent_fwd_general.launches += 1
    return loss, lse


ntxent_fwd_general.launches = 0


def _bwd_general(side, z_rows, z_cols, row_gid, lse, temperature, col_gid,
                 cols_actual, n_half):
    """Launch the rows or the columns kernel of the general backward."""
    if z_rows.device.type != "cuda":
        raise ValueError(f"ntxent_bwd_general_{side} runs on cuda or cpu, "
                         f"got {z_rows.device}")
    _check_kernel_input(z_rows)
    _check_kernel_input(z_cols)
    row_gid, col_gid = _ids(row_gid), _ids(col_gid)
    lse = lse.float().contiguous()
    out = z_rows if side == "rows" else z_cols
    grad = torch.empty(out.shape, dtype=torch.float32, device=out.device)
    err = _bwd_general_kernel(side)(
        z_rows.data_ptr(), z_cols.data_ptr(), row_gid.data_ptr(),
        _ptr(col_gid), lse.data_ptr(), grad.data_ptr(), z_rows.shape[0],
        z_cols.shape[0], z_rows.shape[1], _DTYPE_CODES[z_rows.dtype],
        _inv_t(temperature), cols_actual, n_half, z_rows.device.index,
        torch.cuda.current_stream(z_rows.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"ntxent_bwd_general_{side} launch failed: CUDA "
                           f"error {err}")
    return grad


def ntxent_bwd_general_rows(z_rows, z_cols, row_gid, lse, temperature,
                            col_gid=None, cols_actual=None,
                            n_half=None) -> torch.Tensor:
    """(R, D) fp32 ``G @ z_cols`` (the gradient of loss_sum with respect to
    z_rows before ``1 / T``).

    A CUDA tensor launches the rows kernel of ``csrc/ntxent_bwd_general.cu``
    (counted in ``ntxent_bwd_general_rows.launches``); a CPU tensor runs
    the plain version."""
    cols_actual, n_half = _general_args(z_rows, z_cols, row_gid, col_gid,
                                        cols_actual, n_half)
    if z_rows.device.type == "cpu":
        return ntxent_bwd_general_rows_plain(z_rows, z_cols, row_gid, lse,
                                             temperature, col_gid,
                                             cols_actual, n_half)
    grad = _bwd_general("rows", z_rows, z_cols, row_gid, lse, temperature,
                        col_gid, cols_actual, n_half)
    ntxent_bwd_general_rows.launches += 1
    return grad


ntxent_bwd_general_rows.launches = 0


def ntxent_bwd_general_cols(z_rows, z_cols, row_gid, lse, temperature,
                            col_gid=None, cols_actual=None,
                            n_half=None) -> torch.Tensor:
    """(C, D) fp32 ``G^T @ z_rows`` from the row lse (the gradient of
    loss_sum with respect to z_cols before ``1 / T``).

    A CUDA tensor launches the columns kernel of
    ``csrc/ntxent_bwd_general.cu`` (counted in
    ``ntxent_bwd_general_cols.launches``); a CPU tensor runs the plain
    version."""
    cols_actual, n_half = _general_args(z_rows, z_cols, row_gid, col_gid,
                                        cols_actual, n_half)
    if z_rows.device.type == "cpu":
        return ntxent_bwd_general_cols_plain(z_rows, z_cols, row_gid, lse,
                                             temperature, col_gid,
                                             cols_actual, n_half)
    grad = _bwd_general("cols", z_rows, z_cols, row_gid, lse, temperature,
                        col_gid, cols_actual, n_half)
    ntxent_bwd_general_cols.launches += 1
    return grad


ntxent_bwd_general_cols.launches = 0


class _NtxentPartial(torch.autograd.Function):
    """Partial loss_sum with the kernels' exact backward
    (``_ntxent_partial_fwd``/``_bwd``, ntxent_pallas.py:829-868): the
    forward saves (z_rows, z_cols, row_gid, lse); the backward returns
    ``grad * (g / T)`` for both embeddings, each in its own dtype."""

    @staticmethod
    def forward(ctx, z_rows, z_cols, row_gid, temperature):
        loss_sum, lse = ntxent_fwd_general(z_rows, z_cols, row_gid,
                                           temperature)
        ctx.save_for_backward(z_rows, z_cols, row_gid, lse)
        ctx.temperature = temperature
        return loss_sum

    @staticmethod
    def backward(ctx, g):
        z_rows, z_cols, row_gid, lse = ctx.saved_tensors
        coef = g.float() / ctx.temperature
        args = (z_rows, z_cols, row_gid, lse, ctx.temperature)
        grad_rows = grad_cols = None
        if ctx.needs_input_grad[0]:
            grad_rows = (ntxent_bwd_general_rows(*args) * coef).to(
                z_rows.dtype)
        if ctx.needs_input_grad[1]:
            grad_cols = (ntxent_bwd_general_cols(*args) * coef).to(
                z_cols.dtype)
        return grad_rows, grad_cols, None, None


def ntxent_partial_fused(z_rows: torch.Tensor, z_cols: torch.Tensor,
                         row_gid: torch.Tensor,
                         temperature: float = 0.07) -> torch.Tensor:
    """Partial NT-Xent loss **sum** over a set of rows of the global matrix.

    z_rows: (R, D) local embeddings (this rank's rows of the similarity
    matrix); z_cols: (2N, D) global (gathered) embeddings; row_gid: (R,)
    global index of each local row in the [0, 2N) stacked-view order.
    Returns sum_i (logsumexp_j s_ij - s_i,pos(i)) over the local rows:
    divide by 2N after summing across ranks for the global mean loss.
    Differentiable with respect to both z_rows and z_cols (the z_cols
    gradient is what flows back through the all-gather)."""
    if z_cols.ndim != 2 or z_cols.shape[0] % 2 != 0:
        raise ValueError(f"NT-Xent needs an even global row count, got "
                         f"{tuple(z_cols.shape)}")
    return _NtxentPartial.apply(z_rows.contiguous(), z_cols.contiguous(),
                                row_gid, float(temperature))
