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
  launches ``csrc/infonce_dual_fwd.cu`` on CUDA tensors (#9: the TF32
  walk of ``csrc/ntxent_tf32.cuh``, 3xTF32 for fp32, each s tile formed
  once and folded into both directions, zb's columns cut into the splits
  ``ops.ntxent.column_splits`` plans); ``infonce_dual_fwd_plain`` is the
  same function in plain PyTorch;
* ``infonce_dual_bwd(za, zb, scale, lse_a, lse_b) -> (o_a, o_b)``, fp32
  ``G @ zb`` and ``G.T @ za`` with ``G = P_row + P_col - 2I`` (the total
  dL/ds before ``g / 2N``), launches ``csrc/infonce_dual_bwd.cu`` (#10:
  the rows and columns walks of ``csrc/infonce_cross_bwd.cuh`` with the
  ids 0 .. N - 1, both sides in one grid, each planned by
  ``dual_grads_splits``: ``general_bwd_splits`` at half the SMs);
  ``infonce_dual_bwd_plain`` is its plain version;
* ``info_nce_fused(za, zb, temperature, scale=None)`` is the
  differentiable mean loss, with gradients for za, zb and the scale.

The data-parallel form (``info_nce_dual_partial``, ``infonce_pallas.py:
419-545``): one rank's rows ``za_local`` (n, D) with global ids ``row_gid``
against the all-gathered ``zb_g`` (N, D):

* ``infonce_dual_fwd_rect(za_local, zb_g, scale) -> (lse_a, lse_b_part)``,
  the rectangular stats-only mode of the forward kernel (#9): the local
  rows' lse over all N columns and each column's lse over the local rows;
* ``infonce_bwd_rows(...) -> o_a`` (``G @ zb_g``, n rows: #5's cross-modal
  mode, ``csrc/infonce_dual_bwd.cu``) and ``infonce_bwd_cols(...) -> o_b``
  (``G.T @ za_local``, N columns: #4, ``csrc/infonce_bwd_cols.cu``), with
  ``G`` the combined gradient of the local rows at the merged global
  column lse; both run on the TF32 walk of the general backward
  (``csrc/infonce_cross_bwd.cuh`` over ``csrc/ntxent_tf32.cuh``, 3xTF32
  for fp32), the other side cut into the splits ``ops.ntxent.
  general_bwd_splits`` plans;
* ``info_nce_dual_partial(za_local, zb_g, row_gid, group, scale=)``: the
  differentiable partial loss SUM of the local pairs. Its forward merges
  the column lse across ranks (``pmax`` and ``psum`` of an (N,) vector);
  its backward launches the two gradient kernels.

On the card the backward is this two-kernel form at every N: the TPU
package picks it only when its shared-G accumulators outgrow VMEM
(``_dual_bwd_fits``) and otherwise runs #10 on the rectangle; the
function is the same.

A CUDA tensor launches the kernel or raises; a CPU tensor takes the plain
version. Each wrapper counts one launch per call in ``.launches`` (a call
is a few kernels: the operand prep, the walk, the merge or the split
sum; the square kernels cover both directions in one call). The TPU
package's two-pass backward for large N on one device (``_bwd_sym_call``
in cross-modal mode, taken when its accumulators outgrow VMEM) is the
same function as #10; the square backward serves every N there. What
depends only on the shapes (the split plan, the scratch size) is cached.

The two-pass data-parallel form (``info_nce_partial_fused``,
``infonce_pallas.py:547``): one direction's partial loss SUM of a rank's
rows against the all-gathered other modality, over the general NT-Xent
kernels in their InfoNCE mode (``ops.ntxent``: #1 and #6 with
``diag_pos`` and the device scale); ``parallel.dist_loss.
local_infonce_allgather`` runs it once for each direction.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from . import _build
from .ntxent import (_NtxentPartial, _sm_count, check_width, column_splits,
                     device_scratch, dual_grads_splits, general_bwd_splits)

__all__ = ["info_nce_dual_partial", "info_nce_fused",
           "info_nce_partial_fused", "infonce_bwd_cols",
           "infonce_bwd_cols_plain", "infonce_bwd_rows",
           "infonce_bwd_rows_plain", "infonce_dual_bwd",
           "infonce_dual_bwd_plain", "infonce_dual_fwd",
           "infonce_dual_fwd_plain", "infonce_dual_fwd_rect",
           "infonce_dual_fwd_rect_plain", "resolve_scale"]

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


def _check_rect(za: torch.Tensor, zb: torch.Tensor) -> None:
    if za.ndim != 2 or zb.ndim != 2 or za.shape[1] != zb.shape[1]:
        raise ValueError(f"embeddings must be (n, D) and (N, D): "
                         f"{tuple(za.shape)} vs {tuple(zb.shape)}")
    if za.shape[0] < 1 or zb.shape[0] < 1:
        raise ValueError("InfoNCE needs at least one row and one column")
    if za.device != zb.device:
        raise ValueError(f"za on {za.device}, zb on {zb.device}")


def _check(za: torch.Tensor, zb: torch.Tensor) -> None:
    """Paired embeddings: (N, D) each."""
    _check_rect(za, zb)
    if za.shape != zb.shape:
        raise ValueError(f"paired embeddings must match: "
                         f"{tuple(za.shape)} vs {tuple(zb.shape)}")


def _similarity(za, zb, scale) -> torch.Tensor:
    """fp32 ``(za @ zb.T) * scale`` of the (widened) inputs."""
    return (za.float() @ zb.float().T) * scale.float()


def _lse(s: torch.Tensor, dim: int) -> torch.Tensor:
    """The kernels' logsumexp along ``dim``: max-shifted ``_exp0`` sums
    and ``log(max(l, 1e-37))``."""
    m = s.amax(dim=dim, keepdim=True)
    l = _exp0(s - m).sum(dim=dim)
    return m.squeeze(dim) + torch.log(torch.clamp(l, min=1e-37))


def infonce_dual_fwd_plain(za: torch.Tensor, zb: torch.Tensor,
                           scale: torch.Tensor):
    """(loss_sum, lse_a, lse_b) with the kernel's numerics in each
    direction."""
    _check(za, zb)
    s = _similarity(za, zb, scale)
    pos = torch.diagonal(s)
    lse_a, lse_b = _lse(s, 1), _lse(s, 0)
    return (lse_a - pos).sum() + (lse_b - pos).sum(), lse_a, lse_b


def infonce_dual_fwd_rect_plain(za: torch.Tensor, zb: torch.Tensor,
                                scale: torch.Tensor):
    """(lse_a (n,), lse_b (N,)) of ``s = scale * za @ zb.T`` for za (n, D)
    and zb (N, D): the row and the column logsumexp, nothing else."""
    _check_rect(za, zb)
    s = _similarity(za, zb, scale)
    return _lse(s, 1), _lse(s, 0)


def _cross_modal_g(za, zb, row_gid, scale, lse_a, lse_b) -> torch.Tensor:
    """The combined ``G = (p_row - pos) * valid_row + (p_col - pos)`` of
    rows za with global ids ``row_gid`` against the columns zb
    (``ntxent_pallas.py:445-476`` with ``diag_pos=True``)."""
    s = _similarity(za, zb, scale)
    gid = row_gid.long()
    cols = torch.arange(zb.shape[0], device=zb.device)
    pos = (gid[:, None] == cols[None, :]).float()
    valid_row = (gid < zb.shape[0]).float()[:, None]
    return ((_exp0(s - lse_a[:, None]) - pos) * valid_row
            + (_exp0(s - lse_b[None, :]) - pos))


def infonce_bwd_rows_plain(za, zb, row_gid, scale, lse_a, lse_b):
    """fp32 ``G @ zb`` (n, D): the row side (#5's cross-modal mode)."""
    _check_rect(za, zb)
    return _cross_modal_g(za, zb, row_gid, scale, lse_a, lse_b) @ zb.float()


def infonce_bwd_cols_plain(za, zb, row_gid, scale, lse_a, lse_b):
    """fp32 ``G.T @ za`` (N, D): the column side (#4)."""
    _check_rect(za, zb)
    return (_cross_modal_g(za, zb, row_gid, scale, lse_a, lse_b).T
            @ za.float())


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
    check_width(za.shape[1], "InfoNCE")
    if not (za.is_contiguous() and zb.is_contiguous()):
        raise ValueError("za and zb must be contiguous")
    if scale.numel() != 1 or scale.device != za.device:
        raise ValueError(f"scale must be one value on {za.device}, got "
                         f"shape {tuple(scale.shape)} on {scale.device}")
    return scale.detach().to(torch.float32).reshape(1).contiguous()


_PTR, _INT = ctypes.c_void_p, ctypes.c_int


def _c_function(library: str, name: str, argtypes: list,
                restype=ctypes.c_int):
    """A C entry point of a kernel library, its argument types set."""
    fn = getattr(_build.load(library), name)
    fn.argtypes = argtypes
    fn.restype = restype
    return fn


@functools.cache
def _fwd_kernel():
    # za, zb, scale, lse_a, lse_b, loss, scratch; n, d, dtype, splits,
    # split_cols, device; stream
    return _c_function("infonce_dual_fwd", "ntx_infonce_dual_fwd",
                       [_PTR] * 7 + [_INT] * 6 + [_PTR])


@functools.cache
def _fwd_rect_kernel():
    # za, zb, scale, lse_a, lse_b, scratch; n_a, n_b, d, dtype, splits,
    # split_cols, device; stream
    return _c_function("infonce_dual_fwd", "ntx_infonce_dual_fwd_rect",
                       [_PTR] * 6 + [_INT] * 7 + [_PTR])


@functools.cache
def _bwd_kernel():
    # za, zb, scale, lse_a, lse_b, o_a, o_b, scratch; n, d, dtype, splits,
    # split_cols, device; stream
    return _c_function("infonce_dual_bwd", "ntx_infonce_dual_bwd",
                       [_PTR] * 8 + [_INT] * 6 + [_PTR])


@functools.lru_cache(maxsize=256)
def _fwd_plan(n_a: int, n_b: int, d: int, dtype: int, index: int):
    """(splits, split_cols, scratch floats) of #9: zb's columns cut as
    ``column_splits`` plans for ``n_a`` rows."""
    splits, split_cols = column_splits(n_a, n_b, _sm_count(index))
    # n_a, n_b, d, dtype, splits
    size = _c_function("infonce_dual_fwd", "ntx_infonce_dual_fwd_scratch",
                       [_INT] * 5, ctypes.c_longlong)
    return splits, split_cols, size(n_a, n_b, d, dtype, splits)


@functools.lru_cache(maxsize=256)
def _bwd_plan(n: int, d: int, dtype: int, index: int):
    """(splits, split_cols, scratch floats) of #10: both sides' plan of
    ``ops.ntxent.dual_grads_splits`` (the two sides share one grid, as #8's
    do)."""
    splits, split_cols = dual_grads_splits(n, n, d, _sm_count(index))[0]
    # n, d, dtype, splits
    size = _c_function("infonce_dual_bwd", "ntx_infonce_dual_bwd_scratch",
                       [_INT] * 4, ctypes.c_longlong)
    return splits, split_cols, size(n, d, dtype, splits)


@functools.cache
def _bwd_side_kernel(side: str):
    library = {"rows": "infonce_dual_bwd", "cols": "infonce_bwd_cols"}[side]
    # za, zb, row_gid, scale, lse_a, lse_b, out, scratch; n_rows, n_cols,
    # d, dtype, splits, split_cols, device; stream
    fn = _c_function(library, f"ntx_infonce_bwd_{side}",
                     [_PTR] * 8 + [_INT] * 7 + [_PTR])
    # n_own, n_other, d, dtype, splits
    scratch = _c_function(library, f"ntx_infonce_bwd_{side}_scratch",
                          [_INT] * 5, ctypes.c_longlong)
    return fn, scratch


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
    (n, d), dev, dtype = za.shape, za.device, _DTYPE_CODES[za.dtype]
    splits, split_cols, size = _fwd_plan(n, n, d, dtype, dev.index)
    lse_a = torch.empty(n, dtype=torch.float32, device=dev)
    lse_b = torch.empty(n, dtype=torch.float32, device=dev)
    loss = torch.empty((), dtype=torch.float32, device=dev)
    scratch = device_scratch(dev, size, za.shape[1])
    err = _fwd_kernel()(za.data_ptr(), zb.data_ptr(), scale.data_ptr(),
                        lse_a.data_ptr(), lse_b.data_ptr(), loss.data_ptr(),
                        scratch.data_ptr(), n, d, dtype, splits, split_cols,
                        dev.index, torch.cuda.current_stream(dev).cuda_stream)
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
    d, dev, dtype = za.shape[1], za.device, _DTYPE_CODES[za.dtype]
    splits, split_cols, size = _bwd_plan(n, d, dtype, dev.index)
    o_a = torch.empty(za.shape, dtype=torch.float32, device=dev)
    o_b = torch.empty(za.shape, dtype=torch.float32, device=dev)
    scratch = device_scratch(dev, size, za.shape[1])
    err = _bwd_kernel()(za.data_ptr(), zb.data_ptr(), scale.data_ptr(),
                        lse_a.data_ptr(), lse_b.data_ptr(), o_a.data_ptr(),
                        o_b.data_ptr(), scratch.data_ptr(), n, d, dtype,
                        splits, split_cols, dev.index,
                        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"infonce_dual_bwd launch failed: CUDA error "
                           f"{err}")
    infonce_dual_bwd.launches += 1
    return o_a, o_b


infonce_dual_bwd.launches = 0


def infonce_dual_fwd_rect(za: torch.Tensor, zb: torch.Tensor,
                          scale: torch.Tensor):
    """(lse_a (n,), lse_b_part (N,)) fp32 for za (n, D), zb (N, D).

    A CUDA tensor launches the rectangular stats-only mode of
    ``csrc/infonce_dual_fwd.cu`` (counted in
    ``infonce_dual_fwd_rect.launches``); a CPU tensor runs the plain
    version."""
    _check_rect(za, zb)
    if not _on_cuda("infonce_dual_fwd_rect", za):
        return infonce_dual_fwd_rect_plain(za, zb, scale)
    scale = _check_kernel_input(za, zb, scale)
    (n_a, d), n_b, dev = za.shape, zb.shape[0], za.device
    dtype = _DTYPE_CODES[za.dtype]
    splits, split_cols, size = _fwd_plan(n_a, n_b, d, dtype, dev.index)
    lse_a = torch.empty(n_a, dtype=torch.float32, device=dev)
    lse_b = torch.empty(n_b, dtype=torch.float32, device=dev)
    scratch = device_scratch(dev, size, za.shape[1])
    err = _fwd_rect_kernel()(za.data_ptr(), zb.data_ptr(), scale.data_ptr(),
                             lse_a.data_ptr(), lse_b.data_ptr(),
                             scratch.data_ptr(), n_a, n_b, d, dtype, splits,
                             split_cols, dev.index,
                             torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"infonce_dual_fwd_rect launch failed: CUDA "
                           f"error {err}")
    infonce_dual_fwd_rect.launches += 1
    return lse_a, lse_b


infonce_dual_fwd_rect.launches = 0


def _bwd_side(side: str, wrapper, za, zb, row_gid, scale, lse_a, lse_b):
    """Validate and launch the rows (``G @ zb``) or columns (``G.T @ za``)
    kernel over the splits of the other side that ``general_bwd_splits``
    plans; returns its fp32 output."""
    n_a, n_b = za.shape[0], zb.shape[0]
    for name, t, n in (("row_gid", row_gid, n_a), ("lse_a", lse_a, n_a),
                       ("lse_b", lse_b, n_b)):
        if t.shape != (n,) or t.device != za.device:
            raise ValueError(f"{name} must be ({n},) on {za.device}, got "
                             f"{tuple(t.shape)} on {t.device}")
    scale = _check_kernel_input(za, zb, scale)
    row_gid = row_gid.to(torch.int32).contiguous()
    lse_a = lse_a.float().contiguous()
    lse_b = lse_b.float().contiguous()
    d, dtype = za.shape[1], _DTYPE_CODES[za.dtype]
    own, other = (n_a, n_b) if side == "rows" else (n_b, n_a)
    splits, split_cols = general_bwd_splits(own, other, d,
                                            _sm_count(za.device.index))
    kernel, scratch_size = _bwd_side_kernel(side)
    scratch = device_scratch(za.device,
                             scratch_size(own, other, d, dtype, splits), d)
    out = torch.empty((own, d), dtype=torch.float32, device=za.device)
    err = kernel(
        za.data_ptr(), zb.data_ptr(), row_gid.data_ptr(), scale.data_ptr(),
        lse_a.data_ptr(), lse_b.data_ptr(), out.data_ptr(),
        scratch.data_ptr(), n_a, n_b, d, dtype, splits, split_cols,
        za.device.index, torch.cuda.current_stream(za.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{wrapper.__name__} launch failed: CUDA error "
                           f"{err}")
    wrapper.launches += 1
    return out


def infonce_bwd_rows(za: torch.Tensor, zb: torch.Tensor,
                     row_gid: torch.Tensor, scale: torch.Tensor,
                     lse_a: torch.Tensor, lse_b: torch.Tensor):
    """o_a (n, D) fp32 = ``G @ zb`` for rows za (n, D) with global ids
    ``row_gid`` against zb (N, D), the rows' lse_a (n,) and the global
    column lse_b (N,).

    A CUDA tensor launches ``ntx_infonce_bwd_rows`` of
    ``csrc/infonce_dual_bwd.cu`` (counted in ``infonce_bwd_rows.launches``);
    a CPU tensor runs the plain version."""
    _check_rect(za, zb)
    if not _on_cuda("infonce_bwd_rows", za):
        return infonce_bwd_rows_plain(za, zb, row_gid, scale, lse_a, lse_b)
    return _bwd_side("rows", infonce_bwd_rows, za, zb, row_gid, scale,
                     lse_a, lse_b)


infonce_bwd_rows.launches = 0


def infonce_bwd_cols(za: torch.Tensor, zb: torch.Tensor,
                     row_gid: torch.Tensor, scale: torch.Tensor,
                     lse_a: torch.Tensor, lse_b: torch.Tensor):
    """o_b (N, D) fp32 = ``G.T @ za``: the partial gradient of the
    gathered zb from these rows (arguments as ``infonce_bwd_rows``).

    A CUDA tensor launches ``csrc/infonce_bwd_cols.cu`` (counted in
    ``infonce_bwd_cols.launches``); a CPU tensor runs the plain version."""
    _check_rect(za, zb)
    if not _on_cuda("infonce_bwd_cols", za):
        return infonce_bwd_cols_plain(za, zb, row_gid, scale, lse_a, lse_b)
    return _bwd_side("cols", infonce_bwd_cols, za, zb, row_gid, scale,
                     lse_a, lse_b)


infonce_bwd_cols.launches = 0


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


class _InfoNceDualPartial(torch.autograd.Function):
    """The partial loss sum of one rank's pairs (``infonce_pallas.py:
    443-512``). Forward: the rectangular stats-only kernel, the column lse
    merged across ranks (``m = pmax(lse_b_part)``, ``lse_b = m +
    log(psum(exp(lse_b_part - m)))``, recorded once by the comms
    accounting), the positives from a row-wise dot with ``zb_g[row_gid]``.
    Backward: the rows and columns kernels at the merged lse;
    ``grad_za = o_a * g * scale``, ``grad_zb_g = o_b * g * scale`` (the
    caller's all-gather sums it over ranks), ``grad_scale = g * sum(o_a *
    za_local)``: this rank's share, as the JAX rule returns it."""

    @staticmethod
    def forward(ctx, za, zb_g, row_gid, scale, group):
        # imported here: the parallel package imports this module
        from ..parallel.mesh import pmax, psum

        lse_a, lse_b_part = infonce_dual_fwd_rect(za, zb_g, scale)
        m = pmax(lse_b_part, group)
        lse_b = m + torch.log(psum(torch.exp(lse_b_part - m), group))
        zb_pos = zb_g.index_select(0, row_gid.long())
        pos = scale.float() * torch.sum(za.float() * zb_pos.float(), dim=1)
        loss_part = torch.sum(lse_a - pos) + torch.sum(
            lse_b.index_select(0, row_gid.long()) - pos)
        ctx.save_for_backward(za, zb_g, row_gid, scale, lse_a, lse_b)
        return loss_part

    @staticmethod
    def backward(ctx, g):
        za, zb_g, row_gid, scale, lse_a, lse_b = ctx.saved_tensors
        o_a = infonce_bwd_rows(za, zb_g, row_gid, scale, lse_a, lse_b)
        o_b = infonce_bwd_cols(za, zb_g, row_gid, scale, lse_a, lse_b)
        factor = g.float() * scale.float()
        grad_za = (o_a * factor).to(za.dtype)
        grad_zb = (o_b * factor).to(zb_g.dtype)
        grad_scale = (g.float() * torch.sum(o_a * za.float())).reshape(
            scale.shape).to(scale.dtype)
        return grad_za, grad_zb, None, grad_scale, None


def info_nce_dual_partial(za_local: torch.Tensor, zb_g: torch.Tensor,
                          row_gid: torch.Tensor, group=None, *,
                          scale: torch.Tensor | float = 1.0) -> torch.Tensor:
    """Both-direction partial InfoNCE **sum** of one rank's pairs from one
    walk of its rows x global columns block (``infonce_pallas.py:518``).

    ``za_local`` (n, D): this rank's rows; ``zb_g`` (N, D): the other
    modality gathered over the ranks of ``group`` (``None``: the default
    group, which must be joined); ``row_gid`` (n,): the local rows' global
    ids. Returns ``sum_i (lse_row_i - s_ii) + sum_i (lse_col_gid(i) -
    s_ii)`` over the local rows; psum it over ranks and divide by 2N for
    the mean loss (``parallel.dist_loss.local_infonce_dual``). Gradients
    flow to za_local, zb_g and a tensor ``scale``."""
    _check_rect(za_local, zb_g)
    if row_gid.shape != (za_local.shape[0],):
        raise ValueError(f"row_gid must be ({za_local.shape[0]},), got "
                         f"{tuple(row_gid.shape)}")
    scale = resolve_scale(1.0, scale, za_local.device)
    return _InfoNceDualPartial.apply(za_local.contiguous(), zb_g.contiguous(),
                                     row_gid.to(za_local.device), scale,
                                     group)


def info_nce_partial_fused(z_rows: torch.Tensor, z_cols: torch.Tensor,
                           row_gid: torch.Tensor, *,
                           scale: torch.Tensor | float = 1.0
                           ) -> torch.Tensor:
    """One-direction partial InfoNCE **sum** over rows of the global
    matrix (``infonce_pallas.py:547``).

    Returns ``sum_i [logsumexp_j s_ij - s_i,gid(i)]`` where ``s = scale *
    z_rows @ z_cols.T`` and the positive of local row i is global column
    ``row_gid[i]``, the diagonal of the global matrix; a row whose id is
    >= C (the padding sentinel) adds nothing. The general forward (#1) and
    backward (#6) in their InfoNCE mode at temperature 1, the scale read on
    the device. Differentiable with respect to both operands and a tensor
    ``scale``."""
    if z_rows.ndim != 2 or row_gid.shape != (z_rows.shape[0],):
        raise ValueError(f"row_gid must be ({z_rows.shape[0]},), got "
                         f"{tuple(row_gid.shape)}")
    scale = resolve_scale(1.0, scale, z_rows.device)
    return _NtxentPartial.apply(z_rows.contiguous(), z_cols.contiguous(),
                                row_gid.to(z_rows.device), scale, 1.0, True)
