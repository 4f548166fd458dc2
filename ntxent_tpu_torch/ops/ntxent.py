"""Fused NT-Xent: the hand-written Hopper kernels and their plain versions.

Counterpart of ``ntxent_tpu/ops/ntxent_pallas.py`` in two modes.

Symmetric (``ntxent_loss_fused``): canonical NT-Xent over stacked views
z (2N, D), positive of row i at (i + N) mod 2N, the self-similarity
diagonal masked to -1e30, O(N) residuals (only the row logsumexp survives
the forward).

* ``ntxent_fwd(z, temperature) -> (loss_sum, lse)`` launches
  ``csrc/ntxent_fwd.cu`` on a CUDA tensor; ``ntxent_fwd_plain`` is the
  same function in plain PyTorch;
* ``ntxent_bwd_sym(z, lse, temperature) -> grad`` (fp32, before the
  ``g / T`` scale) launches ``csrc/ntxent_bwd_sym.cu``;
  ``ntxent_bwd_sym_plain`` is its plain version;
* these two and the general forward run on TF32 tensor cores (3xTF32 for
  fp32 z, ``csrc/ntxent_tf32.cuh``), each CTA over one split of the
  columns that ``column_splits`` plans; ``tf32_split`` and
  ``ntxent_fwd_split_plain`` mirror the operand split and the split-and-
  merge order in plain PyTorch for the tests and ``chip_smoke.py``'s
  TF32 control (no wrapper calls them);
* ``ntxent_fwd_tri`` and ``ntxent_bwd_tri``: the same two functions over
  the upper-triangle tiles only (``csrc/ntxent_tri_fwd.cu``, #9's dual
  walk; ``csrc/ntxent_tri_bwd.cu``, #5's walk with the transposed
  product; both on TF32 tensor cores), each CTA walking one stretch of
  the upper tiles that ``tri_runs`` plans; ``ntxent_fwd_tri_plain`` and
  ``ntxent_bwd_tri_plain`` are the same functions in plain PyTorch, by
  64-column blocks;
* ``ntxent_loss_fused(z, temperature, triangular=False)`` is the
  differentiable mean loss: the rectangular kernels, or with
  ``triangular=True`` the triangular ones;
* ``ntxent_loss_and_lse(z, temperature)`` is the mean loss and the row
  logsumexp of the rectangular forward, with no autograd.

General (``ntxent_partial_fused``, ``block_lse``, ``block_grads``): rows
z_rows (R, D) with global ids ``row_gid``, columns z_cols (C, D) with
global ids ``col_gid`` (default: the column index); a column is masked
where its id is >= ``cols_actual`` or equals the row's id, the positive
of a row is the column whose id is ``_pos_gid`` of the row's id, and a
row whose id is >= ``cols_actual`` (the padding sentinel 2N) adds no loss.
With ``diag_pos=True`` (the InfoNCE mode of ``info_nce_partial_fused``,
``ops.infonce``) the row's own id is not masked and is its positive.
``scale`` (a 0-d or (1,) fp32 tensor on the tensors' device, CLIP's
learnable ``exp(logit_scale)``; ``None``: 1) multiplies 1/T; the kernels
read it on the device.

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
  strip loss's building block (``ntxent_pallas.py:871``); its autograd
  function ``_NtxentPartial`` also carries the InfoNCE mode and the scale
  and its gradient (``_ntxent_partial``, ``ntxent_pallas.py:818-868``).

Shard-pair (``block_lse_dual``, ``block_grads_dual``): one tile of the
symmetric global matrix between rows z_rows (R, D) and columns z_cols
(C, D), both with global ids; a padding vector carries the sentinel id
``total``. The row side masks a column whose id is >= total or equals
the row's, the column side a row whose id is >= total or equals the
column's; there is no positive term. They are the building blocks of the
pair-parallel loss (``parallel.pair``).

* ``block_lse_dual(...) -> (lse_rows, lse_cols)`` launches
  ``csrc/ntxent_dual_stats.cu`` (#9's dual walk on TF32 tensor cores:
  each s tile formed once and folded into both directions, z_cols's
  columns cut as ``column_splits`` plans); ``block_lse_dual_plain`` is its
  plain version;
* ``block_grads_dual(..., lse_rows, lse_cols, ...) -> (G @ z_cols,
  G^T @ z_rows)`` (fp32, before the caller's cotangent / T) launches
  ``csrc/ntxent_dual_grads.cu`` (#10's grid: both sides' TF32 backward
  walks in one launch, each side's other side cut as
  ``dual_grads_splits`` plans); ``block_grads_dual_plain`` is its plain
  version. The split plans and scratch sizes of both are cached per
  shape.

A CUDA tensor launches the kernel or raises; a CPU tensor takes the plain
version. Each wrapper counts its launches in ``.launches``. The tile
shape belongs to the CUDA kernels; the column split of #1, #5 and #6 is
planned here (``column_splits``) and handed to them.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch

from . import _build

__all__ = ["block_grads", "block_grads_dual", "block_grads_dual_plain",
           "block_lse", "block_lse_dual", "block_lse_dual_plain",
           "column_splits", "dual_grads_splits", "general_bwd_splits",
           "ntxent_bwd_general_cols",
           "ntxent_bwd_general_cols_plain", "ntxent_bwd_general_rows",
           "ntxent_bwd_general_rows_plain", "ntxent_bwd_sym",
           "ntxent_bwd_sym_plain", "ntxent_bwd_tri", "ntxent_bwd_tri_plain",
           "ntxent_fwd", "ntxent_fwd_general", "ntxent_fwd_general_plain",
           "ntxent_fwd_plain", "ntxent_fwd_split_plain", "ntxent_fwd_tri",
           "ntxent_fwd_tri_plain", "ntxent_loss_and_lse", "ntxent_loss_fused",
           "ntxent_partial_fused", "tf32_split", "tri_runs"]

_NEG_INF = -1e30
# The widest D the kernels take (kMaxWidth of csrc/ntxent_tf32.cuh: a
# backward's grid holds 65535 chunks of 128 columns of D); short of it,
# only device memory bounds D (``device_scratch``).
MAX_WIDTH = 65535 * 128
# rows of one tile of the TF32 walks (csrc/ntxent_tf32.cuh); columns of
# their column tiles
TILE = 64
SPLIT_UNIT = 32  # columns: the grain of column_splits
SM_COUNT = 132  # streaming multiprocessors of an H100 SXM
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def _inv_t(temperature: float) -> float:
    """1/T rounded to fp32, as the TPU kernel multiplies by it."""
    return float(np.float32(1.0 / float(temperature)))


def _exp0(x: torch.Tensor) -> torch.Tensor:
    """``exp(min(x, 0))``: every argument is mathematically <= 0."""
    return torch.exp(torch.clamp(x, max=0.0))


def _log_l(l: torch.Tensor) -> torch.Tensor:
    """``log(max(l, 1e-37))``: a finite lse for a fully masked row."""
    return torch.log(torch.clamp(l, min=1e-37))


def _lse(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Max-shifted logsumexp of masked logits along ``dim``."""
    m = x.amax(dim=dim)
    return m + _log_l(_exp0(x - m.unsqueeze(dim)).sum(dim=dim))


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
    lse = _lse(s, 1)
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


def column_splits(rows: int, cols: int, sms: int = SM_COUNT):
    """(splits, split_cols) of #1 and #5's grid: the columns cut into
    runs of ``split_cols`` (a multiple of 32; the last run shorter), so
    that ceil(rows / 64) row tiles x ``splits`` CTAs come near one wave of
    ``sms`` SMs. Every run is non-empty and the runs cover the columns once;
    a grid of one wave or more (2N = 8192) keeps one split."""
    row_tiles = -(-rows // TILE)
    units = -(-cols // SPLIT_UNIT)
    want = max(1, min(units, sms // row_tiles))
    per = -(-units // want)
    return -(-units // per), per * SPLIT_UNIT


class TriRuns(NamedTuple):
    """The triangular kernels' plan: ``pieces`` (row tile i, first column
    tile j0 >= i, tiles, slot), CTA by CTA; CTA b walks pieces
    ``cta_start[b]`` .. ``cta_start[b + 1] - 1``; ``runs_of[i]``: the
    pieces (runs) of row tile i, whose slots are 0, 1, .. in column
    order."""
    pieces: tuple
    cta_start: tuple
    runs_of: tuple

    @property
    def slots(self) -> int:
        return max(self.runs_of)

    def cta_tiles(self) -> list:
        """The tiles each CTA walks."""
        return [sum(p[2] for p in self.pieces[a:b])
                for a, b in zip(self.cta_start, self.cta_start[1:])]

    def table(self) -> list:
        """The int32 table the kernels read (``TriPlan`` of
        ``csrc/ntxent_tf32.cuh``)."""
        return [x for piece in self.pieces for x in piece] \
            + list(self.cta_start) + list(self.runs_of)


def tri_runs(rows: int, sms: int = SM_COUNT) -> TriRuns:
    """The upper tiles (i, j), j >= i, of ceil(rows / 64) row tiles cut
    over about one wave of ``sms`` CTAs: the tiles in row order 0, nb - 1,
    1, nb - 2, .. (a long row tile, then a short one), each row tile's in
    column order, and CTA b walks the b-th of min(sms, tiles) stretches of
    equal length (floor or ceil of tiles / CTAs). A stretch is one piece
    per row tile it crosses. So the busiest CTA walks at most one tile
    more than the mean, and pairing long with short row tiles keeps a
    stretch to a few pieces (each reloads its row tile)."""
    nb = -(-rows // TILE)
    tiles = nb * (nb + 1) // 2
    ctas = max(1, min(sms, tiles))
    order = [i for pair in zip(range(nb), range(nb - 1, -1, -1))
             for i in pair][:nb]
    bounds = [b * tiles // ctas for b in range(ctas + 1)]
    pieces, cta_start, runs_of = [], [0], [0] * nb
    start = b = 0
    for i in order:  # row tile i holds tiles start .. end - 1 of the walk
        end = start + nb - i
        while b < ctas and bounds[b] < end:
            lo, hi = max(bounds[b], start), min(bounds[b + 1], end)
            if lo < hi:
                pieces.append((i, i + lo - start, hi - lo, runs_of[i]))
                runs_of[i] += 1
            if bounds[b + 1] > end:
                break  # CTA b goes on into the next row tile
            b += 1
            cta_start.append(len(pieces))
        start = end
    return TriRuns(tuple(pieces), tuple(cta_start), tuple(runs_of))


def _d_chunks(d: int) -> int:
    """Chunks of D the backward walks (#5, #6) cut the gradient into, one
    per CTA in the grid's third dimension (``d_chunk`` and ``padded_dt``
    of ``csrc/ntxent_tf32.cuh``): each chunk forms s again."""
    dp = -(-d // SPLIT_UNIT) * SPLIT_UNIT
    chunk = 32 if dp <= 32 else 64 if dp <= 64 else 128
    return -(-dp // chunk)


def general_bwd_splits(own: int, other: int, d: int,
                       sms: int = SM_COUNT):
    """(splits, split_cols) of a #6 kernel: the other side's rows cut as
    ``column_splits`` cuts columns, so that the row tiles of the side that
    owns the outputs, times the splits, times the chunks of D come near
    one wave of ``sms`` SMs."""
    return column_splits(own, other, max(1, sms // _d_chunks(d)))


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def tf32_split(x: torch.Tensor):
    """(hi, lo) of fp32 ``x``: hi rounded to TF32 (10 explicit mantissa
    bits, to nearest, ties away from zero, as ``cvt.rna.tf32.f32``), lo =
    x - hi, so hi + lo == x bit for bit. The plain mirror of the kernels'
    operand split; ``hi`` alone is one TF32 pass."""
    bits = x.float().contiguous().view(torch.int32)
    hi = ((bits + 0x1000) & ~0x1FFF).view(torch.float32)
    return hi, x.float() - hi


def ntxent_fwd_split_plain(z_rows, z_cols, row_gid, temperature,
                           splits, split_cols, col_gid=None,
                           cols_actual=None, n_half=None):
    """(loss_sum, lse (R,)) of the general mode in the kernels' order:
    one (m, l, pos) partial per row and run of ``split_cols`` columns,
    folded in run order (``m = max``, ``l = l exp0(m - m') + l_c exp0(m_c
    - m')``), ``lse = m + log(max(l, 1e-37))``. The same function as
    ``ntxent_fwd_general_plain``; the symmetric mode is this one with the
    indices for ids."""
    cols_actual, n_half = _general_args(z_rows, z_cols, row_gid, col_gid,
                                        cols_actual, n_half)
    masked, raw, onehot, valid = _general_terms(
        z_rows, z_cols, row_gid, temperature, col_gid, cols_actual, n_half)
    m = torch.full_like(masked[:, 0], _NEG_INF)
    l = torch.zeros_like(m)
    p = torch.zeros_like(m)
    for start in range(0, splits * split_cols, split_cols):
        x = masked[:, start:start + split_cols]
        m_c = x.amax(dim=1)
        l_c = _exp0(x - m_c[:, None]).sum(dim=1)
        m_new = torch.maximum(m, m_c)
        l = l * _exp0(m - m_new) + l_c * _exp0(m_c - m_new)
        m = m_new
        p = p + (raw * onehot)[:, start:start + split_cols].sum(dim=1)
    lse = m + _log_l(l)
    return torch.where(valid, lse - p, torch.zeros_like(lse)).sum(), lse


def check_width(d: int, kernels: str) -> None:
    """Raise unless the kernels take embeddings of width ``d``."""
    if not 1 <= d <= MAX_WIDTH:
        raise ValueError(f"the {kernels} kernels take 1 <= D <= {MAX_WIDTH}, "
                         f"got D = {d}")


def device_scratch(device: torch.device, floats: int,
                   d: int) -> torch.Tensor:
    """One launch's fp32 scratch: the operand copies, which grow with D.
    A width whose copies the device cannot hold raises, naming D."""
    try:
        return torch.empty(floats, dtype=torch.float32, device=device)
    except torch.OutOfMemoryError as err:
        raise torch.OutOfMemoryError(
            f"D = {d}: the kernels' operand copies take {4 * floats} bytes, "
            f"more than {device} can hold") from err


def _check_kernel_input(z: torch.Tensor) -> None:
    if z.dtype not in _DTYPE_CODES:
        raise TypeError(f"the NT-Xent kernels take float32 or bfloat16 z, "
                        f"got {z.dtype}")
    check_width(z.shape[1], "NT-Xent")
    if not z.is_contiguous():
        raise ValueError("z must be contiguous")


@functools.cache
def _fwd_kernel():
    fn = _build.load("ntxent_fwd").ntx_ntxent_fwd
    # z, lse, loss, scratch; rows, d, dtype; inv_t; splits, split_cols,
    # device; stream
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 3
                   + [ctypes.c_float] + [ctypes.c_int] * 3
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _bwd_kernel():
    fn = _build.load("ntxent_bwd_sym").ntx_ntxent_bwd_sym
    # z, lse, grad, scratch; rows, d, dtype; inv_t; splits, split_cols,
    # device; stream
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 3
                   + [ctypes.c_float] + [ctypes.c_int] * 3
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _scratch_size(name: str):
    """The library's report of the floats of scratch one call takes (the
    layout of the operand copies and partials lives in the library)."""
    fn = getattr(_build.load(name), f"ntx_{name}_scratch")
    args = {"ntxent_bwd_sym": 4, "ntxent_dual_grads": 6,
            "ntxent_tri_fwd": 4, "ntxent_tri_bwd": 4}.get(name, 5)
    fn.argtypes = [ctypes.c_int] * args
    fn.restype = ctypes.c_longlong
    return fn


def _scratch(z: torch.Tensor, name: str, *args: int) -> torch.Tensor:
    return device_scratch(z.device, _scratch_size(name)(*args), z.shape[1])


def _splits(z: torch.Tensor, rows: int, cols: int):
    return column_splits(rows, cols, _sm_count(z.device.index))


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
    dtype = _DTYPE_CODES[z.dtype]
    splits, split_cols = _splits(z, rows, rows)
    scratch = _scratch(z, "ntxent_fwd", rows, 0, d, dtype, splits)
    lse = torch.empty(rows, dtype=torch.float32, device=z.device)
    loss = torch.empty((), dtype=torch.float32, device=z.device)
    err = _fwd_kernel()(z.data_ptr(), lse.data_ptr(), loss.data_ptr(),
                        scratch.data_ptr(), rows, d, dtype,
                        _inv_t(temperature), splits, split_cols,
                        z.device.index,
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
    ``ntxent_bwd_sym.launches``), whose operand copies take about 4 2N D
    fp32 of scratch (fp32 z; half for bf16) and, with more than one column
    split, a partial gradient per split; a CPU tensor runs the plain
    version."""
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
    rows, d = z.shape
    lse = lse.float().contiguous()
    dtype = _DTYPE_CODES[z.dtype]
    splits, split_cols = _splits(z, rows, rows)
    scratch = _scratch(z, "ntxent_bwd_sym", rows, d, dtype, splits)
    grad = torch.empty(z.shape, dtype=torch.float32, device=z.device)
    err = _bwd_kernel()(z.data_ptr(), lse.data_ptr(), grad.data_ptr(),
                        scratch.data_ptr(), rows, d, dtype,
                        _inv_t(temperature), splits, split_cols,
                        z.device.index,
                        torch.cuda.current_stream(z.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"ntxent_bwd_sym launch failed: CUDA error {err}")
    ntxent_bwd_sym.launches += 1
    return grad


ntxent_bwd_sym.launches = 0


# ---------------------------------------------------------------------------
# Triangular mode: the upper-triangle tiles only
# ---------------------------------------------------------------------------


def _tile_blocks(x: torch.Tensor) -> torch.Tensor:
    """(2N, 2N) -> (2N, nb, TILE): the columns in 64-wide blocks, the last
    block padded with -1e30 (columns that do not exist)."""
    x = torch.nn.functional.pad(x, (0, -x.shape[1] % TILE), value=_NEG_INF)
    return x.view(x.shape[0], -1, TILE)


def ntxent_fwd_tri_plain(z: torch.Tensor, temperature: float):
    """(loss_sum, lse) by 64-column blocks: one (m, l) partial per row and
    block, merged over the blocks (``m = max``, ``l = sum l_c exp0(m_c -
    m)``), ``lse = m + log(max(l, 1e-37))``. The same function as
    ``ntxent_fwd_plain`` and as ``csrc/ntxent_tri_fwd.cu``, which folds
    per-run and per-tile partials in another order (its order is
    emulated in ``tests/test_torch_tri_sm90.py``)."""
    _check(z)
    s, positives, _ = _masked_similarity(z, temperature)
    blocks = _tile_blocks(s)
    m_c = blocks.amax(dim=2)                                 # (2N, nb)
    l_c = _exp0(blocks - m_c[..., None]).sum(dim=2)
    m = m_c.amax(dim=1)
    lse = m + _log_l((l_c * _exp0(m_c - m[:, None])).sum(dim=1))
    return (lse - positives).sum(), lse


def ntxent_bwd_tri_plain(z: torch.Tensor, lse: torch.Tensor,
                         temperature: float) -> torch.Tensor:
    """fp32 ``G @ z`` by 64-column blocks: one partial ``G[:, block] @
    z[block]`` per block, summed over the blocks in order. The same
    function as ``ntxent_bwd_sym_plain`` and as ``csrc/ntxent_tri_bwd.cu``,
    which sums per-run and transposed per-tile partials instead (its order
    is emulated in ``tests/test_torch_tri_sm90.py``)."""
    _check(z)
    if lse.shape != (z.shape[0],):
        raise ValueError(f"lse must be ({z.shape[0]},), got "
                         f"{tuple(lse.shape)}")
    s, _, onehot = _masked_similarity(z, temperature)
    g = (_exp0(s - lse[:, None]) - onehot) + (_exp0(s - lse[None, :])
                                              - onehot)
    zf = z.float()
    pad = -zf.shape[0] % TILE
    z_blocks = torch.nn.functional.pad(zf, (0, 0, 0, pad)).view(
        -1, TILE, zf.shape[1])                               # (nb, TILE, D)
    g_blocks = torch.nn.functional.pad(g, (0, pad)).view(
        g.shape[0], -1, TILE)                                # (2N, nb, TILE)
    parts = torch.einsum("rct,ctd->crd", g_blocks, z_blocks)
    out = parts[0]
    for part in parts[1:]:
        out = out + part
    return out


# z, then the plan and the outputs (fwd: plan, lse, loss; bwd: lse, plan,
# grad), scratch; rows, d, dtype; inv_t; pieces, ctas, slots, device;
# stream
_TRI_ARGTYPES = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 3
                 + [ctypes.c_float] + [ctypes.c_int] * 4 + [ctypes.c_void_p])


@functools.cache
def _tri_kernel(side: str):
    fn = getattr(_build.load(f"ntxent_tri_{side}"), f"ntx_ntxent_tri_{side}")
    fn.argtypes = _TRI_ARGTYPES
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=64)
def _tri_plan(side: str, rows: int, d: int, dtype: int, index: int):
    """(plan table on the card, pieces, CTAs, slots, scratch floats) of #2
    (``side="fwd"``) or #3 (``"bwd"``): ``tri_runs`` at the card's SMs,
    divided among #3's chunks of D (its grid's second dimension)."""
    sms = _sm_count(index)
    if side == "bwd":
        sms = max(1, sms // _d_chunks(d))
    runs = tri_runs(rows, sms)
    table = torch.tensor(runs.table(), dtype=torch.int32,
                         device=torch.device("cuda", index))
    size = _scratch_size(f"ntxent_tri_{side}")(rows, d, dtype, runs.slots)
    return table, len(runs.pieces), len(runs.cta_start) - 1, runs.slots, size


def ntxent_fwd_tri(z: torch.Tensor, temperature: float):
    """(loss_sum, lse) of the symmetric NT-Xent over the upper-triangle
    tiles only.

    A CUDA tensor launches ``csrc/ntxent_tri_fwd.cu`` (counted in
    ``ntxent_fwd_tri.launches``); a CPU tensor runs
    ``ntxent_fwd_tri_plain``."""
    _check(z)
    if z.device.type == "cpu":
        return ntxent_fwd_tri_plain(z, temperature)
    if z.device.type != "cuda":
        raise ValueError(f"ntxent_fwd_tri runs on cuda or cpu, got "
                         f"{z.device}")
    _check_kernel_input(z)
    (rows, d), dev, dtype = z.shape, z.device, _DTYPE_CODES[z.dtype]
    table, *plan, size = _tri_plan("fwd", rows, d, dtype, dev.index)
    lse = torch.empty(rows, dtype=torch.float32, device=dev)
    loss = torch.empty((), dtype=torch.float32, device=dev)
    scratch = device_scratch(dev, size, d)
    err = _tri_kernel("fwd")(z.data_ptr(), table.data_ptr(), lse.data_ptr(),
                             loss.data_ptr(), scratch.data_ptr(), rows, d,
                             dtype, _inv_t(temperature), *plan, dev.index,
                             torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"ntxent_fwd_tri launch failed: CUDA error {err}")
    ntxent_fwd_tri.launches += 1
    return loss, lse


ntxent_fwd_tri.launches = 0


def ntxent_bwd_tri(z: torch.Tensor, lse: torch.Tensor,
                   temperature: float) -> torch.Tensor:
    """(2N, D) fp32 ``G @ z`` over the upper-triangle tiles only (the
    gradient of loss_sum before ``1 / T``).

    A CUDA tensor launches ``csrc/ntxent_tri_bwd.cu`` (counted in
    ``ntxent_bwd_tri.launches``), whose scratch holds z's operand copies
    (about 4 2N D fp32), a partial per run of a row tile (a few 2N D
    fp32) and one per tile above the diagonal (nb (nb - 1) / 2 64 D fp32,
    nb = ceil(2N / 64): 266 MB at 2N = 8192, D = 128); a CPU tensor runs
    the plain version."""
    _check(z)
    if lse.shape != (z.shape[0],) or lse.device != z.device:
        raise ValueError(f"lse must be ({z.shape[0]},) on {z.device}, got "
                         f"{tuple(lse.shape)} on {lse.device}")
    if z.device.type == "cpu":
        return ntxent_bwd_tri_plain(z, lse, temperature)
    if z.device.type != "cuda":
        raise ValueError(f"ntxent_bwd_tri runs on cuda or cpu, got "
                         f"{z.device}")
    _check_kernel_input(z)
    (rows, d), dev, dtype = z.shape, z.device, _DTYPE_CODES[z.dtype]
    lse = lse.float().contiguous()
    table, *plan, size = _tri_plan("bwd", rows, d, dtype, dev.index)
    grad = torch.empty(z.shape, dtype=torch.float32, device=dev)
    scratch = device_scratch(dev, size, d)
    err = _tri_kernel("bwd")(z.data_ptr(), lse.data_ptr(), table.data_ptr(),
                             grad.data_ptr(), scratch.data_ptr(), rows, d,
                             dtype, _inv_t(temperature), *plan, dev.index,
                             torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"ntxent_bwd_tri launch failed: CUDA error {err}")
    ntxent_bwd_tri.launches += 1
    return grad


ntxent_bwd_tri.launches = 0


class _NtxentSym(torch.autograd.Function):
    """loss_sum with the kernels' exact backward (ntxent_pallas.py:724-774):
    the forward saves (z, lse); the backward returns
    ``grad * (g / T)`` cast to z's dtype. ``triangular`` takes the
    upper-triangle kernels (#2, #3) in place of the rectangular ones (#1,
    #5)."""

    @staticmethod
    def forward(ctx, z, temperature, triangular):
        fwd = ntxent_fwd_tri if triangular else ntxent_fwd
        loss_sum, lse = fwd(z, temperature)
        ctx.save_for_backward(z, lse)
        ctx.temperature, ctx.triangular = temperature, triangular
        return loss_sum

    @staticmethod
    def backward(ctx, g):
        z, lse = ctx.saved_tensors
        bwd = ntxent_bwd_tri if ctx.triangular else ntxent_bwd_sym
        grad = bwd(z, lse, ctx.temperature)
        return (grad * (g.float() / ctx.temperature)).to(z.dtype), None, None


def ntxent_loss_fused(z: torch.Tensor, temperature: float = 0.07,
                      triangular: bool = False) -> torch.Tensor:
    """Fused canonical NT-Xent mean loss over stacked views z (2N, D).

    Same semantics as ``ops.oracle.ntxent_loss``, O(N) memory, exact
    gradient through the backward kernel. ``temperature`` is a Python
    float. ``triangular=True`` forms each similarity tile once, over the
    upper triangle, and folds it into both of its row blocks
    (``ntxent_fwd_tri``, ``ntxent_bwd_tri``: half the forward's products,
    three quarters of the backward's); the result differs from the
    rectangular kernels' by summation order only."""
    return _NtxentSym.apply(z.contiguous(), float(temperature),
                            bool(triangular)) / z.shape[0]


def ntxent_loss_and_lse(z: torch.Tensor, temperature: float = 0.07):
    """(mean loss, lse (2N,)) of the rectangular forward (``ntxent_fwd``)
    with no autograd (``ntxent_pallas.py:904``): from lse, row i of the
    masked softmax is ``exp(s_i - lse_i)``, made on demand instead of
    stored."""
    with torch.no_grad():
        loss_sum, lse = ntxent_fwd(z.contiguous(), float(temperature))
    return loss_sum / z.shape[0], lse


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


def _check_scale(scale, device):
    """The logit scale as the kernels read it: ``None``, or a 0-d or (1,)
    fp32 tensor on ``device``."""
    if scale is None:
        return None
    if not isinstance(scale, torch.Tensor) or scale.numel() != 1 \
            or scale.dtype != torch.float32 or scale.device != device:
        raise ValueError(f"scale must be a 0-d or (1,) float32 tensor on "
                         f"{device}, got {scale!r}")
    return scale


def _general_terms(z_rows, z_cols, row_gid, temperature, col_gid,
                   cols_actual, n_half, diag_pos=False, scale=None):
    """(masked scaled similarity, raw scaled similarity, positive one-hot
    E, valid-row mask) of ``_masked_sim_tile`` / ``_pos_gid``; with a
    scale the logits are ``s * (1/T * scale)``, the factor in fp32 as the
    kernels form it."""
    inv_t = _inv_t(temperature)
    if scale is not None:
        inv_t = torch.tensor(inv_t, dtype=torch.float32,
                             device=z_rows.device) * scale.reshape(())
    s = (z_rows.float() @ z_cols.float().T) * inv_t
    rid = row_gid.long()[:, None]
    cid = (torch.arange(z_cols.shape[0], device=z_rows.device)
           if col_gid is None else col_gid.long())[None, :]
    mask = cid >= cols_actual
    if not diag_pos:
        mask = mask | (cid == rid)
    masked = s.masked_fill(mask, _NEG_INF)
    pos = rid if diag_pos else torch.where(rid < n_half, rid + n_half,
                                           rid - n_half)
    return masked, s, (cid == pos).float(), rid[:, 0] < cols_actual


def ntxent_fwd_general_plain(z_rows, z_cols, row_gid, temperature,
                             col_gid=None, cols_actual=None, n_half=None,
                             diag_pos=False, scale=None):
    """(loss_sum, lse (R,)) of the general mode with the kernel's numerics:
    fp32 similarity of the (widened) inputs, max-shifted ``_exp0`` sum,
    ``log(max(l, 1e-37))``; rows with ids >= cols_actual add no loss."""
    cols_actual, n_half = _general_args(z_rows, z_cols, row_gid, col_gid,
                                        cols_actual, n_half)
    masked, raw, onehot, valid = _general_terms(
        z_rows, z_cols, row_gid, temperature, col_gid, cols_actual, n_half,
        diag_pos, _check_scale(scale, z_rows.device))
    lse = _lse(masked, 1)
    positives = (raw * onehot).sum(dim=1)
    loss = torch.where(valid, lse - positives, torch.zeros_like(lse))
    return loss.sum(), lse


def _general_g(z_rows, z_cols, row_gid, lse, temperature, col_gid,
               cols_actual, n_half, diag_pos, scale):
    """G = (P - E) * valid_row with P = exp0(s - lse[row])."""
    cols_actual, n_half = _general_args(z_rows, z_cols, row_gid, col_gid,
                                        cols_actual, n_half)
    if lse.shape != (z_rows.shape[0],) or lse.device != z_rows.device:
        raise ValueError(f"lse must be ({z_rows.shape[0]},) on "
                         f"{z_rows.device}, got {tuple(lse.shape)} on "
                         f"{lse.device}")
    masked, _, onehot, valid = _general_terms(
        z_rows, z_cols, row_gid, temperature, col_gid, cols_actual, n_half,
        diag_pos, _check_scale(scale, z_rows.device))
    p = _exp0(masked - lse.float()[:, None])
    return (p - onehot) * valid.float()[:, None]


def ntxent_bwd_general_rows_plain(z_rows, z_cols, row_gid, lse, temperature,
                                  col_gid=None, cols_actual=None,
                                  n_half=None, diag_pos=False,
                                  scale=None) -> torch.Tensor:
    """(R, D) fp32 ``G @ z_cols`` (``_bwd_rows_kernel``)."""
    return _general_g(z_rows, z_cols, row_gid, lse, temperature, col_gid,
                      cols_actual, n_half, diag_pos, scale) @ z_cols.float()


def ntxent_bwd_general_cols_plain(z_rows, z_cols, row_gid, lse, temperature,
                                  col_gid=None, cols_actual=None,
                                  n_half=None, diag_pos=False,
                                  scale=None) -> torch.Tensor:
    """(C, D) fp32 ``G^T @ z_rows`` (``_bwd_cols_kernel``)."""
    return _general_g(z_rows, z_cols, row_gid, lse, temperature, col_gid,
                      cols_actual, n_half, diag_pos,
                      scale).T @ z_rows.float()


def _ids(ids):
    return None if ids is None else ids.to(torch.int32).contiguous()


def _ptr(t) -> int | None:
    return None if t is None else t.data_ptr()


# z_rows, z_cols, row_gid, col_gid, then the rest of each general entry
# point's pointers (fwd: scale, lse, loss, scratch; bwd: lse, scale, grad,
# scratch); rows, cols, d, dtype; inv_t; cols_actual, n_half, diag_pos,
# splits, split_cols, device; stream
_GENERAL_ARGTYPES = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 4
                     + [ctypes.c_float] + [ctypes.c_int] * 6
                     + [ctypes.c_void_p])


@functools.cache
def _fwd_general_kernel():
    fn = _build.load("ntxent_fwd").ntx_ntxent_fwd_general
    fn.argtypes = _GENERAL_ARGTYPES
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _bwd_general_kernel(side: str):
    fn = getattr(_build.load("ntxent_bwd_general"),
                 f"ntx_ntxent_bwd_general_{side}")
    fn.argtypes = _GENERAL_ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def ntxent_fwd_general(z_rows, z_cols, row_gid, temperature, col_gid=None,
                       cols_actual=None, n_half=None, diag_pos=False,
                       scale=None):
    """(loss_sum, lse): fp32 scalar and (R,) fp32 row logsumexp of the
    general mode.

    A CUDA tensor launches the general mode of ``csrc/ntxent_fwd.cu``
    (counted in ``ntxent_fwd_general.launches``); a CPU tensor runs
    ``ntxent_fwd_general_plain``."""
    cols_actual, n_half = _general_args(z_rows, z_cols, row_gid, col_gid,
                                        cols_actual, n_half)
    scale = _check_scale(scale, z_rows.device)
    if z_rows.device.type == "cpu":
        return ntxent_fwd_general_plain(z_rows, z_cols, row_gid, temperature,
                                        col_gid, cols_actual, n_half,
                                        diag_pos, scale)
    if z_rows.device.type != "cuda":
        raise ValueError(f"ntxent_fwd_general runs on cuda or cpu, got "
                         f"{z_rows.device}")
    _check_kernel_input(z_rows)
    _check_kernel_input(z_cols)
    (rows, d), cols = z_rows.shape, z_cols.shape[0]
    row_gid, col_gid = _ids(row_gid), _ids(col_gid)
    scale = None if scale is None else scale.contiguous()
    dtype = _DTYPE_CODES[z_rows.dtype]
    splits, split_cols = _splits(z_rows, rows, cols)
    scratch = _scratch(z_rows, "ntxent_fwd", rows, cols, d, dtype, splits)
    lse = torch.empty(rows, dtype=torch.float32, device=z_rows.device)
    loss = torch.empty((), dtype=torch.float32, device=z_rows.device)
    err = _fwd_general_kernel()(
        z_rows.data_ptr(), z_cols.data_ptr(), row_gid.data_ptr(),
        _ptr(col_gid), _ptr(scale), lse.data_ptr(), loss.data_ptr(),
        scratch.data_ptr(), rows, cols, d, dtype, _inv_t(temperature),
        cols_actual, n_half, int(bool(diag_pos)), splits, split_cols,
        z_rows.device.index,
        torch.cuda.current_stream(z_rows.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"ntxent_fwd_general launch failed: CUDA error "
                           f"{err}")
    ntxent_fwd_general.launches += 1
    return loss, lse


ntxent_fwd_general.launches = 0


def _bwd_general(side, z_rows, z_cols, row_gid, lse, temperature, col_gid,
                 cols_actual, n_half, diag_pos, scale):
    """Launch the rows or the columns kernel of the general backward."""
    if z_rows.device.type != "cuda":
        raise ValueError(f"ntxent_bwd_general_{side} runs on cuda or cpu, "
                         f"got {z_rows.device}")
    if lse.shape != (z_rows.shape[0],) or lse.device != z_rows.device:
        raise ValueError(f"lse must be ({z_rows.shape[0]},) on "
                         f"{z_rows.device}, got {tuple(lse.shape)} on "
                         f"{lse.device}")
    _check_kernel_input(z_rows)
    _check_kernel_input(z_cols)
    row_gid, col_gid = _ids(row_gid), _ids(col_gid)
    scale = None if scale is None else scale.contiguous()
    lse = lse.float().contiguous()
    (rows, d), cols = z_rows.shape, z_cols.shape[0]
    own, other = (rows, cols) if side == "rows" else (cols, rows)
    dtype = _DTYPE_CODES[z_rows.dtype]
    splits, split_cols = general_bwd_splits(own, other, d,
                                            _sm_count(z_rows.device.index))
    scratch = _scratch(z_rows, "ntxent_bwd_general", own, other, d, dtype,
                       splits)
    grad = torch.empty((own, d), dtype=torch.float32, device=z_rows.device)
    err = _bwd_general_kernel(side)(
        z_rows.data_ptr(), z_cols.data_ptr(), row_gid.data_ptr(),
        _ptr(col_gid), lse.data_ptr(), _ptr(scale), grad.data_ptr(),
        scratch.data_ptr(), rows, cols, d, dtype, _inv_t(temperature),
        cols_actual, n_half, int(bool(diag_pos)), splits, split_cols,
        z_rows.device.index,
        torch.cuda.current_stream(z_rows.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"ntxent_bwd_general_{side} launch failed: CUDA "
                           f"error {err}")
    return grad


def ntxent_bwd_general_rows(z_rows, z_cols, row_gid, lse, temperature,
                            col_gid=None, cols_actual=None, n_half=None,
                            diag_pos=False, scale=None) -> torch.Tensor:
    """(R, D) fp32 ``G @ z_cols`` (the gradient of loss_sum with respect to
    z_rows before ``scale / T``).

    A CUDA tensor launches the rows kernel of ``csrc/ntxent_bwd_general.cu``
    (counted in ``ntxent_bwd_general_rows.launches``); a CPU tensor runs
    the plain version."""
    cols_actual, n_half = _general_args(z_rows, z_cols, row_gid, col_gid,
                                        cols_actual, n_half)
    scale = _check_scale(scale, z_rows.device)
    if z_rows.device.type == "cpu":
        return ntxent_bwd_general_rows_plain(z_rows, z_cols, row_gid, lse,
                                             temperature, col_gid,
                                             cols_actual, n_half, diag_pos,
                                             scale)
    grad = _bwd_general("rows", z_rows, z_cols, row_gid, lse, temperature,
                        col_gid, cols_actual, n_half, diag_pos, scale)
    ntxent_bwd_general_rows.launches += 1
    return grad


ntxent_bwd_general_rows.launches = 0


def ntxent_bwd_general_cols(z_rows, z_cols, row_gid, lse, temperature,
                            col_gid=None, cols_actual=None, n_half=None,
                            diag_pos=False, scale=None) -> torch.Tensor:
    """(C, D) fp32 ``G^T @ z_rows`` from the row lse (the gradient of
    loss_sum with respect to z_cols before ``scale / T``).

    A CUDA tensor launches the columns kernel of
    ``csrc/ntxent_bwd_general.cu`` (counted in
    ``ntxent_bwd_general_cols.launches``); a CPU tensor runs the plain
    version."""
    cols_actual, n_half = _general_args(z_rows, z_cols, row_gid, col_gid,
                                        cols_actual, n_half)
    scale = _check_scale(scale, z_rows.device)
    if z_rows.device.type == "cpu":
        return ntxent_bwd_general_cols_plain(z_rows, z_cols, row_gid, lse,
                                             temperature, col_gid,
                                             cols_actual, n_half, diag_pos,
                                             scale)
    grad = _bwd_general("cols", z_rows, z_cols, row_gid, lse, temperature,
                        col_gid, cols_actual, n_half, diag_pos, scale)
    ntxent_bwd_general_cols.launches += 1
    return grad


ntxent_bwd_general_cols.launches = 0


class _NtxentPartial(torch.autograd.Function):
    """Partial loss_sum with the kernels' exact backward and a logit scale
    (``_ntxent_partial``, ntxent_pallas.py:818-868). ``apply(z_rows,
    z_cols, row_gid, scale, temperature, diag_pos)``: ``scale`` is
    ``None`` (NT-Xent) or a 0-d or (1,) fp32 tensor, the effective 1/T
    ``scale / T``. The forward saves (z_rows, z_cols, row_gid, lse and the
    scale); the backward returns ``grad * (g / T * scale)`` for both
    embeddings, each in its own dtype, and the scale's gradient ``(g / T)
    sum(gr * z_rows)`` with ``gr`` the rows kernel's output, so the rows
    kernel runs when z_rows or the scale needs a gradient."""

    @staticmethod
    def forward(ctx, z_rows, z_cols, row_gid, scale, temperature, diag_pos):
        loss_sum, lse = ntxent_fwd_general(z_rows, z_cols, row_gid,
                                           temperature, diag_pos=diag_pos,
                                           scale=scale)
        ctx.save_for_backward(z_rows, z_cols, row_gid, lse, scale)
        ctx.temperature, ctx.diag_pos = temperature, diag_pos
        return loss_sum

    @staticmethod
    def backward(ctx, g):
        z_rows, z_cols, row_gid, lse, scale = ctx.saved_tensors
        coef = g.float() / ctx.temperature
        factor = coef if scale is None else coef * scale.float()
        args = (z_rows, z_cols, row_gid, lse, ctx.temperature)
        kw = dict(diag_pos=ctx.diag_pos, scale=scale)
        need_rows, need_cols, _, need_scale = ctx.needs_input_grad[:4]
        grad_rows = grad_cols = grad_scale = None
        if need_rows or need_scale:
            gr = ntxent_bwd_general_rows(*args, **kw)
            if need_rows:
                grad_rows = (gr * factor).to(z_rows.dtype)
            if need_scale:
                # d loss_sum / d scale = (1/T) sum_ij G_ij (zr_i . zc_j)
                #                      = (1/T) sum_i (G @ zc)_i . zr_i
                grad_scale = (coef * torch.sum(gr * z_rows.float())).reshape(
                    scale.shape).to(scale.dtype)
        if need_cols:
            grad_cols = (ntxent_bwd_general_cols(*args, **kw) * factor).to(
                z_cols.dtype)
        return grad_rows, grad_cols, None, grad_scale, None, None


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
                                row_gid, None, float(temperature), False)


# ---------------------------------------------------------------------------
# Ring mode: local rows against one visiting column block
# ---------------------------------------------------------------------------


def block_lse(z_rows: torch.Tensor, z_cols: torch.Tensor,
              row_gid: torch.Tensor, col_gid: torch.Tensor,
              temperature: float, total_cols: int) -> torch.Tensor:
    """(R,) fp32 logsumexp of each row over ONE column block of the global
    similarity matrix (``ntxent_pallas.py:941``), self-columns masked by
    global id: the fold step of the fused ring NT-Xent
    (``parallel.ring``). The general forward (#1) with the block's column
    ids and ``cols_actual = n_half = total_cols``, which points every
    row's positive past the real ids (the ring adds the positives
    itself). The kernels mask the ragged edge of a block, so nothing is
    padded with sentinel ids. A CUDA tensor launches #1 (counted in
    ``ntxent_fwd_general.launches``); a CPU tensor takes its plain
    version."""
    total = int(total_cols)
    return ntxent_fwd_general(z_rows.contiguous(), z_cols.contiguous(),
                              row_gid, temperature, col_gid, total, total)[1]


def block_grads(z_rows: torch.Tensor, z_cols: torch.Tensor,
                row_gid: torch.Tensor, col_gid: torch.Tensor,
                lse_rows: torch.Tensor, temperature: float,
                total_cols: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``(P @ z_cols, P^T @ z_rows)`` in fp32 for ``P = exp(s - lse_rows)``
    over this column block (``ntxent_pallas.py:981``): the gradients of
    ``sum_r lse_r`` restricted to the block, times the temperature; the
    caller multiplies by ``cotangent / T`` once. The general backward's
    rows and columns kernels (#6) in the mode of ``block_lse``."""
    total = int(total_cols)
    args = (z_rows.contiguous(), z_cols.contiguous(), row_gid, lse_rows,
            temperature, col_gid, total, total)
    return ntxent_bwd_general_rows(*args), ntxent_bwd_general_cols(*args)


# ---------------------------------------------------------------------------
# Shard-pair mode: one tile of the symmetric matrix, both directions
# ---------------------------------------------------------------------------


def _dual_args(z_rows, z_cols, row_gid, col_gid):
    if z_rows.ndim != 2 or z_cols.ndim != 2 \
            or z_rows.shape[1] != z_cols.shape[1]:
        raise ValueError(f"rows (R, D) and columns (C, D) must share D, got "
                         f"{tuple(z_rows.shape)} and {tuple(z_cols.shape)}")
    if z_rows.shape[0] < 1 or z_cols.shape[0] < 1:
        raise ValueError("a shard-pair tile needs at least one row and one "
                         "column")
    if z_rows.dtype != z_cols.dtype or z_rows.device != z_cols.device:
        raise ValueError(f"rows and columns must share dtype and device, got "
                         f"{z_rows.dtype} on {z_rows.device} and "
                         f"{z_cols.dtype} on {z_cols.device}")
    for name, ids, n in (("row_gid", row_gid, z_rows.shape[0]),
                         ("col_gid", col_gid, z_cols.shape[0])):
        if ids.shape != (n,) or ids.device != z_rows.device \
                or ids.is_floating_point():
            raise ValueError(f"{name} must be ({n},) integers on "
                             f"{z_rows.device}, got {tuple(ids.shape)} "
                             f"{ids.dtype} on {ids.device}")


def _dual_terms(z_rows, z_cols, row_gid, col_gid, temperature, total):
    """(s_row, s_col, valid_row, valid_col) of ``_dual_stats_kernel``:
    the scaled similarity masked for each direction, and which ids are
    not the padding sentinel."""
    s = (z_rows.float() @ z_cols.float().T) * _inv_t(temperature)
    rid = row_gid.long()[:, None]
    cid = col_gid.long()[None, :]
    self_hit = cid == rid
    s_row = s.masked_fill((cid >= total) | self_hit, _NEG_INF)
    s_col = s.masked_fill((rid >= total) | self_hit, _NEG_INF)
    return s_row, s_col, rid[:, 0] < total, cid[0] < total


def block_lse_dual_plain(z_rows, z_cols, row_gid, col_gid, temperature,
                         total):
    """(lse_rows (R,), lse_cols (C,)) fp32: each row's logsumexp over the
    tile's columns, each column's over the tile's rows (the mirror tile's
    row direction), each with its direction's mask."""
    _dual_args(z_rows, z_cols, row_gid, col_gid)
    s_row, s_col, _, _ = _dual_terms(z_rows, z_cols, row_gid, col_gid,
                                     temperature, total)
    return _lse(s_row, 1), _lse(s_col, 0)


def block_grads_dual_plain(z_rows, z_cols, row_gid, col_gid, lse_rows,
                           lse_cols, temperature, total):
    """(G @ z_cols (R, D), G^T @ z_rows (C, D)) fp32 with ``G =
    exp0(s_row - lse_rows) valid_row + exp0(s_col - lse_cols) valid_col``
    (``_dual_grads_kernel``): no positive term."""
    _dual_args(z_rows, z_cols, row_gid, col_gid)
    if lse_rows.shape != (z_rows.shape[0],) \
            or lse_cols.shape != (z_cols.shape[0],):
        raise ValueError(f"lse_rows and lse_cols must be ({z_rows.shape[0]},)"
                         f" and ({z_cols.shape[0]},), got "
                         f"{tuple(lse_rows.shape)} and "
                         f"{tuple(lse_cols.shape)}")
    s_row, s_col, valid_r, valid_c = _dual_terms(
        z_rows, z_cols, row_gid, col_gid, temperature, total)
    g = (_exp0(s_row - lse_rows.float()[:, None]) * valid_r.float()[:, None]
         + _exp0(s_col - lse_cols.float()[None, :]) * valid_c.float()[None])
    return g @ z_cols.float(), g.T @ z_rows.float()


@functools.cache
def _dual_stats_kernel():
    fn = _build.load("ntxent_dual_stats").ntx_ntxent_dual_stats
    # z_rows, z_cols, row_gid, col_gid, lse_rows, lse_cols, scratch; rows,
    # cols, d, dtype; inv_t; total, splits, split_cols, device; stream
    fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 4
                   + [ctypes.c_float] + [ctypes.c_int] * 4
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _dual_grads_kernel():
    fn = _build.load("ntxent_dual_grads").ntx_ntxent_dual_grads
    # z_rows, z_cols, row_gid, col_gid, lse_rows, lse_cols, grad_rows,
    # grad_cols, scratch; rows, cols, d, dtype; inv_t; total, splits_r,
    # split_cols_r, splits_c, split_cols_c, device; stream
    fn.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 4
                   + [ctypes.c_float] + [ctypes.c_int] * 6
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=256)
def _dual_stats_plan(rows: int, cols: int, d: int, dtype: int, index: int):
    """(splits, split_cols, scratch floats) of #7: z_cols's columns cut as
    ``column_splits`` plans for ``rows`` rows."""
    splits, split_cols = column_splits(rows, cols, _sm_count(index))
    return (splits, split_cols,
            _scratch_size("ntxent_dual_stats")(rows, cols, d, dtype, splits))


def dual_grads_splits(rows: int, cols: int, d: int, sms: int = SM_COUNT):
    """((splits, split_cols) of the row owners, of the column owners) of
    #8: each side's other side cut as ``general_bwd_splits`` plans at half
    the SMs, since the two sides share one grid."""
    half = max(1, sms // 2)
    return (general_bwd_splits(rows, cols, d, half),
            general_bwd_splits(cols, rows, d, half))


@functools.lru_cache(maxsize=256)
def _dual_grads_plan(rows: int, cols: int, d: int, dtype: int, index: int):
    """(splits_r, split_cols_r, splits_c, split_cols_c, scratch floats) of
    #8 (``dual_grads_splits``)."""
    (splits_r, cols_r), (splits_c, cols_c) = dual_grads_splits(
        rows, cols, d, _sm_count(index))
    size = _scratch_size("ntxent_dual_grads")(rows, cols, d, dtype,
                                               splits_r, splits_c)
    return splits_r, cols_r, splits_c, cols_c, size


def _dual_kernel_input(name, z_rows, z_cols):
    if z_rows.device.type != "cuda":
        raise ValueError(f"{name} runs on cuda or cpu, got {z_rows.device}")
    _check_kernel_input(z_rows)
    _check_kernel_input(z_cols)


def block_lse_dual(z_rows: torch.Tensor, z_cols: torch.Tensor,
                   row_gid: torch.Tensor, col_gid: torch.Tensor,
                   temperature: float, total: int):
    """(lse_rows, lse_cols) of ONE shard-pair tile from a single walk
    (``ntxent_pallas.py:1094``): lse_rows[a] is the logsumexp over this
    tile's columns for row a, lse_cols[b] over this tile's rows for column
    b. Fold results across a rank's tiles with logaddexp; weight a tile
    by adding log(w) to both outputs. Not differentiable: the pair loss
    calls ``block_grads_dual`` itself.

    A CUDA tensor launches ``csrc/ntxent_dual_stats.cu`` (counted in
    ``block_lse_dual.launches``); a CPU tensor runs the plain version."""
    _dual_args(z_rows, z_cols, row_gid, col_gid)
    if z_rows.device.type == "cpu":
        return block_lse_dual_plain(z_rows, z_cols, row_gid, col_gid,
                                    temperature, total)
    _dual_kernel_input("block_lse_dual", z_rows, z_cols)
    (rows, d), cols, dev = z_rows.shape, z_cols.shape[0], z_rows.device
    dtype = _DTYPE_CODES[z_rows.dtype]
    splits, split_cols, size = _dual_stats_plan(rows, cols, d, dtype,
                                                dev.index)
    lse_rows = torch.empty(rows, dtype=torch.float32, device=dev)
    lse_cols = torch.empty(cols, dtype=torch.float32, device=dev)
    scratch = device_scratch(dev, size, d)
    row_gid, col_gid = _ids(row_gid), _ids(col_gid)
    err = _dual_stats_kernel()(
        z_rows.data_ptr(), z_cols.data_ptr(), row_gid.data_ptr(),
        col_gid.data_ptr(), lse_rows.data_ptr(), lse_cols.data_ptr(),
        scratch.data_ptr(), rows, cols, d, dtype, _inv_t(temperature),
        int(total), splits, split_cols, dev.index,
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"block_lse_dual launch failed: CUDA error {err}")
    block_lse_dual.launches += 1
    return lse_rows, lse_cols


block_lse_dual.launches = 0


def block_grads_dual(z_rows: torch.Tensor, z_cols: torch.Tensor,
                     row_gid: torch.Tensor, col_gid: torch.Tensor,
                     lse_rows: torch.Tensor, lse_cols: torch.Tensor,
                     temperature: float, total: int):
    """Both sides' gradient contributions of one shard-pair tile, times T
    (``ntxent_pallas.py:1213``): with ``S = sum of the global rows' lse``
    and the tile's rows and columns carrying their GLOBAL lse,
    ``(dS/dz_rows, dS/dz_cols) * T`` restricted to this tile's softmax
    terms (no positive term), fp32. The caller multiplies by ``cotangent
    / T`` once and adds the local positives' gradient.

    A CUDA tensor launches ``csrc/ntxent_dual_grads.cu`` (counted in
    ``block_grads_dual.launches``); a CPU tensor runs the plain
    version."""
    _dual_args(z_rows, z_cols, row_gid, col_gid)
    if z_rows.device.type == "cpu":
        return block_grads_dual_plain(z_rows, z_cols, row_gid, col_gid,
                                      lse_rows, lse_cols, temperature, total)
    _dual_kernel_input("block_grads_dual", z_rows, z_cols)
    rows, cols = z_rows.shape[0], z_cols.shape[0]
    if lse_rows.shape != (rows,) or lse_cols.shape != (cols,) \
            or lse_rows.device != z_rows.device \
            or lse_cols.device != z_rows.device:
        raise ValueError(f"lse_rows and lse_cols must be ({rows},) and "
                         f"({cols},) on {z_rows.device}")
    lse_rows = lse_rows.float().contiguous()
    lse_cols = lse_cols.float().contiguous()
    row_gid, col_gid = _ids(row_gid), _ids(col_gid)
    d, dev, dtype = z_rows.shape[1], z_rows.device, _DTYPE_CODES[z_rows.dtype]
    *plan, size = _dual_grads_plan(rows, cols, d, dtype, dev.index)
    grad_rows = torch.empty(z_rows.shape, dtype=torch.float32, device=dev)
    grad_cols = torch.empty(z_cols.shape, dtype=torch.float32, device=dev)
    scratch = device_scratch(dev, size, d)
    err = _dual_grads_kernel()(
        z_rows.data_ptr(), z_cols.data_ptr(), row_gid.data_ptr(),
        col_gid.data_ptr(), lse_rows.data_ptr(), lse_cols.data_ptr(),
        grad_rows.data_ptr(), grad_cols.data_ptr(), scratch.data_ptr(),
        rows, cols, d, dtype, _inv_t(temperature), int(total), *plan,
        dev.index, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"block_grads_dual launch failed: CUDA error "
                           f"{err}")
    block_grads_dual.launches += 1
    return grad_rows, grad_cols


block_grads_dual.launches = 0
