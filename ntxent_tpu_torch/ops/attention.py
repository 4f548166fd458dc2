"""Flash attention: the hand-written Hopper kernels and their plain versions.

Counterpart of ``ntxent_tpu/ops/attention_pallas.py``. On the flattened
(B*H, L, D) layout:

* ``flash_attention_fwd`` returns ``(o, lse)`` as the TPU forward kernel
  does: ``o`` in q's dtype, ``lse`` fp32 of shape (B*H, Lq)
  (``csrc/flash_attention_fwd.cu``; plain version ``attention_plain``);
* ``flash_attention_dq`` and ``flash_attention_dkv`` are the backward
  (``csrc/flash_attention_bwd.cu``; plain versions
  ``attention_dq_plain`` and ``attention_dkv_plain``), from the saved
  lse and ``delta = rowsum(dO * O)``, with fp32 outputs;
* ``flash_fold`` is one fold of a K/V block into carried fp32
  statistics ``(m, l, acc)``, unnormalized (``csrc/flash_attention_fold.cu``;
  plain version ``flash_fold_plain``): the per-hop step of the ring
  attention (``parallel.ring_attention``).

A tensor on the GPU launches the CUDA kernel or raises; a tensor on the
CPU takes the plain version. There is no fallback from a kernel to its
plain version. Each wrapper counts its launches in ``.launches``.

``flash_attention`` is the public (B, L, H, D) entry, as in the JAX
package, differentiable through the backward wrappers.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from . import _build
from .blocks import round_up

__all__ = ["attention_dkv_plain", "attention_dq_plain", "attention_plain",
           "flash_attention", "flash_attention_dkv", "flash_attention_dq",
           "flash_attention_fwd", "flash_fold", "flash_fold_plain",
           "resolve_attention_scale"]

_NEG_INF = -1e30
BLOCK_Q = 64  # q rows per thread block (csrc/flash_attention_tile.cuh)
HEAD_DIMS = (64, 128)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_INT32_MAX = 2**31 - 1


def resolve_attention_scale(scale, head_dim) -> float:
    """The default-scale rule: None -> 1/sqrt(head_dim)."""
    return float(scale) if scale is not None else 1.0 / math.sqrt(head_dim)


def _scores(q, k, sc, causal, q_offset, k_offset):
    """fp32 ``q k^T * scale``; when causal, keys after the query's global
    position (``k_offset + j > q_offset + i``) are masked to -1e30."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * sc
    if causal:
        qpos = q_offset + torch.arange(q.shape[1], device=q.device)
        kpos = k_offset + torch.arange(k.shape[1], device=q.device)
        s = s.masked_fill(kpos[None, None, :] > qpos[None, :, None],
                          _NEG_INF)
    return s


def attention_plain(q, k, v, *, causal: bool = False, scale=None,
                    q_offset: int = 0, k_offset: int = 0):
    """Plain PyTorch attention with the kernel's numerics.

    q: (BH, Lq, D), k/v: (BH, Lk, D). Scores and softmax statistics are
    fp32; causal masking compares global positions ``q_offset + i`` and
    ``k_offset + j``; masked scores are -1e30 and weigh 0; exponents are
    clamped at 0 and ``log(l)`` floored at 1e-37; p is cast to v's dtype
    before p . v; a fully masked row gives o = 0 (l = 0 -> 1).
    """
    sc = resolve_attention_scale(scale, q.shape[-1])
    s = _scores(q, k, sc, causal, q_offset, k_offset)
    m = torch.clamp(s.amax(dim=-1, keepdim=True), min=_NEG_INF)
    p = torch.where(s <= _NEG_INF * 0.5, 0.0,
                    torch.exp(torch.clamp(s - m, max=0.0)))
    l = p.sum(dim=-1, keepdim=True)
    acc = torch.matmul(p.to(v.dtype).float(), v.float())
    o = acc / torch.where(l == 0.0, 1.0, l)
    lse = m + torch.log(torch.clamp(l, min=1e-37))
    return o.to(q.dtype), lse.squeeze(-1)


def _check_flat(q, k, v) -> None:
    if (q.ndim != 3 or k.shape != v.shape or k.ndim != 3
            or q.shape[0] != k.shape[0] or q.shape[2] != k.shape[2]):
        raise ValueError(f"expected (BH, L, D) q/k/v with shared BH/D, got "
                         f"{tuple(q.shape)} {tuple(k.shape)} "
                         f"{tuple(v.shape)}")
    if min(q.shape) < 1 or k.shape[1] < 1:
        raise ValueError(f"empty attention input: q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}")
    if not (q.device == k.device == v.device):
        raise ValueError(f"q/k/v on different devices: {q.device}, "
                         f"{k.device}, {v.device}")


@functools.cache
def _kernel():
    """The C entry point, built on first use (see ``_build``)."""
    fn = _build.load("flash_attention_fwd").ntx_flash_attention_fwd
    # q, k, v, o, lse; bh, lq, lk, head_dim, dtype; scale; causal, q_off,
    # k_off, device; stream
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 5
                   + [ctypes.c_float] + [ctypes.c_int] * 4
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _check_kernel_args(q, k, v, q_offset, k_offset, **named) -> None:
    """What the CUDA kernels take: one dtype of float32/bfloat16, head_dim
    64 or 128, contiguous 16-byte aligned tensors, an int32 grid."""
    tensors = {"q": q, "k": k, "v": v, **named}
    if q.dtype not in _DTYPE_CODES or any(t.dtype != q.dtype
                                          for t in tensors.values()):
        raise TypeError(f"flash_attention kernels take float32 or bfloat16 "
                        f"inputs of one dtype, got "
                        f"{ {n: t.dtype for n, t in tensors.items()} }")
    bh, lq, d = q.shape
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention kernel supports head_dim in "
                         f"{HEAD_DIMS}, got {d}")
    for name, t in tensors.items():
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte "
                             "aligned")
    tiles = round_up(max(lq, k.shape[1]), BLOCK_Q) // BLOCK_Q
    if (bh * tiles > _INT32_MAX
            or max(abs(q_offset), abs(k_offset)) > _INT32_MAX // 2):
        raise ValueError(f"grid or offsets exceed int32: bh={bh}, lq={lq}, "
                         f"lk={k.shape[1]}, offsets=({q_offset}, "
                         f"{k_offset})")


def _launch(q, k, v, sc, causal, q_offset, k_offset):
    _check_kernel_args(q, k, v, q_offset, k_offset)
    bh, lq, d = q.shape
    lk = k.shape[1]
    o = torch.empty_like(q)
    lse = torch.empty((bh, lq), dtype=torch.float32, device=q.device)
    err = _kernel()(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                    lse.data_ptr(), bh, lq, lk, d, _DTYPE_CODES[q.dtype],
                    sc, int(causal), int(q_offset), int(k_offset),
                    q.device.index, torch.cuda.current_stream(
                        q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_attention_fwd launch failed: CUDA error "
                           f"{err}")
    flash_attention_fwd.launches += 1
    return o, lse


def flash_attention_fwd(q, k, v, *, causal: bool = False, scale=None,
                        q_offset: int = 0, k_offset: int = 0):
    """(o, lse) for flattened q (BH, Lq, D), k/v (BH, Lk, D).

    On CUDA tensors this launches the Hopper kernel (and counts the
    launch in ``flash_attention_fwd.launches``); on CPU tensors it runs
    ``attention_plain``.
    """
    _check_flat(q, k, v)
    sc = resolve_attention_scale(scale, q.shape[-1])
    if q.device.type == "cuda":
        return _launch(q, k, v, sc, causal, q_offset, k_offset)
    if q.device.type == "cpu":
        return attention_plain(q, k, v, causal=causal, scale=sc,
                               q_offset=q_offset, k_offset=k_offset)
    raise ValueError(f"flash_attention runs on cuda or cpu, got {q.device}")


flash_attention_fwd.launches = 0


def _bwd_probs(q, k, v, do, lse, delta, sc, causal, q_offset, k_offset):
    """(p, ds) of the backward kernels (attention_pallas.py:138-152):
    fp32 scores of the inputs, masked to -1e30, ``p = 0`` where
    ``s <= -5e29`` else ``exp(min(s - lse, 0))``, ``dp = dO V^T`` in fp32,
    ``ds = p * (dp - delta) * scale``."""
    s = _scores(q, k, sc, causal, q_offset, k_offset)
    p = torch.where(s <= _NEG_INF * 0.5, 0.0,
                    torch.exp(torch.clamp(s - lse[..., None], max=0.0)))
    dp = torch.matmul(do.float(), v.float().transpose(-1, -2))
    return p, p * (dp - delta[..., None]) * sc


def attention_dq_plain(q, k, v, do, lse, delta, *, causal: bool = False,
                       scale=None, q_offset: int = 0, k_offset: int = 0):
    """fp32 dQ with the kernel's numerics: ``ds`` is cast to k's dtype
    before ``ds . K`` (attention_pallas.py:153)."""
    sc = resolve_attention_scale(scale, q.shape[-1])
    _, ds = _bwd_probs(q, k, v, do, lse, delta, sc, causal, q_offset,
                       k_offset)
    return torch.matmul(ds.to(k.dtype).float(), k.float())


def attention_dkv_plain(q, k, v, do, lse, delta, *, causal: bool = False,
                        scale=None, q_offset: int = 0, k_offset: int = 0):
    """fp32 (dK, dV) with the kernel's numerics: p, dO, ds and Q all in
    fp32 (attention_pallas.py:191-204)."""
    sc = resolve_attention_scale(scale, q.shape[-1])
    p, ds = _bwd_probs(q, k, v, do, lse, delta, sc, causal, q_offset,
                       k_offset)
    dv = torch.matmul(p.transpose(-1, -2), do.float())
    dk = torch.matmul(ds.transpose(-1, -2), q.float())
    return dk, dv


def _check_bwd(q, k, v, do, lse, delta) -> None:
    _check_flat(q, k, v)
    if do.shape != q.shape or lse.shape != q.shape[:2] \
            or delta.shape != q.shape[:2]:
        raise ValueError(f"expected dO {tuple(q.shape)} and lse/delta "
                         f"{tuple(q.shape[:2])}, got {tuple(do.shape)}, "
                         f"{tuple(lse.shape)}, {tuple(delta.shape)}")
    if any(t.device != q.device for t in (do, lse, delta)):
        raise ValueError("dO, lse and delta must be on q's device")
    if q.device.type not in ("cuda", "cpu"):
        raise ValueError(f"flash_attention runs on cuda or cpu, got "
                         f"{q.device}")


@functools.cache
def _bwd_kernels():
    """The two C entry points of csrc/flash_attention_bwd.cu."""
    lib = _build.load("flash_attention_bwd")
    # q, k, v, dO, lse, delta, out(s); bh, lq, lk, head_dim, dtype; scale;
    # causal, q_off, k_off, device; stream
    tail = ([ctypes.c_int] * 5 + [ctypes.c_float] + [ctypes.c_int] * 4
            + [ctypes.c_void_p])
    dq, dkv = lib.ntx_flash_attention_dq, lib.ntx_flash_attention_dkv
    dq.argtypes = [ctypes.c_void_p] * 7 + tail
    dkv.argtypes = [ctypes.c_void_p] * 8 + tail
    dq.restype = dkv.restype = ctypes.c_int
    return dq, dkv


def _bwd_launch(fn, name, outs, q, k, v, do, lse, delta, sc, causal,
                q_offset, k_offset):
    _check_kernel_args(q, k, v, q_offset, k_offset, do=do)
    lse, delta = lse.float().contiguous(), delta.float().contiguous()
    bh, lq, d = q.shape
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
             lse.data_ptr(), delta.data_ptr(), *(o.data_ptr() for o in outs),
             bh, lq, k.shape[1], d, _DTYPE_CODES[q.dtype], sc, int(causal),
             int(q_offset), int(k_offset), q.device.index,
             torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")


def flash_attention_dq(q, k, v, do, lse, delta, *, causal: bool = False,
                       scale=None, q_offset: int = 0, k_offset: int = 0):
    """fp32 dQ (BH, Lq, D) from the forward's lse and delta.

    On CUDA tensors this launches ``csrc/flash_attention_bwd.cu``'s dQ
    kernel (counted in ``flash_attention_dq.launches``); on CPU tensors
    it runs ``attention_dq_plain``."""
    _check_bwd(q, k, v, do, lse, delta)
    sc = resolve_attention_scale(scale, q.shape[-1])
    kw = dict(causal=causal, scale=sc, q_offset=q_offset, k_offset=k_offset)
    if q.device.type == "cpu":
        return attention_dq_plain(q, k, v, do, lse, delta, **kw)
    dq = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    _bwd_launch(_bwd_kernels()[0], "flash_attention_dq", (dq,), q, k, v, do,
                lse, delta, sc, causal, q_offset, k_offset)
    flash_attention_dq.launches += 1
    return dq


flash_attention_dq.launches = 0


def flash_attention_dkv(q, k, v, do, lse, delta, *, causal: bool = False,
                        scale=None, q_offset: int = 0, k_offset: int = 0):
    """fp32 (dK, dV), each (BH, Lk, D), from the forward's lse and delta.

    On CUDA tensors this launches ``csrc/flash_attention_bwd.cu``'s dK/dV
    kernel (counted in ``flash_attention_dkv.launches``); on CPU tensors
    it runs ``attention_dkv_plain``."""
    _check_bwd(q, k, v, do, lse, delta)
    sc = resolve_attention_scale(scale, q.shape[-1])
    kw = dict(causal=causal, scale=sc, q_offset=q_offset, k_offset=k_offset)
    if q.device.type == "cpu":
        return attention_dkv_plain(q, k, v, do, lse, delta, **kw)
    dk = torch.empty(k.shape, dtype=torch.float32, device=q.device)
    dv = torch.empty(v.shape, dtype=torch.float32, device=q.device)
    _bwd_launch(_bwd_kernels()[1], "flash_attention_dkv", (dk, dv), q, k, v,
                do, lse, delta, sc, causal, q_offset, k_offset)
    flash_attention_dkv.launches += 1
    return dk, dv


flash_attention_dkv.launches = 0


def flash_fold_plain(q, k, v, m, l, acc, *, q_offset: int = 0,
                     k_offset: int = 0, scale=None, causal: bool = False):
    """Plain PyTorch version of ``flash_fold`` with the kernel's numerics
    (attention_pallas.py:217-258), the whole block folded in one step where
    the kernel walks 64-key tiles (the same function in exact arithmetic):
    fp32 scores, masked ones -1e30; ``m_new = max(m, rowmax s)``; ``p = 0``
    where ``s <= -5e29``, else ``exp(min(s - m_new, 0))``; ``alpha =
    exp(min(m - m_new, 0))``; ``l = l alpha + sum p``; ``acc = acc alpha +
    (p cast to v's dtype) . v``. Returns new tensors; a row that sees no
    key keeps its carry bit for bit."""
    sc = resolve_attention_scale(scale, q.shape[-1])
    s = _scores(q, k, sc, causal, q_offset, k_offset)
    m_new = torch.maximum(m, s.amax(dim=-1))
    p = torch.where(s <= _NEG_INF * 0.5, 0.0,
                    torch.exp(torch.clamp(s - m_new[..., None], max=0.0)))
    alpha = torch.exp(torch.clamp(m - m_new, max=0.0))
    l_new = l * alpha + p.sum(dim=-1)
    acc_new = acc * alpha[..., None] + torch.matmul(p.to(v.dtype).float(),
                                                    v.float())
    return m_new, l_new, acc_new


def _check_fold(q, k, v, m, l, acc) -> None:
    _check_flat(q, k, v)
    if m.shape != q.shape[:2] or l.shape != q.shape[:2] \
            or acc.shape != q.shape:
        raise ValueError(f"expected m, l {tuple(q.shape[:2])} and acc "
                         f"{tuple(q.shape)}, got {tuple(m.shape)}, "
                         f"{tuple(l.shape)}, {tuple(acc.shape)}")
    if any(t.dtype != torch.float32 for t in (m, l, acc)):
        raise TypeError(f"the carried (m, l, acc) are float32, got "
                        f"{m.dtype}, {l.dtype}, {acc.dtype}")
    if any(t.device != q.device for t in (m, l, acc)):
        raise ValueError("m, l and acc must be on q's device")
    if q.device.type not in ("cuda", "cpu"):
        raise ValueError(f"flash_fold runs on cuda or cpu, got {q.device}")


@functools.cache
def _fold_kernel():
    """The C entry point of csrc/flash_attention_fold.cu."""
    fn = _build.load("flash_attention_fold").ntx_flash_attention_fold
    # q, k, v, m_in, l_in, acc_in, m_out, l_out, acc_out; bh, lq, lk,
    # head_dim, dtype; scale; causal, q_off, k_off, device; stream
    fn.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 5
                   + [ctypes.c_float] + [ctypes.c_int] * 4
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def flash_fold(q, k, v, m, l, acc, *, q_offset: int = 0, k_offset: int = 0,
               scale=None, causal: bool = False):
    """Fold one K/V block into running flash statistics; returns the new
    ``(m, l, acc)``.

    q (BH, Lq, D), k/v (BH, Lk, D) in one dtype; the carry m, l (BH, Lq)
    and acc (BH, Lq, D) in fp32, as left by earlier folds (start: m =
    -1e30, l = 0, acc = 0). ``q_offset``/``k_offset`` are the blocks'
    global positions for causal masking and may take any sign. The
    result is unnormalized: ``lse = m + log(max(l, 1e-37))`` and ``out =
    acc / l`` (l == 0 -> 1) after the last fold. The outputs are new
    tensors; the carry is not written.

    On CUDA tensors this launches ``csrc/flash_attention_fold.cu``
    (counted in ``flash_fold.launches``); on CPU tensors it runs
    ``flash_fold_plain``."""
    _check_fold(q, k, v, m, l, acc)
    sc = resolve_attention_scale(scale, q.shape[-1])
    kw = dict(q_offset=q_offset, k_offset=k_offset, scale=sc, causal=causal)
    if q.device.type == "cpu":
        return flash_fold_plain(q, k, v, m, l, acc, **kw)
    _check_kernel_args(q, k, v, q_offset, k_offset)
    for name, t in (("m", m), ("l", l), ("acc", acc)):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte "
                             "aligned")
    bh, lq, d = q.shape
    outs = (torch.empty_like(m), torch.empty_like(l), torch.empty_like(acc))
    err = _fold_kernel()(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), m.data_ptr(), l.data_ptr(),
        acc.data_ptr(), *(o.data_ptr() for o in outs), bh, lq, k.shape[1], d,
        _DTYPE_CODES[q.dtype], sc, int(causal), int(q_offset), int(k_offset),
        q.device.index, torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_fold launch failed: CUDA error {err}")
    flash_fold.launches += 1
    return outs


flash_fold.launches = 0


class _FlashAttention(torch.autograd.Function):
    """Flat (BH, L, D) attention whose backward is the dQ and dK/dV
    wrappers (attention_pallas.py:515-535): the forward saves
    (q, k, v, o, lse); the backward forms ``delta = rowsum(dO * O)`` in
    fp32 and casts the fp32 gradients to the inputs' dtypes."""

    @staticmethod
    def forward(ctx, q, k, v, sc, causal, q_offset, k_offset):
        o, lse = flash_attention_fwd(q, k, v, causal=causal, scale=sc,
                                     q_offset=q_offset, k_offset=k_offset)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.kw = dict(causal=causal, scale=sc, q_offset=q_offset,
                      k_offset=k_offset)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        # autograd may hand back a permuted view of the flattened layout
        do = do.contiguous().to(q.dtype)
        delta = torch.sum(do.float() * o.float(), dim=-1)
        dq = flash_attention_dq(q, k, v, do, lse, delta, **ctx.kw)
        dk, dv = flash_attention_dkv(q, k, v, do, lse, delta, **ctx.kw)
        return (dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None, None,
                None, None)


def _flat(x):
    b, l, h, d = x.shape
    return x.permute(0, 2, 1, 3).reshape(b * h, l, d).contiguous()


def _unflat(x, b, h):
    bh, l, d = x.shape
    return x.reshape(b, h, l, d).permute(0, 2, 1, 3)


def flash_attention(q, k, v, *, causal: bool = False, scale=None,
                    q_offset: int = 0, k_offset: int = 0):
    """softmax(q k^T * scale) v for q (B, Lq, H, D), k/v (B, Lk, H, D).

    ``q_offset``/``k_offset`` are the blocks' global positions for causal
    masking. Returns (B, Lq, H, D) in q's dtype; differentiable in q, k
    and v through ``flash_attention_dq``/``flash_attention_dkv``.
    """
    if (q.ndim != 4 or k.shape != v.shape or k.ndim != 4
            or q.shape[0] != k.shape[0] or q.shape[2:] != k.shape[2:]):
        raise ValueError(f"expected (B, L, H, D) q/k/v with shared B/H/D, "
                         f"got {tuple(q.shape)} {tuple(k.shape)} "
                         f"{tuple(v.shape)}")
    b, _, h, _ = q.shape
    sc = resolve_attention_scale(scale, q.shape[-1])
    o = _FlashAttention.apply(_flat(q), _flat(k), _flat(v), sc, bool(causal),
                              int(q_offset), int(k_offset))
    return _unflat(o, b, h)
