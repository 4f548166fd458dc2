"""Flash attention: the hand-written Hopper kernel and its plain version.

Counterpart of ``ntxent_tpu/ops/attention_pallas.py``'s forward.
``flash_attention_fwd`` takes the flattened (B*H, L, D) layout and
returns ``(o, lse)`` as the TPU kernel does: ``o`` in q's dtype, ``lse``
fp32 of shape (B*H, Lq). A tensor on the GPU launches the CUDA kernel
(``csrc/flash_attention_fwd.cu``) or raises; a tensor on the CPU takes
``attention_plain``, the same function in plain PyTorch. There is no
fallback from the kernel to the plain version.

``flash_attention`` is the public (B, L, H, D) entry, as in the JAX
package.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from . import _build
from .blocks import round_up

__all__ = ["attention_plain", "flash_attention", "flash_attention_fwd",
           "resolve_attention_scale"]

_NEG_INF = -1e30
BLOCK_Q = 64  # q rows per thread block in csrc/flash_attention_fwd.cu
HEAD_DIMS = (64, 128)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_INT32_MAX = 2**31 - 1


def resolve_attention_scale(scale, head_dim) -> float:
    """The default-scale rule: None -> 1/sqrt(head_dim)."""
    return float(scale) if scale is not None else 1.0 / math.sqrt(head_dim)


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
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * sc
    if causal:
        qpos = q_offset + torch.arange(q.shape[1], device=q.device)
        kpos = k_offset + torch.arange(k.shape[1], device=q.device)
        s = s.masked_fill(kpos[None, None, :] > qpos[None, :, None],
                          _NEG_INF)
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


def _launch(q, k, v, sc, causal, q_offset, k_offset):
    if q.dtype not in _DTYPE_CODES or not (q.dtype == k.dtype == v.dtype):
        raise TypeError(f"flash_attention kernel takes float32 or bfloat16 "
                        f"q/k/v of one dtype, got {q.dtype}, {k.dtype}, "
                        f"{v.dtype}")
    bh, lq, d = q.shape
    lk = k.shape[1]
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention kernel supports head_dim in "
                         f"{HEAD_DIMS}, got {d}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte "
                             "aligned")
    if (bh * (round_up(lq, BLOCK_Q) // BLOCK_Q) > _INT32_MAX
            or max(abs(q_offset), abs(k_offset)) > _INT32_MAX // 2):
        raise ValueError(f"grid or offsets exceed int32: bh={bh}, lq={lq}, "
                         f"offsets=({q_offset}, {k_offset})")
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
    masking. Returns (B, Lq, H, D) in q's dtype.
    """
    if (q.ndim != 4 or k.shape != v.shape or k.ndim != 4
            or q.shape[0] != k.shape[0] or q.shape[2:] != k.shape[2:]):
        raise ValueError(f"expected (B, L, H, D) q/k/v with shared B/H/D, "
                         f"got {tuple(q.shape)} {tuple(k.shape)} "
                         f"{tuple(v.shape)}")
    b, _, h, _ = q.shape
    o, _ = flash_attention_fwd(_flat(q), _flat(k), _flat(v), causal=causal,
                               scale=scale, q_offset=q_offset,
                               k_offset=k_offset)
    return _unflat(o, b, h)
