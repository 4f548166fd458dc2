"""Sequence parallelism for long sequences: ring attention and Ulysses
all-to-all attention, counterpart of ``ntxent_tpu/parallel/ring_attention.py``.

Shapes follow the towers: q, k, v are (B, L, H, D); under a plan over a
process group each rank holds the sequence shard (B, L/P, H, D) of rank
order, and the output is its shard of the result.

* **Ring attention** (``make_ring_attention``): Q stays home; (K, V)
  blocks circulate to rank + 1 while every rank folds each visiting block
  into online-softmax statistics (running max m, sum l, output acc) at
  the block's global positions. A hop's sends are issued before its fold,
  so the transfer overlaps the fold. The backward is a second ring pass in
  which (K, V) circulate with their (dK, dV) accumulators and arrive home
  carrying every rank's contribution. ``impl="jnp"`` folds in plain
  PyTorch (the JAX ``_fold``); ``impl="flash"`` runs one ``flash_fold``
  kernel (#12) a hop forward and ``flash_attention_dq`` (#13) and
  ``flash_attention_dkv`` (#14) a hop backward, at the hop's global
  offsets, from the saved global lse.
* **Ulysses** (``make_ulysses_attention``): one all-to-all re-shards from
  sequence-split to head-split, attention runs locally and exactly, a
  second all-to-all re-shards back. Needs H % P == 0.

A rank knows which rank a visiting block left from its hop count, so
the global positions of a block are computed where the JAX ring sends
them along: a hop carries only (K, V) and, backward, (dK, dV). The
forward makes P - 1 hops (the JAX ring's P-th hop only brings the blocks
home); the backward makes P - 1 hops of (K, V) and P of (dK, dV).

Both plans carry their process group as the function's ``group``
attribute, which ``models.long_context`` reads to place a rank's token
shard at its global positions. Without an initialized process group a
plan runs as a world of one.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..ops.attention import (
    BLOCK_Q,
    _bwd_probs,
    _flat,
    _scores,
    _unflat,
    flash_attention_dkv,
    flash_attention_dq,
    flash_fold,
    resolve_attention_scale,
)
from ..ops.ntxent import _exp0, _log_l
from .mesh import all_to_all, ppermute_start, rank, world_size

__all__ = ["attention_oracle", "blockwise_attention", "make_ring_attention",
           "make_ulysses_attention"]

_NEG_INF = -1e30


def attention_oracle(q, k, v, *, causal: bool = False, scale=None,
                     q_offset: int = 0, k_offset: int = 0):
    """Full-softmax attention in plain PyTorch (fp32 scores and softmax),
    the reference the parallel forms are held to. q, k, v: (B, L, H, D);
    returns q's dtype."""
    b, _, h, d = q.shape
    s = _scores(_flat(q), _flat(k), resolve_attention_scale(scale, d),
                causal, q_offset, k_offset)
    p = torch.softmax(s, dim=-1)
    return _unflat(torch.matmul(p.to(v.dtype), _flat(v)), b, h).to(q.dtype)


def _fold(qf, kf, vf, q_off: int, k_off: int, m, l, acc, sc, causal):
    """Fold one (K, V) block into the online-softmax statistics
    (``ring_attention.py:115``), flat layout: qf (BH, Lq, D) fp32, kf/vf
    (BH, Lk, D); m, l (BH, Lq), acc (BH, Lq, D) fp32. Entries of a wholly
    masked row weigh 0."""
    s = _scores(qf, kf, sc, causal, q_off, k_off)
    m_new = torch.maximum(m, s.amax(dim=-1))
    p = torch.where(s <= _NEG_INF * 0.5, 0.0, _exp0(s - m_new[..., None]))
    alpha = _exp0(m - m_new)
    l = l * alpha + p.sum(dim=-1)
    acc = acc * alpha[..., None] + torch.matmul(p, vf.float())
    return m_new, l, acc


def _init_stats(bh: int, lq: int, d: int, device):
    return (torch.full((bh, lq), _NEG_INF, device=device),
            torch.zeros((bh, lq), device=device),
            torch.zeros((bh, lq, d), device=device))


def blockwise_attention(q, k, v, *, block_kv: int | None = None,
                        causal: bool = False, scale=None):
    """Single-device flash-style attention: a loop over K/V blocks of
    ``block_kv`` keys (default: one block) folded into online-softmax
    statistics; never forms the (L, L) matrix of more than one block.
    The same function as ``attention_oracle``. L must divide by
    ``block_kv``."""
    b, lq, h, d = q.shape
    lk = k.shape[1]
    block = block_kv or lk
    if lk % block:
        raise ValueError(f"sequence {lk} not divisible by block {block}")
    sc = resolve_attention_scale(scale, d)
    qf, kf, vf = _flat(q).float(), _flat(k), _flat(v)
    m, l, acc = _init_stats(b * h, lq, d, q.device)
    for j in range(0, lk, block):
        m, l, acc = _fold(qf, kf[:, j:j + block], vf[:, j:j + block], 0, j,
                          m, l, acc, sc, causal)
    return _unflat(acc / l[..., None], b, h).to(q.dtype)


# ---------------------------------------------------------------------------
# Ring attention
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class _Ring:
    """One rank's view of the ring: the group, its size and this rank,
    the masking and scale, the impl and the chunks of a hop."""

    group: object
    size: int
    rank: int
    causal: bool
    scale: float
    impl: str
    chunks: int

    def source(self, hop: int) -> int:
        """The rank whose block this rank holds after ``hop`` hops."""
        return (self.rank - hop) % self.size


def _hop(ring: _Ring, tensors):
    """Issue one hop to rank + 1 of every tensor, each as ``ring.chunks``
    sends along the sequence (dim 1); ``wait()`` on the handle returns
    the tensors that arrived."""
    return ppermute_start(tensors, 1, ring.group, chunks=ring.chunks, dim=1)


def hop_fold(ring: _Ring, qf, kf, vf, q_off: int, k_off: int, stats):
    """Fold one visiting block into this rank's statistics: the
    ``flash_fold`` kernel (#12) or the plain ``_fold``."""
    m, l, acc = stats
    if ring.impl == "flash":
        return flash_fold(qf, kf, vf, m, l, acc, q_offset=q_off,
                          k_offset=k_off, scale=ring.scale,
                          causal=ring.causal)
    return _fold(qf.float(), kf, vf, q_off, k_off, m, l, acc, ring.scale,
                 ring.causal)


def ring_output(stats, dtype):
    """(out, lse) of the folded statistics, flat: ``out = acc / l``
    (l == 0 -> 1) in ``dtype`` and ``lse = m + log(max(l, 1e-37))``."""
    m, l, acc = stats
    l_safe = torch.where(l == 0.0, 1.0, l)
    return (acc / l_safe[..., None]).to(dtype), m + _log_l(l)


def hop_grads(ring: _Ring, qf, kf, vf, dof, lse, delta, q_off: int,
              k_off: int):
    """(dq, dk, dv) contributions in fp32 of one visiting block: the dQ
    (#13) and dK/dV (#14) kernels at the hop's offsets, or the plain
    second-pass step of ``ring_attention.py:257-270``."""
    kw = dict(causal=ring.causal, scale=ring.scale, q_offset=q_off,
              k_offset=k_off)
    if ring.impl == "flash":
        dq = flash_attention_dq(qf, kf, vf, dof, lse, delta, **kw)
        dk, dv = flash_attention_dkv(qf, kf, vf, dof, lse, delta, **kw)
        return dq, dk, dv
    p, ds = _bwd_probs(qf, kf, vf, dof, lse, delta, ring.scale, ring.causal,
                       q_off, k_off)
    return (torch.matmul(ds, kf.float()),
            torch.matmul(ds.transpose(-1, -2), qf.float()),
            torch.matmul(p.transpose(-1, -2), dof.float()))


class _RingAttention(torch.autograd.Function):
    """One rank's ring attention (``_ring_attention``/
    ``_ring_attention_flash``, ``ring_attention.py:190-391``) on the flat
    (BH, L/P, D) layout."""

    @staticmethod
    def forward(ctx, qf, kf, vf, ring):
        l_loc = qf.shape[1]
        q_off = ring.rank * l_loc
        stats = _init_stats(qf.shape[0], l_loc, qf.shape[2], qf.device)
        block = (kf, vf)
        for hop in range(ring.size):
            # the next hop's sends go out before this hop's fold
            pending = (_hop(ring, block) if hop < ring.size - 1
                       else None)
            stats = hop_fold(ring, qf, *block, q_off,
                             ring.source(hop) * l_loc, stats)
            if pending is not None:
                block = pending.wait()
        out, lse = ring_output(stats, qf.dtype)
        ctx.save_for_backward(qf, kf, vf, out, lse)
        ctx.ring = ring
        return out

    @staticmethod
    def backward(ctx, g):
        qf, kf, vf, out, lse = ctx.saved_tensors
        ring = ctx.ring
        l_loc = qf.shape[1]
        q_off = ring.rank * l_loc
        dof = g.contiguous().to(qf.dtype)
        delta = torch.sum(dof.float() * out.float(), dim=-1)
        dq = torch.zeros(qf.shape, dtype=torch.float32, device=qf.device)
        dk = torch.zeros(kf.shape, dtype=torch.float32, device=qf.device)
        dv = torch.zeros_like(dk)
        block = (kf, vf)
        for hop in range(ring.size):
            pending = (_hop(ring, block) if hop < ring.size - 1
                       else None)
            dq_c, dk_c, dv_c = hop_grads(ring, qf, *block, dof, lse, delta,
                                         q_off, ring.source(hop) * l_loc)
            dq += dq_c
            # (dK, dV) ride with their block: after the P-th hop they are
            # home, holding every rank's contribution
            dk, dv = _hop(ring, (dk + dk_c, dv + dv_c)).wait()
            if pending is not None:
                block = pending.wait()
        return dq.to(qf.dtype), dk.to(kf.dtype), dv.to(vf.dtype), None


def _check_blocks(block_q, block_kv) -> None:
    """The port's attention kernels have one tile, 64 rows by 64 keys."""
    for name, value in (("block_q", block_q), ("block_kv", block_kv)):
        if value not in (None, BLOCK_Q):
            raise ValueError(f"{name}={value}: the port's attention kernels "
                             f"have one tile of {BLOCK_Q} rows (None or "
                             f"{BLOCK_Q})")


def make_ring_attention(group=None, *, causal: bool = False, scale=None,
                        impl: str = "jnp", block_q: int | None = None,
                        block_kv: int | None = None,
                        transfer_chunks: int | None = None):
    """Sequence-parallel ring attention over the ranks of ``group``.

    Returns ``fn(q, k, v) -> out``, each (B, L/P, H, D): this rank's
    shard of the sequence, in rank order. ``causal`` masks with GLOBAL
    positions, so the ranks' outputs are the shards of full attention
    over the whole sequence. Differentiable in q, k and v through the
    second ring pass.

    ``impl="jnp"`` folds hops in plain PyTorch; ``impl="flash"`` runs the
    ``flash_fold`` kernel (#12) a hop forward and the dQ (#13) and dK/dV
    (#14) kernels a hop backward on CUDA tensors (their plain versions on
    the CPU). The kernels have one 64-row tile: ``block_q``/``block_kv``
    take None or 64 and nothing else; the jnp fold has no tiles and takes
    neither. ``transfer_chunks`` splits each hop into that many sends
    along the sequence (the same bytes, one recorded call each).
    """
    if impl not in ("jnp", "flash"):
        raise ValueError(f"unknown ring attention impl {impl!r}")
    if impl != "flash" and (block_q is not None or block_kv is not None):
        raise ValueError("block_q/block_kv tune the flash kernels; the "
                         "jnp fold has no tiles — they would be silently "
                         "ignored")
    _check_blocks(block_q, block_kv)
    chunks = max(int(transfer_chunks or 1), 1)

    def ring_attention(q, k, v):
        if q.ndim != 4 or k.shape != q.shape or v.shape != q.shape:
            raise ValueError(f"expected (B, L/P, H, D) q/k/v of one shape, "
                             f"got {tuple(q.shape)} {tuple(k.shape)} "
                             f"{tuple(v.shape)}")
        b, _, h, d = q.shape
        ring = _Ring(group, world_size(group), rank(group), bool(causal),
                     resolve_attention_scale(scale, d), impl, chunks)
        out = _RingAttention.apply(_flat(q), _flat(k), _flat(v), ring)
        return _unflat(out, b, h)

    ring_attention.group = group
    return ring_attention


# ---------------------------------------------------------------------------
# Ulysses (all-to-all head parallelism)
# ---------------------------------------------------------------------------


def make_ulysses_attention(group=None, *, causal: bool = False, scale=None,
                           block_kv: int | None = None):
    """All-to-all sequence-parallel attention over the ranks of ``group``.

    Input and output (B, L/P, H, D), this rank's sequence shard. One
    ``all_to_all`` re-shards to (B, L, H/P, D) (the whole sequence, a
    slice of the heads), attention runs locally (``blockwise_attention``
    when ``block_kv`` is set, else ``attention_oracle``), and a second
    all-to-all restores the sequence sharding. H % P == 0. Gradients flow
    through the collectives (the reverse all-to-all)."""

    def ulysses_attention(q, k, v):
        p, h = world_size(group), q.shape[2]
        if h % p:
            raise ValueError(f"Ulysses needs heads ({h}) divisible by the "
                             f"group's size ({p}); use make_ring_attention "
                             "instead")

        def to_heads(x):  # (B, L/P, H, D) -> (B, L, H/P, D)
            return all_to_all(x, split_dim=2, concat_dim=1, group=group)

        qh, kh, vh = to_heads(q), to_heads(k), to_heads(v)
        if block_kv:
            oh = blockwise_attention(qh, kh, vh, block_kv=block_kv,
                                     causal=causal, scale=scale)
        else:
            oh = attention_oracle(qh, kh, vh, causal=causal, scale=scale)
        return all_to_all(oh, split_dim=1, concat_dim=2, group=group)

    ulysses_attention.group = group
    return ulysses_attention
