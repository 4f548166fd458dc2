"""Ring NT-Xent and ring InfoNCE, counterpart of
``ntxent_tpu/parallel/ring.py``.

The quadratic object of a contrastive loss is the similarity matrix of the
global batch. The ring never gathers it: each rank's embedding block
circulates to rank + 1 while every rank folds each visiting block into
online-softmax statistics (running max m, sum l) of its local rows. After
P - 1 hops every rank has seen all 2N columns: memory O(N/P) a rank, and
only neighbour links carry traffic.

* ``make_ring_ntxent(group, temperature, impl)``: ``"jnp"`` folds in plain
  PyTorch and differentiates through the hops (the backward of a hop is
  the reverse hop, so the backward is a reverse ring); ``"fused"`` folds
  each visiting block with ``ops.ntxent.block_lse`` (#1 in its general
  mode) and runs the custom second ring pass of ``_make_ring_lse_sum``
  (``ring.py:101``) with ``block_grads`` (#6): the row gradient
  accumulates at home while the column gradient of each visiting block
  circulates home with it. ``"auto"`` takes ``"fused"`` for CUDA tensors
  and ``"jnp"`` on the CPU. ``chunks`` sends each hop as that many slices
  of rows, each slice's onward send issued before its fold (the chunked
  schedule of ``--dp-loss chunked``, ``dist_loss.local_ntxent_chunked``,
  whose backward is JAX AD's transpose of the forward's hops instead of
  a second ring pass: #6 against the blocks the forward received, each
  chunk's column cotangent one hop back a hop, (P - 1) 2n D a rank on
  the wire, at full precision under int8).
  Every hop rides the wire policy (``parallel.precision``) of the
  forward.
* ``make_ring_infonce(group, impl)``: ``"dual"`` circulates one block
  and its column statistics and folds each tile into both softmax
  directions; ``"twoblock"`` circulates both modalities' blocks. Plain
  PyTorch, as in JAX.

The functions take this rank's views (n, D) and return the global mean
loss on every rank. A visiting block's global row ids follow from the
hop count, so a hop carries the block alone where the JAX ring sends the
ids along. Gradients follow the port's convention for a ``psum``'d loss
(``parallel.mesh``): a rank's gradient of its shard is P times its share
of the global gradient. The final ``psum`` needs an initialized process
group, a world of one included.
"""

from __future__ import annotations

import torch

from ..ops.infonce import resolve_scale
from ..ops.ntxent import _exp0, _log_l, block_grads, block_lse
from .mesh import (
    chunk_bounds,
    local_row_gids,
    ppermute,
    ppermute_start,
    psum,
    rank,
    transpose_wire,
    world_size,
)
from .precision import collective_dtype

__all__ = ["info_nce_loss_ring", "make_ring_infonce", "make_ring_ntxent",
           "ntxent_loss_ring"]

_NEG_INF = -1e30


def _stats(rows: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    return (torch.full((rows,), _NEG_INF, device=device),
            torch.zeros((rows,), device=device))


def _ring_gids(group, n_local: int, device):
    """(P, this rank, ids of a rank's rows): ``ids(r)`` are the global ids
    of rank r's stacked views."""
    p, r = world_size(group), rank(group)

    def ids(src: int) -> torch.Tensor:
        return local_row_gids(src, n_local, p, device)

    return p, r, ids


def _ntxent_jnp(z1, z2, temperature: float, group, chunks: int = 1):
    """``_ring_body`` (``ring.py:46``): plain folds, gradients through the
    hops. Each hop sends the block as ``chunks`` slices of rows, chunk c's
    onward send issued before chunk c is folded (the chunked schedule of
    ``dist_loss.py:161-175``)."""
    n_local = z1.shape[0]
    p, r, ids = _ring_gids(group, n_local, z1.device)
    two_n = 2 * n_local * p
    inv_t = 1.0 / temperature
    z_local = torch.cat([z1, z2])
    my_gid = ids(r)
    pos = (z1.float() * z2.float()).sum(dim=-1) * inv_t
    pos = torch.cat([pos, pos])
    bounds = chunk_bounds(z_local.shape[0], chunks)

    def fold(block, block_gid, m, l):
        s = (z_local.float() @ block.float().T) * inv_t
        s = s.masked_fill(my_gid[:, None] == block_gid[None, :], _NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=1))
        l = l * torch.exp(m - m_new) + _exp0(s - m_new[:, None]).sum(dim=1)
        return m_new, l

    m, l = _stats(z_local.shape[0], z1.device)
    blocks = [z_local[lo:hi] for lo, hi in bounds]
    for hop in range(p):
        gid = ids((r - hop) % p)
        sent = []
        for (lo, hi), block in zip(bounds, blocks):
            if hop < p - 1:
                sent.append(ppermute(block, 1, group))
            m, l = fold(block, gid[lo:hi], m, l)
        blocks = sent
    loss_sum = (m + _log_l(l) - pos).sum()
    return psum(loss_sum, group) / two_n


def lse_hop(z_local, block, my_gid, block_gid, temperature: float,
            total: int, stats):
    """Fold one visiting block into this rank's rows' (m, l): the rows'
    lse over the block's columns (``block_lse``, #1), merged online."""
    m, l = stats
    lse_k = block_lse(z_local, block, my_gid, block_gid, temperature, total)
    m_new = torch.maximum(m, lse_k)
    return m_new, l * torch.exp(m - m_new) + torch.exp(lse_k - m_new)


def lse_sum_grad(grows, gblk, ct, temperature: float, dtype):
    """The gradient of ``S`` for this rank's rows: the summed row
    gradients of its hops and its block's column gradients, home from
    every rank, times the cotangent over the temperature."""
    return ((grows + gblk) * (ct.float() / temperature)).to(dtype)


def rank_loss_sum(z1, z2, temperature: float, lse_sum):
    """This rank's part of the summed loss: the lse of its 2n rows less
    their positives, each pair's similarity counted in both its rows."""
    pos = (z1.float() * z2.float()).sum(dim=-1) * (1.0 / temperature)
    return lse_sum - 2.0 * pos.sum()


class _RingLseSum(torch.autograd.Function):
    """``S = sum_i lse_i`` over this rank's rows, the lse accumulated around
    the ring by ``block_lse`` (#1), its backward by ``block_grads`` (#6).

    Each hop sends the block as ``chunks`` slices of rows, chunk c's
    onward send issued before chunk c is folded, so its transfer overlaps
    the fold (``dist_loss.py:161-175``). The sends ride the wire policy of
    the forward (``collective_dtype()`` read there). Two backwards:

    * ``ad=False``, the ring NT-Xent's custom backward
      (``_make_ring_lse_sum``, ``ring.py:101``): a second ring pass sends
      the blocks again (the same quantize chain gives the blocks the
      forward folded, bit for bit) and the column gradient of each block
      rides home with it; the JAX shims record these hops, and they run
      on the policy;
    * ``ad=True``, JAX's AD of the chunked loss (``dist_loss.py:87-117``):
      the forward keeps the P - 1 blocks it received, as it folded them
      (after the wire's quantize and dequantize), (P - 1) 2n D of memory
      a rank; the backward folds each (hop, chunk) against them in reverse
      hop order and sends each chunk's column cotangent one hop back
      (rank r to r - 1) per hop, adding its own, the transpose of the
      forward's hops: (P - 1) 2n D a rank on the wire, recorded nowhere,
      on the hops' transpose wire (full precision under int8, the
      straight-through estimator)."""

    @staticmethod
    def forward(ctx, z_local, temperature, group, n_local, chunks=1,
                ad=False):
        wire = collective_dtype()
        p, r, ids = _ring_gids(group, n_local, z_local.device)
        total, my_gid = z_local.shape[0] * p, ids(r)
        bounds = chunk_bounds(z_local.shape[0], chunks)
        stats = _stats(z_local.shape[0], z_local.device)
        blocks = [z_local[lo:hi] for lo, hi in bounds]
        received = []  # under ad: the P - 1 hops' blocks, chunk by chunk
        for hop in range(p):
            gid = ids((r - hop) % p)
            sent = []
            for (lo, hi), block in zip(bounds, blocks):
                # the chunk's onward send goes out before its fold
                if hop < p - 1:
                    sent.append(ppermute_start([block], 1, group, wire=wire))
                stats = lse_hop(z_local, block, my_gid, gid[lo:hi],
                                temperature, total, stats)
            blocks = [h.wait()[0] for h in sent]
            if ad and blocks:
                received += blocks
        lse = stats[0] + _log_l(stats[1])
        ctx.save_for_backward(z_local, lse, *received)
        ctx.args = (temperature, group, n_local, bounds, ad, wire)
        return lse.sum()

    @staticmethod
    def backward(ctx, ct):
        z_local, lse, *received = ctx.saved_tensors
        temperature, group, n_local, bounds, ad, wire = ctx.args
        p, r, ids = _ring_gids(group, n_local, z_local.device)
        total, my_gid = z_local.shape[0] * p, ids(r)
        grows = torch.zeros(z_local.shape, dtype=torch.float32,
                            device=z_local.device)
        if ad:
            gblk = _transposed_hops(z_local, received, lse, my_gid, ids,
                                    bounds, temperature, total, group,
                                    transpose_wire(wire), grows)
        else:
            gblk = _second_pass(z_local, lse, my_gid, ids, bounds,
                                temperature, total, group, wire, grows)
        return (lse_sum_grad(grows, gblk, ct, temperature, z_local.dtype),
                None, None, None, None, None)


def _second_pass(z_local, lse, my_gid, ids, bounds, temperature, total,
                 group, wire, grows):
    """``ad=False``: the blocks go round again, each chunk's column
    gradient riding with it; after P hops it is home, holding every
    rank's contribution. Adds the row gradients into ``grows``; returns
    the column gradient of this rank's block."""
    p, r = world_size(group), rank(group)
    gcols = [grows.new_zeros((hi - lo, z_local.shape[1]))
             for lo, hi in bounds]
    blocks = [z_local[lo:hi] for lo, hi in bounds]
    for hop in range(p):
        gid = ids((r - hop) % p)
        sent = []
        for c, ((lo, hi), block) in enumerate(zip(bounds, blocks)):
            if hop < p - 1:
                sent.append(ppermute_start([block], 1, group, wire=wire))
            gr_k, gc_k = block_grads(z_local, block, my_gid, gid[lo:hi], lse,
                                     temperature, total)
            grows += gr_k
            gcols[c] = gcols[c] + gc_k
        gcols = ppermute_start(gcols, 1, group, wire=wire).wait()
        blocks = [h.wait()[0] for h in sent]
    return torch.cat(gcols) if len(gcols) > 1 else gcols[0]


def _transposed_hops(z_local, received, lse, my_gid, ids, bounds,
                     temperature, total, group, col_wire, grows):
    """``ad=True``: the scan's transpose. Hop h's block came from rank
    r - h; its chunk c's cotangent is this rank's column gradient of the
    fold plus what arrives from rank r + 1 (the cotangent of the block it
    forwarded), sent on to rank r - 1 until hop 0, where it is this
    rank's own. Each chunk's send goes out before the next chunk's fold.
    Adds the row gradients into ``grows``; returns the column gradient of
    this rank's block."""
    p, r = world_size(group), rank(group)
    n_chunks = len(bounds)
    carry, inflight = None, []
    for hop in reversed(range(p)):
        gid = ids((r - hop) % p)
        blocks = (received[(hop - 1) * n_chunks:hop * n_chunks] if hop
                  else [z_local[lo:hi] for lo, hi in bounds])
        nxt = []
        for c, ((lo, hi), block) in enumerate(zip(bounds, blocks)):
            gr_k, gc_k = block_grads(z_local, block, my_gid, gid[lo:hi], lse,
                                     temperature, total)
            grows += gr_k
            if inflight:
                gc_k = inflight[c].wait()[0] + gc_k
            if hop:
                nxt.append(ppermute_start([gc_k], -1, group, record=False,
                                          wire=col_wire))
            else:
                nxt.append(gc_k)
        if hop:
            inflight = nxt
        else:
            carry = nxt
    return torch.cat(carry) if len(carry) > 1 else carry[0]


def _ntxent_fused(z1, z2, temperature: float, group, chunks: int = 1,
                  ad: bool = False):
    """``_ring_body_fused`` (``ring.py:181``): the lse part through the
    custom ring (``_RingLseSum``, ``chunks`` slices a hop; ``ad`` as
    there), the device-local positives through autograd."""
    n_local = z1.shape[0]
    two_n = 2 * n_local * world_size(group)
    lse_sum = _RingLseSum.apply(torch.cat([z1, z2]).contiguous(),
                                float(temperature), group, n_local,
                                int(chunks), ad)
    return psum(rank_loss_sum(z1, z2, temperature, lse_sum), group) / two_n


def make_ring_ntxent(group=None, temperature: float = 0.07,
                     impl: str = "auto", chunks: int = 1):
    """The ring NT-Xent over the ranks of ``group``: ``fn(z1_local,
    z2_local) -> global mean loss``, the views (n, D) of this rank.

    ``impl``: ``"fused"`` folds with the block kernels and runs the custom
    second ring pass; ``"jnp"`` folds in plain PyTorch with gradients
    through the hops; ``"auto"`` takes ``"fused"`` for CUDA tensors and
    ``"jnp"`` on the CPU. ``chunks``: the slices of rows a hop sends
    (``mesh.chunk_bounds``)."""
    if impl not in ("auto", "fused", "jnp"):
        raise ValueError(f"impl must be 'auto', 'fused' or 'jnp', got "
                         f"{impl!r}")
    t = float(temperature)

    def ring_ntxent(z1_local, z2_local):
        chosen = impl
        if impl == "auto":
            chosen = "fused" if z1_local.device.type == "cuda" else "jnp"
        body = _ntxent_fused if chosen == "fused" else _ntxent_jnp
        return body(z1_local, z2_local, t, group, chunks)

    return ring_ntxent


def ntxent_loss_ring(z1: torch.Tensor, z2: torch.Tensor, group=None,
                     temperature: float = 0.07,
                     impl: str = "auto") -> torch.Tensor:
    """Global-batch NT-Xent of this rank's views without gathering the
    global batch."""
    return make_ring_ntxent(group, temperature, impl)(z1, z2)


def _fold_rows(rows, blk, scale, m, l):
    """Fold the tile ``scale * rows @ blk^T`` into the rows' (m, l); the
    scale multiplies the fp32 product, so blocks travel in their dtype."""
    s = (rows.float() @ blk.float().T) * scale
    m_new = torch.maximum(m, s.amax(dim=1))
    l = l * torch.exp(m - m_new) + _exp0(s - m_new[:, None]).sum(dim=1)
    return m_new, l, s


def _infonce_twoblock(za, zb, scale, group):
    """``_infonce_ring_body`` (``ring.py:263``): both modalities' blocks
    circulate; each rank folds the visiting zb into its za rows and the
    visiting za into its zb rows."""
    n_local = za.shape[0]
    p = world_size(group)
    pos = (za.float() * zb.float()).sum(dim=-1) * scale
    m_a, l_a = _stats(n_local, za.device)
    m_b, l_b = _stats(n_local, za.device)
    za_blk, zb_blk = za, zb
    for hop in range(p):
        m_a, l_a, _ = _fold_rows(za, zb_blk, scale, m_a, l_a)
        m_b, l_b, _ = _fold_rows(zb, za_blk, scale, m_b, l_b)
        if hop < p - 1:
            za_blk = ppermute(za_blk, 1, group)
            zb_blk = ppermute(zb_blk, 1, group)
    loss_sum = ((m_a + _log_l(l_a) - pos).sum()
                + (m_b + _log_l(l_b) - pos).sum())
    return psum(loss_sum, group) / (2 * n_local * p)


def _infonce_dual(za, zb, scale, group):
    """``_infonce_ring_dual_body`` (``ring.py:318``): only the zb blocks
    circulate, each with its running column statistics; every tile is
    folded into the local rows and, transposed, into the visiting block's
    columns; a last stats-only hop takes each block's column statistics
    home."""
    n_local = za.shape[0]
    p = world_size(group)
    pos = (za.float() * zb.float()).sum(dim=-1) * scale
    m_a, l_a = _stats(n_local, za.device)
    m_blk, l_blk = _stats(n_local, za.device)
    zb_blk = zb
    for hop in range(p):
        m_a, l_a, s = _fold_rows(za, zb_blk, scale, m_a, l_a)
        st = s.T
        m_bn = torch.maximum(m_blk, st.amax(dim=1))
        l_blk = l_blk * torch.exp(m_blk - m_bn) + _exp0(
            st - m_bn[:, None]).sum(dim=1)
        m_blk = m_bn
        if hop < p - 1:
            zb_blk, m_blk, l_blk = (ppermute(t, 1, group)
                                    for t in (zb_blk, m_blk, l_blk))
    # the block is one hop short of home: send its finished statistics
    m_blk, l_blk = (ppermute(t, 1, group) for t in (m_blk, l_blk))
    loss_sum = ((m_a + _log_l(l_a) - pos).sum()
                + (m_blk + _log_l(l_blk) - pos).sum())
    return psum(loss_sum, group) / (2 * n_local * p)


def make_ring_infonce(group=None, impl: str = "dual"):
    """The ring InfoNCE over the ranks of ``group``: ``fn(za_local,
    zb_local, scale) -> global mean loss`` (``scale`` a float or a tensor,
    e.g. CLIP's learnable logit scale). ``impl="dual"`` circulates one
    block a hop; ``"twoblock"`` both."""
    if impl not in ("dual", "twoblock"):
        raise ValueError(f"unknown ring impl {impl!r}")
    body = _infonce_dual if impl == "dual" else _infonce_twoblock

    def ring_infonce(za_local, zb_local, scale):
        return body(za_local, zb_local,
                    resolve_scale(0.07, scale, za_local.device), group)

    return ring_infonce


def info_nce_loss_ring(za: torch.Tensor, zb: torch.Tensor, group=None,
                       temperature: float = 0.07, *, scale=None,
                       impl: str = "dual") -> torch.Tensor:
    """Global-batch InfoNCE of this rank's pairs without gathering the
    global batch; ``scale`` (1/T) defaults to ``1 / temperature``."""
    return make_ring_infonce(group, impl)(
        za, zb, resolve_scale(temperature, scale, za.device))
