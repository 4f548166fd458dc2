"""Pair-parallel NT-Xent over ``torch.distributed``: the balanced
symmetric shard-pair schedule, counterpart of
``ntxent_tpu/parallel/pair.py`` (``--dp-loss pair``).

The global (2N, 2N) similarity matrix is symmetric, so the strip schedule
(``dist_loss.local_ntxent_allgather``: every rank its local rows x global
columns) forms every off-diagonal shard-pair tile twice across the world.
Here each unordered pair of shards {d, e} is walked once: rank d takes
the column shards (d + k) mod P for k = 0 .. floor((P - 1) / 2) and, for
even P, the antipodal k = P / 2, which both of its endpoints claim at
weight 1/2 (``+log 1/2`` in lse space). Per tile the dual kernels
(``ops.ntxent.block_lse_dual``, #7, and ``block_grads_dual``, #8) fold one
walk into both sides' statistics and gradients. The column statistics
merge over ranks with a ``pmax`` and a ``psum`` of a (2N,) vector in the
forward, the gradient contributions with one ``psum`` of a (2N, D) buffer
in the backward, at the forward's wire policy (quantized under int8). Positives stay local (each row's paired view lives on
the same rank) and are differentiated by autograd.

Unlike the JAX body, which takes the global views inside a
``shard_map``, ``pair_body`` takes the rank's local views, as
``dist_loss.local_ntxent_allgather`` does.
"""

from __future__ import annotations

import functools
import math

import torch

from ..ops.ntxent import block_grads_dual, block_lse_dual
from .mesh import all_gather, local_row_gids, pmax, psum, rank, world_size
from .precision import collective_dtype, collective_precision

__all__ = ["make_pair_ntxent", "ntxent_loss_pair", "pair_body",
           "rank_grad_buffer", "rank_lse_part"]

_NEG_INF = -1e30


def _tile_schedule(world: int) -> list[tuple[int, float]]:
    """(k, weight) of the column-shard offsets every rank walks: k = 0 is
    the self tile (its transpose is itself, folded once); 1 ..
    floor((P - 1) / 2) are full-weight pairs; for even P the antipodal
    k = P / 2 is claimed by both of its endpoints at weight 1/2."""
    ks = [(0, 1.0)]
    half = (world - 1) // 2
    ks += [(k, 1.0) for k in range(1, half + 1)]
    if world % 2 == 0 and world > 1:
        ks.append((world // 2, 0.5))
    return ks


def _tiles(z_g: torch.Tensor, d: int, world: int, two_n_local: int):
    """(k, weight, z_e, gid_e) of each tile rank d walks, from the
    gathered views ``z_g`` ([rank 0's (z1, z2); rank 1's; ...]); gid_e
    are shard e's global ids (``mesh.local_row_gids``)."""
    for k, w in _tile_schedule(world):
        e = (d + k) % world
        yield (k, w, z_g[e * two_n_local:(e + 1) * two_n_local],
               local_row_gids(e, two_n_local // 2, world, z_g.device))


def rank_lse_part(z_local: torch.Tensor, my_gid: torch.Tensor,
                  z_g: torch.Tensor, d: int, world: int,
                  temperature: float) -> torch.Tensor:
    """Rank d's (2N,) share of every global row's lse: its tiles' row and
    column statistics folded with logaddexp at their global ids, -1e30
    where it has none. The world's lse is the log-sum-exp of the shares
    over ranks (``pair_body`` merges them with a ``pmax`` and a
    ``psum``)."""
    two_n_local = z_local.shape[0]
    two_n = two_n_local * world
    lse_part = torch.full((two_n,), _NEG_INF, dtype=torch.float32,
                          device=z_local.device)
    mine = my_gid.long()
    for k, w, ze, gid_e in _tiles(z_g, d, world, two_n_local):
        lr, lc = block_lse_dual(z_local, ze, my_gid, gid_e, temperature,
                                two_n)
        if w != 1.0:  # weight in lse space: l w <=> lse + log w
            lr, lc = lr + math.log(w), lc + math.log(w)
        lse_part[mine] = torch.logaddexp(lse_part[mine], lr)
        if k != 0:
            # k = 0's transpose is the same tile: folding lc too would
            # count the self pair twice
            theirs = gid_e.long()
            lse_part[theirs] = torch.logaddexp(lse_part[theirs], lc)
    return lse_part


def rank_grad_buffer(z_local: torch.Tensor, my_gid: torch.Tensor,
                     z_g: torch.Tensor, d: int, world: int,
                     lse_all: torch.Tensor,
                     temperature: float) -> torch.Tensor:
    """Rank d's (2N, D) fp32 share of ``dS/dz * T`` for ``S`` the sum of
    every global row's lse: its tiles' row and column gradients at their
    global ids. The sum of the shares over ranks is the whole gradient."""
    two_n_local, dim = z_local.shape
    two_n = two_n_local * world
    buf = torch.zeros((two_n, dim), dtype=torch.float32,
                      device=z_local.device)
    mine = my_gid.long()
    for k, w, ze, gid_e in _tiles(z_g, d, world, two_n_local):
        theirs = gid_e.long()
        gr, gc = block_grads_dual(z_local, ze, my_gid, gid_e, lse_all[mine],
                                  lse_all[theirs], temperature, two_n)
        if k == 0:
            # the self tile's G holds both directions already (lse_rows ==
            # lse_cols there): gc would double it
            buf.index_add_(0, mine, gr)
        else:
            buf.index_add_(0, mine, w * gr)
            buf.index_add_(0, theirs, w * gc)
    return buf


class _PairLseSum(torch.autograd.Function):
    """``S = sum over the local rows of the GLOBAL lse`` with the pair
    schedule (the JAX ``custom_vjp`` of ``pair.py:80-161``). The forward
    all-gathers z inside the function (so autograd adds no reduce-scatter
    of its own), folds this rank's tiles and merges the shares over ranks;
    the backward ``psum``s the (2N, D) gradient buffer and keeps this
    rank's rows.

    INVARIANT (uniform cotangent): the backward scales the psum'd GLOBAL
    gradient buffer by this rank's own cotangent ``ct``, which is valid
    only when ``ct`` is the same on every rank. That holds for the one
    caller (``pair_body``: the loss is psum'd then divided by a global
    constant, so every rank gets the same scalar), and it is what makes
    the schedule work: tiles of rows owned by OTHER ranks are computed
    here and psum'd home, and a per-rank ``ct`` would have to travel with
    each tile's rows (an all-gather of P scalars) to stay right. Reused
    under a non-uniform cotangent, this backward must psum or gather the
    row owners' cotangents and scale the buffer's rows before the psum."""

    @staticmethod
    def forward(ctx, z_local, my_gid, temperature, group):
        world, d = world_size(group), rank(group)
        z_g = all_gather(z_local, group)
        lse_part = rank_lse_part(z_local, my_gid, z_g, d, world, temperature)
        m = pmax(lse_part, group)
        lse_all = m + torch.log(psum(torch.exp(lse_part - m), group))
        ctx.save_for_backward(z_local, my_gid, z_g, lse_all)
        ctx.temperature, ctx.group = temperature, group
        ctx.wire = collective_dtype()
        return lse_all[my_gid.long()].sum()

    @staticmethod
    def backward(ctx, ct):
        z_local, my_gid, z_g, lse_all = ctx.saved_tensors
        group = ctx.group
        buf = rank_grad_buffer(z_local, my_gid, z_g, rank(group),
                               world_size(group), lse_all, ctx.temperature)
        # the forward's wire policy: JAX traces this psum under it, and
        # autograd may run the backward on a thread of its own
        with collective_precision(ctx.wire):
            grad_full = psum(buf, group)
        grad = grad_full[my_gid.long()] * (ct.float() / ctx.temperature)
        return grad.to(z_local.dtype), None, None, None


def pair_body(z1_local: torch.Tensor, z2_local: torch.Tensor,
              temperature: float, group=None) -> torch.Tensor:
    """The global-batch NT-Xent mean loss from one rank's views (n, D)
    each, with the pair schedule (``pair.py:164``; the signature of
    ``dist_loss.local_ntxent_allgather``). Every rank returns the same
    value."""
    n_local = z1_local.shape[0]
    world = world_size(group)
    two_n = 2 * n_local * world
    z_local = torch.cat([z1_local, z2_local]).contiguous()
    my_gid = local_row_gids(rank(group), n_local, world, z_local.device)
    # The positives are local pairs; their gradient (the -E term of
    # d loss / d s) comes from autograd through this expression.
    pos = (z1_local * z2_local).sum(dim=-1, dtype=torch.float32) \
        * (1.0 / temperature)
    lse_sum = _PairLseSum.apply(z_local, my_gid, float(temperature), group)
    loss_sum = lse_sum - torch.cat([pos, pos]).sum()
    return psum(loss_sum, group) / two_n


def make_pair_ntxent(group=None, temperature: float = 0.07):
    """``loss_fn(z1_local, z2_local) -> scalar``: the pair-parallel
    global-batch NT-Xent over the ranks of ``group``
    (``pair.py:192``), the same contract as
    ``dist_loss.make_sharded_ntxent`` at about half the loss's products
    at large P."""
    return functools.partial(pair_body, temperature=float(temperature),
                             group=group)


def ntxent_loss_pair(z1_local: torch.Tensor, z2_local: torch.Tensor,
                     group=None, temperature: float = 0.07) -> torch.Tensor:
    """Global-batch canonical NT-Xent, pair-parallel (one-shot form,
    ``pair.py:217``)."""
    return make_pair_ntxent(group, temperature)(z1_local, z2_local)
