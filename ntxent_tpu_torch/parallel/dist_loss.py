"""Data-parallel NT-Xent and InfoNCE over ``torch.distributed``,
counterpart of the strip schedule and of the dual InfoNCE of
``ntxent_tpu/parallel/dist_loss.py``; the pair schedule lives in
``parallel.pair``.

NT-Xent: every rank runs the encoder on its shard of the global batch,
all-gathers the embeddings of both views, computes only its local rows x
global columns strip of the similarity matrix with the fused kernels
(``ops.ntxent.ntxent_partial_fused``: the general forward, #1, and the
general backward, #6) and sums the partial losses over ranks. The
gradient of the gathered columns flows back through the all-gather as a
reduce-scatter (``parallel.mesh``).

The chunked schedule (``local_ntxent_chunked``, ``--dp-loss chunked``)
replaces the all-gather by a ring of hops sent in chunks, each chunk's
transfer overlapping the previous chunk's fold (``parallel.ring``).

InfoNCE (CLIP), two bodies (``resolve_local_infonce``):

* ``local_infonce_dual`` (``"dual"``): every rank gathers the text
  embeddings only, walks its image rows x global text columns block once
  for both softmax directions (``ops.infonce.info_nce_dual_partial``:
  #9's rectangular mode forward, #5's cross-modal mode and #4 backward),
  merges the column statistics across ranks with a ``pmax`` and a
  ``psum`` of an (N,) vector, and sums the partial losses over ranks;
* ``local_infonce_allgather`` (``"twopass"``): every rank gathers both
  modalities and computes each direction's local rows x global columns
  block on its own (``ops.infonce.info_nce_partial_fused``: #1 and #6 in
  their InfoNCE mode), then sums the two partial losses over ranks.

Unlike the JAX functions, which take the global (sharded) views inside a
``shard_map``, these take the rank's local views: a rank holds only its
shard.
"""

from __future__ import annotations

import functools

import torch

from ..ops.infonce import (
    info_nce_dual_partial,
    info_nce_partial_fused,
    resolve_scale,
)
from ..ops.ntxent import ntxent_partial_fused
from .mesh import all_gather, local_row_gids, psum, rank, world_size
from .pair import pair_body
from .ring import _ntxent_fused as ring_fused

__all__ = ["info_nce_loss_distributed", "local_infonce_allgather",
           "local_infonce_dual",
           "local_ntxent_allgather", "local_ntxent_chunked",
           "make_sharded_infonce", "make_sharded_ntxent",
           "ntxent_loss_distributed", "resolve_local_infonce",
           "resolve_local_ntxent"]

def local_ntxent_allgather(z1_local: torch.Tensor, z2_local: torch.Tensor,
                           temperature: float, group=None) -> torch.Tensor:
    """The global-batch NT-Xent mean loss from one rank's views (n, D)
    each (``dist_loss.py:68``): all-gather both views, the fused partial
    loss of the local rows against the global columns, ``psum`` over
    ranks, divided by 2N. Every rank returns the same value."""
    n_local = z1_local.shape[0]
    z_global = torch.cat([all_gather(z1_local, group),
                          all_gather(z2_local, group)])          # (2N, D)
    z_local = torch.cat([z1_local, z2_local])                    # (2n, D)
    gid = local_row_gids(rank(group), n_local, world_size(group),
                         z_local.device)
    loss_sum = ntxent_partial_fused(z_local, z_global, gid, temperature)
    return psum(loss_sum, group) / z_global.shape[0]


def local_ntxent_chunked(z1_local: torch.Tensor, z2_local: torch.Tensor,
                         temperature: float, group=None,
                         chunks: int | None = None) -> torch.Tensor:
    """The global-batch NT-Xent mean loss from one rank's views (n, D)
    each with the chunked ring-overlap schedule (``dist_loss.py:87``):
    the same loss as ``local_ntxent_allgather``, but the all-gather never
    happens. The rank's stacked block (2n, D) circulates around the ring
    as ``chunks`` slices of rows (``ops.autotune.resolve_ring_chunks``
    when None: clamped, cached or the heuristic, never measured); each
    chunk's onward send is issued before its fold, so the transfer
    overlaps the fold (``parallel.ring._RingLseSum``: ``block_lse``, #1,
    per chunk and hop; ``block_grads``, #6, per chunk and hop in the
    backward against the blocks the forward received, each chunk's column
    cotangent sent one hop back a hop, as JAX's AD transposes the
    forward's hops: (P - 1) 2n D a rank, on the wire and in memory). The
    visiting rows' global ids follow from the hop, so the forward sends
    exactly the strip loss's two all-gathers' bytes, (P - 1) 2n D
    itemsize a rank, each chunk on the wire policy by itself. Every rank
    returns the same value."""
    from ..ops.autotune import resolve_ring_chunks

    n_local, dim = z1_local.shape
    n_chunks = resolve_ring_chunks(2 * n_local, dim, world_size(group),
                                   z1_local.dtype, chunks=chunks)
    return ring_fused(z1_local, z2_local, temperature, group, n_chunks,
                      ad=True)


def resolve_local_ntxent(impl: str):
    """The per-rank NT-Xent body for an impl name (``dist_loss.py:199``):
    ``"strip"``, ``"pair"`` (``parallel.pair.pair_body``) or
    ``"chunked"`` (``local_ntxent_chunked``, which also takes a trailing
    ``chunks``), with the signature ``(z1_local, z2_local, temperature,
    group)``."""
    bodies = {"strip": local_ntxent_allgather, "pair": pair_body,
              "chunked": local_ntxent_chunked}
    try:
        return bodies[impl]
    except KeyError:
        raise ValueError(f"unknown NT-Xent impl {impl!r}") from None


def make_sharded_ntxent(group=None, temperature: float = 0.07,
                        impl: str = "strip", ring_chunks: int | None = None):
    """``loss_fn(z1_local, z2_local) -> scalar``: the global-batch NT-Xent
    over the ranks of ``group`` (``dist_loss.py:216``). ``ring_chunks``
    sets the chunk count of ``impl="chunked"`` (ignored by the others, as
    in JAX)."""
    extra = {"chunks": ring_chunks} if impl == "chunked" else {}
    return functools.partial(resolve_local_ntxent(impl),
                             temperature=float(temperature), group=group,
                             **extra)


def ntxent_loss_distributed(z1_local: torch.Tensor, z2_local: torch.Tensor,
                            group=None,
                            temperature: float = 0.07) -> torch.Tensor:
    """Global-batch canonical NT-Xent over the ranks of ``group`` (one-shot
    form, ``dist_loss.py:267``)."""
    return make_sharded_ntxent(group, temperature)(z1_local, z2_local)


def local_infonce_dual(za_local: torch.Tensor, zb_local: torch.Tensor,
                       scale: torch.Tensor, group=None) -> torch.Tensor:
    """The global-batch symmetric InfoNCE mean loss from one rank's pairs
    (n, D) each (``dist_loss.py:304``): all-gather ``zb`` only (its
    backward is the reduce-scatter of the gathered columns' gradient), the
    partial sum of this rank's rows with their global ids ``rank n + [0,
    n)``, ``psum`` over ranks, divided by 2N. ``scale`` (CLIP's learnable
    ``exp(logit_scale)``) is a differentiable tensor. Every rank returns
    the same value."""
    n_local = za_local.shape[0]
    zb_g = all_gather(zb_local, group)                            # (N, D)
    gid = rank(group) * n_local + torch.arange(
        n_local, dtype=torch.int32, device=za_local.device)
    part = info_nce_dual_partial(za_local, zb_g, gid, group, scale=scale)
    return psum(part, group) / (2 * zb_g.shape[0])


def local_infonce_allgather(za_local: torch.Tensor, zb_local: torch.Tensor,
                            scale: torch.Tensor,
                            group=None) -> torch.Tensor:
    """The global-batch symmetric InfoNCE mean loss from one rank's pairs
    (n, D) each, in two passes (``dist_loss.py:279``): all-gather both
    modalities (each gather's backward is the reduce-scatter of its
    gradient), the partial sum of this rank's za rows against the gathered
    zb and of its zb rows against the gathered za, both with the global
    ids ``rank n + [0, n)``, ``psum`` over ranks, divided by 2N. ``scale``
    (CLIP's learnable ``exp(logit_scale)``) is a differentiable tensor.
    Every rank returns the same value."""
    n_local = za_local.shape[0]
    za_g = all_gather(za_local, group)                            # (N, D)
    zb_g = all_gather(zb_local, group)
    gid = rank(group) * n_local + torch.arange(
        n_local, dtype=torch.int32, device=za_local.device)
    loss_a = info_nce_partial_fused(za_local, zb_g, gid, scale=scale)
    loss_b = info_nce_partial_fused(zb_local, za_g, gid, scale=scale)
    return psum(loss_a + loss_b, group) / (2 * za_g.shape[0])


def resolve_local_infonce(impl: str):
    """The per-rank InfoNCE body for an impl name (``dist_loss.py:326``):
    ``"dual"`` or ``"twopass"``, with the signature ``(za_local,
    zb_local, scale, group)``."""
    impls = {"dual": local_infonce_dual,
             "twopass": local_infonce_allgather}
    try:
        return impls[impl]
    except KeyError:
        raise ValueError(f"unknown InfoNCE impl {impl!r}; choose from "
                         f"{sorted(impls)}") from None


def make_sharded_infonce(group=None, impl: str = "dual"):
    """``loss_fn(za_local, zb_local, scale) -> scalar``: the global-batch
    InfoNCE over the ranks of ``group`` (``dist_loss.py:338``)."""
    return functools.partial(resolve_local_infonce(impl), group=group)


def info_nce_loss_distributed(za: torch.Tensor, zb: torch.Tensor,
                              group=None, temperature: float = 0.07, *,
                              scale=None) -> torch.Tensor:
    """Global-batch symmetric InfoNCE over the ranks of ``group`` (one-shot
    form, ``dist_loss.py:371``): this rank's pairs (n, D) each through
    ``make_sharded_infonce``'s dual body, at ``scale`` (a tensor or a
    float) or, without one, ``1 / temperature``."""
    return make_sharded_infonce(group)(
        za, zb, resolve_scale(temperature, scale, za.device))
