"""Data-parallel NT-Xent and InfoNCE over ``torch.distributed``,
counterpart of the strip schedule and of the dual InfoNCE of
``ntxent_tpu/parallel/dist_loss.py``.

NT-Xent: every rank runs the encoder on its shard of the global batch,
all-gathers the embeddings of both views, computes only its local rows x
global columns strip of the similarity matrix with the fused kernels
(``ops.ntxent.ntxent_partial_fused``: the general forward, #1, and the
general backward, #6) and sums the partial losses over ranks. The
gradient of the gathered columns flows back through the all-gather as a
reduce-scatter (``parallel.mesh``).

InfoNCE (CLIP, ``local_infonce_dual``): every rank gathers the text
embeddings only, walks its image rows x global text columns block once
for both softmax directions (``ops.infonce.info_nce_dual_partial``: #9's
rectangular mode forward, #5's cross-modal mode and #4 backward), merges
the column statistics across ranks with a ``pmax`` and a ``psum`` of an
(N,) vector, and sums the partial losses over ranks.

Unlike the JAX functions, which take the global (sharded) views inside a
``shard_map``, these take the rank's local views: a rank holds only its
shard.
"""

from __future__ import annotations

import functools

import torch

from ..ops.infonce import info_nce_dual_partial
from ..ops.ntxent import ntxent_partial_fused
from .mesh import all_gather, local_row_gids, psum, rank, world_size

__all__ = ["local_infonce_dual", "local_ntxent_allgather",
           "make_sharded_infonce", "make_sharded_ntxent",
           "ntxent_loss_distributed", "resolve_local_infonce",
           "resolve_local_ntxent"]

# The other schedules of ``--dp-loss``, by the ROADMAP.md item that ports
# them.
NOT_PORTED = {
    "pair": "ROADMAP.md Queue A 4 (pair and triangular loss schedules: "
            "kernels #7 and #8)",
    "chunked": "ROADMAP.md Queue A 3(d) (--dp-loss chunked, the "
               "ring-overlap schedule)",
}
# The InfoNCE impls beside "dual", by the ROADMAP.md item that ports them.
INFONCE_NOT_PORTED = {
    "twopass": "ROADMAP.md Queue A 3(f) (local_infonce_allgather: "
               "info_nce_partial_fused over #1 and #6 with diag_pos and a "
               "traced scale)",
}


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


def resolve_local_ntxent(impl: str):
    """The per-rank NT-Xent body for an impl name (``dist_loss.py:199``).
    ``"pair"`` and ``"chunked"`` are not ported and raise, naming their
    items; ``ntxent-train`` refuses them at its flag."""
    if impl == "strip":
        return local_ntxent_allgather
    if impl in NOT_PORTED:
        raise NotImplementedError(f"--dp-loss {impl} is not ported yet: "
                                  f"{NOT_PORTED[impl]}")
    raise ValueError(f"unknown NT-Xent impl {impl!r}")


def make_sharded_ntxent(group=None, temperature: float = 0.07,
                        impl: str = "strip"):
    """``loss_fn(z1_local, z2_local) -> scalar``: the global-batch NT-Xent
    over the ranks of ``group`` (``dist_loss.py:216``)."""
    return functools.partial(resolve_local_ntxent(impl),
                             temperature=float(temperature), group=group)


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


def resolve_local_infonce(impl: str):
    """The per-rank InfoNCE body for an impl name (``dist_loss.py:326``).
    ``"twopass"`` is not ported and raises, naming its item."""
    if impl == "dual":
        return local_infonce_dual
    if impl in INFONCE_NOT_PORTED:
        raise NotImplementedError(f"the {impl} InfoNCE is not ported yet: "
                                  f"{INFONCE_NOT_PORTED[impl]}")
    raise ValueError(f"unknown InfoNCE impl {impl!r}")


def make_sharded_infonce(group=None, impl: str = "dual"):
    """``loss_fn(za_local, zb_local, scale) -> scalar``: the global-batch
    InfoNCE over the ranks of ``group`` (``dist_loss.py:338``)."""
    return functools.partial(resolve_local_infonce(impl), group=group)
