"""Data-parallel NT-Xent over ``torch.distributed``, counterpart of the
strip schedule of ``ntxent_tpu/parallel/dist_loss.py``.

Every rank runs the encoder on its shard of the global batch, all-gathers
the embeddings of both views, computes only its local rows x global
columns strip of the similarity matrix with the fused kernels
(``ops.ntxent.ntxent_partial_fused``: the general forward, #1, and the
general backward, #6) and sums the partial losses over ranks. The
gradient of the gathered columns flows back through the all-gather as a
reduce-scatter (``parallel.mesh``).

Unlike the JAX functions, which take the global (sharded) views inside a
``shard_map``, these take the rank's local views: a rank holds only its
shard.
"""

from __future__ import annotations

import functools

import torch

from ..ops.ntxent import ntxent_partial_fused
from .mesh import all_gather, local_row_gids, psum, rank, world_size

__all__ = ["local_ntxent_allgather", "make_sharded_ntxent",
           "ntxent_loss_distributed", "resolve_local_ntxent"]

# The other schedules of ``--dp-loss``, by the ROADMAP.md item that ports
# them.
NOT_PORTED = {
    "pair": "ROADMAP.md Queue A 4 (pair and triangular loss schedules: "
            "kernels #7 and #8)",
    "chunked": "ROADMAP.md Queue A 3(d) (--dp-loss chunked, the "
               "ring-overlap schedule)",
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
