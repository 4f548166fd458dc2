"""Parallelism of the port over ``torch.distributed``: process groups,
autograd-aware collectives with comms accounting (``parallel.mesh``), the
data-parallel NT-Xent and InfoNCE losses (``parallel.dist_loss``), the
wire policy of the collectives (``parallel.precision``), the
pair-parallel NT-Xent (``parallel.pair``), sequence-parallel ring and
Ulysses attention (``parallel.ring_attention``) and the ring NT-Xent and
InfoNCE (``parallel.ring``)."""

from .dist_loss import (
    local_infonce_allgather,
    local_infonce_dual,
    local_ntxent_allgather,
    local_ntxent_chunked,
    make_sharded_infonce,
    make_sharded_ntxent,
    ntxent_loss_distributed,
    resolve_local_infonce,
    resolve_local_ntxent,
)
from .mesh import (
    CommsAccounting,
    all_gather,
    all_to_all,
    comms_accounting,
    init_from_env,
    init_from_file,
    local_row_gids,
    pmax,
    pmean,
    ppermute,
    process_info,
    psum,
    psum_scatter,
    quantized_grad_reduce,
    quantized_grad_reduce_,
)
from .precision import collective_dtype, collective_precision
from .pair import make_pair_ntxent, ntxent_loss_pair, pair_body
from .ring import (
    info_nce_loss_ring,
    make_ring_infonce,
    make_ring_ntxent,
    ntxent_loss_ring,
)
from .ring_attention import (
    attention_oracle,
    blockwise_attention,
    make_ring_attention,
    make_ulysses_attention,
)

__all__ = [
    "CommsAccounting",
    "all_gather",
    "all_to_all",
    "attention_oracle",
    "blockwise_attention",
    "collective_dtype",
    "collective_precision",
    "comms_accounting",
    "init_from_env",
    "info_nce_loss_ring",
    "init_from_file",
    "local_infonce_allgather",
    "local_infonce_dual",
    "local_ntxent_allgather",
    "local_ntxent_chunked",
    "local_row_gids",
    "make_pair_ntxent",
    "make_ring_attention",
    "make_ring_infonce",
    "make_ring_ntxent",
    "make_sharded_infonce",
    "make_sharded_ntxent",
    "make_ulysses_attention",
    "ntxent_loss_distributed",
    "ntxent_loss_pair",
    "ntxent_loss_ring",
    "pair_body",
    "pmax",
    "pmean",
    "ppermute",
    "process_info",
    "psum",
    "psum_scatter",
    "quantized_grad_reduce",
    "quantized_grad_reduce_",
    "resolve_local_infonce",
    "resolve_local_ntxent",
]
