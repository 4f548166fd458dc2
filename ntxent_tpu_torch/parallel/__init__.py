"""Data parallelism of the port over ``torch.distributed``: process
groups, autograd-aware collectives with comms accounting
(``parallel.mesh``), the data-parallel NT-Xent and InfoNCE losses
(``parallel.dist_loss``) and the pair-parallel NT-Xent
(``parallel.pair``)."""

from .dist_loss import (
    local_infonce_dual,
    local_ntxent_allgather,
    make_sharded_infonce,
    make_sharded_ntxent,
    ntxent_loss_distributed,
    resolve_local_infonce,
    resolve_local_ntxent,
)
from .mesh import (
    CommsAccounting,
    all_gather,
    comms_accounting,
    init_from_env,
    init_from_file,
    local_row_gids,
    pmax,
    pmean,
    process_info,
    psum,
)
from .pair import make_pair_ntxent, ntxent_loss_pair, pair_body

__all__ = [
    "CommsAccounting",
    "all_gather",
    "comms_accounting",
    "init_from_env",
    "init_from_file",
    "local_infonce_dual",
    "local_ntxent_allgather",
    "local_row_gids",
    "make_pair_ntxent",
    "make_sharded_infonce",
    "make_sharded_ntxent",
    "ntxent_loss_distributed",
    "ntxent_loss_pair",
    "pair_body",
    "pmax",
    "pmean",
    "process_info",
    "psum",
    "resolve_local_infonce",
    "resolve_local_ntxent",
]
