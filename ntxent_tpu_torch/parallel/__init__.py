"""Parallelism of the port over ``torch.distributed``: process groups,
autograd-aware collectives with comms accounting (``parallel.mesh``), the
data-parallel NT-Xent and InfoNCE losses (``parallel.dist_loss``), the
wire policy of the collectives (``parallel.precision``), the
pair-parallel NT-Xent (``parallel.pair``), sequence-parallel ring and
Ulysses attention (``parallel.ring_attention``), the ring NT-Xent and
InfoNCE (``parallel.ring``), and model parallelism: the switch-MoE layer
and its expert-parallel form (``parallel.moe``), Megatron tensor
parallelism (``parallel.tp``), ZeRO-3 (``parallel.fsdp``), the two
composed, over the sharded state of ``parallel.shards``, and the GPipe
schedule (``parallel.pp``)."""

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
from .fsdp import (
    fsdp_param_spec,
    make_fsdp_clip_train_step,
    make_fsdp_train_step,
    param_bytes_per_device,
    shard_train_state_fsdp,
)
from .mesh import (
    CommsAccounting,
    all_gather,
    all_to_all,
    comms_accounting,
    copy_to_group,
    grid_groups,
    init_distributed,
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
    reduce_from_group,
    split_rows,
)
from .moe import (
    MoEMlp,
    MoEParams,
    init_moe_params,
    make_expert_parallel_moe,
    moe_aux_from,
    switch_moe,
)
from .pp import make_gpipe, pipeline_stage_params, stack_stage_params
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
from .shards import Sharding
from .tp import (
    make_tp_clip_train_step,
    make_tp_simclr_train_step,
    shard_train_state,
    shard_train_state_tp_fsdp,
)

__all__ = [
    "all_gather",
    "all_to_all",
    "attention_oracle",
    "blockwise_attention",
    "collective_dtype",
    "collective_precision",
    "comms_accounting",
    "CommsAccounting",
    "copy_to_group",
    "fsdp_param_spec",
    "grid_groups",
    "info_nce_loss_ring",
    "init_distributed",
    "init_from_env",
    "init_from_file",
    "init_moe_params",
    "local_infonce_allgather",
    "local_infonce_dual",
    "local_ntxent_allgather",
    "local_ntxent_chunked",
    "local_row_gids",
    "make_expert_parallel_moe",
    "make_fsdp_clip_train_step",
    "make_fsdp_train_step",
    "make_gpipe",
    "make_pair_ntxent",
    "make_ring_attention",
    "make_ring_infonce",
    "make_ring_ntxent",
    "make_sharded_infonce",
    "make_sharded_ntxent",
    "make_tp_clip_train_step",
    "make_tp_simclr_train_step",
    "make_ulysses_attention",
    "moe_aux_from",
    "MoEMlp",
    "MoEParams",
    "ntxent_loss_distributed",
    "ntxent_loss_pair",
    "ntxent_loss_ring",
    "pair_body",
    "param_bytes_per_device",
    "pipeline_stage_params",
    "pmax",
    "pmean",
    "ppermute",
    "process_info",
    "psum",
    "psum_scatter",
    "quantized_grad_reduce",
    "quantized_grad_reduce_",
    "reduce_from_group",
    "resolve_local_infonce",
    "resolve_local_ntxent",
    "shard_train_state",
    "shard_train_state_fsdp",
    "shard_train_state_tp_fsdp",
    "Sharding",
    "split_rows",
    "stack_stage_params",
    "switch_moe",
]
