"""The JAX package's public names that the port leaves out by decision,
each group with its reason (README.md's port section lists the same).

A name is ``"module:name"`` relative to the package (``"parallel.mesh:
create_mesh"``); a whole module is ``"module"``. Every other name in a
JAX module's ``__all__`` has a counterpart of the same name in the
port's module of the same path (``tests/test_torch_surface.py`` holds
the two packages to that by AST).
"""

from __future__ import annotations

__all__ = ["UNPORTED", "unported_names"]

UNPORTED: dict[str, tuple[str, ...]] = {
    # the kernels, the XLA FFI and native CPU library, the JAX <-> torch
    # bridge: the port's kernels are the CUDA kernels of ops.ntxent,
    # ops.infonce and ops.attention, and the port is torch itself
    "modules set aside": (
        "ffi", "native", "torch_compat", "ops.attention_pallas",
        "ops.infonce_pallas", "ops.ntxent_pallas"),
    # a rank of the port holds its own shard in a torch.distributed group
    # (parallel.mesh's rank and world_size, parallel.shards' cuts): there
    # is no device mesh, PartitionSpec tree or global array to build
    "JAX sharding": (
        "parallel:create_hybrid_mesh", "parallel:create_mesh",
        "parallel:data_sharding", "parallel:global_batch",
        "parallel:param_spec_tree", "parallel:replicate_state",
        "parallel:replicated_sharding", "parallel:sharded_prefetch",
        "parallel:tp_fsdp_param_spec", "parallel:tp_fsdp_spec_fn",
        "parallel:tp_param_spec",
        "parallel.fsdp:fsdp_spec_tree",
        "parallel.mesh:axis_index", "parallel.mesh:axis_size",
        "parallel.mesh:comms_scaled", "parallel.mesh:create_hybrid_mesh",
        "parallel.mesh:create_mesh", "parallel.mesh:data_sharding",
        "parallel.mesh:global_batch", "parallel.mesh:match_partition_rules",
        "parallel.mesh:mesh_topology", "parallel.mesh:pcast",
        "parallel.mesh:place_with_specs",
        "parallel.mesh:replicated_sharding",
        "parallel.mesh:resolve_restore_specs", "parallel.mesh:shard_map",
        "parallel.mesh:sharded_prefetch",
        "parallel.mesh:tree_partition_specs",
        "parallel.tp:param_spec_tree", "parallel.tp:tp_param_spec",
        "training:GlobalTwoViewPipeline", "training:shard_batch",
        "analysis.graph.targets:audit_mesh"),
    # XLA's compiled-cost and graph helpers: the port counts FLOPs at each
    # kernel launch (ops.flops), times with CUDA events
    # (utils.profiling.cuda_time_ms) and censuses c10d calls
    "XLA-only": (
        "analysis.graph.census:hlo_census",
        "analysis.graph.census:jaxpr_census",
        "analysis.graph.donation:lowered_alias_report",
        "utils:BenchmarkResults", "utils:chain_flops_per_step",
        "utils:compile_chain", "utils:flops_from_compiled",
        "utils:measured_flops", "utils:time_chain", "utils:time_fn",
        "utils:time_fn_chained", "utils:trace",
        "utils.profiling:BenchmarkResults",
        "utils.profiling:chain_flops_per_step",
        "utils.profiling:compile_chain",
        "utils.profiling:flops_from_compiled",
        "utils.profiling:measured_flops", "utils.profiling:time_chain",
        "utils.profiling:time_fn", "utils.profiling:time_fn_chained",
        "utils.profiling:trace"),
    # TPU probes: the port's are utils.capability's device_name and
    # check_tensor_core_support
    "TPU probes": (
        "utils:device_kind", "utils:has_mxu", "utils:supports_bf16_matmul",
        "utils:verify_accelerator_requirements",
        "utils.capability:device_kind", "utils.capability:has_mxu",
        "utils.capability:is_tpu_backend",
        "utils.capability:supports_bf16_matmul",
        "utils.capability:verify_accelerator_requirements"),
    # Pallas tiles and VMEM budgets: the port's kernels plan their own
    # (ops.ntxent.column_splits, the kernels' Plan)
    "Pallas tile autotuners": (
        "ops:autotune_attention_blocks", "ops:autotune_blocks",
        "ops:choose_blocks",
        "ops.autotune:autotune_attention_blocks",
        "ops.autotune:autotune_blocks",
        "ops.blocks:VMEM_BUDGET_BYTES", "ops.blocks:choose_blocks"),
    # host input keyed by jax.random and optax's chain builder: the port
    # augments on the device (training.augment, training.data's
    # TwoViewPipeline over training.datasets' loaders) and its optimizer
    # is training.lars.LARS in optax's state layout
    "JAX host input and optax": (
        "training:ArrayDataset", "training:augment_pair",
        "training:create_lars", "training:streaming_two_view_iterator",
        "training:synthetic_images", "training:two_view_iterator",
        "training.augment:augment_pair", "training.augment:random_flip",
        "training.augment:random_grayscale",
        "training.augment:random_resized_crop",
        "training.data:ArrayDataset", "training.data:synthetic_images",
        "training.data:two_view_iterator",
        "training.datasets:streaming_two_view_iterator",
        "training.lars:create_lars"),
}


def unported_names() -> set[str]:
    """Every entry of ``UNPORTED``, whatever its reason."""
    return {name for names in UNPORTED.values() for name in names}
