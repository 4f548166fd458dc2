"""PyTorch/CUDA port of ntxent_tpu for NVIDIA Hopper (H100).

A second package beside the JAX one, which stays the reference. It
imports ``torch`` and nothing of JAX or of ``ntxent_tpu``. Every Pallas
kernel on a ported path becomes a kernel written by hand for ``sm_90a``
(``csrc/``), with a plain PyTorch version beside it that CPU tensors
take. Entry points run on the CUDA device unless the caller passes
``device="cpu"``.

Ported so far:

* the serving path of a ViT SimCLR model (``cli.serve_main``,
  ``serving``, ``models``), whose attention runs the flash-attention
  forward kernel (``ops.attention``): the int8 rung, the adaptive bucket
  ladder, supervised restarts, the checkpoint watcher, Prometheus
  ``/metrics`` and request spans (``obs``);
* single-card SimCLR training of a ViT (``cli.train_main``,
  ``training``): the fused NT-Xent forward and backward kernels
  (``ops.ntxent``), the flash-attention backward kernels, BatchNorm in
  train mode, LARS, on-device two-view augmentation;
* single-card CLIP training (``cli.train_main --objective clip``,
  ``models.clip``): the fused InfoNCE forward and backward kernels
  (``ops.infonce``), a causal text tower, AdamW;
* ResNet SimCLR training (``models.resnet``, flax-exact BatchNorm; the
  ImageNet stem as a convolution or space-to-depth'd), on
  one card or data-parallel under ``torchrun`` (``parallel``: process
  groups, differentiable collectives with comms accounting, the strip
  loss over the general NT-Xent forward and backward kernels,
  ``ops.ntxent.ntxent_partial_fused``), cross-replica BatchNorm;
* data-parallel CLIP training under ``torchrun`` (``--objective clip``):
  the dual InfoNCE (``parallel.dist_loss.local_infonce_dual``,
  ``ops.infonce.info_nce_dual_partial``) over the rectangular InfoNCE
  forward kernel, its rows backward kernel and the columns backward
  kernel, with the column logsumexp merged across ranks;
* the pair-parallel NT-Xent (``--dp-loss pair``, ``parallel.pair``) over
  the dual shard-pair kernels, and the triangular symmetric loss
  (``ntxent_loss_fused(triangular=True)``) over the upper-triangle
  forward and backward kernels;
* long-context attention (``models.LongContextTransformer``) under
  sequence-parallel ring attention (``parallel.make_ring_attention``:
  the carried-statistics fold kernel a hop forward, the flash dQ and
  dK/dV kernels a hop backward) or Ulysses all-to-all attention, and the
  ring NT-Xent (over the general NT-Xent kernels) and ring InfoNCE
  (``parallel.ring``);
* train-side telemetry (``obs``: the step timeline with its FLOP count
  and MFU, the slow-step profiler, the metrics endpoint, the event log
  and its flight dumps; the training layers' registry series);
* the loss oracles (``ops.oracle``), the reference-compatible API
  (``api``) and the JAX package's thirteen top-level names, exported
  here as they are there; ``losses.NTXentLoss`` is the loss as an
  ``nn.Module``;
* ``weights.load_flax_variables`` and ``weights.flax_paths`` to carry the
  JAX package's weights and parameter paths across;
* the serving fleet (``fleet_cli``, ``python -m ntxent_tpu_torch.fleet_cli``):
  a router with an embedding cache, canaried rollout, shadow drift,
  tenant admission and autoscaling over supervised ``serve`` workers, and
  the fleet's federation, SLO and history planes (``obs``). The router
  tier imports no torch;
* the fleet's retrieval tier (``retrieval``): the checkpoint-step-versioned
  IVF-PQ index behind the router's ``/search``, ``/index/insert`` and
  ``/embed?store=true``, and its self-healing shard plane (``python -m
  ntxent_tpu_torch.retrieval.shard``), numpy and stdlib as in the JAX
  package.
"""

import importlib

# The thirteen names resolve on first access (PEP 562), as in
# ``ntxent_tpu/__init__.py``: importing the package loads no torch, so the
# serving fleet's router process (``fleet_cli``, ``serving.router``,
# ``serving.fleet``) starts without paying the torch import.
_EXPORTS = {name: "ntxent_tpu_torch.api" for name in (
    "backward", "check_tensor_core_support", "cosine_normalize", "forward",
    "info_nce_fused", "info_nce_loss", "ntxent", "ntxent_loss",
    "ntxent_loss_and_lse", "ntxent_loss_compat", "ntxent_loss_fused",
    "ntxent_loss_paired", "ntxent_partial_fused")}


def __getattr__(name):
    module = _EXPORTS.get(name)
    if module is None:
        raise AttributeError(
            f"module {__name__!r} has no attribute {name!r}")
    value = getattr(importlib.import_module(module), name)
    globals()[name] = value  # later access skips __getattr__
    return value


def __dir__():
    return sorted(set(globals()) | set(_EXPORTS))


__all__ = ["__version__", "backward", "check_tensor_core_support",
           "cosine_normalize", "forward", "info_nce_fused", "info_nce_loss",
           "ntxent", "ntxent_loss", "ntxent_loss_and_lse",
           "ntxent_loss_compat", "ntxent_loss_fused", "ntxent_loss_paired",
           "ntxent_partial_fused"]
__version__ = "0.7.0"
