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
  forward kernel (``ops.attention``);
* single-card SimCLR training of a ViT (``cli.train_main``,
  ``training``): the fused NT-Xent forward and backward kernels
  (``ops.ntxent``), the flash-attention backward kernels, BatchNorm in
  train mode, LARS, on-device two-view augmentation;
* single-card CLIP training (``cli.train_main --objective clip``,
  ``models.clip``): the fused InfoNCE forward and backward kernels
  (``ops.infonce``), a causal text tower, AdamW;
* the loss oracles (``ops.oracle``) and the reference-compatible API
  (``api``), which also exports ``info_nce_fused`` and ``info_nce_loss``
  as the JAX package's top level does;
* ``weights.load_flax_variables`` and ``weights.flax_paths`` to carry the
  JAX package's weights and parameter paths across.
"""

from .api import info_nce_fused, info_nce_loss

__all__ = ["__version__", "info_nce_fused", "info_nce_loss"]
__version__ = "0.3.0"
