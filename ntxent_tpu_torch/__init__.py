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
* the loss oracles (``ops.oracle``) and the reference-compatible API
  (``api``);
* ``weights.load_flax_variables`` and ``weights.flax_paths`` to carry the
  JAX package's weights and parameter paths across.
"""

__version__ = "0.2.0"
