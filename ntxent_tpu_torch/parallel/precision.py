"""Collective precision policy: what dtype rides the wire, counterpart of
``ntxent_tpu/parallel/precision.py`` (a copy of its own: the port imports
nothing of the JAX package).

This module is the pure half: the thread-local policy context and the
int8 quantize/dequantize math. ``parallel.mesh`` owns the collectives
that read it and the wire-byte accounting.

Policy (``collective_precision(dtype)``):

* ``"float32"``, the default: payloads ride as they are.
* ``"bf16"`` (alias ``"bfloat16"``): float payloads are cast to bfloat16
  before the collective and back after (half the wire bytes; reductions
  sum in bf16).
* ``"int8"``: eligible payloads are quantized with one symmetric scale
  per row of the last axis (``quantize_int8``), sent as int8 and float32
  scales, and dequantized after (about a quarter of the bytes).
  Reductions take the two-phase schedule of ``parallel.mesh``.

Eligibility (``quantizable``): int8 applies only to float payloads of at
least ``MIN_QUANT_ELEMS`` elements (``NTXENT_QUANT_MIN_ELEMS``, default
1024); scalars (the psum'd loss), small vectors and integer payloads ride
in full precision.

The context is thread-local and read when a collective is issued. A
backward that autograd runs on its own thread (the CUDA device thread)
sees ``"float32"``, so every autograd function that issues a collective
in its backward keeps the dtype of its forward (``collective_dtype()``
read there) and enters it again.
"""

from __future__ import annotations

import os
import threading

import torch

__all__ = ["COLLECTIVE_DTYPES", "MIN_QUANT_ELEMS", "collective_dtype",
           "collective_precision", "dequantize_int8", "int8_scale",
           "quantizable", "quantize_int8"]

# the closed set of policy names (the dtype labels of the comms counters
# stay bounded by it)
COLLECTIVE_DTYPES = ("float32", "bf16", "int8")

# payloads below this many elements ride in full precision
MIN_QUANT_ELEMS = int(os.environ.get("NTXENT_QUANT_MIN_ELEMS", "1024"))

_policy = threading.local()


def collective_dtype() -> str:
    """The wire dtype the innermost ``collective_precision`` of this
    thread set (``"float32"`` outside any)."""
    return getattr(_policy, "dtype", "float32")


class collective_precision:
    """Context manager: collectives issued inside it on this thread ride
    the wire as ``dtype``. Nests (the inner one wins); ``"bfloat16"`` is
    an alias of ``"bf16"``; an unknown name raises ``ValueError``."""

    def __init__(self, dtype: str = "float32"):
        dtype = {"bfloat16": "bf16"}.get(str(dtype), str(dtype))
        if dtype not in COLLECTIVE_DTYPES:
            raise ValueError(f"collective dtype must be one of "
                             f"{COLLECTIVE_DTYPES}, got {dtype!r}")
        self.dtype = dtype
        self._saved = "float32"

    def __enter__(self) -> "collective_precision":
        self._saved = collective_dtype()
        _policy.dtype = self.dtype
        return self

    def __exit__(self, *exc) -> None:
        _policy.dtype = self._saved


def quantizable(x, min_elems: int | None = None) -> bool:
    """Is this payload worth sending as int8? A float tensor of at least
    ``min_elems`` elements (default ``MIN_QUANT_ELEMS``) and one or more
    dimensions."""
    if not isinstance(x, torch.Tensor) or not x.dtype.is_floating_point:
        return False
    floor = MIN_QUANT_ELEMS if min_elems is None else int(min_elems)
    return x.dim() >= 1 and x.numel() >= floor


def quantize_int8(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 quantization, one scale per row of the last axis:
    ``scale = max(amax(|row|), 1e-30) / 127`` (shape ``x.shape[:-1] +
    (1,)``, float32), ``q = clip(round(x / scale), -127, 127)`` as int8,
    rounding half to even as ``jnp.round`` does. An all-zero row gives
    zeros, never NaN; -128 is never made."""
    xf = x.float()
    amax = xf.abs().amax(dim=-1, keepdim=True)
    scale = int8_scale(amax)
    q = torch.clamp(torch.round(xf / scale), -127.0, 127.0).to(torch.int8)
    return q, scale


def int8_scale(amax: torch.Tensor) -> torch.Tensor:
    """``max(amax, 1e-30) / 127`` divided as IEEE float32 on every device:
    CUDA turns a division by a Python number into a product with its
    rounded reciprocal, which moves a scale by an ulp, so the divisor is a
    tensor on the device."""
    return torch.clamp(amax, min=1e-30) / amax.new_full((), 127.0)


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor,
                    dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``q * scale`` in float32, cast to ``dtype``."""
    return (q.float() * scale).to(dtype)
