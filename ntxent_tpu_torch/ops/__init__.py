"""Tensor operations of the port: kernels with their plain versions."""

from .attention import (
    attention_plain,
    flash_attention,
    flash_attention_fwd,
    resolve_attention_scale,
)
from .oracle import cosine_normalize

__all__ = [
    "attention_plain",
    "cosine_normalize",
    "flash_attention",
    "flash_attention_fwd",
    "resolve_attention_scale",
]
