"""Tensor operations of the port: kernels with their plain versions."""

from .attention import (
    attention_dkv_plain,
    attention_dq_plain,
    attention_plain,
    flash_attention,
    flash_attention_dkv,
    flash_attention_dq,
    flash_attention_fwd,
    resolve_attention_scale,
)
from .ntxent import (
    ntxent_bwd_sym,
    ntxent_bwd_sym_plain,
    ntxent_fwd,
    ntxent_fwd_plain,
    ntxent_loss_fused,
)
from .oracle import cosine_normalize, ntxent_loss

__all__ = [
    "attention_dkv_plain",
    "attention_dq_plain",
    "attention_plain",
    "cosine_normalize",
    "flash_attention",
    "flash_attention_dkv",
    "flash_attention_dq",
    "flash_attention_fwd",
    "ntxent_bwd_sym",
    "ntxent_bwd_sym_plain",
    "ntxent_fwd",
    "ntxent_fwd_plain",
    "ntxent_loss",
    "ntxent_loss_fused",
    "resolve_attention_scale",
]
