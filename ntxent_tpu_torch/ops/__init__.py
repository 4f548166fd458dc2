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
from .infonce import (
    info_nce_fused,
    infonce_dual_bwd,
    infonce_dual_bwd_plain,
    infonce_dual_fwd,
    infonce_dual_fwd_plain,
)
from .ntxent import (
    ntxent_bwd_sym,
    ntxent_bwd_sym_plain,
    ntxent_fwd,
    ntxent_fwd_plain,
    ntxent_loss_fused,
)
from .oracle import cosine_normalize, info_nce_loss, ntxent_loss

__all__ = [
    "attention_dkv_plain",
    "attention_dq_plain",
    "attention_plain",
    "cosine_normalize",
    "flash_attention",
    "flash_attention_dkv",
    "flash_attention_dq",
    "flash_attention_fwd",
    "info_nce_fused",
    "info_nce_loss",
    "infonce_dual_bwd",
    "infonce_dual_bwd_plain",
    "infonce_dual_fwd",
    "infonce_dual_fwd_plain",
    "ntxent_bwd_sym",
    "ntxent_bwd_sym_plain",
    "ntxent_fwd",
    "ntxent_fwd_plain",
    "ntxent_loss",
    "ntxent_loss_fused",
    "resolve_attention_scale",
]
