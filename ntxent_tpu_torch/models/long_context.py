"""Self-attention with a pluggable attention call.

Counterpart of ``SeqParallelSelfAttention`` in
``ntxent_tpu/models/long_context.py``: q/k/v projections to
(B, L, H, D), an attention function over that layout, and the output
projection. The projections are named ``query``/``key``/``value``/``out``
as in flax, so one set of weights serves every attention function.
"""

from __future__ import annotations

from collections.abc import Callable

import torch
from torch import nn

from ..ops.attention import flash_attention
from .layers import Dense

__all__ = ["SeqParallelSelfAttention"]

# (q, k, v) -> out, all (B, L, H, D); called with mask= only when given
AttentionFn = Callable[..., torch.Tensor]


class SeqParallelSelfAttention(nn.Module):
    """QKV projection + attention call + output projection.

    ``attention_fn`` defaults to ``flash_attention``: the Hopper kernel
    for tensors on the GPU, its plain version on the CPU.
    """

    def __init__(self, hidden: int, num_heads: int,
                 dtype: torch.dtype = torch.bfloat16,
                 attention_fn: AttentionFn | None = None):
        super().__init__()
        if hidden % num_heads:
            raise ValueError(f"hidden {hidden} not divisible by heads "
                             f"{num_heads}")
        self.num_heads = num_heads
        self.head_dim = hidden // num_heads
        self.attention_fn = attention_fn or flash_attention
        self.query = Dense(hidden, hidden, dtype=dtype)
        self.key = Dense(hidden, hidden, dtype=dtype)
        self.value = Dense(hidden, hidden, dtype=dtype)
        self.out = Dense(hidden, hidden, dtype=dtype)

    def forward(self, x: torch.Tensor, mask=None) -> torch.Tensor:
        b, l, hidden = x.shape

        def heads(proj):
            return proj(x).view(b, l, self.num_heads, self.head_dim)

        qkv = (heads(self.query), heads(self.key), heads(self.value))
        out = (self.attention_fn(*qkv) if mask is None
               else self.attention_fn(*qkv, mask=mask))
        return self.out(out.reshape(b, l, hidden))
