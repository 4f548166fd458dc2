"""Vision Transformer encoder (ViT-B/16 class), counterpart of
``ntxent_tpu/models/vit.py``.

Same dtype policy: fp32 parameters, activations in ``dtype`` (bf16 by
default), fp32 LayerNorm, fp32 CLS output. Patchify is the strided conv
of the JAX tower written as the product it lowers to: non-overlapping
patches flattened row-major over (h, w, channel), times the (HWIO
flattened) kernel. Input is NHWC, as in the JAX package.

``attention_impl="flash"`` runs ``SeqParallelSelfAttention`` over the
flash-attention kernel; ``"xla"`` is plain PyTorch that mirrors flax's
``nn.MultiHeadDotProductAttention`` on the same weights, and alone takes
an attention ``mask`` (the CLIP text tower's causal mask), as in the JAX
block.

``moe_experts`` > 0 mounts ``parallel.moe.MoEMlp`` (switch-MoE) in place
of the dense MLP of every other block (blocks 1, 3, ...), as the JAX
tower does (``vit.py:72-77``, ``:117``).
"""

from __future__ import annotations

import math
from functools import partial

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import flash_attention
from ..parallel.mesh import copy_to_group, reduce_from_group
from ..parallel.moe import MoEMlp
from .layers import Dense, LayerNorm, SeqParallelSelfAttention

__all__ = ["EncoderBlock", "MlpBlock", "VisionTransformer", "ViT_B16",
           "ViT_L16", "ViT_S16", "ViT_Ti16", "dot_product_attention"]


def dot_product_attention(q, k, v, mask=None):
    """flax ``dot_product_attention`` as ``MultiHeadDotProductAttention``
    calls it: q scaled by 1/sqrt(D) in the compute dtype, scores and
    softmax in that dtype. (B, L, H, D) in and out. ``mask`` (boolean,
    broadcastable to (B, H, Lq, Lk), True where attention is allowed)
    sets the other scores to the dtype's lowest finite value before the
    softmax, as flax does."""
    q = q / torch.tensor(math.sqrt(q.shape[-1]), dtype=q.dtype)
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k)
    if mask is not None:
        scores = scores.masked_fill(~mask, torch.finfo(scores.dtype).min)
    weights = torch.softmax(scores, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", weights, v)


class MlpBlock(nn.Module):
    """fc1, gelu, fc2. Under tensor parallelism (``tp_group``, set by
    ``parallel.tp``) fc1 holds this rank's columns and fc2 its rows:
    Megatron's ``f`` before fc1, ``g`` after fc2, fc2's bias after it."""

    def __init__(self, hidden: int, mlp_dim: int, dtype: torch.dtype):
        super().__init__()
        self.fc1 = Dense(hidden, mlp_dim, dtype=dtype)
        self.fc2 = Dense(mlp_dim, hidden, dtype=dtype)
        self.tp_group = None

    def forward(self, x):
        if self.tp_group is not None:
            x = copy_to_group(x, self.tp_group)
        # flax nn.gelu defaults to the tanh approximation.
        h = F.gelu(self.fc1(x), approximate="tanh")
        if self.tp_group is None:
            return self.fc2(h)
        dt = self.fc2.dtype
        y = reduce_from_group(F.linear(h.to(dt), self.fc2.weight.to(dt)),
                              self.tp_group)
        return y + self.fc2.bias.to(dt)


class EncoderBlock(nn.Module):
    """Pre-norm block: x + attn(LN(x)), then x + MLP(LN(x))."""

    def __init__(self, hidden: int, num_heads: int, mlp_dim: int,
                 dtype: torch.dtype, moe_experts: int = 0,
                 attention_impl: str = "xla"):
        super().__init__()
        if attention_impl not in ("xla", "flash"):
            raise ValueError(f"unknown attention_impl {attention_impl!r}: "
                             "expected 'xla' or 'flash'")
        self.attention_impl = attention_impl
        self.ln1 = LayerNorm(hidden)
        self.attn = SeqParallelSelfAttention(
            hidden, num_heads, dtype=dtype,
            attention_fn=(flash_attention if attention_impl == "flash"
                          else dot_product_attention))
        self.ln2 = LayerNorm(hidden)
        # the switch-MoE MLP in place of the dense one (moe_experts > 0)
        self.mlp = (MoEMlp(hidden, moe_experts, mlp_dim, dtype)
                    if moe_experts > 0 else MlpBlock(hidden, mlp_dim, dtype))

    def forward(self, x, mask=None):
        if mask is not None and self.attention_impl == "flash":
            raise ValueError("attention_impl='flash' supports only the "
                             "unmasked encoder case (ViT towers)")
        x = x + self.attn(self.ln1(x), mask=mask)
        return x + self.mlp(self.ln2(x))


class VisionTransformer(nn.Module):
    """(B, H, W, C) images -> (B, hidden) fp32 CLS features."""

    def __init__(self, image_size: int = 224, patch_size: int = 16,
                 hidden_dim: int = 768, depth: int = 12, num_heads: int = 12,
                 mlp_dim: int = 3072, dtype: torch.dtype = torch.bfloat16,
                 moe_experts: int = 0, attention_impl: str = "xla",
                 channels: int = 3):
        super().__init__()
        self.patch_size = patch_size
        self.hidden_dim = hidden_dim
        self.dtype = dtype
        grid = image_size // patch_size
        if grid < 1:
            raise ValueError(f"image_size {image_size} is smaller than a "
                             f"{patch_size}px patch")
        self.patch_embed = Dense(patch_size * patch_size * channels,
                                 hidden_dim, dtype=dtype)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, hidden_dim))
        self.pos_embed = nn.Parameter(torch.zeros(1, grid * grid + 1,
                                                  hidden_dim))
        # As in the JAX tower, MoE replaces the MLP of every other block.
        self.blocks = nn.ModuleList(
            EncoderBlock(hidden_dim, num_heads, mlp_dim, dtype,
                         moe_experts=moe_experts if i % 2 == 1 else 0,
                         attention_impl=attention_impl)
            for i in range(depth))
        self.final_ln = LayerNorm(hidden_dim)

    def init_weights(self, generator: torch.Generator) -> None:
        with torch.no_grad():
            self.cls_token.zero_()
            self.pos_embed.normal_(0.0, 0.02, generator=generator)

    def patchify(self, x: torch.Tensor) -> torch.Tensor:
        """(B, H, W, C) -> (B, N, p*p*C), patches row-major over (h, w),
        each patch flattened over (ph, pw, c) like an HWIO kernel."""
        b, h, w, c = x.shape
        p = self.patch_size
        gh, gw = h // p, w // p
        x = x[:, :gh * p, :gw * p]  # a VALID conv drops the remainder
        x = x.reshape(b, gh, p, gw, p, c).permute(0, 1, 3, 2, 4, 5)
        return x.reshape(b, gh * gw, p * p * c)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b = x.shape[0]
        x = self.patch_embed(self.patchify(x.to(self.dtype)))
        if x.shape[1] + 1 != self.pos_embed.shape[1]:
            raise ValueError(f"{x.shape[1]} patches, but the position "
                             f"table holds {self.pos_embed.shape[1] - 1}")
        cls = self.cls_token.to(self.dtype).expand(b, 1, self.hidden_dim)
        x = torch.cat([cls, x], dim=1) + self.pos_embed.to(self.dtype)
        for block in self.blocks:
            x = block(x)
        return self.final_ln(x)[:, 0].float()


ViT_Ti16 = partial(VisionTransformer, hidden_dim=192, depth=12, num_heads=3,
                   mlp_dim=768)
ViT_S16 = partial(VisionTransformer, hidden_dim=384, depth=12, num_heads=6,
                  mlp_dim=1536)
ViT_B16 = partial(VisionTransformer, hidden_dim=768, depth=12, num_heads=12,
                  mlp_dim=3072)
ViT_L16 = partial(VisionTransformer, hidden_dim=1024, depth=24, num_heads=16,
                  mlp_dim=4096)
