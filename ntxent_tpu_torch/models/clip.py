"""CLIP-style dual encoder, counterpart of ``ntxent_tpu/models/clip.py``.

Image tower: a ViT of ``models/vit.py`` (NHWC images -> fp32 CLS
features). Text tower: ``TextTransformer``, a causal transformer over
token ids with EOT pooling. ``CLIPModel`` projects both (no bias),
L2-normalizes them and returns the learnable logit scale
``clamp(exp(logit_scale), 0, 100)``; the loss is InfoNCE over the two
embeddings at that scale (``ops.infonce.info_nce_fused`` or
``ops.oracle.info_nce_loss``).

Same dtype policy as the JAX modules: fp32 parameters, activations in
``dtype`` (bf16 by default), fp32 LayerNorm, fp32 pooled features and
projections. The text tower's attention is the plain (``xla``) path under
a causal mask: the flash kernels take no mask, as in the JAX package.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

from ..ops.oracle import cosine_normalize
from .layers import Dense, LayerNorm
from .vit import EncoderBlock

__all__ = ["CLIPModel", "TextTransformer", "causal_mask"]


def causal_mask(length: int, device=None) -> torch.Tensor:
    """(1, 1, L, L) boolean mask, True where query i may attend key j <= i
    (flax ``make_causal_mask``, broadcast over batch and heads)."""
    return torch.ones(length, length, dtype=torch.bool,
                      device=device).tril()[None, None]


class TextTransformer(nn.Module):
    """(B, T) int token ids (0 = pad) -> (B, hidden) fp32 features at each
    sequence's last non-pad token."""

    def __init__(self, vocab_size: int = 49408, max_len: int = 77,
                 hidden_dim: int = 512, depth: int = 12, num_heads: int = 8,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.max_len = max_len
        self.hidden_dim = hidden_dim
        self.dtype = dtype
        self.embedding = nn.Parameter(torch.zeros(vocab_size, hidden_dim))
        self.pos_embed = nn.Parameter(torch.zeros(1, max_len, hidden_dim))
        self.blocks = nn.ModuleList(
            EncoderBlock(hidden_dim, num_heads, hidden_dim * 4, dtype)
            for _ in range(depth))
        self.final_ln = LayerNorm(hidden_dim)

    def init_weights(self, generator: torch.Generator) -> None:
        """flax ``nn.Embed``'s default (normal, variance 1/hidden) and the
        tower's normal(0.01) position table."""
        with torch.no_grad():
            self.embedding.normal_(0.0, 1.0 / math.sqrt(self.hidden_dim),
                                   generator=generator)
            self.pos_embed.normal_(0.0, 0.01, generator=generator)

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        b, t = tokens.shape
        if t > self.max_len:
            raise ValueError(f"{t} tokens, but the position table holds "
                             f"{self.max_len}")
        # flax nn.Embed(dtype=bf16): the fp32 table cast, then the lookup
        x = self.embedding.to(self.dtype)[tokens]
        x = x + self.pos_embed[:, :t].to(self.dtype)
        mask = causal_mask(t, tokens.device)
        for block in self.blocks:
            x = block(x, mask=mask)
        x = self.final_ln(x)
        # EOT pooling: the feature at each sequence's last non-pad position
        last = torch.clamp((tokens != 0).sum(dim=1) - 1, min=0)
        return x[torch.arange(b, device=tokens.device), last].float()


class CLIPModel(nn.Module):
    """Dual encoder -> (image_embeds, text_embeds, logit scale)."""

    def __init__(self, image_tower: nn.Module, text_tower: nn.Module,
                 embed_dim: int = 512):
        super().__init__()
        self.image_tower = image_tower
        self.text_tower = text_tower
        # flax nn.Dense(use_bias=False, param_dtype=float32) on fp32 features
        self.image_proj = Dense(image_tower.hidden_dim, embed_dim, bias=False,
                                dtype=torch.float32)
        self.text_proj = Dense(text_tower.hidden_dim, embed_dim, bias=False,
                               dtype=torch.float32)
        self.logit_scale = nn.Parameter(torch.zeros(()))
        self.init_weights()

    def init_weights(self, generator: torch.Generator | None = None) -> None:
        """CLIP-standard start: temperature 0.07 as a log scale."""
        with torch.no_grad():
            self.logit_scale.fill_(float(np.float32(np.log(1.0 / 0.07))))

    def scale(self) -> torch.Tensor:
        return torch.clamp(torch.exp(self.logit_scale), 0.0, 100.0)

    def forward(self, images: torch.Tensor, tokens: torch.Tensor):
        return self.encode_image(images), self.encode_text(tokens), \
            self.scale()

    def encode_image(self, images: torch.Tensor) -> torch.Tensor:
        return cosine_normalize(self.image_proj(self.image_tower(images)))

    def encode_text(self, tokens: torch.Tensor) -> torch.Tensor:
        return cosine_normalize(self.text_proj(self.text_tower(tokens)))
