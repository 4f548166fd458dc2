"""Long-context transformer tower with a pluggable attention function,
counterpart of ``ntxent_tpu/models/long_context.py``.

The same parameters run under any of the attention plans of
``parallel.ring_attention``:

* one device: ``flash_attention`` (the default: the Hopper kernels on
  the GPU, their plain versions on the CPU), ``attention_oracle`` or
  ``blockwise_attention``;
* a process group, the sequence sharded over its ranks:
  ``make_ring_attention(group)`` or ``make_ulysses_attention(group)``.

All are the same function: a checkpoint trained under one runs under the
others. ``make_pipelined_apply(model, group, num_microbatches=M)`` runs
the same parameters with the block stack as a GPipe pipeline over a group
of stage ranks (``parallel.pp``). The port has no GSPMD, so a
sequence-parallel plan is explicit: each rank feeds its (B, L/P) shard of
the tokens, in rank order, and the model adds the position-table rows of
the shard's GLOBAL positions ``rank * L/P ...``, read from the plan's
``group`` attribute.

Same dtype policy as the towers (``models/vit.py``): fp32 parameters,
activations in ``dtype`` (bf16 by default), fp32 LayerNorm, pre-norm
blocks; the output is the final LayerNorm's fp32.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from ..ops.attention import flash_attention
from ..parallel.mesh import rank, world_size
from .layers import AttentionFn, LayerNorm, SeqParallelSelfAttention
from .vit import EncoderBlock

__all__ = ["LongContextBlock", "LongContextTransformer",
           "SeqParallelSelfAttention", "default_attention",
           "make_pipelined_apply"]


def default_attention() -> AttentionFn:
    """The attention of a model built without a plan: ``flash_attention``,
    which launches the Hopper kernels on CUDA tensors and runs their plain
    versions on CPU tensors (the JAX package picks its flash kernel on a
    TPU and the jnp oracle elsewhere)."""
    return flash_attention


class LongContextBlock(EncoderBlock):
    """Pre-norm block, ``x + attn(LN(x))`` then ``x + MLP(LN(x))``: the
    encoder block of the towers with the attention function a parameter
    (None: ``default_attention()``)."""

    def __init__(self, hidden: int, num_heads: int, mlp_dim: int,
                 dtype: torch.dtype = torch.bfloat16,
                 attention_fn: AttentionFn | None = None):
        super().__init__(hidden, num_heads, mlp_dim, dtype,
                         attention_impl="flash")
        self.attn.attention_fn = attention_fn or default_attention()


class LongContextTransformer(nn.Module):
    """(B, L) int tokens -> (B, L, hidden) fp32 contextual features.

    Under a sequence-parallel plan (an ``attention_fn`` with a ``group``
    attribute, as ``make_ring_attention`` and ``make_ulysses_attention``
    return) ``tokens`` is this rank's (B, L/P) shard and the output its
    (B, L/P, hidden) shard; ``max_len`` bounds the global length L. A
    rank's parameter gradients are its share: their sum over the ranks is
    the gradient of the whole sequence's loss (JAX's gradient under
    GSPMD).
    """

    def __init__(self, vocab_size: int, hidden_dim: int = 512,
                 depth: int = 8, num_heads: int = 8, mlp_dim: int = 2048,
                 max_len: int = 32768, dtype: torch.dtype = torch.bfloat16,
                 attention_fn: AttentionFn | None = None):
        super().__init__()
        self.hidden_dim = hidden_dim
        self.max_len = max_len
        self.dtype = dtype
        self.attention_fn = attention_fn or default_attention()
        self.embedding = nn.Parameter(torch.zeros(vocab_size, hidden_dim))
        self.pos_embedding = nn.Parameter(torch.zeros(1, max_len,
                                                      hidden_dim))
        self.blocks = nn.ModuleList(
            LongContextBlock(hidden_dim, num_heads, mlp_dim, dtype,
                             self.attention_fn)
            for _ in range(depth))
        self.out_ln = LayerNorm(hidden_dim)

    def init_weights(self, generator: torch.Generator) -> None:
        """flax ``nn.Embed``'s default (normal, variance 1/hidden) and the
        tower's normal(0.02) position table."""
        with torch.no_grad():
            self.embedding.normal_(0.0, 1.0 / math.sqrt(self.hidden_dim),
                                   generator=generator)
            self.pos_embedding.normal_(0.0, 0.02, generator=generator)

    def positions(self, local_len: int) -> tuple[int, int]:
        """(offset, global length) of a rank's shard of ``local_len``
        tokens under the model's attention plan."""
        if not hasattr(self.attention_fn, "group"):  # one device
            return 0, local_len
        group = self.attention_fn.group
        return rank(group) * local_len, world_size(group) * local_len

    def embed(self, tokens: torch.Tensor) -> torch.Tensor:
        """(B, L) tokens -> (B, L, hidden) embedded and positioned
        activations in ``dtype``."""
        offset, total = self.positions(tokens.shape[1])
        if total > self.max_len:
            raise ValueError(f"sequence length {total} exceeds max_len "
                             f"{self.max_len} (raise max_len: it sizes the "
                             "position table)")
        # flax nn.Embed(dtype=bf16): the fp32 table cast, then the lookup
        x = self.embedding.to(self.dtype)[tokens]
        pos = self.pos_embedding[:, offset:offset + tokens.shape[1]]
        return x + pos.to(self.dtype)

    def head(self, x: torch.Tensor) -> torch.Tensor:
        """The final LayerNorm (fp32)."""
        return self.out_ln(x)

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        x = self.embed(tokens)
        for block in self.blocks:
            x = block(x)
        return self.head(x)


def make_pipelined_apply(model: LongContextTransformer, group=None, *,
                         num_microbatches: int, remat: bool = False):
    """``fn(tokens) -> (B, L, hidden)``, equal to ``model(tokens)``, with
    the block stack run as a GPipe pipeline over the ranks of ``group``
    (``long_context.py:168``): rank s applies blocks ``s D/S .. (s + 1)
    D/S - 1`` of ``model``, the embedding and the final norm run
    replicated outside the pipeline. The model's attention must be a
    plain function: a ring or Ulysses plan (an attention with a process
    ``group``) cannot nest inside the pipeline (``:181-184``)."""
    from ..parallel.pp import make_gpipe

    if hasattr(model.attention_fn, "group"):
        raise ValueError("a ring or Ulysses attention plan cannot run inside "
                         "the pipeline: build the model with a plain "
                         "attention function")
    stages = world_size(group)
    depth = len(model.blocks)
    if depth % stages:
        raise ValueError(f"depth {depth} does not split over {stages} "
                         "stages")
    per = depth // stages
    mine = list(model.blocks)[rank(group) * per:(rank(group) + 1) * per]

    def stage_fn(blocks, acts):
        for block in blocks:
            acts = block(acts)
        return acts

    pipe = make_gpipe(stage_fn, group, num_microbatches=num_microbatches,
                      remat=remat)

    def apply(tokens: torch.Tensor) -> torch.Tensor:
        return model.head(pipe(mine, model.embed(tokens)))

    return apply
