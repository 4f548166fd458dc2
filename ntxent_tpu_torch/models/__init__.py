"""Model towers of the port."""

from .clip import CLIPModel, TextTransformer
from .layers import Dense, LayerNorm, init_weights
from .long_context import SeqParallelSelfAttention
from .projection import ProjectionHead, SimCLRModel
from .vit import (
    EncoderBlock,
    MlpBlock,
    VisionTransformer,
    ViT_B16,
    ViT_L16,
    ViT_S16,
    ViT_Ti16,
)

__all__ = [
    "CLIPModel",
    "Dense",
    "EncoderBlock",
    "LayerNorm",
    "MlpBlock",
    "ProjectionHead",
    "SeqParallelSelfAttention",
    "SimCLRModel",
    "TextTransformer",
    "ViT_B16",
    "ViT_L16",
    "ViT_S16",
    "ViT_Ti16",
    "VisionTransformer",
    "init_weights",
]
