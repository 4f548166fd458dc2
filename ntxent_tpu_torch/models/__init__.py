"""Model towers of the port."""

from .clip import CLIPModel, TextTransformer
from .layers import (
    BatchNorm,
    Dense,
    LayerNorm,
    SeqParallelSelfAttention,
    cross_replica_batch_norm,
    init_weights,
)
from .long_context import (
    LongContextBlock,
    LongContextTransformer,
    default_attention,
    make_pipelined_apply,
)
from .projection import ProjectionHead, SimCLRModel
from .resnet import (
    BasicBlock,
    BottleneckBlock,
    ResNet,
    ResNet18,
    ResNet34,
    ResNet50,
    ResNet50x2,
    ResNet101,
    ResNet152,
)
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
    "BasicBlock",
    "BatchNorm",
    "BottleneckBlock",
    "CLIPModel",
    "Dense",
    "EncoderBlock",
    "LayerNorm",
    "LongContextBlock",
    "LongContextTransformer",
    "MlpBlock",
    "ProjectionHead",
    "ResNet",
    "ResNet101",
    "ResNet152",
    "ResNet18",
    "ResNet34",
    "ResNet50",
    "ResNet50x2",
    "SeqParallelSelfAttention",
    "SimCLRModel",
    "TextTransformer",
    "ViT_B16",
    "ViT_L16",
    "ViT_S16",
    "ViT_Ti16",
    "VisionTransformer",
    "cross_replica_batch_norm",
    "default_attention",
    "init_weights",
    "make_pipelined_apply",
]
