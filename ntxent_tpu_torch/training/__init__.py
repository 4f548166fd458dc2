"""Single-card training of the port: SimCLR (LARS, two-view augmentation)
and CLIP (AdamW, paired loading), seeded loading and the train steps."""

from .adamw import AdamW
from .augment import augment_batch_pair
from .datasets import (
    ArraySource,
    PairedArrayLoader,
    PairedPipeline,
    StreamingLoader,
    TwoViewPipeline,
)
from .lars import LARS, cosine_warmup_schedule, simclr_learning_rate
from .trainer import (
    ROADMAP_ITEMS,
    TrainerConfig,
    TrainState,
    create_clip_train_state,
    create_train_state,
    make_clip_train_step,
    make_train_step,
    train_loop,
)

__all__ = [
    "LARS",
    "AdamW",
    "ROADMAP_ITEMS",
    "ArraySource",
    "PairedArrayLoader",
    "PairedPipeline",
    "StreamingLoader",
    "TrainState",
    "TrainerConfig",
    "TwoViewPipeline",
    "augment_batch_pair",
    "cosine_warmup_schedule",
    "create_clip_train_state",
    "create_train_state",
    "make_clip_train_step",
    "make_train_step",
    "simclr_learning_rate",
    "train_loop",
]
