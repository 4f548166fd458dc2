"""Single-card SimCLR training of the port: LARS, two-view augmentation,
seeded loading and the train step."""

from .augment import augment_batch_pair
from .datasets import ArraySource, StreamingLoader, TwoViewPipeline
from .lars import LARS, cosine_warmup_schedule, simclr_learning_rate
from .trainer import (
    ROADMAP_ITEMS,
    TrainerConfig,
    TrainState,
    create_train_state,
    make_train_step,
    train_loop,
)

__all__ = [
    "LARS",
    "ROADMAP_ITEMS",
    "ArraySource",
    "StreamingLoader",
    "TrainState",
    "TrainerConfig",
    "TwoViewPipeline",
    "augment_batch_pair",
    "cosine_warmup_schedule",
    "create_train_state",
    "make_train_step",
    "simclr_learning_rate",
    "train_loop",
]
