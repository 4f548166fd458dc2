"""Training of the port: SimCLR (LARS, two-view augmentation) and CLIP
(AdamW, paired loading), each on one card or data-parallel over ranks,
seeded loading, the train steps (guarded, rematerialized, accumulating:
``MultiSteps``), checkpoints and resume (``fit``, ``CheckpointManager``,
``AsyncCheckpointer``) and preemption."""

from .accum import MultiSteps
from .adamw import AdamW
from .augment import augment_batch_pair
from .checkpoint import (
    AsyncCheckpointer,
    CheckpointManager,
    RetentionPolicy,
    snapshot_state,
)
from .datasets import (
    ArraySource,
    PairedArrayLoader,
    PairedPipeline,
    StreamingLoader,
    TwoViewPipeline,
)
from .lars import LARS, cosine_warmup_schedule, simclr_learning_rate
from .preemption import PreemptionGuard
from .trainer import (
    ROADMAP_ITEMS,
    StepOutcome,
    TrainerConfig,
    TrainState,
    create_clip_train_state,
    create_train_state,
    fit,
    make_clip_train_step,
    make_sharded_clip_train_step,
    make_sharded_train_step,
    make_train_step,
    train_loop,
)

__all__ = [
    "LARS",
    "AdamW",
    "AsyncCheckpointer",
    "CheckpointManager",
    "MultiSteps",
    "PreemptionGuard",
    "RetentionPolicy",
    "ROADMAP_ITEMS",
    "ArraySource",
    "PairedArrayLoader",
    "PairedPipeline",
    "StepOutcome",
    "StreamingLoader",
    "TrainState",
    "TrainerConfig",
    "TwoViewPipeline",
    "augment_batch_pair",
    "cosine_warmup_schedule",
    "create_clip_train_state",
    "create_train_state",
    "fit",
    "make_clip_train_step",
    "make_sharded_clip_train_step",
    "make_sharded_train_step",
    "make_train_step",
    "simclr_learning_rate",
    "snapshot_state",
    "train_loop",
]
