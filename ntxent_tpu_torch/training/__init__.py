"""Training of the port: SimCLR (LARS, two-view augmentation) and CLIP
(AdamW, paired loading), each on one card or data-parallel over ranks;
the sources (ImageFolder, CIFAR-10, arrays and memmaps), the threaded and
native loaders, host and device prefetch; the train steps (guarded,
rematerialized, accumulating: ``MultiSteps``) and the lag-1 loop;
checkpoints and resume (``fit``, ``CheckpointManager``,
``AsyncCheckpointer``) and preemption; evaluation (linear probe, kNN,
fine-tuning)."""

from .accum import MultiSteps
from .adamw import AdamW
from .augment import augment_batch_pair
from .checkpoint import (
    AsyncCheckpointer,
    CheckpointManager,
    RetentionPolicy,
    snapshot_state,
)
from .data import DevicePrefetcher, PrefetchIterator
from .datasets import (
    ArraySource,
    Cifar10Source,
    ImageFolderSource,
    PairedArrayLoader,
    PairedPipeline,
    ShardedShuffle,
    StreamingLoader,
    TwoViewPipeline,
    device_prefetch,
    grain_loader,
)
from .evaluation import (
    extract_features,
    finetune,
    knn_accuracy,
    linear_probe,
)
from .lars import LARS, cosine_warmup_schedule, simclr_learning_rate
from .native_loader import NativeStreamingLoader, native_loader_available
from .preemption import PreemptionGuard
from .trainer import (
    ROADMAP_ITEMS,
    StepOutcome,
    TrainerConfig,
    TrainState,
    create_clip_train_state,
    create_train_state,
    fit,
    init_error_feedback,
    make_clip_train_step,
    make_sharded_clip_train_step,
    make_sharded_train_step,
    make_train_step,
    measure_comms_overlap,
    train_loop,
)

__all__ = [
    "LARS",
    "AdamW",
    "AsyncCheckpointer",
    "CheckpointManager",
    "MultiSteps",
    "PrefetchIterator",
    "PreemptionGuard",
    "RetentionPolicy",
    "ShardedShuffle",
    "ROADMAP_ITEMS",
    "ArraySource",
    "Cifar10Source",
    "DevicePrefetcher",
    "ImageFolderSource",
    "NativeStreamingLoader",
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
    "device_prefetch",
    "extract_features",
    "finetune",
    "fit",
    "grain_loader",
    "init_error_feedback",
    "knn_accuracy",
    "linear_probe",
    "make_clip_train_step",
    "make_sharded_clip_train_step",
    "make_sharded_train_step",
    "make_train_step",
    "measure_comms_overlap",
    "native_loader_available",
    "simclr_learning_rate",
    "snapshot_state",
    "train_loop",
]
