"""Embedding serving of the port: engine, micro-batcher, HTTP server,
checkpoint watcher.

* ``engine.InferenceEngine``: bucket ladder, pad-to-bucket, chunking
  through the largest bucket, ``warmup()``, the int8 rung, atomic weight
  swaps (``swap_variables``), the adaptive ladder (``refresh_ladder``);
* ``ladder``: the decayed size histogram and the ladder's DP;
* ``batcher.MicroBatcher``: bounded queue (429 + Retry-After when
  full), deadlines that expire in the queue, coalescing up to
  ``max_batch`` rows or ``max_delay``, watchdog beats;
* ``server.EmbeddingServer``: ``/embed``, ``/healthz``, ``/readyz``,
  ``/metrics`` (JSON, Prometheus, raw state), ``/rollback``; supervised
  restarts of a stalled batcher;
* ``worker.CheckpointWatcher``: adopts new checkpoint steps, rolls back;
* ``metrics.ServingMetrics``: the series behind ``/metrics``.
"""

from .batcher import (
    BatcherClosed,
    DeadlineExceededError,
    MicroBatcher,
    QueueFullError,
)
from .engine import DEFAULT_BUCKETS, InferenceEngine, quantize_host
from .ladder import SizeHistogram, expected_padded_rows, optimize_ladder
from .metrics import ServingMetrics
from .server import EmbeddingServer
from .worker import CheckpointWatcher

__all__ = [
    "BatcherClosed",
    "CheckpointWatcher",
    "DEFAULT_BUCKETS",
    "DeadlineExceededError",
    "EmbeddingServer",
    "InferenceEngine",
    "MicroBatcher",
    "QueueFullError",
    "ServingMetrics",
    "SizeHistogram",
    "expected_padded_rows",
    "optimize_ladder",
    "quantize_host",
]
