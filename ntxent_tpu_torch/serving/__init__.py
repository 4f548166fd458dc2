"""Embedding serving of the port: engine, micro-batcher, HTTP server.

* ``engine.InferenceEngine``: bucket ladder, pad-to-bucket, chunking
  through the largest bucket, ``warmup()``, ``update_variables()``;
* ``batcher.MicroBatcher``: bounded queue (429 + Retry-After when
  full), deadlines that expire in the queue, coalescing up to
  ``max_batch`` rows or ``max_delay``;
* ``server.EmbeddingServer``: ``/embed``, ``/healthz``, ``/readyz``,
  ``/metrics`` (JSON);
* ``metrics.ServingMetrics``: the counters and latency windows behind
  ``/metrics``.
"""

from .batcher import (
    BatcherClosed,
    DeadlineExceededError,
    MicroBatcher,
    QueueFullError,
)
from .engine import DEFAULT_BUCKETS, InferenceEngine
from .metrics import ServingMetrics
from .server import EmbeddingServer

__all__ = [
    "BatcherClosed",
    "DEFAULT_BUCKETS",
    "DeadlineExceededError",
    "EmbeddingServer",
    "InferenceEngine",
    "MicroBatcher",
    "QueueFullError",
    "ServingMetrics",
]
