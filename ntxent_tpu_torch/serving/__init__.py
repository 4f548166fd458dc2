"""Embedding serving of the port: the worker (engine, micro-batcher, HTTP
server, checkpoint watcher) and the fleet's router tier over it.

The worker process:

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

The router tier (``ntxent_tpu_torch.fleet_cli``), which imports no torch:

* ``cache.EmbeddingCache``: row-content-keyed LRU + TTL, generations, the
  hot store a promote replays;
* ``router.FleetRouter`` over ``router.WorkerPool``: failover retries,
  the 429 shed, the canary state machine, ``TokenBucket`` /
  ``TenantAdmission``;
* ``shadow.ShadowMirror``: mirrored canary traffic, ``cosine_drift``;
* ``fleet.ServingFleet``: spawn, readiness probe, eject, backoff restart,
  the chaos fleet actions;
* ``autoscale.AutoscaleController``: closed-loop pool sizing,
  ``flash_crowd``, ``parse_tenant_quotas``.

Exports resolve lazily (PEP 562), as in ``ntxent_tpu/serving/__init__.py``:
the router process must not pay the torch import that ``engine``,
``server`` and ``worker`` would bring in.
"""

import importlib

# name -> defining submodule; resolved on first attribute access.
_EXPORTS = {
    "AutoscaleController": "autoscale",
    "flash_crowd": "autoscale",
    "parse_tenant_quotas": "autoscale",
    "BatcherClosed": "batcher",
    "DeadlineExceededError": "batcher",
    "MicroBatcher": "batcher",
    "QueueFullError": "batcher",
    "EmbeddingCache": "cache",
    "DEFAULT_BUCKETS": "engine",
    "InferenceEngine": "engine",
    "quantize_host": "engine",
    "ServingFleet": "fleet",
    "SizeHistogram": "ladder",
    "expected_padded_rows": "ladder",
    "optimize_ladder": "ladder",
    "ServingMetrics": "metrics",
    "FleetRouter": "router",
    "TenantAdmission": "router",
    "TokenBucket": "router",
    "WorkerPool": "router",
    "EmbeddingServer": "server",
    "ShadowMirror": "shadow",
    "cosine_drift": "shadow",
    "CheckpointWatcher": "worker",
}


def __getattr__(name):
    module = _EXPORTS.get(name)
    if module is None:
        raise AttributeError(
            f"module {__name__!r} has no attribute {name!r}")
    value = getattr(importlib.import_module(f".{module}", __name__), name)
    globals()[name] = value  # later access skips __getattr__
    return value


def __dir__():
    return sorted(set(globals()) | set(_EXPORTS))


__all__ = sorted(_EXPORTS)
