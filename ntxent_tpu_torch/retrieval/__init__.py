"""The retrieval tier of the port: a versioned ANN index over the fleet's
served embeddings, counterpart of ``ntxent_tpu/retrieval`` module for
module and name for name.

* ``segments``: append-only mutable and sealed (memory-mapped) segments,
  stage-fsync-rename sealing and compaction;
* ``ivf``: ``brute_force_topk``, ``kmeans``, ``IVFIndex``;
* ``pq``: ``PQCodec`` (8-byte codes, ADC tables, the wire, snapshots);
* ``scan``: ``CodedLists``, the fused ``batched_scan``, ``ScanBatcher``;
* ``index``: ``VectorIndex`` (brute force below ``train_rows``, then
  IVF-PQ with an exact re-rank), ``RetrievalMetrics``;
* ``versioned``: ``IndexManager``, index versions keyed to checkpoint
  steps and driven by the router's rollout (promote, rollback, stale),
  the durable docstore and its re-embedding rebuild;
* ``journal``: ``ShardJournal``, the per-shard insert journal;
* ``shard``: ``IndexShard``, ``ShardServer``, ``ShardClient``,
  ``ShardFanout`` (rendezvous placement ``shard_owner``, rebalancing,
  plane versions, the repair loop); ``python -m
  ntxent_tpu_torch.retrieval.shard`` runs one shard.

The router surfaces it as ``POST /search``, ``POST /index/insert``,
``/embed?store=true`` and ``GET /index`` (``serving/router.py``). Every
on-disk and wire format is the JAX package's, byte for byte: an index
either package wrote reopens in the other.

numpy and stdlib only, and no torch: search runs in the router process
and the shard processes, which must not pay the torch import or hold the
card. Exports resolve lazily (PEP 562), as the port's other packages do.
"""

import importlib

# name -> defining submodule; resolved on first attribute access.
_EXPORTS = {
    "RetrievalMetrics": "index",
    "VectorIndex": "index",
    "IVFIndex": "ivf",
    "brute_force_topk": "ivf",
    "kmeans": "ivf",
    "ShardJournal": "journal",
    "PQCodec": "pq",
    "CodedLists": "scan",
    "ScanBatcher": "scan",
    "batched_scan": "scan",
    "MutableSegment": "segments",
    "SealedSegment": "segments",
    "SegmentStore": "segments",
    "IndexShard": "shard",
    "ShardClient": "shard",
    "ShardFanout": "shard",
    "ShardServer": "shard",
    "shard_owner": "shard",
    "IndexManager": "versioned",
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
