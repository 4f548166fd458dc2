"""Device-memory tracking, counterpart of ``ntxent_tpu/utils/memory.py``
(the reference's GPU memory tracker): per-step samples of the card's
allocated, peak and reserved memory from ``torch.cuda.memory_stats``,
dumped to ``memory_profile.json``, with the JAX package's dict keys."""

from __future__ import annotations

import json
import logging
from pathlib import Path

import torch

logger = logging.getLogger(__name__)

__all__ = ["DeviceMemoryTracker", "device_memory_mb"]

# torch.cuda.memory_stats keys -> the JAX package's keys (bytes_in_use,
# peak_bytes_in_use, bytes_limit there)
_KEYS = (("allocated_bytes.all.current", "allocated_mb"),
         ("allocated_bytes.all.peak", "peak_allocated_mb"),
         ("reserved_bytes.all.current", "reserved_mb"))


def device_memory_mb(device=None) -> dict[str, float]:
    """Memory of one device in MB: ``allocated_mb``,
    ``peak_allocated_mb`` and ``reserved_mb`` (the caching allocator's
    pool). Empty for a device with no statistics (the CPU)."""
    device = torch.device(device) if device is not None else (
        torch.device("cuda", torch.cuda.current_device())
        if torch.cuda.is_available() else torch.device("cpu"))
    if device.type != "cuda":
        return {}
    stats = torch.cuda.memory_stats(device)
    return {key: stats[name] / 1024**2 for name, key in _KEYS
            if name in stats}


class DeviceMemoryTracker:
    """Samples device memory at named steps; saves a JSON profile.
    ``log_memory(step)`` appends a sample and logs it,
    ``save_profile(path)`` dumps the samples."""

    def __init__(self, device=None):
        self.device = device
        self.snapshots: list[dict] = []

    def log_memory(self, step: str) -> dict:
        sample = {"step": step, **device_memory_mb(self.device)}
        self.snapshots.append(sample)
        alloc = sample.get("allocated_mb")
        if alloc is not None:
            logger.info("Memory at %s: %.1f MB allocated", step, alloc)
        else:
            logger.info("Memory at %s: stats unavailable on %s", step,
                        self.device or "the CPU")
        return sample

    def save_profile(self, path: str | Path = "memory_profile.json") -> Path:
        path = Path(path)
        path.write_text(json.dumps(self.snapshots, indent=2))
        return path
