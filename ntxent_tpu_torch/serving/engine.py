"""Shape-bucketed inference engine, counterpart of
``ntxent_tpu/serving/engine.py``.

Requests pad up to the nearest rung of a fixed ladder of batch sizes
(default 1/4/16/64/128) and oversized requests split into max-bucket
chunks plus one bucketed tail, so the device only ever sees a few batch
shapes. PyTorch runs eagerly, so there is no compiled-executable cache:
``warmup()`` runs every bucket once (which also builds the CUDA kernels
on first use), bounding first-request latency.

The engine is synchronous; coalescing, queuing and backpressure live one
layer up in ``serving.batcher.MicroBatcher``.
"""

from __future__ import annotations

import logging
import threading
import time
from collections.abc import Sequence

import numpy as np
import torch
from torch import nn

from ..utils.capability import resolve_device
from .metrics import ServingMetrics

logger = logging.getLogger(__name__)

__all__ = ["DEFAULT_BUCKETS", "InferenceEngine"]

DEFAULT_BUCKETS: tuple[int, ...] = (1, 4, 16, 64, 128)


class InferenceEngine:
    """Bucketed forward of ``model`` over a fixed per-example shape.

    ``method`` names the model method to serve (``"forward"`` for the
    normalized embedding, ``"features"`` for encoder features).
    ``example_shape`` is one example's trailing shape, e.g. (H, W, C).
    ``dtype`` is the input dtype handed to the model. ``device`` defaults
    to CUDA and raises when there is no GPU; pass ``"cpu"`` for the CPU.
    """

    def __init__(self, model: nn.Module, example_shape: Sequence[int], *,
                 method: str = "forward",
                 buckets: Sequence[int] = DEFAULT_BUCKETS,
                 dtype: torch.dtype = torch.float32,
                 device: str | torch.device | None = None,
                 metrics: ServingMetrics | None = None):
        buckets = tuple(sorted(set(int(b) for b in buckets)))
        if not buckets or buckets[0] < 1:
            raise ValueError(f"buckets must be positive ints, got {buckets}")
        self.buckets = buckets
        self.max_bucket = buckets[-1]
        self.example_shape = tuple(int(d) for d in example_shape)
        self.dtype = dtype
        self.device = resolve_device(device)
        self.metrics = metrics or ServingMetrics()
        self.model = model.to(self.device).eval()
        self._fn = getattr(self.model, method)
        # Held around every forward and weight swap: a chunk runs
        # entirely on one set of weights.
        self._lock = threading.Lock()
        self.version = 0

    def update_variables(self, state_dict: dict) -> None:
        """Swap model weights (a torch ``state_dict``) between chunks."""
        with self._lock:
            self.model.load_state_dict(state_dict)
            self.version += 1

    def bucket_for(self, n: int) -> int:
        """Smallest ladder bucket >= n (n must fit the ladder)."""
        if n < 1:
            raise ValueError(f"need at least one row, got {n}")
        if n > self.max_bucket:
            raise ValueError(f"{n} rows exceed the largest bucket "
                             f"{self.max_bucket} (chunking is embed()'s "
                             "job)")
        return next(b for b in self.buckets if b >= n)

    def _run(self, x: np.ndarray) -> np.ndarray:
        batch = torch.from_numpy(x).to(self.device, self.dtype)
        with self._lock, torch.inference_mode():
            return self._fn(batch).float().cpu().numpy()

    def warmup(self) -> None:
        """Run every ladder bucket once."""
        for bucket in self.buckets:
            self._run(np.zeros((bucket,) + self.example_shape, np.float32))
        logger.info("serving: warmup complete (%d buckets: %s)",
                    len(self.buckets), list(self.buckets))

    def _embed_chunk(self, x: np.ndarray) -> np.ndarray:
        n = x.shape[0]
        bucket = self.bucket_for(n)
        pad = bucket - n
        if pad:
            x = np.concatenate(
                [x, np.zeros((pad,) + self.example_shape, x.dtype)])
        t0 = time.monotonic()
        out = self._run(x)
        self.metrics.device_call(bucket, rows_real=n, rows_padded=pad,
                                 device_ms=(time.monotonic() - t0) * 1e3)
        return out[:n]

    def embed(self, x: np.ndarray, n_requests: int = 1) -> np.ndarray:
        """Outputs for ``x`` of shape ``(N,) + example_shape``.

        ``N`` may exceed the largest bucket: the batch splits into
        max-bucket chunks plus one bucketed tail, each its own device
        call. ``n_requests`` is accounting only: how many coalesced
        requests this dispatch carries (the batch-fill-ratio numerator).
        """
        x = np.asarray(x, dtype=np.float32)
        if x.shape[1:] != self.example_shape:
            raise ValueError(f"expected trailing shape {self.example_shape},"
                             f" got {x.shape[1:]}")
        if x.shape[0] < 1:
            raise ValueError("need at least one row")
        self.metrics.dispatch(n_requests)
        return np.concatenate([
            self._embed_chunk(x[start:start + self.max_bucket])
            for start in range(0, x.shape[0], self.max_bucket)])
