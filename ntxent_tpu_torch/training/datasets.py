"""Seeded batch loading and the two-view pipeline, counterpart of the parts
of ``ntxent_tpu/training/datasets.py`` the single-card training path uses.

* ``ArraySource``: random access over an in-memory array (or a memmap);
* ``StreamingLoader``: one seeded permutation per epoch,
  ``default_rng(SeedSequence([seed, epoch])).permutation(n)``, cut into
  whole batches. It is the JAX package's shuffle, so a seed yields the
  same batches in both packages. ``state()`` is the position of the next
  batch, (epoch, offset). Batches are gathered on the calling thread:
  the threaded read-ahead of the JAX loader is not ported (an in-memory
  source needs none). With ``retry_policy`` each source read is retried
  on transient errors (``datasets.py:232-250``; the target of the chaos
  plan's ``fetch@n``);
* ``TwoViewPipeline``: loader batch -> device -> uint8 to [0, 1] (as at
  ``datasets.py:316-317``) -> two augmented views. The views' generator
  is seeded from (seed, epoch, offset): a seed gives the same views;
* ``restore(state)`` on the loaders and both pipelines repositions them
  at a ``state()`` (the checkpointed position): a resumed run sees the
  batches and views an uninterrupted one sees;
* data parallelism: a loader of ``rank`` of ``world_size`` gathers rows
  ``rank B/P ... (rank + 1) B/P`` of each global batch of ``B`` (the
  batch one process would make), and its pipeline draws the views'
  parameters for all ``B`` rows and applies its rows' share, so a world
  of P ranks sees exactly the views a world of one sees;
* ``PairedArrayLoader`` (CLIP): (images, tokens) batches of in-memory
  arrays in the same seeded per-epoch order (``datasets.py:368``); with
  ``world_size`` > 1, rank ``rank``'s rows of each global batch, the rows
  the JAX loader's ``shard_index``/``shard_count`` give it;
  ``PairedPipeline`` moves each batch to the device once per step and
  turns uint8 images into [0, 1] there (``cli.py:1372-1375``).
"""

from __future__ import annotations

from collections.abc import Iterator

import numpy as np
import torch

from .augment import augment_batch_pair

__all__ = ["ArraySource", "PairedArrayLoader", "PairedPipeline",
           "StreamingLoader", "TwoViewPipeline"]


class ArraySource:
    """Random-access view over an in-memory array or ``np.load(...,
    mmap_mode='r')`` memmap."""

    def __init__(self, images):
        self.images = images

    def __len__(self) -> int:
        return len(self.images)

    def __getitem__(self, idx: int) -> np.ndarray:
        return np.asarray(self.images[idx])


class StreamingLoader:
    """Seeded shuffling batch loader: (B, H, W, C) numpy batches forever,
    epoch after epoch, always whole batches (the remainder of an epoch is
    dropped, as with the JAX loader's default ``drop_remainder=True``).
    With ``world_size`` > 1 it yields rank ``rank``'s rows of each global
    batch of ``batch_size``. ``retry_policy`` (``resilience.RetryPolicy``)
    retries each source read; without one a read error propagates."""

    def __init__(self, source, batch_size: int, seed: int = 0,
                 rank: int = 0, world_size: int = 1, retry_policy=None):
        if len(source) < batch_size:
            raise ValueError(f"source of {len(source)} < batch {batch_size}")
        if batch_size % world_size or not 0 <= rank < world_size:
            raise ValueError(f"batch {batch_size} must split evenly over "
                             f"{world_size} ranks (rank {rank})")
        self.source = source
        self.batch_size = batch_size
        self.seed = seed
        self.local_batch = batch_size // world_size
        self.row_offset = rank * self.local_batch  # first row of this rank
        self.retry_policy = retry_policy
        self._epoch = 0
        self._offset = 0  # batches already yielded within the epoch

    def _fetch(self, idx: int) -> np.ndarray:
        """One source read, retried per ``retry_policy``."""
        if self.retry_policy is None:
            return self.source[idx]
        return self.retry_policy.call(self.source.__getitem__, idx)

    def state(self) -> dict:
        return {"epoch": self._epoch, "offset": self._offset,
                "seed": self.seed}

    def restore(self, state: dict) -> None:
        """Reposition at ``state`` (as ``state()`` gave it): the next
        batch is the one that followed it. An iterator already running
        over the loader keeps its epoch's order, so a pipeline drops its
        own on restore."""
        self.seed = int(state["seed"])
        self._epoch = int(state["epoch"])
        self._offset = int(state["offset"])

    def batches_per_epoch(self) -> int:
        return len(self.source) // self.batch_size

    def _epoch_order(self, epoch: int) -> np.ndarray:
        rng = np.random.default_rng(np.random.SeedSequence([self.seed, epoch]))
        return rng.permutation(len(self.source))

    def _indices(self) -> Iterator[np.ndarray]:
        """Row indices of each batch; ``state()`` already points past the
        batch when it is handed out."""
        while True:
            order = self._epoch_order(self._epoch)
            while self._offset < self.batches_per_epoch():
                lo = self._offset * self.batch_size
                self._offset += 1
                yield order[lo:lo + self.batch_size]
            self._epoch += 1
            self._offset = 0

    def __iter__(self) -> Iterator[np.ndarray]:
        for idxs in self._indices():
            rows = idxs[self.row_offset:self.row_offset + self.local_batch]
            yield np.stack([self._fetch(int(i)) for i in rows])


class TwoViewPipeline:
    """(view1, view2) device batches from a ``StreamingLoader``."""

    def __init__(self, loader: StreamingLoader, device: torch.device,
                 seed: int = 0):
        self.loader = loader
        self.device = torch.device(device)
        self.seed = seed
        self._it = None

    def _generator(self) -> torch.Generator:
        st = self.loader.state()
        seed = np.random.SeedSequence(
            [self.seed, st["epoch"], st["offset"]]).generate_state(1)[0]
        return torch.Generator(device=self.device).manual_seed(int(seed))

    def state(self) -> dict:
        return self.loader.state()

    def restore(self, state: dict) -> None:
        """Reposition the loader (``datasets.py:348``); valid mid-iteration
        too: the running iterator is dropped and rebuilt at the restored
        position. The views' generator derives from (seed, epoch, offset),
        so a resumed run draws the views an uninterrupted one draws."""
        self.loader.restore(state)
        self._it = None

    def __iter__(self):
        return self

    def __next__(self):
        if self._it is None:
            self._it = iter(self.loader)
        gen = self._generator()
        x = torch.from_numpy(next(self._it)).to(self.device)
        if x.dtype == torch.uint8:
            x = x.to(torch.float32) / 255.0
        return augment_batch_pair(x.float(), gen, self.loader.batch_size,
                                  self.loader.row_offset)


class PairedArrayLoader(StreamingLoader):
    """(images, tokens) numpy batches of paired in-memory arrays, forever,
    in ``StreamingLoader``'s seeded order: the JAX ``PairedArrayLoader``
    of ``batch_size / world_size`` rows with ``shard_index=rank`` and
    ``shard_count=world_size``. ``batch_size`` is the global batch."""

    def __init__(self, images, tokens, batch_size: int, seed: int = 0,
                 rank: int = 0, world_size: int = 1):
        images, tokens = np.asarray(images), np.asarray(tokens)
        if len(images) != len(tokens):
            raise ValueError(f"{len(images)} images vs {len(tokens)} tokens")
        super().__init__(ArraySource(images), batch_size, seed, rank,
                         world_size)
        self.images, self.tokens = images, tokens

    def __iter__(self):
        for idxs in self._indices():
            rows = idxs[self.row_offset:self.row_offset + self.local_batch]
            yield self.images[rows], self.tokens[rows]


class PairedPipeline:
    """(images, tokens) device batches from a ``PairedArrayLoader``:
    float32 images ([0, 1] from uint8), int64 token ids."""

    def __init__(self, loader: PairedArrayLoader, device: torch.device):
        self.loader = loader
        self.device = torch.device(device)
        self._it = None

    def state(self) -> dict:
        return self.loader.state()

    def restore(self, state: dict) -> None:
        """Reposition the loader (``datasets.py:391``), dropping a running
        iterator."""
        self.loader.restore(state)
        self._it = None

    def __iter__(self):
        return self

    def __next__(self):
        if self._it is None:
            self._it = iter(self.loader)
        images, tokens = next(self._it)
        x = torch.from_numpy(images).to(self.device)
        x = x.to(torch.float32) / 255.0 if x.dtype == torch.uint8 \
            else x.float()
        return x, torch.from_numpy(tokens).to(self.device).long()
