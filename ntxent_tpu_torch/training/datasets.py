"""Sources, seeded batch loading and the two-view pipeline, counterpart of
``ntxent_tpu/training/datasets.py``.

* Random-access sources, ``len()`` and ``[idx] -> uint8 (H, W, 3)``:
  ``ImageFolderSource`` (``root/<class>/<image>``, PIL decode, shorter
  side to ``image_size`` with BILINEAR, centre crop), ``Cifar10Source``
  (the ``cifar-10-batches-py`` pickles) and ``ArraySource`` (an array or
  a memmap, with optional labels);
* ``ShardedShuffle``: the one shuffle every loader shares (``datasets.py:
  155-219``): one seeded permutation per epoch, ``default_rng(
  SeedSequence([seed, epoch])).permutation(n)``, cut into global batches
  of ``batch_size`` rows, of which rank ``rank`` of ``world_size`` takes
  rows ``rank B/P ... (rank + 1) B/P`` (the JAX loader's ``shard_index``
  / ``shard_count`` with a per-shard batch of ``B/P``). ``state()`` is
  the position of the next batch, (epoch, offset, seed); ``restore()``
  repositions there. ``drop_remainder=False`` (one rank only) yields the
  short tail batch of an epoch;
* ``StreamingLoader``: the shuffle with threaded read-ahead
  (``datasets.py:251-286``): ``num_threads`` workers keep ``read_ahead``
  whole batches of per-item reads in flight. Tasks are per item only (a
  batch-level task on the same pool would deadlock once the workers are
  fewer than the batches in flight), and an abandoned generator shuts
  its pool down without waiting. ``retry_policy`` retries each source
  read (the chaos plan's ``fetch@n``);
* ``TwoViewPipeline``: loader batch -> device -> uint8 to [0, 1] -> two
  augmented views, the views' generator seeded from (seed, epoch,
  offset); with ``prefetch`` > 0 a ``data.DevicePrefetcher`` moves the
  next loader batches to the device ahead of the consumer. It is also the
  multi-process pipeline (JAX's ``GlobalTwoViewPipeline``,
  ``datasets.py:418``): a rank's loader yields its rows of every global
  batch, and each row's views are drawn for its position in the GLOBAL
  batch, so the views of a P-rank world, joined in rank order, are a
  one-rank run's bit for bit;
* ``PairedArrayLoader`` / ``PairedPipeline`` (CLIP): (images, tokens)
  batches of in-memory arrays in the same seeded order;
* ``device_prefetch`` (``datasets.py:477``) and ``grain_loader``
  (``:491``; grain is an optional dependency, imported when called).

``restore(state)`` on the loaders and pipelines is valid mid-iteration:
a running iterator is dropped and rebuilt at the restored position.
"""

from __future__ import annotations

import os
import pickle
import threading
from collections.abc import Iterator, Sequence
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

from .augment import augment_batch_pair

__all__ = ["ArraySource", "Cifar10Source", "ImageFolderSource",
           "PairedArrayLoader", "PairedPipeline", "ShardedShuffle",
           "StreamingLoader", "TwoViewPipeline", "device_prefetch",
           "grain_loader"]

_IMAGE_EXTS = {".jpeg", ".jpg", ".png", ".bmp", ".ppm", ".webp"}


class ImageFolderSource:
    """ImageNet-layout directory ``root/<class_name>/<image>``: classes in
    sorted order (or ``class_names``), each class's images in sorted
    order; ``labels`` (int32) is each image's class index."""

    def __init__(self, root: str | os.PathLike, image_size: int = 224,
                 class_names: Sequence[str] | None = None):
        self.root = Path(root)
        self.image_size = image_size
        if class_names is None:
            class_names = sorted(
                p.name for p in self.root.iterdir() if p.is_dir())
        if not class_names:
            raise ValueError(f"no class directories under {self.root}")
        self.class_names = list(class_names)
        self.paths: list[Path] = []
        self.labels_list: list[int] = []
        for label, name in enumerate(self.class_names):
            for p in sorted((self.root / name).iterdir()):
                if p.suffix.lower() in _IMAGE_EXTS:
                    self.paths.append(p)
                    self.labels_list.append(label)
        if not self.paths:
            raise ValueError(f"no images found under {self.root}")
        self.labels = np.asarray(self.labels_list, np.int32)

    def __len__(self) -> int:
        return len(self.paths)

    def __getitem__(self, idx: int) -> np.ndarray:
        """Decode, resize the shorter side to ``image_size`` (BILINEAR),
        centre-crop a square: uint8 (S, S, 3)."""
        from PIL import Image

        s = self.image_size
        with Image.open(self.paths[idx]) as im:
            im = im.convert("RGB")
            w, h = im.size
            scale = s / min(w, h)
            im = im.resize((max(s, round(w * scale)),
                            max(s, round(h * scale))), Image.BILINEAR)
            w, h = im.size
            left, top = (w - s) // 2, (h - s) // 2
            return np.asarray(im.crop((left, top, left + s, top + s)),
                              np.uint8)


class Cifar10Source:
    """CIFAR-10's python pickles (``data_batch_1..5`` with ``train=True``,
    ``test_batch`` otherwise) under ``root`` or its ``cifar-10-batches-py``:
    uint8 (N, 32, 32, 3) ``images`` and int32 ``labels``."""

    def __init__(self, root: str | os.PathLike, train: bool = True):
        root = Path(root)
        if (root / "cifar-10-batches-py").is_dir():
            root = root / "cifar-10-batches-py"
        names = ([f"data_batch_{i}" for i in range(1, 6)] if train
                 else ["test_batch"])
        datas, labels = [], []
        for name in names:
            with open(root / name, "rb") as f:
                d = pickle.load(f, encoding="bytes")
            datas.append(d[b"data"])
            labels.extend(d[b"labels"])
        # (N, 3072) rows of CHW -> (N, 32, 32, 3) HWC
        self.images = np.concatenate(datas).reshape(-1, 3, 32, 32) \
            .transpose(0, 2, 3, 1).copy()
        self.labels = np.asarray(labels, np.int32)

    def __len__(self) -> int:
        return len(self.images)

    def __getitem__(self, idx: int) -> np.ndarray:
        return self.images[idx]


class ArraySource:
    """Random-access view over an in-memory array or ``np.load(...,
    mmap_mode='r')`` memmap (only the pages of the rows read are read
    from disk); ``labels`` optional."""

    def __init__(self, images, labels=None):
        self.images = images
        self.labels = labels

    def __len__(self) -> int:
        return len(self.images)

    def __getitem__(self, idx: int) -> np.ndarray:
        return np.asarray(self.images[idx])


class ShardedShuffle:
    """The seeded order, the rank's rows and the resume position that
    every loader shares. ``batch_size`` is the global batch."""

    def _init_shuffle(self, n_rows: int, batch_size: int, seed: int,
                      rank: int, world_size: int,
                      drop_remainder: bool = True) -> None:
        if batch_size % world_size or not 0 <= rank < world_size:
            raise ValueError(f"batch {batch_size} must split evenly over "
                             f"{world_size} ranks (rank {rank})")
        if world_size > 1 and not drop_remainder:
            raise ValueError("sharded loading requires drop_remainder=True "
                             "(a ragged tail batch would leave ranks with "
                             "unequal row counts)")
        if n_rows < batch_size:
            raise ValueError(f"source of {n_rows} < batch {batch_size}")
        self._n_rows = n_rows
        self.batch_size = batch_size
        self.seed = seed
        self.local_batch = batch_size // world_size
        self.row_offset = rank * self.local_batch  # first row of this rank
        self.drop_remainder = drop_remainder
        self._epoch = 0
        self._offset = 0  # batches already yielded within the epoch
        self._lock = threading.Lock()

    def state(self) -> dict:
        with self._lock:
            return {"epoch": self._epoch, "offset": self._offset,
                    "seed": self.seed}

    def restore(self, state: dict) -> None:
        """Reposition at ``state`` (as ``state()`` gave it): the next batch
        is the one that followed it. An iterator already running keeps its
        epoch's order, so a pipeline drops its own on restore."""
        with self._lock:
            self.seed = int(state["seed"])
            self._epoch = int(state["epoch"])
            self._offset = int(state["offset"])

    def batches_per_epoch(self) -> int:
        n = self._n_rows // self.batch_size
        if not self.drop_remainder and self._n_rows % self.batch_size:
            n += 1
        return n

    def _epoch_order(self, epoch: int) -> np.ndarray:
        rng = np.random.default_rng(np.random.SeedSequence([self.seed, epoch]))
        return rng.permutation(self._n_rows)

    def _batch_indices(self, order: np.ndarray, bi: int) -> np.ndarray:
        """This rank's rows of global batch ``bi`` of ``order``."""
        lo = bi * self.batch_size + self.row_offset
        return order[lo:lo + self.local_batch]

    def _advance(self) -> None:
        """One batch handed to the consumer."""
        with self._lock:
            self._offset += 1

    def _next_epoch(self) -> None:
        with self._lock:
            self._epoch += 1
            self._offset = 0

    def _position(self) -> tuple[int, int]:
        with self._lock:
            return self._epoch, self._offset


class StreamingLoader(ShardedShuffle):
    """(B/P, H, W, C) numpy batches forever, epoch after epoch, read by
    ``num_threads`` worker threads ``read_ahead`` batches ahead. With
    ``world_size`` > 1 rank ``rank``'s rows of each global batch of
    ``batch_size``. ``retry_policy`` (``resilience.RetryPolicy``) retries
    each source read; without one a read error reaches the consumer."""

    def __init__(self, source, batch_size: int, seed: int = 0,
                 rank: int = 0, world_size: int = 1, retry_policy=None,
                 num_threads: int = 8, read_ahead: int = 4,
                 drop_remainder: bool = True):
        self._init_shuffle(len(source), batch_size, seed, rank, world_size,
                           drop_remainder)
        self.source = source
        self.num_threads = num_threads
        self.read_ahead = max(1, read_ahead)
        self.retry_policy = retry_policy

    def _fetch(self, idx: int) -> np.ndarray:
        """One source read, retried per ``retry_policy`` (on a worker)."""
        if self.retry_policy is None:
            return self.source[idx]
        return self.retry_policy.call(self.source.__getitem__, idx)

    def __iter__(self) -> Iterator[np.ndarray]:
        # Not a `with` block: a generator abandoned mid-epoch is finalized
        # by GeneratorExit (perhaps at interpreter shutdown, where a
        # blocking join raises), so the pool shuts down without waiting.
        pool = ThreadPoolExecutor(max_workers=self.num_threads)
        try:
            while True:
                epoch, bi = self._position()
                order = self._epoch_order(epoch)
                nb = self.batches_per_epoch()
                pending: list[list] = []
                while bi < nb or pending:
                    while bi < nb and len(pending) < self.read_ahead:
                        pending.append([pool.submit(self._fetch, int(i))
                                        for i in self._batch_indices(order,
                                                                     bi)])
                        bi += 1
                    batch = np.stack([f.result() for f in pending.pop(0)])
                    self._advance()
                    yield batch
                self._next_epoch()
        finally:
            try:
                pool.shutdown(wait=False, cancel_futures=True)
            except Exception:  # at interpreter shutdown its modules are gone
                pass


class TwoViewPipeline:
    """(view1, view2) device batches from a ``StreamingLoader`` (or any
    loader with its ``state()``, ``batch_size`` and ``row_offset``).
    ``prefetch`` > 0 puts a ``data.DevicePrefetcher`` of that depth between
    the loader and the augmentation: the next loader batches are on their
    way to the device while a step runs."""

    def __init__(self, loader, device: torch.device, seed: int = 0,
                 prefetch: int = 0):
        from .data import DevicePrefetcher

        self.loader = loader
        self.device = torch.device(device)
        self.seed = seed
        # what the batches are pulled from; state() is the consumer's
        self.batches = (DevicePrefetcher(loader, prefetch, self.device)
                        if prefetch > 0 else loader)
        self._it = None

    def _generator(self) -> torch.Generator:
        st = self.batches.state()
        seed = np.random.SeedSequence(
            [self.seed, st["epoch"], st["offset"]]).generate_state(1)[0]
        return torch.Generator(device=self.device).manual_seed(int(seed))

    def state(self) -> dict:
        return self.batches.state()

    def restore(self, state: dict) -> None:
        """Reposition the loader (``datasets.py:348``); the views'
        generator derives from (seed, epoch, offset), so a resumed run
        draws the views an uninterrupted one draws."""
        self.batches.restore(state)
        self._it = None

    def last_timing(self) -> tuple[float, float] | None:
        """The prefetcher's (host fetch s, transfer s) of the last batch,
        or None without one."""
        timing = getattr(self.batches, "last_timing", None)
        return timing() if timing is not None else None

    def __iter__(self):
        return self

    def __next__(self):
        if self._it is None:
            self._it = iter(self.batches)
        gen = self._generator()
        x = torch.as_tensor(next(self._it)).to(self.device)
        x = x.to(torch.float32) / 255.0 if x.dtype == torch.uint8 \
            else x.float()
        return augment_batch_pair(x, gen, self.loader.batch_size,
                                  self.loader.row_offset)


class PairedArrayLoader(ShardedShuffle):
    """(images, tokens) numpy batches of paired in-memory arrays, forever,
    in the shared seeded order: the JAX ``PairedArrayLoader`` of
    ``batch_size / world_size`` rows with ``shard_index=rank`` and
    ``shard_count=world_size``. ``batch_size`` is the global batch."""

    def __init__(self, images, tokens, batch_size: int, seed: int = 0,
                 rank: int = 0, world_size: int = 1):
        images, tokens = np.asarray(images), np.asarray(tokens)
        if len(images) != len(tokens):
            raise ValueError(f"{len(images)} images vs {len(tokens)} tokens")
        self._init_shuffle(len(images), batch_size, seed, rank, world_size)
        self.images, self.tokens = images, tokens

    def __iter__(self):
        while True:
            epoch, start = self._position()
            order = self._epoch_order(epoch)
            for bi in range(start, self.batches_per_epoch()):
                rows = self._batch_indices(order, bi)
                self._advance()
                yield self.images[rows], self.tokens[rows]
            self._next_epoch()


class PairedPipeline:
    """(images, tokens) device batches from a ``PairedArrayLoader``:
    float32 images ([0, 1] from uint8), int64 token ids; ``prefetch`` > 0
    as in ``TwoViewPipeline``."""

    def __init__(self, loader: PairedArrayLoader, device: torch.device,
                 prefetch: int = 0):
        from .data import DevicePrefetcher

        self.loader = loader
        self.device = torch.device(device)
        self.batches = (DevicePrefetcher(loader, prefetch, self.device)
                        if prefetch > 0 else loader)
        self._it = None

    def state(self) -> dict:
        return self.batches.state()

    def restore(self, state: dict) -> None:
        """Reposition the loader (``datasets.py:391``), dropping a running
        iterator."""
        self.batches.restore(state)
        self._it = None

    last_timing = TwoViewPipeline.last_timing

    def __iter__(self):
        return self

    def __next__(self):
        if self._it is None:
            self._it = iter(self.batches)
        images, tokens = next(self._it)
        x = torch.as_tensor(images).to(self.device)
        x = x.to(torch.float32) / 255.0 if x.dtype == torch.uint8 \
            else x.float()
        return x, torch.as_tensor(tokens).to(self.device).long()


def device_prefetch(iterator, depth: int = 2, device=None):
    """Batches moved to ``device`` ``depth`` ahead of consumption: a thin
    constructor over ``data.DevicePrefetcher``."""
    from .data import DevicePrefetcher

    return DevicePrefetcher(iterator, depth=depth, device=device)


def grain_loader(source, batch_size: int, seed: int = 0,
                 worker_count: int = 0, drop_remainder: bool = True):
    """(B, H, W, C) batches of ``source`` through grain's sampler and
    workers (``datasets.py:491``): any source above is a grain
    random-access source. grain is imported here, on call."""
    import grain.python as grain

    sampler = grain.IndexSampler(num_records=len(source),
                                 shard_options=grain.NoSharding(),
                                 shuffle=True, seed=seed)
    loader = grain.DataLoader(
        data_source=source, sampler=sampler,
        operations=[grain.Batch(batch_size=batch_size,
                                drop_remainder=drop_remainder)],
        worker_count=worker_count)
    return iter(loader)
