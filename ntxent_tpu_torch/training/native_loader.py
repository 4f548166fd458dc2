"""The native streaming loader, counterpart of
``ntxent_tpu/training/native_loader.py``: C++ worker threads gather the
rows of a memory-mapped row store into dense batch buffers
(``csrc/loader.cpp``, host C++ built at the first loader by
``ops._build.load_host``), ``read_ahead`` batches ahead of the consumer
and outside the GIL.

The policy stays in Python: ``NativeStreamingLoader`` is a
``datasets.ShardedShuffle`` like ``StreamingLoader``, so the seeded
order, each rank's rows and ``state()`` are the same and the two
loaders give the same batches. It needs a memmap (``np.load(...,
mmap_mode='r')``, or an ``ArraySource`` over one): sources that decode
per item keep ``StreamingLoader``. Importing this module builds nothing.
"""

from __future__ import annotations

import ctypes
import mmap as mmaplib
from collections import deque
from collections.abc import Iterator

import numpy as np

from ..ops import _build
from .datasets import ArraySource, ShardedShuffle

__all__ = ["NativeStreamingLoader", "native_loader_available"]


def _library() -> ctypes.CDLL:
    lib = _build.load_host("loader")
    lib.ntx_loader_open.restype = ctypes.c_void_p
    lib.ntx_loader_open.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int64, ctypes.c_int32, ctypes.c_int32]
    lib.ntx_loader_submit.restype = ctypes.c_int
    lib.ntx_loader_submit.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_uint8)]
    lib.ntx_loader_next.restype = ctypes.c_int64
    lib.ntx_loader_next.argtypes = [ctypes.c_void_p]
    lib.ntx_loader_outstanding.restype = ctypes.c_int64
    lib.ntx_loader_outstanding.argtypes = [ctypes.c_void_p]
    lib.ntx_loader_close.restype = None
    lib.ntx_loader_close.argtypes = [ctypes.c_void_p]
    return lib


def native_loader_available() -> bool:
    """True when the engine is built or a host compiler can build it."""
    return (_build.host_library_path("loader").exists()
            or _build.host_compiler() is not None)


def _as_memmap(source) -> tuple[np.memmap, int]:
    """The source's memmap and the file offset of its row 0
    (``native_loader.py:66-103``).

    The engine reads row ``i`` at ``offset + i * row_bytes``, so the
    offset comes from the view's data pointer against its root mapping:
    a contiguous slice (``mm[5000:]``) gathers the right rows. A strided
    view is refused (its rows are not ``row_bytes`` apart in the file),
    as is any source that is not a memmap."""
    if isinstance(source, ArraySource):
        source = source.images
    if not isinstance(source, np.memmap):
        raise TypeError(
            "NativeStreamingLoader needs a np.memmap-backed source "
            f"(np.load(..., mmap_mode='r')), got {type(source).__name__}; "
            "use StreamingLoader for in-memory or per-item-decode sources")
    if source.filename is None:
        raise TypeError("memmap has no backing file")
    if not source.flags["C_CONTIGUOUS"]:
        raise TypeError("NativeStreamingLoader needs a C-contiguous memmap "
                        "view (strided slices change the on-disk row "
                        "stride); index rows via the loader's shuffle "
                        "instead")
    root = getattr(source, "_mmap", None)
    if root is None:
        raise TypeError("memmap view carries no root mmap")
    # numpy maps the file from the allocation-granular floor of the header
    # offset; the view's distance from that base is its place in the file
    base_addr = np.frombuffer(root, dtype=np.uint8).ctypes.data
    page_base = source.offset - source.offset % mmaplib.ALLOCATIONGRANULARITY
    file_off = page_base + (source.ctypes.data - base_addr)
    if file_off < 0:
        raise ValueError("memmap data pointer precedes its root mapping")
    return source, int(file_off)


class NativeStreamingLoader(ShardedShuffle):
    """``StreamingLoader``'s constructor, order and ``state()`` over the
    native gather engine; ``retry_policy`` retries a refused submission
    (``OSError``)."""

    def __init__(self, source, batch_size: int, seed: int = 0,
                 rank: int = 0, world_size: int = 1, retry_policy=None,
                 num_threads: int = 8, read_ahead: int = 4,
                 drop_remainder: bool = True):
        mm, file_off = _as_memmap(source)
        self._init_shuffle(len(mm), batch_size, seed, rank, world_size,
                           drop_remainder)
        self._mm = mm
        self._file_offset = file_off
        self._row_shape = mm.shape[1:]
        self._dtype = mm.dtype
        self._row_bytes = int(mm.dtype.itemsize
                              * np.prod(mm.shape[1:], dtype=np.int64))
        self.num_threads = num_threads
        self.read_ahead = max(1, read_ahead)
        self.retry_policy = retry_policy
        self._lib = _library()  # built (or loaded) here: fail at init

    def _submit_once(self, handle, order: np.ndarray, bi: int) -> np.ndarray:
        idxs = np.ascontiguousarray(self._batch_indices(order, bi),
                                    dtype=np.int64)
        out = np.empty((len(idxs), *self._row_shape), self._dtype)
        rc = self._lib.ntx_loader_submit(
            handle, idxs.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            len(idxs), out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
        if rc != 0:
            # the transient class a retry policy covers by default
            raise OSError("native loader rejected batch submission")
        return out

    def _submit(self, handle, order: np.ndarray, bi: int) -> np.ndarray:
        """Queue batch ``bi``; the workers gather into the returned buffer,
        which stays untouched until the matching ``next`` drains it."""
        if self.retry_policy is None:
            return self._submit_once(handle, order, bi)
        return self.retry_policy.call(self._submit_once, handle, order, bi)

    def __iter__(self) -> Iterator[np.ndarray]:
        handle = self._lib.ntx_loader_open(
            str(self._mm.filename).encode(), self._file_offset,
            int(self._n_rows), self._row_bytes, self.local_batch,
            int(self.num_threads), int(self.read_ahead))
        if not handle:
            raise RuntimeError(
                f"native loader failed to open {self._mm.filename}")
        try:
            while True:
                epoch, bi = self._position()
                order = self._epoch_order(epoch)
                nb = self.batches_per_epoch()
                inflight: deque[np.ndarray] = deque()
                while bi < nb and len(inflight) < self.read_ahead:
                    inflight.append(self._submit(handle, order, bi))
                    bi += 1
                while inflight:
                    rows = self._lib.ntx_loader_next(handle)
                    if rows < 0:
                        raise RuntimeError("native loader next() failed")
                    out = inflight.popleft()
                    if bi < nb:
                        inflight.append(self._submit(handle, order, bi))
                        bi += 1
                    self._advance()
                    yield out[:rows]
                self._next_epoch()
        finally:
            self._lib.ntx_loader_close(handle)
