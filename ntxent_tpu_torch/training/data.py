"""Host and device read-ahead, counterpart of ``PrefetchIterator`` and
``DevicePrefetcher`` of ``ntxent_tpu/training/data.py:75-311``.

* ``PrefetchIterator``: a producer thread keeps ``depth`` items of an
  iterator in a bounded queue. Every ``put`` of the producer, the
  end-of-stream sentinel's included, blocks while the queue is full and
  gives up once the consumer closed the iterator, so the sentinel is
  never dropped (the reference's ``put_nowait`` of it meets a full queue
  and leaves the consumer waiting forever); once it is taken, every
  ``next`` raises ``StopIteration``. A producer error reaches the
  consumer with its own type.
* ``DevicePrefetcher``: ``depth`` batches ahead of the consumer on the
  device. On a CUDA device each batch's leaves (numpy arrays or CPU
  tensors) are staged in pinned host buffers and copied on a side
  stream; the consumer's stream waits on the copy's event and the batch
  is recorded on it (``record_stream``), so the caching allocator does
  not hand its memory out early. A pinned buffer is refilled only after
  its last copy completed. On the CPU it is read-ahead alone.
  ``state()`` is the position of the next batch the consumer receives,
  so a checkpoint taken under prefetch replays nothing and skips
  nothing; ``last_timing()`` is (host fetch s, transfer s) of the batch
  last handed out (the transfer is the copy's dispatch: the copy runs
  under the steps between its pull and its consumption).
"""

from __future__ import annotations

import collections
import inspect
import queue as queue_mod
import threading
import time
from collections.abc import Iterator

import numpy as np
import torch

__all__ = ["DevicePrefetcher", "PrefetchIterator"]


class PrefetchIterator:
    """Host-thread prefetch: ``depth`` items in flight ahead of the
    consumer."""

    def __init__(self, iterator: Iterator, depth: int = 2):
        self.iterator = iterator
        self.queue: queue_mod.Queue = queue_mod.Queue(maxsize=depth)
        self.done = object()
        self.error: BaseException | None = None
        self._error_raised = False
        self._ended = False  # the sentinel was taken: StopIteration from now
        self._stop = threading.Event()
        self.thread = threading.Thread(target=self._fill, daemon=True)
        self.thread.start()

    def _put(self, item) -> bool:
        """Block until ``item`` is queued; False once ``close`` stopped
        the producer."""
        while not self._stop.is_set():
            try:
                self.queue.put(item, timeout=0.25)
                return True
            except queue_mod.Full:
                continue
        return False

    def _fill(self):
        try:
            for item in self.iterator:
                if not self._put(item):
                    return
        except BaseException as e:  # surfaced on the consumer thread
            self.error = e
        self._put(self.done)

    def close(self, timeout: float = 5.0):
        """Stop the producer and release buffered items; join it for at
        most ``timeout``. A producer error the consumer never saw is
        raised here."""
        self._stop.set()
        while True:  # drain so a blocked put sees the stop flag
            try:
                self.queue.get_nowait()
            except queue_mod.Empty:
                break
        self.thread.join(timeout=timeout)
        if self.error is not None and not self._error_raised:
            self._error_raised = True
            raise self.error

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        if exc and exc[0] is not None:
            # already unwinding: a pending producer error must not replace
            # the exception in flight
            try:
                self.close()
            except BaseException:
                pass
            return
        self.close()

    def __iter__(self):
        return self

    def __next__(self):
        if self._ended:
            raise StopIteration
        item = self.queue.get()
        if item is self.done:
            self._ended = True
            if self.error is not None:
                self._error_raised = True
                raise self.error
            raise StopIteration
        return item


def _leaves(item) -> list:
    return list(item) if isinstance(item, (tuple, list)) else [item]


def _rebuild(item, leaves: list):
    if isinstance(item, (tuple, list)):
        return type(item)(leaves)
    return leaves[0]


class _Staging:
    """Pinned host buffers by leaf shape, each with the event of the copy
    that last read it: a buffer is refilled only once that copy is done,
    and a new one is made while every buffer is still being read."""

    def __init__(self):
        self.free: dict[tuple, list] = collections.defaultdict(list)

    def take(self, like: torch.Tensor) -> torch.Tensor:
        pool = self.free[(tuple(like.shape), like.dtype)]
        for i, (buffer, event) in enumerate(pool):
            if event.query():
                del pool[i]
                return buffer
        return torch.empty(like.shape, dtype=like.dtype, pin_memory=True)

    def give(self, buffer: torch.Tensor, event) -> None:
        self.free[(tuple(buffer.shape), buffer.dtype)].append((buffer, event))


class DevicePrefetcher:
    """``depth`` batches of ``iterator`` already on ``device`` (or on
    their way) ahead of the consumer. ``state()``/``restore()`` exist when
    the iterator has them."""

    def __init__(self, iterator, depth: int = 2, device=None):
        self._inner = iterator
        self.iterator = iter(iterator)
        self.depth = max(1, int(depth))
        self.device = torch.device("cpu" if device is None else device)
        self._cuda = self.device.type == "cuda"
        self._stream = None
        self._staging = _Staging()
        self._buf: collections.deque = collections.deque()
        self._exhausted = False
        self._timing: tuple[float, float] | None = None
        if hasattr(iterator, "state") and hasattr(iterator, "restore"):
            self.state = self._state
            self.restore = self._restore

    def _put(self, item):
        """The batch on the device: one side-stream copy a leaf from a
        pinned buffer, then an event the consumer waits on."""
        leaves = [torch.as_tensor(leaf) if isinstance(leaf, np.ndarray)
                  else leaf for leaf in _leaves(item)]
        if not self._cuda:
            return _rebuild(item, leaves), None
        if self._stream is None:
            self._stream = torch.cuda.Stream(self.device)
        staged, out = [], []
        with torch.cuda.stream(self._stream):
            for leaf in leaves:
                if leaf.device.type != "cpu":
                    out.append(leaf)
                    continue
                host = self._staging.take(leaf)
                host.copy_(leaf)
                staged.append(host)
                out.append(host.to(self.device, non_blocking=True))
            event = torch.cuda.Event()
            event.record(self._stream)
        for host in staged:
            self._staging.give(host, event)
        return _rebuild(item, out), event

    def _pull(self) -> None:
        st = self._inner.state() if hasattr(self, "state") else None
        t0 = time.perf_counter()
        try:
            item = next(self.iterator)
        except StopIteration:
            self._exhausted = True
            return
        t1 = time.perf_counter()
        item, event = self._put(item)
        self._buf.append((item, event, st, t1 - t0,
                          time.perf_counter() - t1))

    def last_timing(self) -> tuple[float, float] | None:
        """(host fetch s, transfer dispatch s) of the batch the last
        ``__next__`` returned; None before the first."""
        return self._timing

    def _state(self) -> dict:
        return self._buf[0][2] if self._buf else self._inner.state()

    def _restore(self, state: dict) -> None:
        # the read-ahead belongs to the old position: drop it and re-enter
        # the inner iterator at the restored one
        self._buf.clear()
        self._exhausted = False
        self._inner.restore(state)
        self.iterator = iter(self._inner)

    def close(self, timeout: float = 5.0) -> None:
        """Release buffered batches; close a closeable inner iterator
        (a ``PrefetchIterator``'s producer), whose pending error it
        raises."""
        self._buf.clear()
        inner_close = getattr(self._inner, "close", None)
        if inner_close is None:
            return
        try:
            takes_arg = bool(inspect.signature(inner_close).parameters)
        except (TypeError, ValueError):
            takes_arg = False
        if takes_arg:
            inner_close(timeout)
        else:
            inner_close()

    def __iter__(self):
        return self

    def __next__(self):
        while not self._exhausted and len(self._buf) < self.depth:
            self._pull()
        if not self._buf:
            raise StopIteration
        item, event, _, host_s, transfer_s = self._buf.popleft()
        self._timing = (host_s, transfer_s)
        if event is not None:
            consumer = torch.cuda.current_stream(self.device)
            consumer.wait_event(event)
            for leaf in _leaves(item):
                leaf.record_stream(consumer)
        return item
