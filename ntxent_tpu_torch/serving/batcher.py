"""Dynamic micro-batching: many callers, one device.

Counterpart of ``ntxent_tpu/serving/batcher.py`` with the same
semantics. Requests land in a bounded queue; one worker thread drains it
into a concatenated batch, closed by ``max_batch`` rows or
``max_delay_s`` after the first row, runs the engine once and splits the
result per request.

* A full queue rejects at once with ``QueueFullError`` carrying a
  ``retry_after_s`` hint from ``RetryPolicy.delay_for`` (HTTP 429 +
  Retry-After).
* A request whose deadline passes while it is queued is completed with
  ``DeadlineExceededError`` at dispatch and never reaches the device.
* A failing batch fails its requests, never the worker thread.
* ``watchdog=`` (a ``utils.watchdog.StallWatchdog``): the worker beats it
  on every iteration, idle ones included, so a silence means one thing:
  a wedged device call (``server.EmbeddingServer.serve_forever``
  restarts the batcher on it).
* Spans (``obs.trace``; no-ops without an installed event log): the
  worker wraps each coalesced dispatch in ``serve.batch`` (its request
  ids in the span) and, after every requester is woken, emits each
  request's ``serve.queue_wait``.
"""

from __future__ import annotations

import logging
import threading
import time
from collections import deque
from dataclasses import dataclass, field

import numpy as np

from ..obs import trace as _trace
from ..resilience.retry import RetryPolicy
from .engine import InferenceEngine

logger = logging.getLogger(__name__)

__all__ = ["BatcherClosed", "DeadlineExceededError", "MicroBatcher",
           "QueueFullError"]


class QueueFullError(RuntimeError):
    """Backpressure: the request queue is at capacity."""

    def __init__(self, depth: int, retry_after_s: float):
        super().__init__(f"request queue full ({depth} waiting); "
                         f"retry in {retry_after_s:.2f}s")
        self.retry_after_s = retry_after_s


class DeadlineExceededError(TimeoutError):
    """The request's deadline expired before a device call picked it up."""


class BatcherClosed(RuntimeError):
    """submit() after close() (server draining)."""


@dataclass
class _Pending:
    """One queued request and its completion rendezvous."""

    x: np.ndarray
    enqueued: float                       # monotonic
    deadline: float | None                # monotonic, None = no deadline
    request_id: str | None = None         # minted at HTTP ingest
    done: threading.Event = field(default_factory=threading.Event)
    result: np.ndarray | None = None
    error: BaseException | None = None

    def finish(self, result=None, error=None) -> None:
        self.result = result
        self.error = error
        self.done.set()


class MicroBatcher:
    """Bounded-queue request coalescer in front of an InferenceEngine.

    ``submit`` blocks the calling thread until its slice of a batch
    returns; ``submit_async`` returns the pending record. One worker
    thread owns all engine calls.
    """

    def __init__(self, engine: InferenceEngine, max_batch: int | None = None,
                 max_delay_s: float = 0.005, queue_size: int = 64,
                 retry_policy: RetryPolicy | None = None,
                 watchdog=None, poll_s: float = 0.05):
        if queue_size < 1:
            raise ValueError(f"queue_size must be >= 1, got {queue_size}")
        if max_delay_s < 0:
            raise ValueError(f"max_delay_s must be >= 0, got {max_delay_s}")
        self.engine = engine
        self.metrics = engine.metrics
        self.max_batch = int(max_batch or engine.max_bucket)
        self.max_delay_s = float(max_delay_s)
        self.queue_size = int(queue_size)
        self.retry_policy = retry_policy
        self.watchdog = watchdog
        self.poll_s = float(poll_s)
        self.metrics.queue_capacity = self.queue_size
        self._queue: deque[_Pending] = deque()
        self._lock = threading.Lock()
        self._not_empty = threading.Condition(self._lock)
        self._closed = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="ntxent-torch-micro-batcher")
        self._thread.start()

    # -- client side -----------------------------------------------------
    def submit_async(self, x: np.ndarray,
                     timeout_s: float | None = None,
                     request_id: str | None = None) -> _Pending:
        x = np.asarray(x)
        if x.shape[1:] != self.engine.example_shape or x.shape[0] < 1:
            raise ValueError(
                f"request must be (n,) + {self.engine.example_shape} with "
                f"n >= 1, got {x.shape}")
        now = time.monotonic()
        pending = _Pending(
            x=x, enqueued=now,
            deadline=now + timeout_s if timeout_s is not None else None,
            request_id=request_id)
        with self._lock:
            # Checked under the lock that the worker's exit and close()'s
            # drain also take: an accepted request is served or drained.
            if self._closed.is_set():
                raise BatcherClosed("batcher is closed")
            if len(self._queue) >= self.queue_size:
                self.metrics.request_rejected("queue_full")
                raise QueueFullError(len(self._queue),
                                     self._retry_after_s())
            self._queue.append(pending)
            self.metrics.set_queue_depth(len(self._queue))
            self._not_empty.notify()
        self.metrics.request_accepted()
        return pending

    def submit(self, x: np.ndarray, timeout_s: float | None = None,
               request_id: str | None = None) -> np.ndarray:
        """Embed one request of shape ``(n,) + example_shape``.

        Raises ``QueueFullError`` (backpressure), ``DeadlineExceededError``
        (``timeout_s`` elapsed) or the device call's own error.
        ``request_id`` links the worker's spans to the request.
        """
        pending = self.submit_async(x, timeout_s=timeout_s,
                                    request_id=request_id)
        start = pending.enqueued
        # Grace on top of the deadline: the worker expires the request;
        # the extra poll intervals only cover rendezvous scheduling.
        wait = None if timeout_s is None else timeout_s + 4 * self.poll_s
        if not pending.done.wait(wait):
            # Worker stuck in a device call past the grace: mark the
            # request dead so the worker expires it at dispatch.
            pending.deadline = time.monotonic()
            self.metrics.request_done((time.monotonic() - start) * 1e3,
                                      ok=False)
            raise DeadlineExceededError(
                f"no result within {timeout_s:.2f}s (+grace)")
        total_ms = (time.monotonic() - start) * 1e3
        if pending.error is not None:
            self.metrics.request_done(total_ms, ok=False)
            raise pending.error
        self.metrics.request_done(total_ms, ok=True)
        return pending.result

    def _retry_after_s(self) -> float:
        if self.retry_policy is not None:
            return self.retry_policy.delay_for(1)
        return max(self.max_delay_s * 4, 0.05)

    # -- worker side -----------------------------------------------------
    def _take_batch(self) -> list[_Pending]:
        """Block for a first request, then coalesce until the batch is
        full or ``max_delay_s`` has passed since it was taken."""
        with self._not_empty:
            while not self._queue:
                if self._closed.is_set():
                    return []
                self._not_empty.wait(self.poll_s)
                if self.watchdog is not None:
                    self.watchdog.beat()  # idle is progress, not a stall
            batch = [self._queue.popleft()]
        rows = batch[0].x.shape[0]
        flush_at = time.monotonic() + self.max_delay_s
        while rows < self.max_batch:
            with self._not_empty:
                if not self._queue:
                    remaining = flush_at - time.monotonic()
                    if remaining <= 0:
                        break
                    self._not_empty.wait(min(remaining, self.poll_s))
                    if not self._queue:
                        if time.monotonic() >= flush_at:
                            break
                        continue
                nxt = self._queue[0]
                if rows + nxt.x.shape[0] > self.max_batch:
                    break  # leave it for the next batch, keep FIFO order
                batch.append(self._queue.popleft())
            rows += nxt.x.shape[0]
        with self._lock:
            self.metrics.set_queue_depth(len(self._queue))
        return batch

    def _run(self) -> None:
        while True:
            batch = self._take_batch()
            if not batch:
                if self._closed.is_set():
                    self._drain("batcher closed")
                    return
                continue
            try:
                self._serve_batch(batch)
            except Exception:  # noqa: BLE001 — the worker must outlive
                # any bookkeeping failure; _serve_batch fails its requests.
                logger.exception("serving: batch bookkeeping failed")
                for p in batch:
                    if not p.done.is_set():
                        p.finish(error=RuntimeError("internal batcher "
                                                    "error (see log)"))
            if self.watchdog is not None:
                self.watchdog.beat()  # a completed cycle is progress

    def _serve_batch(self, batch: list[_Pending]) -> None:
        now = time.monotonic()
        live: list[_Pending] = []
        expired: list[_Pending] = []
        for p in batch:
            if p.deadline is not None and now >= p.deadline:
                # Expired in the queue: complete it without device work.
                self.metrics.request_rejected("deadline")
                p.finish(error=DeadlineExceededError(
                    "deadline expired while queued "
                    f"({(now - p.enqueued) * 1e3:.0f}ms waiting)"))
                expired.append(p)
            else:
                self.metrics.queue_wait((now - p.enqueued) * 1e3)
                live.append(p)
        if live:
            try:
                x = (live[0].x if len(live) == 1
                     else np.concatenate([p.x for p in live]))
                with _trace.span(
                        "serve.batch", requests=len(live),
                        rows=int(x.shape[0]),
                        request_ids=[p.request_id for p in live
                                     if p.request_id is not None]):
                    out = self.engine.embed(x, n_requests=len(live))
            except Exception as e:  # noqa: BLE001 — fail the batch, not
                # the worker: the loop must outlive any one bad batch.
                logger.exception("serving: device call failed for a batch "
                                 "of %d request(s)", len(live))
                for p in live:
                    p.finish(error=e)
            else:
                off = 0
                for p in live:
                    n = p.x.shape[0]
                    p.finish(result=out[off:off + n])
                    off += n
        # Queue-wait spans go out after every requester is woken (a
        # synchronous event-log write between drain and dispatch would
        # hold the queue); dur_ms still reaches back to the true wait.
        for p in live:
            if p.request_id is not None:
                _trace.emit_span("serve.queue_wait",
                                 (now - p.enqueued) * 1e3,
                                 request_id=p.request_id)
        for p in expired:
            if p.request_id is not None:
                _trace.emit_span("serve.queue_wait",
                                 (now - p.enqueued) * 1e3,
                                 request_id=p.request_id, error="deadline")

    def _drain(self, reason: str) -> None:
        with self._lock:
            waiting = list(self._queue)
            self._queue.clear()
            self.metrics.set_queue_depth(0)
        for p in waiting:
            p.finish(error=BatcherClosed(reason))

    # -- lifecycle -------------------------------------------------------
    def close(self, timeout_s: float = 5.0) -> None:
        """Stop the worker; waiting requests fail with BatcherClosed."""
        self._closed.set()
        with self._not_empty:
            self._not_empty.notify_all()
        self._thread.join(timeout_s)
        self._drain("batcher closed")

    @property
    def closed(self) -> bool:
        return self._closed.is_set()
