"""Retries with exponential backoff, counterpart of
``ntxent_tpu/resilience/retry.py``.

``RetryPolicy.delay_for`` is the backoff schedule (exponential with
seeded jitter): the micro-batcher answers a full queue with 429 and a
``Retry-After`` from it, so clients back off the way the framework's own
retries do. ``RetryPolicy.call`` / ``wrap`` retry a function on
transient errors (``OSError``, ``TimeoutError``) under an attempt cap
and an optional wall-clock budget; the checkpoint manager wraps its
physical writes and reads in one. A retry is logged, counted
(``retries_total``; a give-up in ``retries_exhausted_total``) and emitted
as a ``retry`` event.
"""

from __future__ import annotations

import dataclasses
import functools
import logging
import random
import time
from collections.abc import Callable
from typing import Any

from ..obs import events as obs_events
from ..obs.registry import default_registry

__all__ = ["DEFAULT_TRANSIENT", "RetryBudgetExceeded", "RetryPolicy"]

logger = logging.getLogger(__name__)

_RETRIES = default_registry().counter(
    "retries_total", "transient faults retried by RetryPolicy")
_EXHAUSTED = default_registry().counter(
    "retries_exhausted_total",
    "RetryPolicy give-ups (attempts or wall-clock budget spent)")

# Filesystem and network hiccups (OSError covers ConnectionError and its
# kin) and timeouts; not RuntimeError: a wedged backend stays wedged.
DEFAULT_TRANSIENT: tuple[type[BaseException], ...] = (OSError, TimeoutError)


class RetryBudgetExceeded(RuntimeError):
    """The policy's wall-clock budget ran out mid-retry; the last
    underlying exception is the ``__cause__``."""


@dataclasses.dataclass
class RetryPolicy:
    """``delay_for(k) = min(base * multiplier**(k-1), max) * (1 + U*jitter)``
    with U uniform in [0, 1) from a ``seed``-derived generator.

    ``call(fn, *args)`` runs ``fn`` up to ``max_attempts`` times, sleeping
    ``delay_for(k)`` after the k-th failure. Only instances of
    ``retry_on`` are retried; anything else propagates at once. With
    ``budget_s``, a retry whose sleep would take the call past the budget
    raises ``RetryBudgetExceeded`` from the last error instead."""

    max_attempts: int = 3
    base_delay_s: float = 0.1
    multiplier: float = 2.0
    max_delay_s: float = 30.0
    jitter: float = 0.1
    retry_on: tuple[type[BaseException], ...] = DEFAULT_TRANSIENT
    budget_s: float | None = None
    seed: int = 0
    # injectable clock and sleep: tests pin the schedule without waiting
    sleep: Callable[[float], None] = time.sleep
    monotonic: Callable[[], float] = time.monotonic

    def __post_init__(self):
        if self.max_attempts < 1:
            raise ValueError(f"max_attempts must be >= 1, "
                             f"got {self.max_attempts}")
        if self.base_delay_s < 0 or self.max_delay_s < 0:
            raise ValueError("delays must be non-negative")
        self._rng = random.Random(self.seed)

    def delay_for(self, attempt: int) -> float:
        """Backoff before retry number ``attempt`` (1-based: the sleep
        after the ``attempt``-th failure)."""
        base = min(self.base_delay_s * self.multiplier ** (attempt - 1),
                   self.max_delay_s)
        return base * (1.0 + self._rng.random() * self.jitter)

    def call(self, fn: Callable, *args, **kwargs) -> Any:
        start = self.monotonic()
        name = getattr(fn, "__name__", repr(fn))
        for attempt in range(1, self.max_attempts + 1):
            try:
                return fn(*args, **kwargs)
            except self.retry_on as e:
                if attempt >= self.max_attempts:
                    _EXHAUSTED.inc()
                    raise
                delay = self.delay_for(attempt)
                if self.budget_s is not None and \
                        self.monotonic() - start + delay > self.budget_s:
                    _EXHAUSTED.inc()
                    raise RetryBudgetExceeded(
                        f"retry budget {self.budget_s:.1f}s exhausted after "
                        f"{attempt} attempt(s) of {name!r}") from e
                _RETRIES.inc()
                # "attempt" is the record's supervisor attempt; the retry
                # ordinal rides as call_attempt
                obs_events.emit(
                    "retry", fn=name, call_attempt=attempt,
                    max_attempts=self.max_attempts,
                    error=f"{type(e).__name__}: {e}",
                    delay_s=round(delay, 4))
                logger.warning("transient failure in %r (attempt %d/%d): %s "
                               "-- retrying in %.2fs", name, attempt,
                               self.max_attempts, e, delay)
                self.sleep(delay)
        raise AssertionError("unreachable")  # pragma: no cover

    def wrap(self, fn: Callable) -> Callable:
        """``fn`` with this policy baked in."""

        @functools.wraps(fn)
        def wrapped(*args, **kwargs):
            return self.call(fn, *args, **kwargs)

        return wrapped
