"""Backoff schedule for the serving path's Retry-After hints.

The part of ``ntxent_tpu/resilience/retry.py`` that the micro-batcher
uses: ``RetryPolicy.delay_for`` (exponential backoff with seeded
jitter). A full queue answers 429 with ``Retry-After`` taken from this
schedule, so clients back off the way the framework's own retries do.
Retrying calls comes with the training slice.
"""

from __future__ import annotations

import dataclasses
import random

__all__ = ["RetryPolicy"]


@dataclasses.dataclass
class RetryPolicy:
    """``delay_for(k) = min(base * multiplier**(k-1), max) * (1 + U*jitter)``
    with U uniform in [0, 1) from a ``seed``-derived generator."""

    base_delay_s: float = 0.1
    multiplier: float = 2.0
    max_delay_s: float = 30.0
    jitter: float = 0.1
    seed: int = 0

    def __post_init__(self):
        if self.base_delay_s < 0 or self.max_delay_s < 0:
            raise ValueError("delays must be non-negative")
        self._rng = random.Random(self.seed)

    def delay_for(self, attempt: int) -> float:
        """Backoff before retry number ``attempt`` (1-based: the sleep
        after the ``attempt``-th failure)."""
        base = min(self.base_delay_s * self.multiplier ** (attempt - 1),
                   self.max_delay_s)
        return base * (1.0 + self._rng.random() * self.jitter)
