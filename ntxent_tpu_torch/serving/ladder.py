"""Traffic-adaptive bucket-ladder math: histogram in, bucket edges out.
Counterpart of ``ntxent_tpu/serving/ladder.py``, the same stdlib code.

The serving engine pads every request up to a ladder rung, and
``ServingMetrics`` prices the cost as ``serving_padding_waste``. This
module is the pure half of measure, optimize, re-warm, swap
(``serving/engine.py`` owns the state machine).

Two pieces:

* ``SizeHistogram`` — an online, exponentially decayed histogram of
  device-chunk row counts. Decay is per OBSERVATION (each new chunk
  multiplies every existing weight by ``decay``), so a traffic shift
  ages out at request rate, not wall-clock rate — exactly the rate at
  which the padding bill accrues.
* ``optimize_ladder`` — dynamic programming over the histogram: pick at
  most ``max_buckets`` rungs that minimize expected padded rows. The
  classic structure applies: an optimal rung sits AT an observed size
  (lowering a rung to its group's max row count strictly reduces
  padding), so the DP partitions the sorted observed sizes into
  contiguous groups and charges each group ``weight x (group_max -
  size)``. The configured maximum bucket is always kept as the top rung
  — it is the chunking cap for oversized requests and the shape the
  batcher/row-cap limits were provisioned against, so it must never
  move.

Everything here is stdlib and plain dicts, with no engine state: the DP
is exact and deterministic, so a test can pin its output.
"""

from __future__ import annotations

import threading
from collections.abc import Mapping, Sequence

__all__ = ["SizeHistogram", "expected_padded_rows", "optimize_ladder"]

# Rescale the internal boost factor before it can overflow float range;
# entries whose decayed weight has fallen below NEGLIGIBLE (relative to
# one fresh observation) are dropped so the dict stays bounded by the
# distinct sizes of RECENT traffic.
_RESCALE_AT = 1e30
_NEGLIGIBLE = 1e-9


class SizeHistogram:
    """Exponentially decayed histogram of request/chunk row counts.

    ``observe(rows)`` gives the new sample weight 1 and implicitly
    multiplies every older sample by ``decay`` (implemented as a
    growing boost on new samples + lazy normalization, so one observe
    is O(1), not O(distinct sizes)). ``weights()`` returns the decayed
    view; ``observations`` counts raw observes forever (the
    min-requests cold-start gate reads it). Thread-safe: the engine's
    request threads observe while the re-warm worker reads.
    """

    def __init__(self, decay: float = 0.999):
        if not 0.0 < decay <= 1.0:
            raise ValueError(f"decay must be in (0, 1], got {decay}")
        self.decay = float(decay)
        self._weights: dict[int, float] = {}
        self._boost = 1.0
        self._observations = 0
        self._lock = threading.Lock()

    def observe(self, rows: int, weight: float = 1.0) -> None:
        rows = int(rows)
        if rows < 1:
            raise ValueError(f"rows must be >= 1, got {rows}")
        with self._lock:
            self._observations += 1
            self._boost /= self.decay
            self._weights[rows] = (self._weights.get(rows, 0.0)
                                   + float(weight) * self._boost)
            if self._boost > _RESCALE_AT:
                self._rescale_locked()

    def _rescale_locked(self) -> None:
        boost = self._boost
        self._weights = {s: w / boost for s, w in self._weights.items()
                         if w / boost > _NEGLIGIBLE}
        self._boost = 1.0

    @property
    def observations(self) -> int:
        """Cumulative (undecayed) observe count."""
        with self._lock:
            return self._observations

    def weights(self) -> dict[int, float]:
        """Decayed weight per size (a fresh observation weighs 1.0);
        negligible tails are dropped."""
        with self._lock:
            boost = self._boost
            return {s: w / boost for s, w in self._weights.items()
                    if w / boost > _NEGLIGIBLE}

    def total_weight(self) -> float:
        return sum(self.weights().values())


def expected_padded_rows(weights: Mapping[int, float],
                         ladder: Sequence[int]) -> float:
    """Expected padded rows per (weighted) chunk under ``ladder``.

    ``weights`` maps chunk row count -> weight (a ``SizeHistogram``
    view). Sizes above the top rung are clamped to it — the engine
    chunks oversized requests through the max bucket, so only the
    clamped remainder ever pads. The objective ``optimize_ladder``
    minimizes, shared so the hysteresis prices ladders identically.
    """
    rungs = sorted(set(int(b) for b in ladder))
    if not rungs:
        raise ValueError("ladder must have at least one rung")
    top = rungs[-1]
    cost = 0.0
    for size, weight in weights.items():
        size = min(int(size), top)
        rung = next(b for b in rungs if b >= size)
        cost += float(weight) * (rung - size)
    return cost


def optimize_ladder(weights: Mapping[int, float], max_buckets: int,
                    max_bucket: int, prior: Sequence[int],
                    ) -> tuple[int, ...]:
    """Bucket edges minimizing expected padded rows, DP-exact.

    * ``weights``: decayed size histogram (chunk rows -> weight);
    * ``max_buckets``: ladder-size budget (total rungs, top included);
    * ``max_bucket``: the immovable top rung (chunking cap);
    * ``prior``: the cold-start ladder — returned verbatim when the
      histogram is empty, so an idle or freshly booted engine keeps the
      configured buckets.

    Returns a sorted tuple of unique rungs ending in ``max_bucket``,
    ``len <= max_buckets``. Single-size traffic collapses to that size
    plus the top rung. Deterministic for a given histogram.
    """
    max_bucket = int(max_bucket)
    prior_ladder = tuple(sorted(set(int(b) for b in prior)))
    agg: dict[int, float] = {}
    for size, weight in weights.items():
        weight = float(weight)
        if weight <= 0.0:
            continue
        size = min(int(size), max_bucket)
        if size < 1:
            continue
        agg[size] = agg.get(size, 0.0) + weight
    if not agg:
        return prior_ladder  # cold start: keep the configured prior
    if max_buckets < 2:
        return (max_bucket,)

    sizes = sorted(agg)
    n = len(sizes)
    # The top rung is forced at max_bucket; when it is not itself an
    # observed size it occupies one budget slot without covering a
    # group.
    budget = max_buckets if sizes[-1] == max_bucket else max_buckets - 1
    budget = min(budget, n)

    # Prefix sums for O(1) group cost: cost(i..j) with the rung at
    # sizes[j] is sizes[j]*sum(w) - sum(w*s) over the group.
    w = [agg[s] for s in sizes]
    pw = [0.0] * (n + 1)
    pws = [0.0] * (n + 1)
    for i, s in enumerate(sizes):
        pw[i + 1] = pw[i] + w[i]
        pws[i + 1] = pws[i] + w[i] * s

    def group_cost(i: int, j: int) -> float:
        """Padding cost of sizes[i..j] (inclusive) padded to sizes[j]."""
        return sizes[j] * (pw[j + 1] - pw[i]) - (pws[j + 1] - pws[i])

    inf = float("inf")
    # dp[j][b]: min cost covering the first j sizes with exactly b
    # groups; more groups never cost more, so dp[n][budget] is optimal.
    dp = [[inf] * (budget + 1) for _ in range(n + 1)]
    dp[0][0] = 0.0
    back = [[0] * (budget + 1) for _ in range(n + 1)]
    for j in range(1, n + 1):
        for b in range(1, min(budget, j) + 1):
            best, arg = inf, j - 1
            for i in range(b - 1, j):
                prev = dp[i][b - 1]
                if prev == inf:
                    continue
                cost = prev + group_cost(i, j - 1)
                if cost < best:
                    best, arg = cost, i
            dp[j][b] = best
            back[j][b] = arg
    b = min(budget, n)
    rungs: list[int] = []
    j = n
    while j > 0:
        rungs.append(sizes[j - 1])  # each group's rung is its max size
        j = back[j][b]
        b -= 1
    ladder = tuple(sorted(set(rungs) | {max_bucket}))
    assert len(ladder) <= max_buckets, (ladder, max_buckets)
    return ladder
