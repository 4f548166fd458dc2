"""Why a bucket's first run happened: the cause vocabulary of
``ntxent_tpu/analysis/graph/recompile.py`` (``diff_signatures``,
``RecompileDiffer``), kept private to the serving engine.

Each first run's signature (structure, dtype, weights version, shape) is
recorded per cache key; a new key is diffed against the nearest prior
signature, and the most expensive differing field names the cause:

* ``structure``: the weights' layout changed (a new module is warmed);
* ``dtype``: the same model at another input dtype (the int8 rung);
* ``weights_reload``: the same layout at a new version
  (``update_variables``);
* ``new_shape``: a bucket never run before (the ladder growing);
* ``first_compile``: nothing to diff against;
* ``recompile``: an identical signature run first again (cache thrash).
"""

from __future__ import annotations

import threading

__all__ = ["RecompileDiffer", "diff_signatures"]

# the first listed field that differs names the cause
_FIELD_TO_CAUSE = (
    ("structure", "structure"),
    ("dtype", "dtype"),
    ("version", "weights_reload"),
    ("shape", "new_shape"),
)


def diff_signatures(new: dict, prior: dict) -> str:
    """Cause of running ``new`` first given the nearest ``prior``."""
    for field, cause in _FIELD_TO_CAUSE:
        if new.get(field) != prior.get(field):
            return cause
    return "recompile"


def _distance(a: dict, b: dict) -> int:
    return sum(1 for k in set(a) | set(b) if a.get(k) != b.get(k))


class RecompileDiffer:
    """``observe(key, signature)`` returns the cause of this first run.
    Thread-safe; the history is bounded (``max_history``, oldest evicted
    first), since every weight swap mints new keys."""

    def __init__(self, max_history: int = 256):
        self._lock = threading.Lock()
        self._by_key: dict = {}
        self._max_history = max(int(max_history), 1)

    def _insert(self, key, signature: dict) -> None:
        self._by_key.pop(key, None)  # move to newest on re-observe
        self._by_key[key] = dict(signature)
        while len(self._by_key) > self._max_history:
            self._by_key.pop(next(iter(self._by_key)))

    def observe(self, key, signature: dict) -> str:
        with self._lock:
            prior = self._by_key.get(key)
            if prior is not None:
                self._insert(key, signature)
                return diff_signatures(signature, prior) \
                    if signature != prior else "recompile"
            if not self._by_key:
                self._insert(key, signature)
                return "first_compile"
            nearest = min(self._by_key.values(),
                          key=lambda s: _distance(signature, s))
            self._insert(key, signature)
            return diff_signatures(signature, nearest)
