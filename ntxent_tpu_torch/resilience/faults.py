"""Deterministic fault injection, counterpart of
``ntxent_tpu/resilience/faults.py``: the same plan grammar, the same
ordinals, the same hooks.

Each recovery tier has a fault that drives it (``train --chaos
'nan@3,sigterm@6,truncate@1'``). Every plan entry fires once, at a
deterministic ordinal:

* ``nan@k``: NaN-fill the float tensors of the k-th batch served (integer
  tensors, CLIP's tokens, stay) -> the step's divergence guard;
* ``sigterm@k``: SIGTERM to this process while serving the k-th batch ->
  ``PreemptionGuard``'s save-and-stop and the supervisor's resume;
* ``kill@k``: SIGKILL at the k-th batch (no cleanup, no final save) ->
  the crash audit (``crashsim.py``);
* ``crash@k``: ``ChaosError`` at the k-th batch -> the supervisor's
  restart after an exception;
* ``fetch@n``: a transient ``OSError`` on the n-th source read -> the
  loader's ``RetryPolicy``;
* ``diskfull@n``: ``OSError(ENOSPC)`` at the start of the n-th physical
  checkpoint write (``CheckpointManager(fault_hook=...)``) -> the
  skip-a-checkpoint contract, on the sync and the async writer;
* ``shrink@k`` / ``grow@k``: ``TopologyChange`` at the k-th batch -> a
  restart (the elastic world rebuild of the reference is not ported: the
  supervisor restarts on the same world);
* ``truncate@a``: after attempt a ends, truncate the newest checkpoint's
  largest file -> checksum verification and the newest-valid fallback;
* the fleet's ``killworker``, ``slowworker``, ``spike``, ``drainworker``
  and the shard fleet's ``killshard``, ``lagshard``: parsed into the plan
  as in the reference, for the serving fleet (ROADMAP.md Queue A 8(c),
  12) that will tick them; training never fires them.

``FaultPlan`` is the parsed, immutable spec; ``FaultInjector`` carries the
counters and the hooks. Batch ordinals (nan, sigterm, kill, crash,
shrink, grow) count served batches; fetch and diskfull their own IO
calls; truncate the supervisor's attempts. One injector serves a whole
supervised run, so ordinals continue across restarts: a plan is a script
for the run.
"""

from __future__ import annotations

import dataclasses
import errno
import logging
import os
import signal
import threading
from pathlib import Path

import numpy as np
import torch

logger = logging.getLogger(__name__)

__all__ = ["ChaosError", "FaultInjector", "FaultPlan", "TopologyChange",
           "truncate_checkpoint_file"]

# each action's FaultPlan field: batch ordinals, IO call ordinals,
# supervisor attempts or fleet supervision ticks
_FIELDS = {"nan": "nan_batches", "sigterm": "sigterm_batches",
           "kill": "kill_batches", "crash": "crash_batches",
           "fetch": "fetch_calls", "diskfull": "diskfull_writes",
           "shrink": "shrink_batches", "grow": "grow_batches",
           "truncate": "truncate_attempts",
           "killworker": "killworker_ticks",
           "slowworker": "slowworker_ticks", "spike": "spike_ticks",
           "drainworker": "drainworker_ticks",
           "killshard": "killshard_ticks", "lagshard": "lagshard_ticks"}


class ChaosError(RuntimeError):
    """An injected hard failure (``crash@k``)."""


class TopologyChange(RuntimeError):
    """The world changed under the run (``shrink@k`` / ``grow@k``): the
    attempt ends and the next one would run on another device set."""

    def __init__(self, action: str, batch: int):
        super().__init__(f"chaos: injected {action} at batch {batch}")
        self.action = action
        self.batch = batch


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """Immutable, seeded chaos plan. Ordinals are 1-based."""

    nan_batches: tuple[int, ...] = ()
    sigterm_batches: tuple[int, ...] = ()
    kill_batches: tuple[int, ...] = ()
    crash_batches: tuple[int, ...] = ()
    fetch_calls: tuple[int, ...] = ()
    diskfull_writes: tuple[int, ...] = ()
    shrink_batches: tuple[int, ...] = ()
    grow_batches: tuple[int, ...] = ()
    truncate_attempts: tuple[int, ...] = ()
    killworker_ticks: tuple[int, ...] = ()
    slowworker_ticks: tuple[int, ...] = ()
    spike_ticks: tuple[int, ...] = ()
    drainworker_ticks: tuple[int, ...] = ()
    killshard_ticks: tuple[int, ...] = ()
    lagshard_ticks: tuple[int, ...] = ()
    seed: int = 0

    @classmethod
    def parse(cls, spec: str, seed: int = 0) -> "FaultPlan":
        """Parse ``"nan@3,sigterm@6,kill@4"`` (the ``--chaos`` syntax). A
        malformed entry or an unknown action raises ``ValueError`` naming
        the valid actions."""
        buckets: dict[str, list[int]] = {k: [] for k in _FIELDS}
        for item in filter(None, (s.strip() for s in spec.split(","))):
            kind, sep, at = item.partition("@")
            if not sep:
                raise ValueError(
                    f"bad fault {item!r}: expected <action>@<ordinal>, "
                    f"e.g. 'nan@3'; valid actions: "
                    f"{', '.join(sorted(_FIELDS))}")
            if kind not in buckets:
                raise ValueError(
                    f"unknown fault action {kind!r} in {item!r}; valid "
                    f"actions: {', '.join(sorted(_FIELDS))}")
            try:
                ordinal = int(at)
            except ValueError:
                raise ValueError(f"bad fault ordinal in {item!r}") from None
            if ordinal < 1:
                raise ValueError(f"fault ordinal must be >= 1: {item!r}")
            buckets[kind].append(ordinal)
        return cls(seed=seed, **{_FIELDS[kind]: tuple(ordinals)
                                 for kind, ordinals in buckets.items()})


def _poison(batch):
    """A batch (a tuple of tensors) with its float tensors NaN-filled on
    their own device; integer tensors (CLIP's tokens: an integer has no
    NaN, and the guard watches the loss) stay."""
    return tuple(torch.full_like(x, float("nan"))
                 if x.is_floating_point() else x for x in batch)


def truncate_checkpoint_file(directory: str | os.PathLike) -> Path | None:
    """Truncate the largest file of the newest checkpoint step directory to
    half its size (a torn write). Returns the truncated path, or None when
    there was nothing to corrupt."""
    root = Path(directory)
    if not root.is_dir():
        return None
    steps = sorted((int(p.name), p) for p in root.iterdir()
                   if p.is_dir() and p.name.isdigit())
    if not steps:
        return None
    step_dir = steps[-1][1]
    files = sorted((p for p in step_dir.rglob("*") if p.is_file()),
                   key=lambda p: p.stat().st_size)
    if not files or files[-1].stat().st_size == 0:
        return None
    victim = files[-1]
    size = victim.stat().st_size
    with open(victim, "r+b") as f:
        f.truncate(size // 2)
    logger.warning("chaos: truncated %s from %d to %d bytes", victim, size,
                   size // 2)
    return victim


class FaultInjector:
    """Runtime counters and wrapping hooks of a ``FaultPlan``. One
    injector a supervised run: the ordinals count across restarts."""

    def __init__(self, plan: FaultPlan):
        self.plan = plan
        self._batches = 0
        self._fetches = 0
        self._ckpt_writes = 0
        self._attempts = 0
        self._fetch_lock = threading.Lock()  # reads run on loader threads
        self.fired: list[str] = []

    # -- batch faults (wrap the training data iterator) ------------------
    def wrap_iterator(self, data_iter):
        """Chaos-wrap a batch iterator, keeping ``state()`` / ``restore()``
        when the inner iterator has them (``fit`` keys on those)."""
        if hasattr(data_iter, "state") and hasattr(data_iter, "restore"):
            return _ChaosBatchesStateful(data_iter, self)
        return _ChaosBatches(data_iter, self)

    def on_batch(self, batch):
        """Apply the faults due at this batch; returns the batch, poisoned
        where the plan says so."""
        self._batches += 1
        n = self._batches
        if n in self.plan.nan_batches:
            logger.warning("chaos: NaN-poisoning batch %d", n)
            self.fired.append(f"nan@{n}")
            batch = _poison(batch)
        if n in self.plan.sigterm_batches:
            logger.warning("chaos: delivering SIGTERM at batch %d", n)
            self.fired.append(f"sigterm@{n}")
            os.kill(os.getpid(), signal.SIGTERM)
        if n in self.plan.kill_batches:
            # SIGKILL: nothing after this line runs. The marker goes to fd
            # 2 directly (the logger's buffers die with the process).
            self.fired.append(f"kill@{n}")
            try:
                os.write(2, f"chaos: SIGKILL at batch {n}\n".encode())
            except OSError:
                pass
            os.kill(os.getpid(), signal.SIGKILL)
        if n in self.plan.crash_batches:
            self.fired.append(f"crash@{n}")
            raise ChaosError(f"chaos: injected crash at batch {n}")
        if n in self.plan.shrink_batches:
            logger.warning("chaos: topology shrink at batch %d", n)
            self.fired.append(f"shrink@{n}")
            raise TopologyChange("shrink", n)
        if n in self.plan.grow_batches:
            logger.warning("chaos: topology grow at batch %d", n)
            self.fired.append(f"grow@{n}")
            raise TopologyChange("grow", n)
        return batch

    # -- fetch faults (wrap a random-access source) ----------------------
    def wrap_source(self, source):
        """A source whose n-th ``__getitem__`` raises a transient OSError
        when the plan says so (the loader's retry policy's target)."""
        return _FlakySource(source, self)

    def on_fetch(self) -> None:
        with self._fetch_lock:
            self._fetches += 1
            n = self._fetches
            if n in self.plan.fetch_calls:
                self.fired.append(f"fetch@{n}")
        if n in self.plan.fetch_calls:
            raise OSError(f"chaos: injected transient fetch failure "
                          f"(call {n})")

    # -- checkpoint-writer faults (CheckpointManager fault_hook) ---------
    def on_checkpoint_write(self) -> None:
        """ENOSPC at the start of the n-th physical checkpoint write
        (``diskfull@n``). Called on the async writer's thread too; one
        writer at a time touches the counter."""
        self._ckpt_writes += 1
        if self._ckpt_writes in self.plan.diskfull_writes:
            self.fired.append(f"diskfull@{self._ckpt_writes}")
            raise OSError(errno.ENOSPC,
                          f"chaos: injected ENOSPC on checkpoint write "
                          f"{self._ckpt_writes}")

    # -- checkpoint faults (the supervisor calls between attempts) -------
    def between_attempts(self, checkpoint_dir) -> None:
        self._attempts += 1
        if self._attempts in self.plan.truncate_attempts \
                and checkpoint_dir is not None:
            if truncate_checkpoint_file(checkpoint_dir) is not None:
                self.fired.append(f"truncate@{self._attempts}")


class _ChaosBatches:
    def __init__(self, inner, injector: FaultInjector):
        self._inner = inner
        self._injector = injector
        self._it = None

    def __iter__(self):
        return self

    def __next__(self):
        if self._it is None:
            self._it = iter(self._inner)
        return self._injector.on_batch(next(self._it))


class _ChaosBatchesStateful(_ChaosBatches):
    def state(self) -> dict:
        return self._inner.state()

    def restore(self, state: dict) -> None:
        self._inner.restore(state)
        self._it = None  # re-enter the repositioned inner iterator


class _FlakySource:
    """A source raising the plan's transient fetch errors."""

    def __init__(self, inner, injector: FaultInjector):
        self._inner = inner
        self._injector = injector

    def __len__(self) -> int:
        return len(self._inner)

    def __getitem__(self, idx: int) -> np.ndarray:
        self._injector.on_fetch()
        return self._inner[idx]
