"""Worker-side zero-downtime rollout: watch checkpoints, swap warm.
Counterpart of ``ntxent_tpu/serving/worker.py``.

``CheckpointWatcher`` is a daemon thread that polls a checkpoint
directory (``training/checkpoint.py``, the format both packages write)
with the rules a training restore uses (manifest-verified, newest valid
step; a torn or corrupt step is invisible) and hot-swaps the engine's
weights when a new step lands:

* **warm, then swap**: the step's params and batch_stats load into a
  template module built from the serve flags, and
  ``engine.swap_variables`` copies them into the live module under the
  write side of its forward lock (``"reused"``: the same layout keeps the warm ladder), so
  no request sees a cold bucket or a half-copied model;
* **staggered adoption** (``delay_s``): a step is adopted only after it
  has been seen for that long, so one worker of a fleet takes a new step
  first;
* **rollback** (``rollback()``, the server's ``POST /rollback``): revert
  to the previously served weights and block the bad step, so the
  watcher never adopts it again;
* **the served step** (``served_step()``): ``generation`` is odd while
  a swap runs and counts every one, so the server labels a reply with
  ``X-Checkpoint-Step`` only when no swap began or ended while its rows
  were computed. The JAX worker stamps ``current_step`` at reply time, so
  a chunk computed before a swap and answered after it carries the new
  step's label; behind the fleet router that merges two models' rows in
  one response and caches the old rows as the new step's.

The watcher never writes to the directory: no saves, no retention.
"""

from __future__ import annotations

import logging
import threading
import time

from torch import nn

from ..obs import events as obs_events

logger = logging.getLogger(__name__)

__all__ = ["CheckpointWatcher"]


def _variables(template: nn.Module) -> dict:
    """A restored template -> a state dict of its own tensors (the
    template is reused by the next adoption)."""
    return {k: v.detach().clone() for k, v in template.state_dict().items()}


class CheckpointWatcher:
    """Poll a checkpoint directory; warm-swap the engine on a new valid
    step.

    ``template`` is the module restores load into (``cli`` builds it
    from the serve flags, on the CPU). ``initial_step`` is the step
    already served (None: random weights, so the first valid step on
    disk is adopted).
    """

    def __init__(self, ckpt_dir, template: nn.Module, engine,
                 poll_s: float = 2.0, delay_s: float = 0.0,
                 initial_step: int | None = None):
        from ..training.checkpoint import CheckpointManager

        # max_to_keep=None: retention belongs to the training process that
        # owns the directory; a reader never collects its steps
        self.manager = CheckpointManager(ckpt_dir, max_to_keep=None)
        self.template = template
        self.engine = engine
        self.poll_s = float(poll_s)
        self.delay_s = float(delay_s)
        self.current_step: int | None = initial_step
        # odd while a swap runs: a reply computed across a change of
        # weights must not be labeled with either step
        self.generation = 0
        self.blocked_steps: set[int] = set()
        self.swaps = 0
        self.rollbacks = 0
        # the swap ms of each adoption (restore, copy to the device, swap)
        self.swap_ms: list[float] = []
        self._prev: tuple[int | None, dict] | None = None
        # a host copy of the served weights, what the next adoption keeps
        # as ``_prev``: read back from the card once, at boot, and then
        # the dict each adoption or rollback swaps in
        self._served: dict = engine.variables
        self._first_seen: dict[int, float] = {}
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        if initial_step is not None:
            engine.metrics.set_checkpoint_step(initial_step)

    # -- lifecycle --------------------------------------------------------
    def start(self) -> "CheckpointWatcher":
        if self._thread is not None:
            raise RuntimeError("watcher already started")
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="ntxent-torch-ckpt-watcher")
        self._thread.start()
        return self

    def stop(self, timeout_s: float = 5.0) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout_s)
            self._thread = None
        self.manager.close()

    def _run(self) -> None:
        while not self._stop.wait(self.poll_s):
            try:
                self.poll_once()
            except Exception:  # noqa: BLE001 — a bad poll must not end
                # the watcher: the worker keeps serving its weights
                logger.exception("checkpoint watcher: poll failed")

    # -- adoption ---------------------------------------------------------
    def _candidate_step(self) -> int | None:
        """The newest manifest-valid step that is neither blocked nor
        already served."""
        for step in sorted(self.manager.all_steps(), reverse=True):
            if step in self.blocked_steps:
                continue
            if step == self.current_step:
                return None
            if self.manager.verify(step):
                return step
            logger.warning("checkpoint watcher: step %d fails verification; "
                           "skipping", step)
        return None

    def poll_once(self) -> bool:
        """One poll; True when a swap happened."""
        with self._lock:
            step = self._candidate_step()
            if step is None:
                return False
            if self.delay_s > 0:
                first = self._first_seen.setdefault(step, time.monotonic())
                if time.monotonic() - first < self.delay_s:
                    return False  # staggered: not this worker's turn yet
            return self._adopt(step)

    def _adopt(self, step: int) -> bool:
        t0 = time.monotonic()
        try:
            self.manager.restore_variables(self.template, step=step)
        except Exception as e:  # noqa: BLE001 — a step that verifies but
            # does not load (another model) must not wedge the watcher in
            # a retry loop: block it and keep serving
            logger.exception("checkpoint watcher: restore of step %d "
                             "failed; blocking it", step)
            self.blocked_steps.add(step)
            obs_events.emit("rollout", action="restore_failed", step=step,
                            error=f"{type(e).__name__}: {e}")
            return False
        variables = _variables(self.template)
        prev = (self.current_step, self._served)
        self.generation += 1
        mode = self.engine.swap_variables(variables)
        self.swap_ms.append((time.monotonic() - t0) * 1e3)
        self._prev, self._served = prev, variables
        self.current_step = step
        self.generation += 1
        self.swaps += 1
        self._first_seen.pop(step, None)
        self.engine.metrics.set_checkpoint_step(step)
        obs_events.emit("rollout", action="swap", step=step, mode=mode,
                        previous_step=prev[0])
        logger.info("checkpoint watcher: now serving step %d (%s, previous "
                    "%s)", step, mode, prev[0])
        return True

    def served_step(self, generation: int) -> tuple[bool, int | None]:
        """``(True, step)`` when no swap began or ended since
        ``generation`` was read (even) and ``step`` served throughout;
        ``(False, None)`` otherwise."""
        step = self.current_step
        return generation % 2 == 0 and self.generation == generation, step

    # -- rollback ---------------------------------------------------------
    def rollback(self, step: int | None = None) -> bool:
        """Revert to the previously served weights and block the bad step
        (``None``: the one served). True when the weights changed; False
        when the named step is not the one served (it is blocked all the
        same) or no previous weights are held."""
        with self._lock:
            bad = step if step is not None else self.current_step
            if bad is not None:
                self.blocked_steps.add(bad)
                self._first_seen.pop(bad, None)
            if bad is None or bad != self.current_step:
                return False
            if self._prev is None:
                logger.warning("checkpoint watcher: rollback of step %s "
                               "requested but no previous weights held", bad)
                return False
            prev_step, prev_vars = self._prev
            self.generation += 1
            self.engine.swap_variables(prev_vars)
            self.current_step = prev_step
            self.generation += 1
            self._prev, self._served = None, prev_vars
            self.rollbacks += 1
            self.engine.metrics.set_checkpoint_step(
                prev_step if prev_step is not None else -1)
            self.engine.metrics.rollback()
            obs_events.emit("rollout", action="rollback", step=bad,
                            restored_step=prev_step)
            logger.warning("checkpoint watcher: rolled back step %d -> %s "
                           "(step blocked)", bad, prev_step)
            return True
