"""The self-healing training supervisor, counterpart of
``ntxent_tpu/resilience/supervisor.py``: detectors in, restarts out.

``Supervisor.run()`` runs attempts of a training job and, on a fault a
detector surfaces, restarts in-process from the newest valid checkpoint,
up to ``max_restarts`` times with a backoff:

* **clean but incomplete exit** (SIGTERM, a stall's stop) -> restart;
  ``fit`` saved the stopped step, so the next attempt resumes there;
* **exception** (``DivergenceError``, ``ChaosError``, an IO error past
  its retries) -> restart; the crashed attempt wrote no final save, so
  the restore lands on the last healthy one, and past a corrupt one to
  the newest valid;
* **stall** -> the watchdog's one-shot ``on_stall`` asks the attempt's
  ``PreemptionGuard`` to stop; the attempt saves and returns at the next
  step boundary and is restarted;
* ``TopologyChange`` (``shrink@k`` / ``grow@k``) -> a restart on the same
  world, as the reference does without a ``topology_hook`` (the elastic
  rebuild of the world is not ported: ROADMAP.md Queue A 3(b)).

The caller's ``run_attempt(attempt, stop_fn, watchdog)`` is usually a
closure over ``training.fit`` that builds a fresh ``TrainState`` each
attempt (no tensor of a crashed attempt is reused) and hands ``stop_fn``
and ``watchdog`` through; ``cli`` wires it for ``--max-restarts`` and
``--chaos``. The reference's registry series, restart events and the
flight-recorder dump on a stall wait for the port's observability layer;
restarts and stalls are logged.
"""

from __future__ import annotations

import dataclasses
import logging
import time
from collections.abc import Callable

from ..training.preemption import PreemptionGuard
from ..utils.watchdog import StallWatchdog
from .faults import TopologyChange
from .retry import RetryPolicy

logger = logging.getLogger(__name__)

__all__ = ["AttemptRecord", "Supervisor", "SupervisorResult"]


@dataclasses.dataclass(frozen=True)
class AttemptRecord:
    attempt: int
    # the step the attempt reached; None when it died on an exception
    # before returning a state (its progress is unknown)
    end_step: int | None
    preempted: bool
    stalled: bool
    error: str | None
    # "shrink" / "grow" when a topology change ended the attempt
    topology: str | None = None


@dataclasses.dataclass
class SupervisorResult:
    completed: bool
    state: object
    histories: list
    records: list

    @property
    def history(self):
        """The attempts' histories end to end (a rollback may repeat step
        numbers across an attempt boundary)."""
        return [entry for h in self.histories for entry in h]


class Supervisor:
    """Restart-with-backoff harness around ``run_attempt(attempt, stop_fn,
    watchdog) -> (state, history)``. Complete means ``state.step >=
    num_steps``.

    ``backoff`` (a ``RetryPolicy``) gives only the delays between attempts.
    ``stall_timeout_s`` arms a ``StallWatchdog`` whose escalation stops the
    attempt. ``injector`` (``faults.FaultInjector``) gets its
    ``between_attempts`` hook, where ``truncate@a`` fires."""

    def __init__(self, run_attempt: Callable, num_steps: int,
                 checkpoint_dir=None, max_restarts: int = 3,
                 backoff: RetryPolicy | None = None,
                 stall_timeout_s: float | None = None,
                 injector=None,
                 sleep: Callable[[float], None] = time.sleep):
        if max_restarts < 0:
            raise ValueError(f"max_restarts must be >= 0, got "
                             f"{max_restarts}")
        self.run_attempt = run_attempt
        self.num_steps = int(num_steps)
        self.checkpoint_dir = checkpoint_dir
        self.max_restarts = max_restarts
        self.backoff = backoff or RetryPolicy(
            max_attempts=max_restarts + 1, base_delay_s=1.0,
            multiplier=2.0, max_delay_s=60.0, jitter=0.1)
        self.stall_timeout_s = stall_timeout_s
        self.injector = injector
        self.sleep = sleep
        self._guard: PreemptionGuard | None = None

    def _on_stall(self, quiet_s: float) -> None:
        guard = self._guard
        if guard is None:  # latched between attempts: nothing to stop
            return
        logger.error("supervisor: stall escalation after %.1fs of silence: "
                     "stopping the attempt at the next step boundary "
                     "(checkpoint and in-process restart)", quiet_s)
        guard.request()

    def run(self) -> SupervisorResult:
        histories: list = []
        records: list[AttemptRecord] = []
        state = None
        watchdog = (StallWatchdog(timeout_s=self.stall_timeout_s,
                                  on_stall=self._on_stall)
                    if self.stall_timeout_s else None)
        total_attempts = self.max_restarts + 1
        for attempt in range(total_attempts):
            guard = PreemptionGuard()
            self._guard = guard
            error: str | None = None
            stalled = False
            topology: str | None = None
            attempt_state = None
            if watchdog is not None:
                watchdog.reset()
                watchdog.start()
            try:
                with guard:
                    try:
                        attempt_state, history = self.run_attempt(
                            attempt, stop_fn=guard.requested,
                            watchdog=watchdog)
                        histories.append(history)
                    except TopologyChange as e:
                        topology = e.action
                        error = f"TopologyChange: {e}"
                        logger.warning("supervisor: attempt %d/%d ended by "
                                       "a topology %s: the next one runs on "
                                       "the unchanged world", attempt + 1,
                                       total_attempts, e.action)
                    except Exception as e:  # bounded by max_restarts
                        error = f"{type(e).__name__}: {e}"
                        logger.exception("supervisor: attempt %d/%d died",
                                         attempt + 1, total_attempts)
            finally:
                self._guard = None
                if watchdog is not None:
                    stalled = watchdog.fired.is_set()
                    watchdog.stop()
            end_step = int(attempt_state.step) \
                if attempt_state is not None else None
            if attempt_state is not None:
                state = attempt_state
            records.append(AttemptRecord(
                attempt=attempt, end_step=end_step,
                preempted=guard.preempted, stalled=stalled, error=error,
                topology=topology))
            if error is None and not guard.preempted \
                    and end_step is not None and end_step >= self.num_steps:
                logger.info("supervisor: run complete at step %d after %d "
                            "attempt(s)", end_step, attempt + 1)
                return SupervisorResult(True, state, histories, records)
            if attempt + 1 >= total_attempts:
                break
            if self.injector is not None:
                self.injector.between_attempts(self.checkpoint_dir)
            delay = self.backoff.delay_for(attempt + 1)
            logger.warning(
                "supervisor: attempt %d/%d ended at step %s (preempted=%s, "
                "stalled=%s, error=%s): restarting from the last valid "
                "checkpoint in %.1fs", attempt + 1, total_attempts,
                "<unknown: attempt crashed>" if end_step is None
                else end_step, guard.preempted, stalled, error, delay)
            self.sleep(delay)
        logger.error("supervisor: giving up after %d attempt(s) (last step "
                     "%s of %d): restart budget exhausted", total_attempts,
                     records[-1].end_step if records else 0, self.num_steps)
        return SupervisorResult(False, state, histories, records)
