"""Stall detection for long training loops, counterpart of
``ntxent_tpu/utils/watchdog.py``.

A wedged collective, a hung host-device copy or a stuck input pipeline
leaves the process alive and its log frozen. ``StallWatchdog`` turns that
silence into a diagnosis and an action:

* the loop calls ``beat()`` every step (``training.train_loop`` does when
  given a watchdog);
* a daemon thread checks the time since the last beat; past
  ``timeout_s`` it dumps every thread's Python stack through
  ``faulthandler`` (to stderr or ``dump_path``) and calls ``on_stall``
  through a one-shot latch. Beats after a stall re-arm the detection
  (``stalled`` clears, a later stall dumps again) but never the callback:
  only ``reset()`` reopens it, so a "checkpoint and restart" policy
  cannot fire twice in one incident. ``resilience.supervisor.
  Supervisor`` resets the latch at each attempt.

The watchdog kills nothing itself; ``on_stall`` holds the policy (the
supervisor's stops the attempt at a step boundary). The reference's
``watchdog_stalls_total`` series waits for the port's observability
layer; a stall is logged.
"""

from __future__ import annotations

import faulthandler
import logging
import threading
import time
from collections.abc import Callable

logger = logging.getLogger(__name__)

__all__ = ["StallWatchdog"]


class StallWatchdog:
    """A background thread that flags a loop which stopped making
    progress::

        with StallWatchdog(timeout_s=600, on_stall=stop) as dog:
            for batch in data:
                state, metrics = train_step(state, *batch)
                dog.beat()

    or ``train_loop(..., watchdog=dog)``, which beats once a step."""

    def __init__(self, timeout_s: float = 600.0,
                 on_stall: Callable[[float], None] | None = None,
                 poll_s: float | None = None,
                 dump_path: str | None = None):
        if timeout_s <= 0:
            raise ValueError(f"timeout_s must be positive, got {timeout_s}")
        self.timeout_s = float(timeout_s)
        self.poll_s = float(poll_s) if poll_s is not None \
            else max(0.05, self.timeout_s / 10.0)
        self.on_stall = on_stall
        self.dump_path = dump_path
        self.stalled = threading.Event()
        self.fired = threading.Event()  # the one-shot on_stall latch
        self._last_beat = time.monotonic()
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    def beat(self) -> None:
        """Record progress; re-arms the detection after a stall (the
        ``on_stall`` latch stays closed: see ``reset``)."""
        self._last_beat = time.monotonic()
        self.stalled.clear()

    def reset(self) -> None:
        """Reopen the ``on_stall`` latch and clear the detection: the only
        way to re-arm the callback, called at a recovery boundary."""
        self.fired.clear()
        self.beat()

    def silent_for(self) -> float:
        return time.monotonic() - self._last_beat

    def _dump_stacks(self) -> None:
        try:
            if self.dump_path is not None:
                with open(self.dump_path, "a") as f:
                    f.write(f"=== StallWatchdog dump @ {time.time():.0f} "
                            f"(no beat for {self.silent_for():.1f}s) ===\n")
                    f.flush()
                    faulthandler.dump_traceback(file=f)
            else:
                faulthandler.dump_traceback()
        except Exception:  # the diagnosis must never end the process
            logger.exception("watchdog stack dump failed")

    def _run(self) -> None:
        while not self._stop.wait(self.poll_s):
            quiet = self.silent_for()
            if quiet >= self.timeout_s and not self.stalled.is_set():
                self.stalled.set()
                logger.error("training stalled: no progress for %.1fs "
                             "(timeout %.1fs); dumping thread stacks",
                             quiet, self.timeout_s)
                self._dump_stacks()
                if self.on_stall is not None and not self.fired.is_set():
                    self.fired.set()
                    try:
                        self.on_stall(quiet)
                    except Exception:
                        logger.exception("watchdog on_stall callback "
                                         "failed")

    def start(self) -> "StallWatchdog":
        if self._thread is not None:
            raise RuntimeError("watchdog already started")
        self._stop.clear()  # stop() leaves it set: a restart must clear it
        self.beat()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="ntxent-stall-watchdog")
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=self.poll_s * 4 + 1.0)
            self._thread = None

    def __enter__(self) -> "StallWatchdog":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()
