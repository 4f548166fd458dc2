"""On-demand ``torch.profiler`` capture, counterpart of
``ntxent_tpu/obs/profiler.py``: the slow-step trigger and the manual
triggers.

The bad steps are rare, so ``ProfilerTrigger`` watches the per-step
device time the ``StepTimeline`` feeds it and captures only the window
after one:

* **slow-step trigger**: a step slower than ``slow_factor`` x the
  rolling median starts a capture of the NEXT ``capture_steps`` steps.
  The median is over a bounded window (drift re-baselines); the trigger
  is armed only after ``warmup_steps`` samples, so step 1 (the first run:
  kernel libraries, cuBLAS heuristics, and for the profiler itself a
  CUPTI start of seconds) never fires it. Captured steps stay out of the
  window.
* **manual triggers**: touching ``<trace_dir>/TRIGGER`` (one
  ``os.path.exists`` a step) or SIGUSR2 (installed only on the main
  thread) asks for a capture of the next window.

A capture is ``torch.profiler.profile(activities=[CPU, CUDA])`` started
and stopped by hand and exported as a Chrome trace,
``<trace_dir>/step<N>-<stamp>/trace.json``; its CUDA kernel events name
the hand-written kernels launched through ``ctypes`` as well as aten's.
Each capture appends ``trace`` events (start, complete) naming the
directory. A profiler failure is logged and disables further captures;
the catch covers the capture only, never the step.
"""

from __future__ import annotations

import logging
import os
import statistics
import threading
import time
from collections import deque

from . import events
from .registry import default_registry

logger = logging.getLogger(__name__)

__all__ = ["ProfilerTrigger"]

TRACE_FILE = "trace.json"


def _start_profile():
    """A started ``torch.profiler.profile`` of the host and, when there
    is one, the card."""
    import torch
    import torch.profiler as tp

    activities = [tp.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(tp.ProfilerActivity.CUDA)
    prof = tp.profile(activities=activities)
    prof.start()
    return prof


class ProfilerTrigger:
    """Feed ``on_step(step, duration_ms)`` once a step; captures fire on
    the following steps. Thread-safe (``request`` may come from another
    thread)."""

    def __init__(self, trace_dir: str, slow_factor: float = 3.0,
                 capture_steps: int = 5, warmup_steps: int = 5,
                 window: int = 50, trigger_file: str | None = None,
                 registry=None):
        if slow_factor <= 1.0:
            raise ValueError(f"slow_factor must be > 1, got {slow_factor}")
        if capture_steps < 1:
            raise ValueError("capture_steps must be >= 1")
        self.trace_dir = str(trace_dir)
        self.slow_factor = float(slow_factor)
        self.capture_steps = int(capture_steps)
        self.warmup_steps = int(warmup_steps)
        self.trigger_file = (trigger_file if trigger_file is not None
                             else os.path.join(self.trace_dir, "TRIGGER"))
        os.makedirs(self.trace_dir, exist_ok=True)  # TRIGGER touchable
        self._window: deque[float] = deque(maxlen=window)
        self._lock = threading.Lock()
        # set by the SIGUSR2 handler without the lock: the signal runs on
        # the main thread, which may hold the lock inside on_step
        self._signal_pending = False
        self._requested: str | None = None   # a pending capture's reason
        self._active_dir: str | None = None  # a capture in flight
        self._prof = None
        self._remaining = 0
        self._started_step = 0
        self._last_step = 0
        self._disabled = False
        self._captures = (registry or default_registry()).counter(
            "profiler_captures_total", "on-demand torch.profiler captures")

    # -- triggers --------------------------------------------------------
    def request(self, reason: str = "manual") -> None:
        """Ask for a capture of the next ``capture_steps`` steps (one at a
        time: a request while one is pending or active is dropped)."""
        with self._lock:
            if self._requested is None and self._active_dir is None:
                self._requested = reason

    def install_sigusr2(self) -> bool:
        """SIGUSR2 -> a request; False off the main thread (a supervised
        attempt's worker), where only the trigger file works."""
        import signal

        def on_signal(*_):
            self._signal_pending = True  # a flag only: no lock here

        try:
            signal.signal(signal.SIGUSR2, on_signal)
            return True
        except ValueError:
            logger.warning("SIGUSR2 trigger unavailable off the main "
                           "thread; use the trigger file %s",
                           self.trigger_file)
            return False

    def _check_trigger_file(self) -> None:
        try:
            if not os.path.exists(self.trigger_file):
                return
            # consumed only when a capture can start: during one, the
            # file stays and becomes the next window's request
            with self._lock:
                busy = (self._requested is not None
                        or self._active_dir is not None)
            if busy:
                return
            os.remove(self.trigger_file)
            self.request("trigger_file")
        except OSError:
            pass

    # -- per-step driver -------------------------------------------------
    def on_step(self, step: int, duration_ms: float) -> None:
        if self._disabled:
            return
        if self._signal_pending:
            self._signal_pending = False
            self.request("sigusr2")
        self._check_trigger_file()
        self._last_step = int(step)
        with self._lock:
            if self._active_dir is not None:
                self._remaining -= 1
                if self._remaining <= 0:
                    self._stop_locked(step)
                return  # a captured step stays out of the baseline
            baseline = (statistics.median(self._window)
                        if len(self._window) >= self.warmup_steps else None)
            reason = self._requested
            if reason is None and baseline is not None \
                    and duration_ms > self.slow_factor * baseline:
                reason = (f"slow_step:{duration_ms:.1f}ms>"
                          f"{self.slow_factor:g}x median "
                          f"{baseline:.1f}ms")
            if reason is not None:
                self._requested = None
                self._start_locked(step, reason)
                return
            self._window.append(duration_ms)

    # -- capture lifecycle (lock held) -----------------------------------
    def _start_locked(self, step: int, reason: str) -> None:
        stamp = time.strftime("%Y%m%d-%H%M%S")
        target = os.path.join(self.trace_dir, f"step{step}-{stamp}")
        try:
            os.makedirs(target, exist_ok=True)
            self._prof = _start_profile()
        except Exception as e:  # noqa: BLE001 — the capture, not the step
            logger.error("profiler capture failed to start (%s: %s); "
                         "disabling further captures", type(e).__name__, e)
            self._disabled = True
            return
        self._active_dir = target
        self._remaining = self.capture_steps
        self._started_step = step
        logger.warning("profiler: capturing %d steps to %s (%s)",
                       self.capture_steps, target, reason)
        events.emit("trace", action="start", step=int(step),
                    reason=reason, trace_dir=target,
                    capture_steps=self.capture_steps)

    def _stop_locked(self, step: int) -> None:
        target, self._active_dir = self._active_dir, None
        prof, self._prof = self._prof, None
        try:
            prof.stop()
            prof.export_chrome_trace(os.path.join(target, TRACE_FILE))
        except Exception as e:  # noqa: BLE001 — the capture, not the step
            logger.error("profiler stop failed (%s: %s); disabling further "
                         "captures", type(e).__name__, e)
            self._disabled = True
            return
        self._captures.inc()
        logger.info("profiler: capture complete -> %s", target)
        # the trigger step is not captured: coverage starts after it
        events.emit("trace", action="complete", step=int(step),
                    trace_dir=target,
                    steps_captured=int(step) - self._started_step)

    def close(self) -> None:
        """End a capture in flight (run teardown); its ``complete`` event
        reports how far it got."""
        with self._lock:
            if self._active_dir is not None:
                self._stop_locked(max(self._last_step, self._started_step))
