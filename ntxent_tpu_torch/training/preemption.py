"""Preemption: SIGTERM becomes a checkpoint and a clean exit, counterpart
of ``ntxent_tpu/training/preemption.py``.

A scheduler preempts a node with SIGTERM and a grace window. The handler
only sets a flag (async-signal-safe); the work (device sync, the final
checkpoint) happens on the main thread at the next step boundary, where
``fit``'s ``stop_fn`` polls ``PreemptionGuard.requested``. Under async
checkpointing the stop sends ``fit``'s final save through
``AsyncCheckpointer.emergency_save``, so the stopped step is on disk
before the process exits. The first poll that sees the signal also dumps
the flight recorder (``obs.events.dump_flight(reason="signal",
routine=True)``): from the polling thread, never the handler, and only
where telemetry already lives (the ``--log-jsonl`` directory or
``NTXENT_FLIGHT_DIR``).
"""

from __future__ import annotations

import logging
import signal
import threading

logger = logging.getLogger(__name__)

__all__ = ["PreemptionGuard"]


class PreemptionGuard:
    """Context manager that turns SIGTERM (``signals``) into a stop
    request::

        with PreemptionGuard() as guard:
            state, history = fit(..., stop_fn=guard.requested)
        if guard.preempted:
            ...  # fit saved the stopped step

    Handlers are installed only on the main thread (Python requires it);
    elsewhere the guard is a manual flag (``request``). The handler chains
    to the one it replaced (once, on the first signal), a second signal
    while stopping is ignored, and the previous handlers come back on
    exit."""

    def __init__(self, signals: tuple[int, ...] = (signal.SIGTERM,)):
        self._signals = signals
        self._event = threading.Event()
        self._previous: dict[int, object] = {}
        self._installed = False
        self._announced = False

    def requested(self) -> bool:
        """True once a shutdown signal has arrived (``fit``'s stop_fn)."""
        if self._event.is_set() and not self._announced:
            # logged from the polling thread, never from the handler:
            # logging's streams are not reentrant
            self._announced = True
            logger.warning("shutdown signal received: finishing current "
                           "step, saving checkpoint, then exiting")
            # best effort: the save this poll unblocks never waits on a
            # full disk
            try:
                from ..obs import events as obs_events

                obs_events.dump_flight(reason="signal", routine=True)
            except Exception:
                logger.exception("flight recorder dump failed on signal")
        return self._event.is_set()

    @property
    def preempted(self) -> bool:
        return self._event.is_set()

    def request(self) -> None:
        """Stop without a signal (tests; another thread's shutdown)."""
        self._event.set()

    def _handler(self, signum, frame):
        first = not self._event.is_set()
        self._event.set()
        prev = self._previous.get(signum)
        # Python's default SIGINT handler would raise KeyboardInterrupt
        # mid-step, which a guard over SIGINT exists to prevent
        if first and callable(prev) and prev is not signal.default_int_handler:
            prev(signum, frame)

    def __enter__(self) -> "PreemptionGuard":
        if threading.current_thread() is threading.main_thread():
            for sig in self._signals:
                self._previous[sig] = signal.getsignal(sig)
                signal.signal(sig, self._handler)
            self._installed = True
        else:
            logger.warning("PreemptionGuard outside the main thread: no "
                           "signal handlers installed (request() still "
                           "works)")
        return self

    def __exit__(self, *exc) -> None:
        if self._installed:
            for sig, prev in self._previous.items():
                signal.signal(sig, prev)
            self._installed = False
