"""The host half of the divergence guard, counterpart of
``ntxent_tpu/resilience/guard.py``: skip, then gradient-scale backoff,
then rollback.

The step half lives in ``training/trainer.py``: a step built with
``make_train_step(guard=True)`` (or the data-parallel one) computes the
global gradient norm, decides ``ok = isfinite(loss) & isfinite(norm)``
and on a bad step applies no update (parameters, optimizer state and
BatchNorm running statistics keep their values before the step) while
``state.step`` still advances. It reports ``grad_norm`` and ``step_ok``
and takes a trailing ``scale`` that multiplies the gradients.

``DivergenceGuard`` reads each step's ``StepOutcome`` (``train_loop``'s
``step_guard`` hook) and escalates through three tiers:

1. **skip**: a non-finite step was already dropped by the step; count it;
2. **backoff**: ``backoff_after`` consecutive skips multiply the scale by
   ``backoff_factor``; ``regrow_after`` consecutive healthy steps divide
   it back, up to 1.0;
3. **rollback**: ``rollback_after`` skips in the attempt, or the scale
   falling below ``min_scale``, raise ``DivergenceError``: the supervisor
   restarts from the newest valid checkpoint.

``None`` for a threshold disables its tier (``--nan-policy
skip|backoff|rollback``). The decisions are logged, kept in ``stats``,
counted in the JAX package's registry series (``train_divergence_
{skips,backoffs,rollbacks}_total``, the ``train_grad_scale`` gauge) and
emitted as ``divergence`` events (action skip, backoff or rollback, with
the outcome's lag).
"""

from __future__ import annotations

import logging

from ..obs import events as obs_events
from ..obs.registry import default_registry

logger = logging.getLogger(__name__)

__all__ = ["DivergenceError", "DivergenceGuard"]

_SKIPS = default_registry().counter(
    "train_divergence_skips_total",
    "non-finite steps skipped by the in-step guard")
_BACKOFFS = default_registry().counter(
    "train_divergence_backoffs_total",
    "gradient-scale backoff escalations")
_ROLLBACKS = default_registry().counter(
    "train_divergence_rollbacks_total",
    "DivergenceError rollbacks raised to the supervisor")
_SCALE = default_registry().gauge(
    "train_grad_scale", "current divergence-guard gradient scale")


class DivergenceError(RuntimeError):
    """Raised by ``DivergenceGuard`` when skips and backoff are spent;
    the supervisor's rollback tier catches it."""


class DivergenceGuard:
    """Callable step guard for ``train_loop(step_guard=...)``: takes a
    ``trainer.StepOutcome`` a step, raises ``DivergenceError`` to demand a
    rollback. ``scale_value()`` is the gradient scale the loop hands the
    guarded step."""

    def __init__(self, backoff_after: int | None = 2,
                 rollback_after: int | None = 8,
                 backoff_factor: float = 0.5,
                 regrow_after: int = 100,
                 min_scale: float = 2.0 ** -10,
                 init_scale: float = 1.0):
        if backoff_after is not None and backoff_after < 1:
            raise ValueError("backoff_after must be >= 1 or None")
        if rollback_after is not None and rollback_after < 1:
            raise ValueError("rollback_after must be >= 1 or None")
        if not 0.0 < backoff_factor < 1.0:
            raise ValueError("backoff_factor must be in (0, 1)")
        self.backoff_after = backoff_after
        self.rollback_after = rollback_after
        self.backoff_factor = backoff_factor
        self.regrow_after = regrow_after
        self.min_scale = min_scale
        self.scale = float(init_scale)
        _SCALE.set(self.scale)  # a run that never backs off scrapes 1.0
        self.consecutive_skips = 0
        self.total_skips = 0
        self._healthy_streak = 0
        # over the guard's life, across attempts
        self.stats = {"skips": 0, "backoffs": 0, "rollbacks": 0,
                      "scale": self.scale}

    def scale_value(self) -> float:
        """The gradient scale as a Python float; the step multiplies the
        gradients by it on the device."""
        return self.scale

    def reset_attempt(self) -> None:
        """Per-attempt counter reset (the supervisor's restart boundary).
        The scale survives: a run that needed backoff before the rollback
        usually needs it right after."""
        self.consecutive_skips = 0
        self.total_skips = 0
        self._healthy_streak = 0

    def _set_scale(self, scale: float) -> None:
        self.scale = scale
        self.stats["scale"] = scale
        _SCALE.set(scale)

    def _emit(self, action: str, outcome) -> None:
        obs_events.emit(
            "divergence", action=action, step=int(outcome.step),
            loss=outcome.loss, grad_norm=outcome.grad_norm,
            consecutive=self.consecutive_skips,
            total=self.total_skips, scale=self.scale, guarded=True,
            lag=int(getattr(outcome, "lag", 0)))

    def _rollback(self, outcome, message: str) -> None:
        self.stats["rollbacks"] += 1
        _ROLLBACKS.inc()
        self._emit("rollback", outcome)
        logger.error("divergence guard: %s", message)
        raise DivergenceError(message)

    def __call__(self, outcome) -> None:
        if outcome.ok:
            self.consecutive_skips = 0
            self._healthy_streak += 1
            if self.scale < 1.0 \
                    and self._healthy_streak >= self.regrow_after:
                self._set_scale(min(1.0, self.scale / self.backoff_factor))
                self._healthy_streak = 0
                logger.info("divergence guard: %d healthy steps, scale "
                            "regrown to %g", self.regrow_after, self.scale)
            return

        self._healthy_streak = 0
        self.consecutive_skips += 1
        self.total_skips += 1
        self.stats["skips"] += 1
        _SKIPS.inc()
        logger.warning(
            "divergence guard: non-finite step %d skipped (loss=%s, "
            "grad_norm=%s; %d consecutive, %d total)", outcome.step,
            outcome.loss, outcome.grad_norm, self.consecutive_skips,
            self.total_skips)
        if self.rollback_after is not None \
                and self.total_skips >= self.rollback_after:
            self._rollback(
                outcome,
                f"{self.total_skips} non-finite steps this attempt (budget "
                f"{self.rollback_after}): rolling back to the last valid "
                "checkpoint")
        if self.backoff_after is not None \
                and self.consecutive_skips >= self.backoff_after \
                and self.consecutive_skips % self.backoff_after == 0:
            self._set_scale(self.scale * self.backoff_factor)
            self.stats["backoffs"] += 1
            _BACKOFFS.inc()
            logger.warning("divergence guard: %d consecutive skips, gradient "
                           "scale backed off to %g", self.consecutive_skips,
                           self.scale)
            if self.scale < self.min_scale:
                if self.rollback_after is not None:
                    self._rollback(
                        outcome,
                        f"gradient scale {self.scale:g} collapsed below "
                        f"{self.min_scale:g}: rolling back to the last "
                        "valid checkpoint")
                self._set_scale(self.min_scale)
            self._emit("backoff", outcome)
        else:
            self._emit("skip", outcome)
