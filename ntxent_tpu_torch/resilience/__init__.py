"""Resilience of the port, counterpart of ``ntxent_tpu/resilience``:
``RetryPolicy`` (transient IO), ``DivergenceGuard`` (skip, backoff,
rollback of non-finite steps), the chaos plans of ``faults``,
``supervisor.Supervisor`` (in-process restarts; it imports the training
package, which imports ``retry``, so it is not re-exported here) and the
SIGKILL crash audit of ``crashsim``."""

from .faults import (
    ChaosError,
    FaultInjector,
    FaultPlan,
    TopologyChange,
    truncate_checkpoint_file,
)
from .guard import DivergenceError, DivergenceGuard
from .retry import RetryBudgetExceeded, RetryPolicy

__all__ = ["ChaosError", "DivergenceError", "DivergenceGuard",
           "FaultInjector", "FaultPlan", "RetryBudgetExceeded",
           "RetryPolicy", "TopologyChange", "truncate_checkpoint_file"]
