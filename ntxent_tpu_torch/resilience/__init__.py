"""Resilience of the port, counterpart of ``ntxent_tpu/resilience``:
``RetryPolicy`` (transient IO), ``DivergenceGuard`` (skip, backoff,
rollback of non-finite steps), the chaos plans of ``faults``,
``supervisor.Supervisor`` (in-process restarts) and the SIGKILL crash
audit of ``crashsim``.

Exports resolve lazily (PEP 562): the fleet's router process builds a
``FaultPlan`` and a ``FaultInjector`` from here and loads no torch.
``Supervisor`` imports the training package, so it is reached as
``resilience.supervisor.Supervisor``, not from here.
"""

import importlib

# name -> defining submodule; resolved on first attribute access.
_EXPORTS = {
    "ChaosError": "faults",
    "FaultInjector": "faults",
    "FaultPlan": "faults",
    "TopologyChange": "faults",
    "truncate_checkpoint_file": "faults",
    "DivergenceError": "guard",
    "DivergenceGuard": "guard",
    "DEFAULT_TRANSIENT": "retry",
    "RetryBudgetExceeded": "retry",
    "RetryPolicy": "retry",
    "AttemptRecord": "supervisor",
    "Supervisor": "supervisor",
    "SupervisorResult": "supervisor",
}


def __getattr__(name):
    module = _EXPORTS.get(name)
    if module is None:
        raise AttributeError(
            f"module {__name__!r} has no attribute {name!r}")
    value = getattr(importlib.import_module(f".{module}", __name__), name)
    globals()[name] = value  # later access skips __getattr__
    return value


def __dir__():
    return sorted(set(globals()) | set(_EXPORTS))


__all__ = sorted(_EXPORTS)
