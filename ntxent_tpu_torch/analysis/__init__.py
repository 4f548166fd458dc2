"""ntxent-lint and ntxent-audit for the port: project-native static
analysis of ``ntxent_tpu_torch``, the counterpart of
``ntxent_tpu/analysis/`` with the same layout, names, exit codes,
baseline format and output formats.

Each checker encodes a defect class as a machine check:

* ``collective-shim`` -- a ``torch.distributed`` collective outside
  ``parallel/mesh.py`` bypasses the comms accounting and the wire
  precision policy (it silently under-counts ``collective_bytes_total``).
* ``host-sync`` -- per-step host syncs on step state (``.item()`` of a
  state tensor, ``torch.cuda.synchronize()``) inside the hot loops.
* ``lock-discipline`` -- blocking work lexically under a serving/obs
  lock, and lock acquisition inside signal handlers.
* ``import-boundary`` -- the port never imports JAX or the JAX package,
  and the router tier never reaches torch at import time; the static
  graph agrees by test with the runtime tripwires.
* ``telemetry-schema`` -- event types outside ``EVENT_TYPES``, illegal
  exposition metric names, and metric label keys outside the bounded
  vocabulary.

This package and ``graph/__init__`` import neither torch nor numpy: a
lint run loads neither (the router tier imports ``analysis`` too). The
graph half (``analysis.graph``: the collective census as a dispatch
mode, wire dtype, donation, recompile causes) imports torch inside its
functions only. Inline suppression: ``# ntxent: lint-ok[rule] reason``
on the finding's line or the line above. Accepted findings live in the
committed ``ntxent_tpu_torch/analysis/lint_baseline.json``; the CLI
exits nonzero only on NEW findings.
"""

from .framework import (
    Finding,
    LintConfig,
    LintResult,
    compare_with_baseline,
    load_baseline,
    run_lint,
    write_baseline,
)
from .imports import reachable_modules

__all__ = [
    "Finding",
    "LintConfig",
    "LintResult",
    "compare_with_baseline",
    "load_baseline",
    "reachable_modules",
    "run_lint",
    "write_baseline",
]
