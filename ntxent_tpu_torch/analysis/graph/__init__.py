"""ntxent-audit for the port: audits of what the program RUNS, the
counterpart of ``ntxent_tpu/analysis/graph/``.

Where ``ntxent-lint`` (the sibling package) guards the source, this
package audits the collectives and buffers the entry points really
produce when they run. Four analyzers, sharing the lint framework's
finding/baseline machinery and output formats:

* ``collective-census`` (census.py) -- every ``torch.ops.c10d`` op a
  callable runs, seen by a ``TorchDispatchMode`` (backward included),
  priced by the ring byte model of the mesh helpers and cross-checked
  against their declared accounting; the autograd remainder is published
  as ``collective_graph_bytes_total{source="ad"}``.
* ``wire-dtype`` (wiredtype.py) -- under an int8/bf16 policy, no
  eligible-sized collective carries float32 on the wire.
* ``donation`` (donation.py) -- a host snapshot of the train state must
  not share storage with the live tensors an in-place step overwrites.
* ``recompile-cause`` (recompile.py) -- the first-run signature differ
  the serving engine uses, and the audit of a ``compile`` event stream.

IMPORT DISCIPLINE: this ``__init__`` stays empty of imports. The parent
``ntxent_tpu_torch.analysis`` package is on the torch-free import
boundary, and the census and donation modules use torch (inside their
functions). Import submodules explicitly (``from
ntxent_tpu_torch.analysis.graph import census``).
"""
