"""collective-shim: every ``torch.distributed`` collective must ride
``parallel/mesh.py``, the port's counterpart of
``ntxent_tpu/analysis/collectives.py``.

The mesh helpers are where the comms accounting and the wire policy
(``parallel.precision``) live. A raw ``dist.all_reduce`` elsewhere still
computes the right sum, which is exactly why it is dangerous: it
silently under-counts ``collective_bytes_total`` and skips the wire
dtype policy, so every byte claim measured downstream is short by it.
This checker makes the audit a standing guarantee: any spelling of a
collective outside the shim file is an error. It sees through every
way of naming the module:

* ``torch.distributed.all_reduce(...)`` (and ``import torch as th`` ->
  ``th.distributed.all_reduce``);
* ``import torch.distributed as dist`` / ``from torch import
  distributed as d`` -> ``dist.all_reduce(...)``;
* ``from torch.distributed import all_reduce [as ar]`` -> bare
  ``all_reduce(...)`` (the import itself is flagged too).

Control-plane calls (a stop flag, a barrier, a checkpoint's gather to
rank 0) are collectives too: where one belongs outside a step, it says
so with ``# ntxent: lint-ok[collective-shim] <reason>``.
"""

from __future__ import annotations

import ast

from .framework import Checker, LintContext, SourceFile

__all__ = ["CollectiveShimChecker", "COLLECTIVES"]

COLLECTIVES = frozenset({
    "all_reduce", "all_gather", "all_gather_into_tensor", "reduce_scatter",
    "reduce_scatter_tensor", "all_to_all", "all_to_all_single",
    "broadcast", "reduce", "gather", "scatter", "send", "recv", "isend",
    "irecv", "batch_isend_irecv", "barrier", "all_gather_object",
    "broadcast_object_list",
})


def _dotted(node: ast.AST) -> str | None:
    """'torch.distributed.all_reduce' for an Attribute/Name chain."""
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


class CollectiveShimChecker(Checker):
    rule = "collective-shim"
    describe = ("torch.distributed collective call outside "
                "parallel/mesh.py (bypasses comms accounting + the wire "
                "precision policy)")
    incident = ("the JAX package's unshimmed all_to_all/pmax under-counted "
                "collective_bytes_total (ntxent_tpu/analysis/"
                "collectives.py); the port's ZeRO-3 gather recorded its "
                "bytes by hand beside a raw dist.all_gather")

    def check(self, src: SourceFile, ctx: LintContext):
        if src.rel in ctx.config.shim_paths:
            return
        # bare:       from torch.distributed import all_reduce [as ar]
        # dist_names: import torch.distributed as d / from torch import
        #             distributed [as d]  ->  <name>.all_reduce(...)
        # torch_names: torch / import torch as th  ->
        #             <name>.distributed.all_reduce(...)
        bare: set[str] = set()  # local names of collectives
        dist_names: set[str] = set()
        torch_names = {"torch"}
        for node in ast.walk(src.tree):
            if isinstance(node, ast.Import):
                for alias in node.names:
                    if alias.name == "torch.distributed" and alias.asname:
                        dist_names.add(alias.asname)
                    elif alias.name == "torch" and alias.asname:
                        torch_names.add(alias.asname)
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                if node.module == "torch.distributed":
                    for alias in node.names:
                        if alias.name in COLLECTIVES:
                            bare.add(alias.asname or alias.name)
                            yield src.finding(
                                self.rule, node,
                                f"`from torch.distributed import "
                                f"{alias.name}` — use the "
                                f"parallel/mesh.py helpers instead")
                elif node.module == "torch":
                    for alias in node.names:
                        if alias.name == "distributed":
                            dist_names.add(alias.asname or "distributed")
        for node in ast.walk(src.tree):
            if not isinstance(node, ast.Call):
                continue
            name = _dotted(node.func)
            if name is None:
                continue
            op = name.rsplit(".", 1)[-1]
            head = name[:-(len(op) + 1)]
            is_dist = name in bare or (  # a bare call, aliases included
                op in COLLECTIVES and (head in dist_names or (
                    head.endswith(".distributed")
                    and head[:-len(".distributed")] in torch_names)))
            if is_dist:
                yield src.finding(
                    self.rule, node,
                    f"raw `{name}` bypasses the mesh helpers — call one "
                    f"of `parallel.mesh` so comms accounting and the "
                    f"collective_precision policy see it")
