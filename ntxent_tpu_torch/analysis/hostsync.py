"""host-sync: no per-step device->host syncs on step state in hot loops,
the port's counterpart of ``ntxent_tpu/analysis/hostsync.py``.

The JAX incident: ``int(s.step)`` executed every step inside the train
loop forced a device round trip that serialized the host against the
queued device work. The same holds on the card: ``loss.item()`` in the
loop waits for the step, and the launches of the next step queue only
after it. The port's loop reads a step's metrics once, from pinned
memory behind an event (``trainer._Metrics``), and syncs on purpose only
where a timeline brackets the device time (``trainer._sync``).

Rule shape (an incident encoder, not a general performance lint):
inside a HOT function (``train_loop``/``eval_loop``/``fit``, the step
hooks ``*_hook``, and the serving dispatch bodies), inside a
``for``/``while`` loop:

* a sync spelling -- ``.item()``, ``.tolist()``, ``.cpu()``,
  ``.numpy()``, or ``int()``/``float()``/``bool()`` of the expression --
  whose operand involves STEP STATE; or
* ``torch.cuda.synchronize()``, which waits for all of it.

One change from JAX: the port's ``TrainState.step`` is a Python ``int``
(``training/trainer.py``), so ``.step`` is not step state and
``int(state.step)`` costs nothing. Step state is the tensors reached
through a state object: ``state.model``, ``state.optimizer``,
``state.ef_residual``, ``state.kept``. Values already on the host (a
drained metrics dict) are not step state and stay legal.
"""

from __future__ import annotations

import ast

from .framework import Checker, LintContext, SourceFile

__all__ = ["HostSyncChecker"]

_SYNC_BUILTINS = {"int", "float", "bool"}
_SYNC_METHODS = {"item", "tolist", "cpu", "numpy"}
_STATE_NAMES = {"state", "train_state", "new_state"}
# the tensors of a TrainState (its ``step`` is a host int)
_STATE_TENSORS = {"model", "optimizer", "ef_residual", "kept"}


def _mentions_step_state(node: ast.AST) -> bool:
    for sub in ast.walk(node):
        if isinstance(sub, ast.Attribute) and sub.attr in _STATE_TENSORS \
                and isinstance(sub.value, ast.Name) \
                and sub.value.id in _STATE_NAMES:
            return True
    return False


def _is_cuda_synchronize(func: ast.AST) -> bool:
    """``torch.cuda.synchronize`` (or ``cuda.synchronize``)."""
    return isinstance(func, ast.Attribute) and func.attr == "synchronize" \
        and isinstance(func.value, ast.Attribute) \
        and func.value.attr == "cuda"


def _sync_operand(call: ast.Call) -> ast.AST | None:
    """The operand being synced, when ``call`` is a sync spelling."""
    func = call.func
    if isinstance(func, ast.Name) and func.id in _SYNC_BUILTINS \
            and len(call.args) == 1:
        return call.args[0]
    if isinstance(func, ast.Attribute) and func.attr in _SYNC_METHODS \
            and not call.args:
        return func.value
    return None


class _HotLoopVisitor(ast.NodeVisitor):
    """Collect sync-on-step-state calls inside loops of one hot body."""

    def __init__(self):
        self.loop_depth = 0
        self.hits: list[ast.Call] = []

    def visit_For(self, node: ast.For) -> None:
        self.loop_depth += 1
        self.generic_visit(node)
        self.loop_depth -= 1

    visit_AsyncFor = visit_For

    def visit_While(self, node: ast.While) -> None:
        self.loop_depth += 1
        self.generic_visit(node)
        self.loop_depth -= 1

    def visit_FunctionDef(self, node) -> None:
        # A nested def is a new (cold-until-called) scope: a sync in a
        # callback defined inside the loop is the caller's problem at
        # its own call site, not a per-iteration sync here.
        return

    visit_AsyncFunctionDef = visit_FunctionDef

    def visit_Call(self, node: ast.Call) -> None:
        if self.loop_depth > 0:
            if _is_cuda_synchronize(node.func):
                self.hits.append(node)
            else:
                operand = _sync_operand(node)
                if operand is not None and _mentions_step_state(operand):
                    self.hits.append(node)
        self.generic_visit(node)


class HostSyncChecker(Checker):
    rule = "host-sync"
    describe = ("device->host sync on step state inside a hot loop "
                "(train_loop / step hooks / serving dispatch)")
    incident = ("the JAX loop's per-step `int(s.step)` serialized the "
                "host against the async device queue every step "
                "(ntxent_tpu/analysis/hostsync.py)")

    def _is_hot(self, name: str, rel: str, cfg) -> bool:
        if name in cfg.hot_functions:
            return True
        if any(name.endswith(sfx) for sfx in cfg.hot_suffixes):
            return True
        if rel.startswith(cfg.serving_scope) and name in cfg.hot_serving:
            return True
        return False

    def check(self, src: SourceFile, ctx: LintContext):
        cfg = ctx.config
        for node in ast.walk(src.tree):
            if not isinstance(node, (ast.FunctionDef,
                                     ast.AsyncFunctionDef)):
                continue
            if not self._is_hot(node.name, src.rel, cfg):
                continue
            visitor = _HotLoopVisitor()
            for stmt in node.body:
                visitor.visit(stmt)
            for call in visitor.hits:
                yield src.finding(
                    self.rule, call,
                    f"host sync on step state inside `{node.name}`'s "
                    f"loop — hoist it out of the per-step path (read "
                    f"metrics once, behind the step's event)")
