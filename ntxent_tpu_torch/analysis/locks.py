"""lock-discipline: no blocking work under serving/obs locks; no lock
acquisition inside signal handlers. A copy of
``ntxent_tpu/analysis/locks.py`` over the port's scopes.

Two incidents of the JAX package share the rule:

* SHA-1 hashing and serial rollback HTTP rode inside
  ``with self._lock:`` on the serving request path — every concurrent
  request convoyed behind one holder's I/O. The checker flags LEXICAL
  blocking calls (file open, subprocess, sleep, thread join, sockets,
  HTTP) inside ``with <lock>:`` bodies under ``serving/`` and ``obs/``.
  The repo's own fix pattern is the one to copy: snapshot under the
  lock, do the slow work outside (obs/events.py dump_flight).
* A signal handler that takes a lock the interrupted thread may
  already hold is a self-deadlock — handlers must only flip flags
  (training/preemption.py and obs/profiler.py are the clean exemplars).
  Flagged repo-wide: ``with <lock>:`` or ``.acquire()`` inside any
  function statically registered via ``signal.signal``.

``.wait()`` is deliberately NOT in the blocking set: condition
variables wait UNDER their lock by design (releasing it while parked).
"""

from __future__ import annotations

import ast
import re

from .framework import Checker, LintContext, SourceFile

__all__ = ["LockDisciplineChecker"]

# Module-attribute calls that block: receiver.attr pairs.
_BLOCKING_MODULE_CALLS = {
    ("time", "sleep"),
    ("subprocess", "run"), ("subprocess", "Popen"),
    ("subprocess", "call"), ("subprocess", "check_call"),
    ("subprocess", "check_output"),
    ("socket", "create_connection"),
    ("os", "fsync"),
    ("shutil", "copy"), ("shutil", "copy2"), ("shutil", "copytree"),
    ("shutil", "rmtree"),
}
_BLOCKING_BARE_CALLS = {"open", "sleep", "urlopen"}
# method names that block regardless of receiver module
_BLOCKING_METHODS = {"urlopen", "recv", "sendall", "connect",
                     "getresponse"}


def _terminal_name(node: ast.AST) -> str | None:
    if isinstance(node, ast.Attribute):
        return node.attr
    if isinstance(node, ast.Name):
        return node.id
    return None


# Word-boundary match, not substring: `self.clock`, `blocked`,
# `blocklist` must NOT read as locks; `_lock`, `label_lock`, `rlock`,
# `lock2` do.
_LOCK_NAME = re.compile(r"(^|_)r?locks?(\d*)($|_)", re.IGNORECASE)


def _is_lock_expr(node: ast.AST) -> bool:
    name = _terminal_name(node)
    return name is not None and _LOCK_NAME.search(name) is not None


def _blocking_reason(call: ast.Call) -> str | None:
    func = call.func
    if isinstance(func, ast.Name):
        if func.id in _BLOCKING_BARE_CALLS:
            return f"`{func.id}()`"
        return None
    if not isinstance(func, ast.Attribute):
        return None
    recv = func.value
    if isinstance(recv, ast.Name) \
            and (recv.id, func.attr) in _BLOCKING_MODULE_CALLS:
        return f"`{recv.id}.{func.attr}()`"
    if func.attr in _BLOCKING_METHODS:
        return f"`.{func.attr}()`"
    if func.attr == "join":
        # thread.join() / thread.join(timeout) blocks; str.join(iter)
        # does not. Receivers that are string literals, and calls whose
        # single argument is a non-numeric expression (the iterable),
        # are the string spelling.
        if isinstance(recv, ast.Constant) and isinstance(recv.value, str):
            return None
        if not call.args:
            return "`.join()`"
        if len(call.args) == 1 and isinstance(call.args[0], ast.Constant) \
                and isinstance(call.args[0].value, (int, float)):
            return "`.join(timeout)`"
        return None
    return None


class _WithLockVisitor(ast.NodeVisitor):
    """Blocking calls lexically inside ``with <lock>:`` bodies.

    Nested defs inside the with-body are skipped: defining a closure
    under a lock does not run it there.
    """

    def __init__(self):
        self.lock_depth = 0
        self.hits: list[tuple[ast.Call, str]] = []

    def visit_With(self, node: ast.With) -> None:
        locked = any(_is_lock_expr(item.context_expr)
                     or (isinstance(item.context_expr, ast.Call)
                         and _is_lock_expr(item.context_expr.func))
                     for item in node.items)
        if locked:
            self.lock_depth += 1
        self.generic_visit(node)
        if locked:
            self.lock_depth -= 1

    visit_AsyncWith = visit_With

    def visit_FunctionDef(self, node) -> None:
        if self.lock_depth == 0:
            self.generic_visit(node)

    visit_AsyncFunctionDef = visit_FunctionDef

    def visit_Call(self, node: ast.Call) -> None:
        if self.lock_depth > 0:
            reason = _blocking_reason(node)
            if reason is not None:
                self.hits.append((node, reason))
        self.generic_visit(node)


def _signal_handler_names(tree: ast.AST) -> set[str]:
    """Function names statically passed to ``signal.signal(...)``."""
    out: set[str] = set()
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call) or len(node.args) < 2:
            continue
        func = node.func
        is_signal = (
            isinstance(func, ast.Attribute) and func.attr == "signal"
            and isinstance(func.value, ast.Name)
            and "signal" in func.value.id
        ) or (isinstance(func, ast.Name) and func.id == "signal")
        if not is_signal:
            continue
        handler = node.args[1]
        if isinstance(handler, ast.Name):
            out.add(handler.id)
        elif isinstance(handler, ast.Attribute):
            out.add(handler.attr)
    return out


class LockDisciplineChecker(Checker):
    rule = "lock-discipline"
    describe = ("blocking call under a serving/obs lock, or lock "
                "acquisition inside a signal handler")
    incident = ("the JAX router's SHA-1 + rollback HTTP under the cache "
                "lock convoyed the request path; a handler-side lock is a "
                "self-deadlock")

    def check(self, src: SourceFile, ctx: LintContext):
        if any(src.rel.startswith(scope)
               for scope in ctx.config.lock_scopes):
            visitor = _WithLockVisitor()
            visitor.visit(src.tree)
            for call, reason in visitor.hits:
                yield src.finding(
                    self.rule, call,
                    f"{reason} inside a `with <lock>:` block — snapshot "
                    f"under the lock, do the blocking work outside it")
        # Signal-handler half: repo-wide.
        handlers = _signal_handler_names(src.tree)
        if not handlers:
            return
        for node in ast.walk(src.tree):
            if not isinstance(node, (ast.FunctionDef,
                                     ast.AsyncFunctionDef)) \
                    or node.name not in handlers:
                continue
            for sub in ast.walk(node):
                if isinstance(sub, ast.With):
                    for item in sub.items:
                        if _is_lock_expr(item.context_expr):
                            yield src.finding(
                                self.rule, sub,
                                f"signal handler `{node.name}` takes a "
                                f"lock — the interrupted thread may "
                                f"already hold it (flip a flag instead)")
                if isinstance(sub, ast.Call) \
                        and isinstance(sub.func, ast.Attribute) \
                        and sub.func.attr == "acquire" \
                        and _is_lock_expr(sub.func.value):
                    yield src.finding(
                        self.rule, sub,
                        f"signal handler `{node.name}` acquires a lock "
                        f"— self-deadlock hazard (flip a flag instead)")
