"""telemetry-schema: event types, metric names, and label keys are a
closed vocabulary, checked at lint time. A copy of
``ntxent_tpu/analysis/telemetry.py`` over the port's ``EVENT_TYPES``
(``obs/events.py``) and registry.

The event stream accepts unknown types at runtime BY DESIGN (it is
extensible), which makes a typo'd ``emit("divergnce", ...)`` silent
forever — no reader ever matches it. Same for metric names the
exposition escaper would mangle, and for label keys: the pow2-
cardinality rule bounds label VALUES, but an unreviewed new
label KEY is how unbounded cardinality sneaks in (per-tenant, per-
request ids). So:

* every ``emit("<literal>", ...)`` type must be in ``EVENT_TYPES`` —
  extracted statically from obs/events.py, so the checker and the
  runtime share one source of truth;
* every registry ``counter``/``gauge``/``histogram`` literal name must
  already be exposition-legal (``prometheus_name`` would pass it
  through unchanged);
* every literal label key must come from the bounded vocabulary in
  ``LintConfig.label_vocab`` — adding a key is a deliberate,
  reviewable config diff, not a drive-by.

Non-literal arguments are skipped (a dynamic event type is a different
design smell, not this rule's).
"""

from __future__ import annotations

import ast
import os
import re

from .framework import Checker, LintContext, SourceFile

__all__ = ["TelemetrySchemaChecker"]

# Mirror of obs.registry's exposition-name legality (kept in literal
# sync by tests/test_torch_lint.py rather than an import: the linter must
# not import the package it lints).
_NAME_OK = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")

_METRIC_FACTORIES = {"counter", "gauge", "histogram"}
# Receivers that make a .emit(...) call an EVENT-LOG emit (vs. any
# other class's unrelated .emit method).
_EMIT_RECEIVERS = {"events", "obs_events", "_events"}


def _extract_event_types(src: SourceFile) -> tuple[str, ...] | None:
    for node in ast.walk(src.tree):
        if isinstance(node, ast.Assign) and any(
                isinstance(t, ast.Name) and t.id == "EVENT_TYPES"
                for t in node.targets):
            if isinstance(node.value, (ast.Tuple, ast.List)):
                vals = []
                for elt in node.value.elts:
                    if isinstance(elt, ast.Constant) \
                            and isinstance(elt.value, str):
                        vals.append(elt.value)
                return tuple(vals)
    return None


def _is_event_emit(func: ast.AST) -> bool:
    if isinstance(func, ast.Name):
        return func.id == "emit"
    if isinstance(func, ast.Attribute) and func.attr == "emit":
        recv = func.value
        name = recv.attr if isinstance(recv, ast.Attribute) \
            else recv.id if isinstance(recv, ast.Name) else ""
        return name in _EMIT_RECEIVERS or "log" in name.lower() \
            or "event" in name.lower()
    return False


def _registry_aliases(tree: ast.AST) -> set[str]:
    """Local names bound to something registry-shaped — the repo's
    dominant spelling is ``r = self.registry; r.counter(...)``, so the
    receiver check must see through one assignment hop. File-level
    over-approximation (an alias in one function matches uses in
    another): acceptable, because only ``counter``/``gauge``/
    ``histogram`` calls on the alias are ever inspected."""
    aliases: set[str] = set()
    for node in ast.walk(tree):
        if not isinstance(node, ast.Assign) \
                or len(node.targets) != 1 \
                or not isinstance(node.targets[0], ast.Name):
            continue
        value = node.value
        if isinstance(value, ast.Call):
            value = value.func  # MetricsRegistry() / default_registry()
        name = value.attr if isinstance(value, ast.Attribute) \
            else value.id if isinstance(value, ast.Name) else ""
        if "registry" in name.lower():
            aliases.add(node.targets[0].id)
    return aliases


def _is_registry_factory(func: ast.AST, aliases: set[str]) -> bool:
    if not (isinstance(func, ast.Attribute)
            and func.attr in _METRIC_FACTORIES):
        return False
    recv = func.value
    name = recv.attr if isinstance(recv, ast.Attribute) \
        else recv.id if isinstance(recv, ast.Name) else ""
    if "registry" in name.lower() or name in aliases:
        return True
    # default_registry().counter(...)
    if isinstance(recv, ast.Call):
        f = recv.func
        fname = f.attr if isinstance(f, ast.Attribute) \
            else f.id if isinstance(f, ast.Name) else ""
        return "registry" in fname.lower()
    return False


class TelemetrySchemaChecker(Checker):
    rule = "telemetry-schema"
    describe = ("event type outside EVENT_TYPES, exposition-illegal "
                "metric name, or label key outside the bounded "
                "vocabulary")
    incident = ("runtime accepts unknown event types by design, so a "
                "typo'd type/label is silent forever; unreviewed label "
                "keys are the unbounded-cardinality backdoor the pow2 "
                "rule closed for values")

    _types_cache: tuple[str, ...] | None = None

    def _event_types(self, ctx: LintContext) -> tuple[str, ...]:
        # check() runs once per file; the vocabulary is constant for the
        # whole run — extract it once, not ~110 ast.walks per lint.
        if self._types_cache is not None:
            return self._types_cache
        cfg = ctx.config
        if cfg.event_types is not None:
            types = tuple(cfg.event_types)
        else:
            types = ()
            rel = cfg.events_path.replace(os.sep, "/")
            src = ctx.file_by_rel(rel)
            if src is not None:
                types = _extract_event_types(src) or ()
        self._types_cache = types
        return types

    def check(self, src: SourceFile, ctx: LintContext):
        event_types = self._event_types(ctx)
        vocab = set(ctx.config.label_vocab)
        aliases = _registry_aliases(src.tree)
        for node in ast.walk(src.tree):
            if not isinstance(node, ast.Call):
                continue
            if event_types and _is_event_emit(node.func) and node.args:
                first = node.args[0]
                if isinstance(first, ast.Constant) \
                        and isinstance(first.value, str) \
                        and first.value not in event_types:
                    yield src.finding(
                        self.rule, node,
                        f"event type {first.value!r} is not in "
                        f"EVENT_TYPES — a typo here is silent at "
                        f"runtime (add it to obs/events.py if it is a "
                        f"new core type)")
            if _is_registry_factory(node.func, aliases):
                if node.args and isinstance(node.args[0], ast.Constant) \
                        and isinstance(node.args[0].value, str):
                    name = node.args[0].value
                    if not _NAME_OK.match(name):
                        yield src.finding(
                            self.rule, node,
                            f"metric name {name!r} is not exposition-"
                            f"legal (prometheus_name would rewrite it; "
                            f"name it legally at the source)")
                for kw in node.keywords:
                    if kw.arg != "labels" \
                            or not isinstance(kw.value, ast.Dict):
                        continue
                    for key in kw.value.keys:
                        if isinstance(key, ast.Constant) \
                                and isinstance(key.value, str) \
                                and key.value not in vocab:
                            yield src.finding(
                                self.rule, key,
                                f"label key {key.value!r} is outside "
                                f"the bounded vocabulary — new keys "
                                f"need a LintConfig.label_vocab entry "
                                f"(and a cardinality story, per the "
                                f"pow2 rule)")
