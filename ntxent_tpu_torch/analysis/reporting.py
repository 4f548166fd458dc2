"""Shared finding reporters for the port's analysis CLIs (lint + audit),
a copy of ``ntxent_tpu/analysis/reporting.py``.

``--format github`` renders findings as GitHub workflow commands
(``::error file=...``) so a CI job annotates the diff inline instead
of burying findings in a log. One implementation, both tools: the
formats must not drift (``tests/test_torch_lint.py`` holds them to the
JAX package's).

Pure stdlib, like everything import-reachable from ``ntxent-lint``.
"""

from __future__ import annotations

__all__ = ["github_annotations", "print_github"]


def _escape_property(value: str) -> str:
    """Workflow-command property escaping (the documented set)."""
    return (value.replace("%", "%25").replace("\r", "%0D")
            .replace("\n", "%0A").replace(":", "%3A").replace(",", "%2C"))


def _escape_data(value: str) -> str:
    return value.replace("%", "%25").replace("\r", "%0D") \
        .replace("\n", "%0A")


def github_annotations(findings, tool: str, stale=(), parse_errors=()):
    """Workflow-command lines for NEW findings (+ notices for stale
    baseline entries and parse errors). ``file``/``line`` come from the
    finding; graph findings carry pseudo-paths (``graph://target``) —
    GitHub renders those as plain annotations, which is the right
    degradation (there is no source line for a traced-graph defect)."""
    lines = []
    for f in findings:
        props = f"file={_escape_property(f.path)}"
        if f.line:
            props += f",line={f.line}"
        props += f",title={_escape_property(f'{tool}[{f.rule}]')}"
        lines.append(f"::error {props}::{_escape_data(f.message)}")
    for path, err in parse_errors:
        lines.append(
            f"::error file={_escape_property(path)},"
            f"title={_escape_property(f'{tool}[parse]')}"
            f"::{_escape_data(err)}")
    for key in stale:
        rule, path, snippet = key
        lines.append(
            f"::notice file={_escape_property(path)},"
            f"title={_escape_property(f'{tool}[stale-baseline]')}"
            f"::stale baseline entry (fix landed — remove it): "
            f"{_escape_data(f'{rule}: {snippet}')}")
    return lines


def print_github(findings, tool: str, stale=(), parse_errors=()) -> None:
    for line in github_annotations(findings, tool, stale, parse_errors):
        print(line)
