"""Shared visitor framework for the port's ntxent-lint checkers, a copy of
``ntxent_tpu/analysis/framework.py`` with the port's settings in
``LintConfig``.

Design (deliberately small):

* one parse per file (``SourceFile`` owns the ``ast`` tree, the raw
  lines, and the per-line suppression map);
* checkers are objects with a ``rule`` name and two hooks —
  ``check(src, ctx)`` per file and ``finalize(ctx)`` once per run (the
  import-boundary checker works on the whole graph, not one file);
* findings carry ``file:line`` plus the stripped source line as their
  BASELINE IDENTITY: line numbers churn on every edit, the offending
  text does not, so a committed baseline survives unrelated diffs;
* suppression is lexical and rule-scoped: ``# ntxent: lint-ok[rule]
  reason`` on the finding's line or the line directly above. A
  suppression naming the WRONG rule does not suppress (tests pin this).

Pure stdlib by contract: a lint run loads neither torch, numpy nor jax
(``tests/test_torch_lint.py`` checks ``sys.modules`` of a lint process).
"""

from __future__ import annotations

import ast
import dataclasses
import json
import os
import re
from collections import Counter

__all__ = [
    "Finding",
    "LintConfig",
    "LintResult",
    "SourceFile",
    "Checker",
    "compare_with_baseline",
    "load_baseline",
    "run_lint",
    "write_baseline",
    "iter_source_files",
]

# ``# ntxent: lint-ok[rule]`` or ``lint-ok[rule-a,rule-b]``; anything
# after the bracket is the human reason (required by convention,
# unenforced — the review sees the diff either way).
_SUPPRESS_RE = re.compile(r"#\s*ntxent:\s*lint-ok\[([a-zA-Z0-9_,\- ]+)\]")

# Default scan set, relative to the repo root: the port's package and the
# card's smoke script. tests/ stays out (its fixtures violate rules on
# purpose), and so does the JAX package, which lints itself.
_DEFAULT_TARGETS = ("ntxent_tpu_torch", "chip_smoke.py")
_SKIP_DIRS = {"__pycache__", ".git", "tests", "benchmark_results"}


@dataclasses.dataclass(frozen=True)
class Finding:
    """One rule violation at a precise location.

    ``snippet`` (the stripped source line) is the stable half of the
    baseline key — see module docstring."""

    rule: str
    path: str  # repo-relative, posix separators
    line: int
    message: str
    snippet: str = ""

    def key(self) -> tuple[str, str, str]:
        return (self.rule, self.path, self.snippet)

    def format(self) -> str:
        return f"{self.path}:{self.line}: [{self.rule}] {self.message}"


@dataclasses.dataclass
class LintConfig:
    """Project knobs the checkers read; tests override to point the
    same checkers at fixture trees."""

    root: str = "."
    targets: tuple[str, ...] = _DEFAULT_TARGETS
    # collective-shim: the one file allowed to call torch.distributed's
    # collectives (its helpers record the comms accounting and apply the
    # wire policy).
    shim_paths: tuple[str, ...] = ("ntxent_tpu_torch/parallel/mesh.py",)
    # import-boundary (b): the torch-free router tier's root modules: the
    # router, the shard and journal processes and their helpers (a
    # superset of what the
    # runtime tripwires of tests/test_torch_fleet_e2e.py and
    # tests/test_torch_retrieval_fleet.py load; test_torch_lint pins it).
    boundary_roots: tuple[str, ...] = (
        "ntxent_tpu_torch.fleet_cli",
        "ntxent_tpu_torch.serving",
        "ntxent_tpu_torch.serving.router",
        "ntxent_tpu_torch.serving.cache",
        "ntxent_tpu_torch.serving.fleet",
        "ntxent_tpu_torch.serving.autoscale",
        "ntxent_tpu_torch.serving.shadow",
        "ntxent_tpu_torch.obs",
        "ntxent_tpu_torch.obs.aggregate",
        "ntxent_tpu_torch.obs.slo",
        "ntxent_tpu_torch.obs.history",
        "ntxent_tpu_torch.resilience",
        "ntxent_tpu_torch.resilience.faults",
        "ntxent_tpu_torch.retrieval",
        "ntxent_tpu_torch.retrieval.shard",
        "ntxent_tpu_torch.retrieval.journal",
        "ntxent_tpu_torch.analysis",
    )
    boundary_forbidden: tuple[str, ...] = (
        # torch and what loads it: the multi-second import a restarted
        # router or shard process must not pay
        "torch", "torchvision", "triton",
    )
    # import-boundary (a): what no file of the targets imports anywhere,
    # function bodies included (tests/test_torch_import_boundary.py's
    # static scan, which must agree): JAX and its libraries, the JAX
    # package, and the packages the card's machine lacks.
    package_forbidden: tuple[str, ...] = (
        "jax", "jaxlib", "flax", "optax", "chex", "ntxent_tpu", "msgpack",
        "ml_dtypes",
    )
    # lock-discipline: directories whose locks guard request paths.
    lock_scopes: tuple[str, ...] = ("ntxent_tpu_torch/serving/",
                                    "ntxent_tpu_torch/obs/")
    # host-sync: function names that ARE the hot path.
    hot_functions: tuple[str, ...] = ("train_loop", "eval_loop", "fit")
    hot_suffixes: tuple[str, ...] = ("_hook",)
    # serving dispatch bodies (scoped to serving/ by the checker).
    hot_serving: tuple[str, ...] = ("_run", "_serve_batch", "_take_batch",
                                    "submit", "submit_async", "dispatch",
                                    "_dispatch", "_flush")
    serving_scope: str = "ntxent_tpu_torch/serving/"
    # telemetry-schema: where EVENT_TYPES lives, and the bounded label
    # vocabulary (adding a key here is the deliberate act the
    # pow2-cardinality rule wants a diff line for).
    events_path: str = "ntxent_tpu_torch/obs/events.py"
    event_types: tuple[str, ...] | None = None  # None: parse events_path
    label_vocab: tuple[str, ...] = (
        "op", "axis", "dtype", "stage", "run_id", "reason", "instance",
        "bucket", "slo", "rows", "mode", "worker",
        # collective_graph_bytes_total{source=ad|gspmd}: a two-value
        # closed set naming who inserted the traffic.
        "source",
        # retrieval_ops_total{kind=build|seal|compact|promote|rollback|
        # stale|rebuild}: the index lifecycle, a closed set.
        "kind",
        # tenant_admitted/rejected_total{tenant=...}: open at the wire,
        # but the router tracks at most max_tenants values and melts the
        # rest into "other".
        "tenant",
        # obs_anomalies_total{series=...}: bounded by the history store's
        # max_series cap.
        "series",
        # retrieval_shard_up{shard=0..N-1}: one value per configured shard
        # endpoint, bounded by --search-shards.
        "shard",
    )


class SourceFile:
    """One parsed python file: ast tree + lines + suppression map."""

    def __init__(self, abs_path: str, rel_path: str, text: str):
        self.abs_path = abs_path
        self.rel = rel_path.replace(os.sep, "/")
        self.text = text
        self.lines = text.splitlines()
        self.tree = ast.parse(text, filename=rel_path)
        self.suppressions: dict[int, set[str]] = {}
        for i, line in enumerate(self.lines, start=1):
            m = _SUPPRESS_RE.search(line)
            if m:
                rules = {r.strip() for r in m.group(1).split(",")
                         if r.strip()}
                self.suppressions[i] = rules

    def snippet(self, line: int) -> str:
        if 1 <= line <= len(self.lines):
            return self.lines[line - 1].strip()
        return ""

    def suppressed(self, rule: str, line: int) -> bool:
        for at in (line, line - 1):
            if rule in self.suppressions.get(at, ()):
                return True
        return False

    def finding(self, rule: str, node: ast.AST, message: str) -> Finding:
        line = getattr(node, "lineno", 0)
        return Finding(rule=rule, path=self.rel, line=line,
                       message=message, snippet=self.snippet(line))


class Checker:
    """Base checker: subclasses set ``rule``/``describe``/``incident``
    and implement ``check`` (per file) and/or ``finalize`` (per run)."""

    rule: str = ""
    describe: str = ""
    incident: str = ""  # the past-PR defect this rule encodes

    def check(self, src: SourceFile, ctx: "LintContext"):
        return ()

    def finalize(self, ctx: "LintContext"):
        return ()


@dataclasses.dataclass
class LintContext:
    config: LintConfig
    files: list[SourceFile]

    def file_by_rel(self, rel: str) -> SourceFile | None:
        for src in self.files:
            if src.rel == rel:
                return src
        return None


@dataclasses.dataclass
class LintResult:
    findings: list[Finding]            # active (unsuppressed)
    suppressed: list[Finding]          # matched a lint-ok
    parse_errors: list[tuple[str, str]]  # (path, error)

    def by_rule(self) -> dict[str, list[Finding]]:
        out: dict[str, list[Finding]] = {}
        for f in self.findings:
            out.setdefault(f.rule, []).append(f)
        return out


def iter_source_files(root: str,
                      targets: tuple[str, ...]) -> list[tuple[str, str]]:
    """(abs_path, rel_path) for every .py under the configured targets."""
    out = []
    for target in targets:
        base = os.path.join(root, target)
        if os.path.isfile(base):
            if base.endswith(".py"):
                out.append((base, target))
            continue
        for dirpath, dirnames, filenames in os.walk(base):
            dirnames[:] = sorted(d for d in dirnames
                                 if d not in _SKIP_DIRS)
            for name in sorted(filenames):
                if not name.endswith(".py"):
                    continue
                abs_path = os.path.join(dirpath, name)
                rel = os.path.relpath(abs_path, root)
                out.append((abs_path, rel))
    return out


def _all_checkers() -> list[Checker]:
    # Local imports: checker modules import this one for the base class.
    from .collectives import CollectiveShimChecker
    from .hostsync import HostSyncChecker
    from .imports import ImportBoundaryChecker
    from .locks import LockDisciplineChecker
    from .telemetry import TelemetrySchemaChecker

    return [CollectiveShimChecker(), HostSyncChecker(),
            LockDisciplineChecker(), ImportBoundaryChecker(),
            TelemetrySchemaChecker()]


def all_rules() -> dict[str, Checker]:
    return {c.rule: c for c in _all_checkers()}


def run_lint(config: LintConfig | None = None,
             rules: tuple[str, ...] | None = None) -> LintResult:
    """Parse the configured tree once, run the (selected) checkers,
    partition findings by suppression."""
    config = config or LintConfig()
    files: list[SourceFile] = []
    parse_errors: list[tuple[str, str]] = []
    for abs_path, rel in iter_source_files(config.root, config.targets):
        try:
            with open(abs_path, encoding="utf-8") as f:
                text = f.read()
            files.append(SourceFile(abs_path, rel, text))
        except (OSError, SyntaxError, ValueError) as e:
            # A file the linter cannot parse is itself a finding-grade
            # problem, but not THIS linter's: report and continue.
            parse_errors.append((rel.replace(os.sep, "/"), str(e)))
    ctx = LintContext(config=config, files=files)
    checkers = _all_checkers()
    if rules is not None:
        unknown = set(rules) - {c.rule for c in checkers}
        if unknown:
            raise ValueError(f"unknown lint rule(s): {sorted(unknown)}")
        checkers = [c for c in checkers if c.rule in rules]
    active: list[Finding] = []
    suppressed: list[Finding] = []
    for checker in checkers:
        produced: list[Finding] = []
        for src in files:
            produced.extend(checker.check(src, ctx))
        produced.extend(checker.finalize(ctx))
        for finding in produced:
            src = ctx.file_by_rel(finding.path)
            if src is not None and src.suppressed(finding.rule,
                                                  finding.line):
                suppressed.append(finding)
            else:
                active.append(finding)
    active.sort(key=lambda f: (f.path, f.line, f.rule))
    suppressed.sort(key=lambda f: (f.path, f.line, f.rule))
    return LintResult(active, suppressed, parse_errors)


# ---------------------------------------------------------------------------
# Baseline: committed, count-keyed acceptance of pre-existing findings
# ---------------------------------------------------------------------------
#
# Key = (rule, path, stripped source line); counts make duplicates (the
# same offending line appearing N times in one file) explicit. The gate
# fails only on findings BEYOND the baselined count; baseline entries
# with no surviving finding are STALE and reported so the file shrinks
# as debt is paid instead of fossilizing.


def load_baseline(path: str) -> Counter:
    with open(path, encoding="utf-8") as f:
        data = json.load(f)
    counts: Counter = Counter()
    for entry in data.get("findings", []):
        key = (entry["rule"], entry["path"], entry.get("snippet", ""))
        counts[key] += int(entry.get("count", 1))
    return counts


def write_baseline(path: str, findings: list[Finding]) -> None:
    # Regenerating must not clobber justifications a maintainer already
    # wrote (the workflow REQUIRES a reason per accepted entry): carry
    # existing reasons over by key, TODO-stamp only genuinely new ones.
    reasons: dict[tuple, str] = {}
    if os.path.isfile(path):
        try:
            with open(path, encoding="utf-8") as f:
                for entry in json.load(f).get("findings", []):
                    key = (entry["rule"], entry["path"],
                           entry.get("snippet", ""))
                    reasons[key] = entry.get("reason", "")
        except (OSError, ValueError, KeyError):
            pass  # unreadable prior baseline: write fresh
    counts = Counter(f.key() for f in findings)
    entries = [
        {"rule": rule, "path": rel, "snippet": snippet, "count": n,
         "reason": reasons.get((rule, rel, snippet))
         or "TODO: justify why this finding is accepted"}
        for (rule, rel, snippet), n in sorted(counts.items())
    ]
    with open(path, "w", encoding="utf-8") as f:
        json.dump({"version": 1, "findings": entries}, f, indent=2)
        f.write("\n")


def compare_with_baseline(
    findings: list[Finding], baseline: Counter,
) -> tuple[list[Finding], list[Finding], list[tuple]]:
    """(new, accepted, stale_keys): findings beyond their baselined
    count are new; baseline entries beyond the current count are stale."""
    remaining = Counter(baseline)
    new: list[Finding] = []
    accepted: list[Finding] = []
    for f in findings:
        if remaining.get(f.key(), 0) > 0:
            remaining[f.key()] -= 1
            accepted.append(f)
        else:
            new.append(f)
    stale = sorted(key for key, n in remaining.items() if n > 0)
    return new, accepted, stale
