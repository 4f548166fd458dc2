"""``ntxent-lint`` for the port: run the checkers over
``ntxent_tpu_torch`` and ``chip_smoke.py``, gate on NEW findings. The
counterpart of ``ntxent_tpu/analysis/cli.py``, with its flags, exit codes
and output formats.

Exit codes: 0 = clean (or every finding baselined/suppressed);
1 = new findings (or parse errors); 2 = usage error.

Typical invocations (``python -m ntxent_tpu_torch.analysis.cli`` as
``ntxent-lint``)::

    ntxent-lint                       # repo root auto-detected, text out
    ntxent-lint --rules collective-shim,host-sync
    ntxent-lint --format json         # tooling view (findings + stale)
    ntxent-lint --write-baseline      # accept the current findings
    ntxent-lint --list-rules          # rule table with incidents
    ntxent-lint --boundary-modules    # the static torch-free module list

The baseline is ``ntxent_tpu_torch/analysis/lint_baseline.json`` (the
repo root's ``lint_baseline.json`` belongs to the JAX package). The
process stays free of torch, numpy and jax: pure ``ast``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

from .framework import (
    LintConfig,
    all_rules,
    compare_with_baseline,
    load_baseline,
    run_lint,
    write_baseline,
)
from .imports import reachable_modules

BASELINE_NAME = "lint_baseline.json"
# the port's baselines live beside its analysis package, repo-relative
BASELINE_DIR = os.path.join("ntxent_tpu_torch", "analysis")

__all__ = ["main", "find_root", "BASELINE_DIR", "BASELINE_NAME",
           "default_baseline"]


def find_root(start: str | None = None) -> str:
    """Nearest ancestor holding the package dir (repo checkout root)."""
    path = os.path.abspath(start or os.getcwd())
    while True:
        if os.path.isdir(os.path.join(path, "ntxent_tpu_torch")):
            return path
        parent = os.path.dirname(path)
        if parent == path:
            break
        path = parent
    # Installed-package fallback: lint the tree this file lives in.
    return os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))))


def default_baseline(root: str, name: str = BASELINE_NAME) -> str:
    """``<root>/ntxent_tpu_torch/analysis/<name>``."""
    return os.path.join(root, BASELINE_DIR, name)


def _parse_args(argv):
    parser = argparse.ArgumentParser(
        prog="ntxent-lint",
        description="the port's project-native static analysis")
    parser.add_argument("--root", default=None,
                        help="repo root (default: auto-detect upward "
                             "from the cwd)")
    parser.add_argument("--rules", default=None,
                        help="comma-separated subset of rules to run")
    parser.add_argument("--baseline", default=None,
                        help=f"baseline file (default: <root>/"
                             f"{BASELINE_DIR}/{BASELINE_NAME} when "
                             f"present)")
    parser.add_argument("--no-baseline", action="store_true",
                        help="ignore any baseline: every finding is new")
    parser.add_argument("--write-baseline", action="store_true",
                        help="accept the current findings into the "
                             "baseline file and exit 0")
    parser.add_argument("--format", choices=("text", "json", "github"),
                        default="text",
                        help="github = workflow-command annotations "
                             "(::error file=...) via the reporter "
                             "shared with ntxent-audit")
    parser.add_argument("--list-rules", action="store_true",
                        help="print the rule table and exit")
    parser.add_argument("--boundary-modules", action="store_true",
                        help="print the import-boundary checker's "
                             "statically reachable (torch-free) module "
                             "list and exit")
    return parser.parse_args(argv)


def main(argv=None) -> int:
    args = _parse_args(argv if argv is not None else sys.argv[1:])
    if args.list_rules:
        for rule, checker in sorted(all_rules().items()):
            print(f"{rule}\n    {checker.describe}\n"
                  f"    incident: {checker.incident}")
        return 0
    root = os.path.abspath(args.root) if args.root else find_root()
    config = LintConfig(root=root)
    if args.boundary_modules:
        for name, rel in reachable_modules(config=config).items():
            print(f"{name}  {rel}")
        return 0
    rules = tuple(r.strip() for r in args.rules.split(",")) \
        if args.rules else None
    t0 = time.perf_counter()
    try:
        result = run_lint(config, rules=rules)
    except ValueError as e:
        print(f"ntxent-lint: {e}", file=sys.stderr)
        return 2

    baseline_path = args.baseline or default_baseline(root)
    if args.write_baseline:
        to_write = list(result.findings)
        if rules is not None and os.path.isfile(baseline_path):
            # A scoped run only re-decides the SELECTED rules: entries
            # for every other rule are carried over untouched, not
            # silently dropped from the rewritten file.
            from .framework import Finding

            for (rule, rel, snippet), n in \
                    load_baseline(baseline_path).items():
                if rule not in rules:
                    to_write.extend(
                        Finding(rule=rule, path=rel, line=0,
                                message="(carried baseline entry)",
                                snippet=snippet)
                        for _ in range(n))
        write_baseline(baseline_path, to_write)
        print(f"ntxent-lint: baseline with {len(to_write)} "
              f"finding(s) written to {baseline_path}")
        return 0
    baseline = None
    if not args.no_baseline and os.path.isfile(baseline_path):
        baseline = load_baseline(baseline_path)
        if rules is not None:
            # Scope the comparison to the selected rules: a partial run
            # must not misreport other rules' live entries as stale.
            baseline = type(baseline)(
                {k: v for k, v in baseline.items() if k[0] in rules})
    if baseline:
        new, accepted, stale = compare_with_baseline(result.findings,
                                                     baseline)
    else:
        new, accepted, stale = list(result.findings), [], []
    elapsed = time.perf_counter() - t0

    if args.format == "json":
        print(json.dumps({
            "new": [vars(f) for f in new],
            "baselined": [vars(f) for f in accepted],
            "suppressed": [vars(f) for f in result.suppressed],
            "stale_baseline": [list(k) for k in stale],
            "parse_errors": [list(p) for p in result.parse_errors],
            "elapsed_s": round(elapsed, 3),
        }, indent=2))
    elif args.format == "github":
        from .reporting import print_github

        print_github(new, "ntxent-lint", stale=stale,
                     parse_errors=result.parse_errors)
        print(f"ntxent-lint: {len(new)} new, {len(accepted)} baselined,"
              f" {len(result.suppressed)} suppressed ({elapsed:.2f}s)",
              file=sys.stderr)
    else:
        for f in new:
            print(f.format())
        for path, err in result.parse_errors:
            print(f"{path}: parse error: {err}")
        for key in stale:
            print(f"stale baseline entry (fix landed — remove it): "
                  f"{key[0]} @ {key[1]}: {key[2]}", file=sys.stderr)
        print(f"ntxent-lint: {len(new)} new, {len(accepted)} baselined,"
              f" {len(result.suppressed)} suppressed, {len(stale)} "
              f"stale baseline entr{'y' if len(stale) == 1 else 'ies'} "
              f"({elapsed:.2f}s)", file=sys.stderr)
    return 1 if new or result.parse_errors else 0


if __name__ == "__main__":
    sys.exit(main())
