"""``ntxent-audit`` for the port: run the analyzers over the entry points
that run, gate on NEW findings. The counterpart of
``ntxent_tpu/analysis/graph/cli.py``: the same exit-code contract (0 =
clean or baselined, 1 = new findings or a failed run, 2 = usage error),
the same count-keyed baseline semantics
(``ntxent_tpu_torch/analysis/audit_baseline.json``) and output formats
(text / json / github via the shared reporter). Findings carry
pseudo-paths (``graph://dist_loss/grad``, ``events://compile``) whose
baseline identity is the finding's stable snippet.

The census RUNS the targets' collectives, so the CLI spawns ``--world``
P gloo ranks on the CPU (default 4; JAX's ``--devices``), one CPU thread
each, that meet over a ``FileStore`` in a temporary directory. Every
rank runs every target; rank 0 reports. No accelerator and no network:
it rides CI next to the lint gate.

Typical invocations (``python -m ntxent_tpu_torch.analysis.graph.cli``
as ``ntxent-audit``)::

    ntxent-audit                       # full suite, text output
    ntxent-audit --world 2
    ntxent-audit --analyzers wire-dtype,donation
    ntxent-audit --format json         # per-target census report too
    ntxent-audit --format github       # CI annotations
    ntxent-audit --events run.jsonl    # recompile-cause over a log
    ntxent-audit --write-baseline      # accept current findings
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

BASELINE_NAME = "audit_baseline.json"

ANALYZERS = ("collective-census", "wire-dtype", "donation",
             "recompile-cause")

_DESCRIBE = {
    "collective-census": (
        "census of every c10d op a target runs (a TorchDispatchMode, "
        "backward included) cross-checked against the declared ring "
        "formulas",
        "the accounting records forward call sites only: autograd's "
        "collectives were missing from /metrics"),
    "wire-dtype": (
        "no eligible-sized collective may carry f32 on the wire under "
        "an int8/bf16 precision policy (verified in the ops that ran)",
        "the quant claim was only measured by the same helpers that "
        "performed the compression"),
    "donation": (
        "a host snapshot of the train state must not alias the live "
        "tensors an in-place step overwrites",
        "the JAX package's zero-copy snapshot of a donated buffer was "
        "overwritten mid-save; the port's optimizers update in place"),
    "recompile-cause": (
        "serving compile events must carry a cause; identical "
        "signatures must not churn",
        "'compiles stay flat' was a bare count — a miss could not say "
        "WHY it compiled"),
}

# a world that has not finished by then is killed and the run fails
WORLD_DEADLINE_S = 600.0

__all__ = ["main", "ANALYZERS", "BASELINE_NAME", "run_analyzers"]


def _parse_args(argv):
    parser = argparse.ArgumentParser(
        prog="ntxent-audit",
        description="the port's audit of the entry points that run")
    parser.add_argument("--root", default=None,
                        help="repo root (default: auto-detect upward "
                             "from the cwd)")
    parser.add_argument("--analyzers", default=None,
                        help="comma-separated subset of analyzers")
    parser.add_argument("--baseline", default=None,
                        help=f"baseline file (default: <root>/"
                             f"ntxent_tpu_torch/analysis/{BASELINE_NAME} "
                             f"when present)")
    parser.add_argument("--no-baseline", action="store_true",
                        help="ignore any baseline: every finding is new")
    parser.add_argument("--write-baseline", action="store_true",
                        help="accept the current findings and exit 0")
    parser.add_argument("--format", choices=("text", "json", "github"),
                        default="text")
    parser.add_argument("--list-analyzers", action="store_true",
                        help="print the analyzer table and exit")
    parser.add_argument("--events", default=None,
                        help="JSONL event log for the recompile-cause "
                             "analyzer (compile events)")
    parser.add_argument("--churn-threshold", type=int, default=3,
                        help="same-signature compiles that count as "
                             "churn (default 3)")
    parser.add_argument("--fixture-module", default=None,
                        help="python file whose targets(group) extends "
                             "the audit suite (gate self-tests)")
    parser.add_argument("--world", type=int, default=4,
                        help="gloo ranks the targets run on (default 4)")
    parser.add_argument("--no-publish", action="store_true",
                        help="skip bumping collective_graph_bytes_total "
                             "(the CLI publishes by default so a scrape "
                             "of the audit process shows the remainder)")
    return parser.parse_args(argv)


def _load_fixture_targets(path: str, group):
    import importlib.util

    spec = importlib.util.spec_from_file_location("_audit_fixture", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return list(module.targets(group))


def _census_analyzer(targets, report):
    """collective-census over the census-* targets; returns findings
    and fills ``report`` with per-target totals and remainders."""
    from ..framework import Finding
    from .census import (
        census_of_callable,
        census_totals,
        declared_wire_totals,
        graph_remainder,
        wire_totals,
    )

    findings = []
    ad_bytes = 0.0
    for t in targets:
        if not t.kind.startswith("census-"):
            continue
        built = t.build()
        entries, declared = census_of_callable(built["fn"], *built["args"])
        summary = graph_remainder(entries, declared)
        summary["totals"] = {f"{op}|{ax}": [c, b] for (op, ax), (c, b)
                             in sorted(census_totals(entries).items())}
        summary["wire"] = {op: list(v) for op, v
                           in sorted(wire_totals(entries).items())}
        summary["declared_wire"] = {
            op: list(v) for op, v
            in sorted(declared_wire_totals(declared).items())}
        summary["autograd_thread_ops"] = sorted(
            {e.op for e in entries if e.thread != "caller"})
        report[t.name] = summary
        if t.kind == "census-fwd":
            # Forward runs: the census equals the declared ring formulas
            # EXACTLY per wire op; any drift is a helper bypass or a
            # byte-model fork.
            cen = wire_totals(entries)
            dec = declared_wire_totals(declared)
            for op in sorted(set(cen) | set(dec)):
                c = cen.get(op, (0, 0.0))
                d = dec.get(op, (0, 0.0))
                if c[0] != d[0] or abs(c[1] - d[1]) > 1e-6:
                    findings.append(Finding(
                        rule="collective-census",
                        path=f"graph://{t.name}", line=0,
                        message=(
                            f"census/declared mismatch for {op}: the run "
                            f"says {c[0]} calls / {c[1]:.1f} B, the helpers "
                            f"declared {d[0]} / {d[1]:.1f} B — a collective "
                            f"bypassed the mesh helpers or the byte model "
                            f"drifted"),
                        snippet=f"mismatch|{op}"))
        elif t.kind == "census-grad":
            if summary["ad_bytes"] <= 0.0:
                findings.append(Finding(
                    rule="collective-census",
                    path=f"graph://{t.name}", line=0,
                    message=(
                        "grad census found NO traffic beyond the "
                        "forward-declared sites — autograd's collectives "
                        "are invisible again (the dispatch mode missed "
                        "the backward)"),
                    snippet="ad-remainder-zero"))
            ad_bytes += summary["ad_bytes"]
    report["_remainder"] = {"ad_bytes": round(ad_bytes, 3),
                            "gspmd_bytes": 0.0}
    return findings


def run_analyzers(targets, analyzers, events_path=None,
                  churn_threshold: int = 3, publish: bool = True):
    """(findings, census_report) over the selected analyzers, on this
    rank (every rank of the targets' group calls it at once)."""
    findings = []
    report: dict = {}
    if "collective-census" in analyzers:
        findings.extend(_census_analyzer(targets, report))
        if publish:
            from .census import publish_graph_census

            rem = report.get("_remainder", {})
            publish_graph_census(rem.get("ad_bytes", 0.0),
                                 rem.get("gspmd_bytes", 0.0))
    if "wire-dtype" in analyzers:
        from .census import census_of_callable
        from .wiredtype import wire_dtype_findings

        for t in targets:
            if t.kind != "wire-dtype":
                continue
            built = t.build()
            entries, _ = census_of_callable(built["fn"], *built["args"])
            findings.extend(
                wire_dtype_findings(entries, t.policy, t.name))
    if "donation" in analyzers:
        from .donation import donation_findings

        for t in targets:
            if t.kind != "donation":
                continue
            built = t.build()
            findings.extend(donation_findings(
                built["step"], built["state"], built["args"],
                built["snapshot"], t.name))
    if "recompile-cause" in analyzers and events_path:
        from .recompile import churn_findings

        events = []
        with open(events_path, encoding="utf-8") as f:
            for line in f:
                line = line.strip()
                if line:
                    try:
                        events.append(json.loads(line))
                    except ValueError:
                        continue
        findings.extend(churn_findings(events, churn_threshold))
    findings.sort(key=lambda f: (f.path, f.rule, f.snippet))
    return findings, report


def _rank_main(rank: int, world: int, store: str, analyzers, fixture,
               out: str) -> None:
    """One gloo rank: join, run the target analyzers, rank 0 writes
    ``out`` (the findings and the census report as JSON)."""
    import datetime

    import torch

    from ...parallel import mesh
    from .targets import default_targets

    torch.set_num_threads(1)
    mesh.init_from_file(store, rank, world, device="cpu",
                        timeout=datetime.timedelta(seconds=300))
    try:
        targets = default_targets()
        if fixture:
            targets = targets + _load_fixture_targets(fixture, None)
        findings, report = run_analyzers(targets, analyzers, publish=False)
        if rank == 0:
            with open(out, "w", encoding="utf-8") as f:
                json.dump({"findings": [vars(x) for x in findings],
                           "report": report}, f)
    finally:
        mesh.shutdown()


def _run_world(world: int, analyzers, fixture) -> tuple[list, dict]:
    """Spawn ``world`` ranks of ``_rank_main``; (findings, report) of
    rank 0. A rank that fails or outlives ``WORLD_DEADLINE_S`` fails the
    run (every rank is killed)."""
    import importlib
    import multiprocessing

    from ..framework import Finding

    # by its package name, also when run as ``python -m`` (__main__)
    self_module = importlib.import_module(".cli", __package__)
    ctx = multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "rank0.json")
        procs = [ctx.Process(target=self_module._rank_main,
                             args=(r, world, os.path.join(tmp, "store"),
                                   tuple(analyzers), fixture, out))
                 for r in range(world)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + WORLD_DEADLINE_S
        try:
            for p in procs:
                p.join(max(0.0, deadline - time.monotonic()))
        finally:
            hung = [r for r, p in enumerate(procs) if p.is_alive()]
            for p in procs:
                if p.is_alive():
                    p.kill()
                p.join()
        codes = [p.exitcode for p in procs]
        if hung or codes != [0] * world:
            raise RuntimeError(f"the audit world of {world} failed: rank "
                               f"exit codes {codes}, killed at the "
                               f"deadline {hung}")
        with open(out, encoding="utf-8") as f:
            got = json.load(f)
    return [Finding(**x) for x in got["findings"]], got["report"]


def main(argv=None) -> int:
    args = _parse_args(argv if argv is not None else sys.argv[1:])
    if args.list_analyzers:
        for name in ANALYZERS:
            describe, incident = _DESCRIBE[name]
            print(f"{name}\n    {describe}\n    incident: {incident}")
        return 0
    analyzers = tuple(a.strip() for a in args.analyzers.split(",")) \
        if args.analyzers else ANALYZERS
    unknown = set(analyzers) - set(ANALYZERS)
    if unknown:
        print(f"ntxent-audit: unknown analyzer(s): {sorted(unknown)}",
              file=sys.stderr)
        return 2
    # Misconfiguration must be loud, not a green no-op: an EXPLICITLY
    # selected recompile-cause run with no event log audits nothing,
    # and an --events file nobody reads is the converse typo.
    if args.analyzers and "recompile-cause" in analyzers \
            and not args.events:
        print("ntxent-audit: --analyzers recompile-cause needs "
              "--events FILE (there is nothing else for it to audit)",
              file=sys.stderr)
        return 2
    if args.events and "recompile-cause" not in analyzers:
        print("ntxent-audit: --events given but the recompile-cause "
              "analyzer is not selected — the file would be ignored",
              file=sys.stderr)
        return 2
    if args.world < 1:
        print(f"ntxent-audit: --world must be >= 1, got {args.world}",
              file=sys.stderr)
        return 2

    from ..cli import default_baseline, find_root
    from ..framework import (
        compare_with_baseline,
        load_baseline,
        write_baseline,
    )

    root = os.path.abspath(args.root) if args.root else find_root()
    t0 = time.perf_counter()
    ranked = [a for a in analyzers if a != "recompile-cause"]
    findings, report = [], {}
    if ranked or args.fixture_module:
        try:
            findings, report = _run_world(args.world, ranked,
                                          args.fixture_module)
        except RuntimeError as e:
            print(f"ntxent-audit: {e}", file=sys.stderr)
            return 1
    if "recompile-cause" in analyzers and args.events:
        more, _ = run_analyzers([], ("recompile-cause",),
                                events_path=args.events,
                                churn_threshold=args.churn_threshold,
                                publish=False)
        findings = sorted(findings + more,
                          key=lambda f: (f.path, f.rule, f.snippet))
    if not args.no_publish and report.get("_remainder"):
        from .census import publish_graph_census

        rem = report["_remainder"]
        publish_graph_census(rem.get("ad_bytes", 0.0),
                             rem.get("gspmd_bytes", 0.0))

    baseline_path = args.baseline or default_baseline(root, BASELINE_NAME)
    if args.write_baseline:
        to_write = list(findings)
        if args.analyzers and os.path.isfile(baseline_path):
            # A scoped run only re-decides the SELECTED analyzers:
            # entries for every other analyzer are carried over
            # untouched (same rule as ntxent-lint's scoped
            # --write-baseline).
            from ..framework import Finding

            for (rule, rel, snippet), n in \
                    load_baseline(baseline_path).items():
                if rule not in analyzers:
                    to_write.extend(
                        Finding(rule=rule, path=rel, line=0,
                                message="(carried baseline entry)",
                                snippet=snippet)
                        for _ in range(n))
        write_baseline(baseline_path, to_write)
        print(f"ntxent-audit: baseline with {len(to_write)} finding(s) "
              f"written to {baseline_path}")
        return 0
    baseline = None
    if not args.no_baseline and os.path.isfile(baseline_path):
        baseline = load_baseline(baseline_path)
        if args.analyzers:
            baseline = type(baseline)(
                {k: v for k, v in baseline.items() if k[0] in analyzers})
    if baseline:
        new, accepted, stale = compare_with_baseline(findings, baseline)
    else:
        new, accepted, stale = list(findings), [], []
    elapsed = time.perf_counter() - t0

    if args.format == "json":
        print(json.dumps({
            "new": [vars(f) for f in new],
            "baselined": [vars(f) for f in accepted],
            "stale_baseline": [list(k) for k in stale],
            "census": report,
            "elapsed_s": round(elapsed, 3),
        }, indent=2))
    elif args.format == "github":
        from ..reporting import print_github

        print_github(new, "ntxent-audit", stale=stale)
        print(f"ntxent-audit: {len(new)} new, {len(accepted)} baselined "
              f"({elapsed:.1f}s)", file=sys.stderr)
    else:
        for f in new:
            print(f.format())
        for key in stale:
            print(f"stale baseline entry (fix landed — remove it): "
                  f"{key[0]} @ {key[1]}: {key[2]}", file=sys.stderr)
        rem = report.get("_remainder", {})
        if rem:
            print(f"ntxent-audit: graph remainder beyond declared sites: "
                  f"ad={rem.get('ad_bytes', 0.0):.1f} B, "
                  f"gspmd={rem.get('gspmd_bytes', 0.0):.1f} B "
                  f"(collective_graph_bytes_total{{source=...}})",
                  file=sys.stderr)
        print(f"ntxent-audit: {len(new)} new, {len(accepted)} baselined, "
              f"{len(stale)} stale baseline entr"
              f"{'y' if len(stale) == 1 else 'ies'} ({elapsed:.1f}s)",
              file=sys.stderr)
    return 1 if new else 0


if __name__ == "__main__":
    sys.exit(main())
