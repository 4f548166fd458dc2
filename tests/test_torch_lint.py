"""The port's ``ntxent-lint`` (``ntxent_tpu_torch/analysis``): the five
checkers in torch spellings, the suppression and baseline mechanics, the
CLI, the port's tree held clean, and parity with the JAX package's lint
on the same inputs.

Fixture trees are written to ``tmp_path`` in the port's layout
(``ntxent_tpu_torch/...``), so the default ``LintConfig`` runs against
them unchanged: one violation per rule (a raw ``dist.all_reduce``, an
``.item()`` of a state tensor in ``train_loop``'s loop, a sleep under a
serving lock, ``import torch`` on the router chain and ``import jax`` in
the port, a typo'd event type with an illegal metric name and an
unreviewed label key).
"""

import ast
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

from ntxent_tpu_torch.analysis import (
    LintConfig,
    compare_with_baseline,
    load_baseline,
    reachable_modules,
    run_lint,
    write_baseline,
)
from ntxent_tpu_torch.analysis.cli import BASELINE_NAME, main as lint_main
from ntxent_tpu_torch.analysis.framework import Finding, SourceFile
from ntxent_tpu_torch.analysis.reporting import github_annotations

pytestmark = pytest.mark.lint

REPO = Path(__file__).resolve().parents[1]
ALL_RULES = {"collective-shim", "host-sync", "lock-discipline",
             "import-boundary", "telemetry-schema"}

EVENTS = '''
EVENT_TYPES = ("step", "compile", "checkpoint")
'''

TREE = {
    "ntxent_tpu_torch/__init__.py": "",
    "ntxent_tpu_torch/obs/__init__.py": "",
    "ntxent_tpu_torch/obs/events.py": EVENTS,
    "ntxent_tpu_torch/parallel/__init__.py": "",
    "ntxent_tpu_torch/parallel/mesh.py": '''
        import torch.distributed as dist

        def psum(x):
            dist.all_reduce(x)  # the shim file may
            return x
        ''',
    "ntxent_tpu_torch/training/__init__.py": "",
    "ntxent_tpu_torch/training/loop.py": '''
        import torch
        import torch.distributed as dist

        def train_loop(state, batches):
            for v1, v2 in batches:
                dist.all_reduce(v1)
                loss = state.model(v1).sum().item()
                n = int(state.step)  # a host int in the port
            return loss
        ''',
    "ntxent_tpu_torch/serving/__init__.py": "",
    "ntxent_tpu_torch/serving/cache.py": '''
        import threading
        import time

        class Cache:
            def __init__(self):
                self._lock = threading.Lock()

            def get(self):
                with self._lock:
                    time.sleep(0.1)
        ''',
    "ntxent_tpu_torch/serving/router.py": '''
        import torch
        from . import cache
        ''',
    "ntxent_tpu_torch/ops/__init__.py": "",
    "ntxent_tpu_torch/ops/kernel.py": '''
        def build():
            import jax  # even lazily: the card has none
            return jax
        ''',
    "ntxent_tpu_torch/obs/metrics.py": '''
        from . import events

        def publish(registry):
            events.emit("divergnce", step=1)
            registry.counter("bad-name", "help")
            registry.gauge("ok_name", "help", labels={"user": "u"})
        ''',
}


def _write(root: Path, files: dict) -> Path:
    for rel, text in files.items():
        path = root / rel
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(textwrap.dedent(text))
    return root


def _lint(root: Path, rules=None):
    return run_lint(LintConfig(root=str(root)), rules=rules)


@pytest.fixture
def tree(tmp_path):
    return _write(tmp_path / "tree", TREE)


# ---------------------------------------------------------------------------
# each rule fires


class TestRulesFire:
    def test_every_rule_fires_on_the_fixture_tree(self, tree):
        result = _lint(tree)
        assert not result.parse_errors
        assert {f.rule for f in result.findings} == ALL_RULES
        assert not result.suppressed

    def test_collective_shim_spares_the_shim_file(self, tree):
        found = _lint(tree, ("collective-shim",)).findings
        assert [(f.path, f.line) for f in found] == [
            ("ntxent_tpu_torch/training/loop.py", 7)]
        assert "dist.all_reduce" in found[0].message

    def test_collective_shim_sees_through_aliases(self, tmp_path):
        root = _write(tmp_path, {"ntxent_tpu_torch/a.py": '''
            import torch
            import torch as th
            import torch.distributed as d
            from torch import distributed as td
            from torch.distributed import all_gather as ag, new_group

            def f(x, parts, dist):
                torch.distributed.broadcast(x, 0)
                th.distributed.barrier()
                d.all_to_all_single(x, x)
                td.reduce_scatter_tensor(x, x)
                ag(parts, x)
                new_group([0])           # not a collective
                dist.gather(0, x)        # a tensor named dist
                x.scatter(0, x, x)       # a tensor method
            '''})
        found = _lint(root, ("collective-shim",)).findings
        assert [f.line for f in found] == [6, 9, 10, 11, 12, 13]

    def test_host_sync_flags_only_step_state_in_the_loop(self, tree):
        found = _lint(tree, ("host-sync",)).findings
        assert [(f.path, f.line) for f in found] == [
            ("ntxent_tpu_torch/training/loop.py", 8)]

    def test_host_sync_spellings(self, tmp_path):
        root = _write(tmp_path, {"ntxent_tpu_torch/t.py": '''
            import torch

            def fit(state, metrics, steps):
                torch.cuda.synchronize()          # outside the loop
                for _ in range(steps):
                    state.optimizer.lr.item()
                    float(state.ef_residual[0].sum())
                    bool(state.kept.ok)
                    state.model.weight.cpu()
                    state.model.weight.numpy()
                    state.model.weight.tolist()
                    torch.cuda.synchronize()
                    float(metrics["loss"])         # drained to the host
                    int(state.step)                # a host int

                    def later():
                        state.model.weight.item()  # a callback's own

            def step_hook(state):
                while True:
                    state.model.w.item()

            def helper(state):
                for _ in range(2):
                    state.model.w.item()           # not a hot function
            '''})
        found = _lint(root, ("host-sync",)).findings
        assert [f.line for f in found] == [7, 8, 9, 10, 11, 12, 13, 22]

    def test_lock_discipline_flags_sleep_under_the_serving_lock(self, tree):
        found = _lint(tree, ("lock-discipline",)).findings
        assert [(f.path, f.line) for f in found] == [
            ("ntxent_tpu_torch/serving/cache.py", 11)]

    def test_import_boundary_both_halves(self, tree):
        found = _lint(tree, ("import-boundary",)).findings
        by_path = {f.path: f for f in found}
        assert sorted(by_path) == ["ntxent_tpu_torch/ops/kernel.py",
                                   "ntxent_tpu_torch/serving/router.py"]
        assert "`jax` imported" in by_path[
            "ntxent_tpu_torch/ops/kernel.py"].message
        router = by_path["ntxent_tpu_torch/serving/router.py"].message
        assert "`torch` imported at module level" in router
        assert "ntxent_tpu_torch.serving.router" in router

    def test_import_boundary_defers_are_legal(self, tmp_path):
        root = _write(tmp_path, {
            "ntxent_tpu_torch/__init__.py": "",
            "ntxent_tpu_torch/obs/__init__.py": '''
                from typing import TYPE_CHECKING
                if TYPE_CHECKING:
                    import torch

                def lazy():
                    import torch
                    return torch
                ''',
            "ntxent_tpu_torch/model.py": "import torch\n",
            "ntxent_tpu_torch/x.py": '''
                import ntxent_tpu_torch.model
                from ntxent_tpu.serving import router
                ''',
        })
        found = _lint(root, ("import-boundary",)).findings
        # the router tier never reaches model.py; x.py imports the JAX
        # package (boundary a)
        assert [(f.path, f.line) for f in found] == [
            ("ntxent_tpu_torch/x.py", 3)]

    def test_telemetry_schema_flags_type_name_and_label(self, tree):
        found = _lint(tree, ("telemetry-schema",)).findings
        messages = " ".join(f.message for f in found)
        assert len(found) == 3
        assert "'divergnce'" in messages and "'bad-name'" in messages \
            and "'user'" in messages


# ---------------------------------------------------------------------------
# suppression


class TestSuppression:
    def test_lint_ok_suppresses_and_the_wrong_rule_does_not(self, tmp_path):
        root = _write(tmp_path, {"ntxent_tpu_torch/a.py": '''
            import torch.distributed as dist

            def f(x):
                # ntxent: lint-ok[collective-shim] control plane
                dist.barrier()
                dist.broadcast(x, 0)  # ntxent: lint-ok[collective-shim] flag
                # ntxent: lint-ok[host-sync] the wrong rule
                dist.all_reduce(x)
            '''})
        result = _lint(root)
        assert [f.line for f in result.suppressed] == [6, 7]
        assert [f.line for f in result.findings] == [9]


# ---------------------------------------------------------------------------
# baseline


def _finding(line=1, snippet="dist.barrier()", rule="collective-shim"):
    return Finding(rule=rule, path="ntxent_tpu_torch/a.py", line=line,
                   message="m", snippet=snippet)


class TestBaseline:
    def test_new_accepted_and_stale(self, tmp_path):
        path = tmp_path / "b.json"
        write_baseline(str(path), [_finding(), _finding(2, "gone()")])
        baseline = load_baseline(str(path))
        new, accepted, stale = compare_with_baseline(
            [_finding(5), _finding(6), _finding(7, "x()")], baseline)
        assert [f.line for f in accepted] == [5]
        assert [f.line for f in new] == [6, 7]
        assert stale == [("collective-shim", "ntxent_tpu_torch/a.py",
                          "gone()")]

    def test_write_baseline_keeps_written_reasons(self, tmp_path):
        path = tmp_path / "b.json"
        write_baseline(str(path), [_finding()])
        data = json.loads(path.read_text())
        assert data["findings"][0]["reason"].startswith("TODO")
        data["findings"][0]["reason"] = "a save's gather"
        path.write_text(json.dumps(data))
        write_baseline(str(path), [_finding(), _finding(3, "y()")])
        reasons = {e["snippet"]: e["reason"]
                   for e in json.loads(path.read_text())["findings"]}
        assert reasons["dist.barrier()"] == "a save's gather"
        assert reasons["y()"].startswith("TODO")

    def test_cli_exit_codes(self, tree, tmp_path, capsys):
        base = tmp_path / "b.json"
        assert lint_main(["--root", str(tree), "--no-baseline"]) == 1
        assert lint_main(["--root", str(tree), "--rules", "nope"]) == 2
        assert lint_main(["--root", str(tree), "--baseline", str(base),
                          "--write-baseline"]) == 0
        assert lint_main(["--root", str(tree), "--baseline",
                          str(base)]) == 0
        (tree / "ntxent_tpu_torch/training/loop.py").write_text(
            "def f():\n    pass\n")
        capsys.readouterr()
        assert lint_main(["--root", str(tree), "--baseline",
                          str(base)]) == 0
        assert "stale baseline entr" in capsys.readouterr().err
        with pytest.raises(SystemExit) as e:
            lint_main(["--format", "yaml"])
        assert e.value.code == 2

    def test_cli_default_baseline_is_the_ports(self, tree, capsys):
        path = tree / "ntxent_tpu_torch/analysis" / BASELINE_NAME
        path.parent.mkdir()
        assert lint_main(["--root", str(tree), "--write-baseline"]) == 0
        assert path.is_file() and not (tree / BASELINE_NAME).exists()
        assert lint_main(["--root", str(tree)]) == 0

    def test_scoped_write_baseline_keeps_other_rules(self, tree, tmp_path):
        base = tmp_path / "b.json"
        assert lint_main(["--root", str(tree), "--baseline", str(base),
                          "--write-baseline"]) == 0
        before = load_baseline(str(base))
        assert lint_main(["--root", str(tree), "--baseline", str(base),
                          "--rules", "host-sync", "--write-baseline"]) == 0
        assert load_baseline(str(base)) == before
        assert lint_main(["--root", str(tree), "--baseline", str(base),
                          "--rules", "host-sync"]) == 0

    def test_json_and_github_formats(self, tree, capsys):
        assert lint_main(["--root", str(tree), "--no-baseline", "--format",
                          "json"]) == 1
        out = json.loads(capsys.readouterr().out)
        assert {f["rule"] for f in out["new"]} == ALL_RULES
        assert lint_main(["--root", str(tree), "--no-baseline", "--format",
                          "github"]) == 1
        lines = capsys.readouterr().out.splitlines()
        assert lines and all(ln.startswith("::error file=") for ln in lines)

    def test_list_rules_and_boundary_modules(self, capsys):
        assert lint_main(["--list-rules"]) == 0
        listed = capsys.readouterr().out
        assert all(rule in listed for rule in ALL_RULES)
        assert lint_main(["--root", str(REPO), "--boundary-modules"]) == 0
        mods = capsys.readouterr().out
        assert "ntxent_tpu_torch.serving.router" in mods
        assert "ntxent_tpu_torch.ops.ntxent" not in mods


# ---------------------------------------------------------------------------
# the port's own tree


class TestPortClean:
    def test_the_port_has_no_new_findings_against_its_baseline(self):
        assert lint_main(["--root", str(REPO)]) == 0

    def test_every_raw_collective_carries_a_reason(self):
        result = run_lint(LintConfig(root=str(REPO)),
                          rules=("collective-shim",))
        assert result.findings == []
        assert len(result.suppressed) == 7
        for f in result.suppressed:
            src = (REPO / f.path).read_text().splitlines()
            above = src[f.line - 2]
            assert "lint-ok[collective-shim]" in above
            assert above.split("]", 1)[1].strip()  # a reason follows

    def test_the_committed_lint_baseline_is_empty(self):
        data = json.loads((REPO / "ntxent_tpu_torch/analysis" /
                           BASELINE_NAME).read_text())
        assert data == {"version": 1, "findings": []}

    def test_a_lint_process_loads_no_torch_numpy_or_jax(self):
        code = ("import json, sys\n"
                "from ntxent_tpu_torch.analysis.cli import main\n"
                f"rc = main(['--root', {str(REPO)!r}])\n"
                "print(json.dumps([rc, sorted(m for m in sys.modules if "
                "m.split('.')[0] in ('torch', 'numpy', 'jax'))]))\n")
        env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
        env["PYTHONPATH"] = str(REPO)
        out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                             env=env, capture_output=True, text=True,
                             timeout=120, check=True).stdout
        rc, loaded = json.loads(out.strip().splitlines()[-1])
        assert (rc, loaded) == (0, [])

    def test_static_event_types_equal_the_runtime_ones(self):
        from ntxent_tpu_torch.analysis.telemetry import (
            _extract_event_types,
        )
        from ntxent_tpu_torch.obs.events import EVENT_TYPES

        path = REPO / "ntxent_tpu_torch/obs/events.py"
        src = SourceFile(str(path), "ntxent_tpu_torch/obs/events.py",
                         path.read_text())
        assert _extract_event_types(src) == EVENT_TYPES

    def test_the_metric_name_rule_matches_the_registry(self):
        from ntxent_tpu_torch.analysis import telemetry
        from ntxent_tpu_torch.obs import registry

        assert telemetry._NAME_OK.pattern == registry._NAME_OK.pattern

    def test_reachable_modules_hold_what_the_router_loads(self):
        """The runtime tripwire's imports (``test_torch_fleet_e2e``'s
        router tier and the lazy exports it resolves) load only modules
        the static graph reaches from the boundary roots."""
        from test_torch_fleet_e2e import ROUTER_TIER

        code = (
            "import importlib, json, sys\n"
            f"for name in {ROUTER_TIER!r}:\n"
            "    importlib.import_module(name)\n"
            "from ntxent_tpu_torch.serving import FleetRouter, ServingFleet\n"
            "from ntxent_tpu_torch.obs import MetricHistory, SLOEngine\n"
            "from ntxent_tpu_torch.resilience import FaultInjector\n"
            "import ntxent_tpu_torch.retrieval.shard\n"
            "import ntxent_tpu_torch.analysis\n"
            "print(json.dumps(sorted(m for m in sys.modules\n"
            "    if m.startswith('ntxent_tpu_torch'))))\n")
        env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
        env["PYTHONPATH"] = str(REPO)
        out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                             env=env, capture_output=True, text=True,
                             timeout=120, check=True).stdout
        loaded = set(json.loads(out.strip().splitlines()[-1]))
        reached = set(reachable_modules(root=str(REPO)))
        assert set(ROUTER_TIER) <= loaded
        assert loaded <= reached, sorted(loaded - reached)
        assert "ntxent_tpu_torch.analysis.framework" in reached
        assert not any(m.startswith("ntxent_tpu_torch.ops.")
                       for m in reached)


# ---------------------------------------------------------------------------
# parity with the JAX package's lint on the same inputs


def test_compare_with_baseline_equals_jax():
    from collections import Counter

    from ntxent_tpu.analysis import framework as jframework

    findings = [_finding(1), _finding(2), _finding(3, "x()")]
    baseline = Counter({("collective-shim", "ntxent_tpu_torch/a.py",
                         "dist.barrier()"): 1,
                        ("host-sync", "b.py", "y()"): 2})
    jfindings = [jframework.Finding(**vars(f)) for f in findings]
    got = compare_with_baseline(findings, baseline)
    want = jframework.compare_with_baseline(jfindings, baseline)
    assert [vars(f) for f in got[0]] == [vars(f) for f in want[0]]
    assert [vars(f) for f in got[1]] == [vars(f) for f in want[1]]
    assert got[2] == want[2]


def test_github_annotations_equal_jax():
    from ntxent_tpu.analysis.reporting import (
        github_annotations as jax_annotations,
    )

    findings = [Finding("collective-shim", "a,b.py", 3, "50% of\nit: x"),
                Finding("wire-dtype", "graph://t", 0, "leak")]
    stale = [("host-sync", "c.py", "int(x)")]
    parse = [("d.py", "bad: 1%")]
    assert github_annotations(findings, "ntxent-lint", stale, parse) == \
        jax_annotations(findings, "ntxent-lint", stale, parse)


LOCKS_AND_TELEMETRY = '''
import signal
import threading
import time

from . import events

_lock = threading.Lock()


def handler(signum, frame):
    with _lock:
        pass


signal.signal(signal.SIGTERM, handler)


class Server:
    def __init__(self):
        self._lock = threading.RLock()
        self.clock = 0

    def serve(self, registry):
        r = registry
        with self._lock:
            time.sleep(1)
            open("x")
            ",".join(["a"])
            self.thread.join(5)
        with self.clock:
            time.sleep(1)
        events.emit("stepp")
        r.counter("ok_total", "h", labels={"bucket": "1", "who": "x"})
        r.histogram("lat ms", "h")
'''


@pytest.mark.parametrize("rule", ["lock-discipline", "telemetry-schema"])
def test_lock_and_telemetry_checkers_equal_jax(rule, tmp_path):
    """One fixture text under each package's serving scope: the same
    findings, line for line (the paths differ by the package name)."""
    from ntxent_tpu.analysis import LintConfig as JaxConfig
    from ntxent_tpu.analysis import run_lint as jax_lint

    for pkg in ("ntxent_tpu", "ntxent_tpu_torch"):
        _write(tmp_path, {f"{pkg}/serving/server.py": LOCKS_AND_TELEMETRY,
                          f"{pkg}/obs/events.py": EVENTS})
    port = run_lint(LintConfig(root=str(tmp_path),
                               targets=("ntxent_tpu_torch",)), (rule,))
    ref = jax_lint(JaxConfig(root=str(tmp_path), targets=("ntxent_tpu",)),
                   (rule,))

    def key(result, pkg):
        return [(f.rule, f.path.replace(pkg, "PKG"), f.line, f.message,
                 f.snippet) for f in result.findings]

    assert key(port, "ntxent_tpu_torch") == key(ref, "ntxent_tpu")
    assert port.findings


def test_the_import_test_scan_agrees_with_the_checker(tmp_path):
    """``tests/test_torch_import_boundary.py``'s AST scan and the
    checker's boundary (a) flag the same lines of one doctored file."""
    from test_torch_import_boundary import _forbidden, _imports

    text = textwrap.dedent('''
        import os
        import jax.numpy as jnp
        from ntxent_tpu.serving import router
        from ntxent_tpu_torch import obs

        def f():
            import msgpack
            from flax import linen
        ''')
    path = _write(tmp_path, {"ntxent_tpu_torch/a.py": text}) \
        / "ntxent_tpu_torch/a.py"
    scan = sorted(line for line, mod in _imports(path) if _forbidden(mod))
    found = _lint(tmp_path, ("import-boundary",)).findings
    assert [f.line for f in found] == scan == [3, 4, 8, 9]
    assert ast.parse(text)  # the text is valid Python
