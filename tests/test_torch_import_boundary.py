"""The port imports neither JAX nor the JAX package.

``ntxent_tpu_torch`` and ``chip_smoke.py`` must run on a machine with no
JAX: they keep their own copies of what they need from ``ntxent_tpu``.
That machine has no ``msgpack`` (nor ``ml_dtypes``) either: the port
encodes flax's checkpoint format itself (``utils/msgpack.py``).
A fresh interpreter imports the port's entry modules and checks what got
loaded; a static scan of every source checks what could be.
"""

import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
PACKAGE = REPO / "ntxent_tpu_torch"
FORBIDDEN_ROOTS = ("jax", "jaxlib", "flax", "optax", "ntxent_tpu",
                   "msgpack", "ml_dtypes")


def _forbidden(module: str) -> bool:
    """True for jax/flax/... and ntxent_tpu or ntxent_tpu.*, but not for
    ntxent_tpu_torch, which shares the prefix."""
    root = module.split(".")[0]
    return root in FORBIDDEN_ROOTS


def test_prefix_rule():
    assert _forbidden("ntxent_tpu") and _forbidden("ntxent_tpu.serving")
    assert _forbidden("jax.numpy") and _forbidden("flax.linen")
    assert _forbidden("msgpack") and _forbidden("msgpack.fallback")
    assert not _forbidden("ntxent_tpu_torch")
    assert not _forbidden("ntxent_tpu_torch.utils.msgpack")
    assert not _forbidden("ntxent_tpu_torch.serving.engine")


def _modules():
    """Every module of the port, by dotted name."""
    for path in sorted(PACKAGE.rglob("*.py")):
        parts = path.relative_to(REPO).with_suffix("").parts
        yield ".".join(parts[:-1] if parts[-1] == "__init__" else parts)


def test_importing_the_port_loads_no_jax():
    code = (
        "import importlib, json, sys\n"
        f"for name in {sorted(_modules())!r}:\n"
        "    importlib.import_module(name)\n"
        "print(json.dumps(sorted(sys.modules)))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(REPO)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120,
                         check=True).stdout
    loaded = json.loads(out.strip().splitlines()[-1])
    assert set(_modules()) <= set(loaded)
    assert [m for m in loaded if _forbidden(m)] == []


def _sources():
    yield from sorted(PACKAGE.rglob("*.py"))
    yield REPO / "chip_smoke.py"


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.lineno, node.module or ""


@pytest.mark.parametrize("path", list(_sources()),
                         ids=lambda p: str(p.relative_to(REPO)))
def test_no_source_imports_jax_or_the_jax_package(path):
    bad = [f"{path.name}:{line} imports {mod}"
           for line, mod in _imports(path) if _forbidden(mod)]
    assert bad == []


def test_scan_sees_every_module():
    names = {p.relative_to(PACKAGE).as_posix() for p in PACKAGE.rglob("*.py")}
    assert {"cli.py", "weights.py", "api.py", "ops/attention.py",
            "ops/ntxent.py", "ops/oracle.py", "ops/infonce.py",
            "models/clip.py", "training/adamw.py", "serving/server.py",
            "models/vit.py", "models/projection.py", "training/lars.py",
            "training/augment.py", "training/datasets.py",
            "training/trainer.py", "utils/profiling.py", "models/resnet.py",
            "parallel/__init__.py", "parallel/mesh.py",
            "parallel/dist_loss.py", "parallel/pair.py",
            "parallel/ring_attention.py", "parallel/ring.py",
            "models/long_context.py", "models/layers.py",
            "training/checkpoint.py", "training/preemption.py",
            "utils/msgpack.py", "parallel/precision.py",
            "ops/autotune.py", "parallel/moe.py", "parallel/tp.py",
            "parallel/fsdp.py", "parallel/pp.py",
            "parallel/shards.py", "fleet_cli.py", "cli_common.py",
            "serving/router.py", "serving/fleet.py", "serving/cache.py",
            "serving/shadow.py", "serving/autoscale.py",
            "obs/aggregate.py", "obs/slo.py", "obs/history.py",
            "retrieval/__init__.py", "retrieval/segments.py",
            "retrieval/ivf.py", "retrieval/pq.py", "retrieval/scan.py",
            "retrieval/index.py", "retrieval/versioned.py",
            "retrieval/journal.py", "retrieval/shard.py",
            "analysis/__init__.py", "analysis/framework.py",
            "analysis/reporting.py", "analysis/collectives.py",
            "analysis/hostsync.py", "analysis/locks.py",
            "analysis/imports.py", "analysis/telemetry.py",
            "analysis/cli.py", "analysis/graph/__init__.py",
            "analysis/graph/census.py", "analysis/graph/wiredtype.py",
            "analysis/graph/donation.py", "analysis/graph/recompile.py",
            "analysis/graph/targets.py", "analysis/graph/cli.py"} <= names


def test_the_scan_agrees_with_the_lint_checker():
    """This file's AST scan and the port's ``import-boundary`` checker
    (``analysis.imports``) see the same tree: the static graph knows every
    module the scan names (``reachable_modules`` from all of them is all
    of them), and the checker's half (a), JAX or the JAX package imported
    anywhere, flags what the scan flags: nothing."""
    from ntxent_tpu_torch.analysis import (
        LintConfig,
        reachable_modules,
        run_lint,
    )

    names = sorted(_modules())
    assert sorted(reachable_modules(root=str(REPO),
                                    roots=tuple(names))) == names
    scanned = [(path, line) for path in _sources()
               for line, mod in _imports(path) if _forbidden(mod)]
    found = run_lint(LintConfig(root=str(REPO)),
                     rules=("import-boundary",)).findings
    assert scanned == [] and found == []


@pytest.mark.parametrize("module", ["ntxent_tpu_torch.parallel.precision",
                                    "ntxent_tpu_torch.ops.autotune"])
def test_the_wire_modules_import_alone_without_jax(module):
    """The wire policy and the ring-chunk autotune keep their own copies of
    ``ntxent_tpu/parallel/precision.py`` and the ring-chunk half of
    ``ntxent_tpu/ops/autotune.py``: a fresh interpreter imports each and
    loads nothing of JAX or the JAX package."""
    code = (f"import json, sys, {module}\n"
            "print(json.dumps(sorted(sys.modules)))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(REPO)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120,
                         check=True).stdout
    loaded = json.loads(out.strip().splitlines()[-1])
    assert module in loaded
    assert [m for m in loaded if _forbidden(m)] == []
