"""The port's public names against the JAX package's, by AST (no module
of either package is imported to read them).

For every module of ``ntxent_tpu`` with a literal ``__all__``, each name
must be in the port's module of the same path (its literal ``__all__``,
or the ``_EXPORTS`` table of a lazy package ``__init__``), or in
``ntxent_tpu_torch.surface.UNPORTED``, the list of names left out by
decision; a module missing from the port must be listed whole. The list
holds no stale entry (a name the port now has, or JAX no longer has),
and README.md's port section names every entry. The names the package
surface gained (Queue A (a)) import from the port's packages.
"""

import ast
import importlib
from pathlib import Path

import pytest

from ntxent_tpu_torch.surface import UNPORTED, unported_names

REPO = Path(__file__).resolve().parents[1]
JAX_ROOT, PORT_ROOT = REPO / "ntxent_tpu", REPO / "ntxent_tpu_torch"


def _literal(path: Path, target: str):
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, ast.Assign) and any(
                isinstance(t, ast.Name) and t.id == target
                for t in node.targets):
            try:
                return ast.literal_eval(node.value)
            except ValueError:
                return None
    return None


def _public(path: Path) -> set[str] | None:
    names = _literal(path, "__all__")
    exports = _literal(path, "_EXPORTS")
    if names is None and exports is None:
        return None
    return set(names or ()) | set(exports or ())


def _module(rel: Path) -> str:
    parts = list(rel.with_suffix("").parts)
    if parts[-1] == "__init__":
        parts.pop()
    return ".".join(parts)


def _jax_modules():
    for path in sorted(JAX_ROOT.rglob("*.py")):
        names = _literal(path, "__all__")
        if names is not None:
            yield path.relative_to(JAX_ROOT), set(names)


def _missing() -> set[str]:
    out = set()
    for rel, names in _jax_modules():
        module = _module(rel)
        port = PORT_ROOT / rel
        if not port.exists():
            out.add(module)
            continue
        out |= {f"{module}:{n}" for n in names - (_public(port) or set())}
    return out


def test_every_jax_name_is_ported_or_decided():
    undecided = _missing() - unported_names()
    assert not undecided, (
        f"JAX names missing from the port and from "
        f"ntxent_tpu_torch.surface.UNPORTED: {sorted(undecided)}")


def test_the_decision_list_holds_no_stale_entry():
    assert not unported_names() - _missing()


def test_the_decisions_are_grouped_once():
    entries = [n for names in UNPORTED.values() for n in names]
    assert len(entries) == len(set(entries))


def test_readme_lists_every_decision():
    readme = (REPO / "README.md").read_text()
    section = readme[readme.index("### Names unported by decision"):]
    for reason, names in UNPORTED.items():
        assert reason in section, reason
        for name in names:
            assert f"`{name}`" in section, name


@pytest.mark.parametrize("module,name", [
    ("ntxent_tpu_torch.parallel", "info_nce_loss_distributed"),
    ("ntxent_tpu_torch.training", "estimate_mfu"),
    ("ntxent_tpu_torch.utils", "DeviceMemoryTracker"),
    ("ntxent_tpu_torch.utils", "device_memory_mb"),
    ("ntxent_tpu_torch.utils", "setup_logging"),
    ("ntxent_tpu_torch.serving.metrics", "LatencyWindow"),
    ("ntxent_tpu_torch.resilience", "Supervisor"),
    ("ntxent_tpu_torch.resilience.crashsim", "restore_reshards_from_jsonl"),
])
def test_the_surface_names_import(module, name):
    assert callable(getattr(importlib.import_module(module), name))


def test_latency_window_snapshot_is_the_serving_shape():
    """JAX's ``LatencyWindow.snapshot`` recurses through ``snapshot_ms``;
    the port's gives the serving wire shape JAX's docstring names."""
    from ntxent_tpu_torch.serving.metrics import LatencyWindow

    window = LatencyWindow(window=4)
    for ms in (1.0, 3.0):
        window.observe(ms)
    snap = window.snapshot()
    assert snap == window.snapshot_ms()
    assert snap["count"] == 2 and snap["mean_ms"] == 2.0
    assert snap["max_ms"] == 3.0 and snap["window"] == 2
    assert window.total_ms == 4.0


def test_info_nce_loss_distributed_is_the_sharded_infonce(tmp_path):
    """The one-shot form equals ``make_sharded_infonce`` at ``1 / T`` and
    at an explicit scale, in a gloo world of one."""
    import numpy as np
    import torch

    from ntxent_tpu_torch.parallel import (
        info_nce_loss_distributed,
        make_sharded_infonce,
        mesh,
    )

    rng = np.random.default_rng(0)
    za, zb = (torch.from_numpy(rng.normal(size=(8, 16)).astype(np.float32))
              for _ in range(2))
    mesh.init_from_file(str(tmp_path / "store"), 0, 1, device="cpu")
    try:
        got = info_nce_loss_distributed(za, zb, temperature=0.1)
        want = make_sharded_infonce()(za, zb, torch.tensor(
            np.float32(1.0 / 0.1)))
        assert torch.equal(got, want)
        scaled = info_nce_loss_distributed(za, zb, scale=5.0)
        assert torch.equal(scaled, make_sharded_infonce()(
            za, zb, torch.tensor(5.0)))
    finally:
        mesh.shutdown()
