"""import-boundary: the port's two import boundaries, the counterpart of
``ntxent_tpu/analysis/imports.py``.

(a) **The port reaches no JAX.** No file of the port or of
``chip_smoke.py`` imports ``jax``, ``jaxlib``, ``flax``, ``optax``,
``chex``, the JAX package ``ntxent_tpu``, ``msgpack`` or ``ml_dtypes``,
anywhere: module scope or a function body (the card's machine has none
of them). This is the static half of
``tests/test_torch_import_boundary.py``, which must agree with it.

(b) **The router tier reaches no torch.** The fleet router, the shard
and journal processes and the observability plane restart in
milliseconds; their import surface is torch-free, held together by PEP
562 lazy package ``__init__``s. This checker walks the STATIC import
graph from the boundary roots: every module-level ``import``/``from``
(including inside class bodies and module-level ``if``/``try`` arms,
excluding function bodies and ``TYPE_CHECKING`` guards -- those don't
run at import time) is an edge; reaching ``torch`` (or a package that
loads it) is an error naming the file:line and the chain from the root.

``reachable_modules()`` is public API: the runtime tripwires of
``tests/test_torch_fleet_e2e.py`` and ``tests/test_torch_retrieval_
fleet.py`` load a subset of it, and ``tests/test_torch_lint.py`` pins
that, so the static and dynamic proofs cannot drift apart.
"""

from __future__ import annotations

import ast
import os

from .framework import (
    Checker,
    LintConfig,
    LintContext,
    SourceFile,
    iter_source_files,
)

__all__ = ["ImportBoundaryChecker", "reachable_modules",
           "module_graph"]


def _module_name(rel: str) -> str | None:
    """'ntxent_tpu_torch/serving/router.py' ->
    'ntxent_tpu_torch.serving.router'; package __init__ files name the
    package itself; loose files ('chip_smoke.py') name their stem."""
    if not rel.endswith(".py"):
        return None
    parts = rel[:-3].replace(os.sep, "/").split("/")
    if parts[-1] == "__init__":
        parts = parts[:-1]
    if not parts:
        return None
    return ".".join(parts)


def _import_time_imports(tree: ast.Module):
    """Every import statement that executes at module import time:
    module scope, class bodies, and module-level ``if``/``try``/
    ``with``/``for``/``while``/``match`` arms — NOT function bodies,
    NOT ``if TYPE_CHECKING:`` bodies."""
    out: list[ast.stmt] = []

    def is_type_checking(test: ast.AST) -> bool:
        return (isinstance(test, ast.Name)
                and test.id == "TYPE_CHECKING") or (
            isinstance(test, ast.Attribute)
            and test.attr == "TYPE_CHECKING")

    def walk(stmts) -> None:
        for stmt in stmts:
            if isinstance(stmt, (ast.Import, ast.ImportFrom)):
                out.append(stmt)
            elif isinstance(stmt, (ast.FunctionDef,
                                   ast.AsyncFunctionDef)):
                continue
            elif isinstance(stmt, ast.If):
                if not is_type_checking(stmt.test):
                    walk(stmt.body)
                walk(stmt.orelse)
            elif isinstance(stmt, ast.Try):
                walk(stmt.body)
                for handler in stmt.handlers:
                    walk(handler.body)
                walk(stmt.orelse)
                walk(stmt.finalbody)
            elif isinstance(stmt, (ast.With, ast.AsyncWith)):
                walk(stmt.body)
            elif isinstance(stmt, (ast.For, ast.AsyncFor, ast.While)):
                # Module-level loop bodies DO run at import time.
                walk(stmt.body)
                walk(stmt.orelse)
            elif isinstance(stmt, ast.ClassDef):
                walk(stmt.body)
            elif hasattr(ast, "Match") and isinstance(stmt, ast.Match):
                for case in stmt.cases:
                    walk(case.body)
    walk(tree.body)
    return out


def _resolve_deps(module: str, is_pkg: bool, node: ast.stmt,
                  known: set[str]) -> list[str]:
    """Module names a single import statement pulls in at import time.

    ``import a.b.c`` executes a, a.b AND a.b.c; ``from a.b import c``
    executes a.b, plus a.b.c when c is itself a known module file
    (otherwise it is an attribute and costs nothing extra)."""
    deps: list[str] = []

    def add_with_parents(name: str) -> None:
        parts = name.split(".")
        for i in range(1, len(parts) + 1):
            deps.append(".".join(parts[:i]))

    if isinstance(node, ast.Import):
        for alias in node.names:
            add_with_parents(alias.name)
        return deps
    assert isinstance(node, ast.ImportFrom)
    if node.level == 0:
        base = node.module or ""
    else:
        parts = module.split(".")
        if not is_pkg:
            parts = parts[:-1]
        parts = parts[:len(parts) - (node.level - 1)]
        base = ".".join(parts)
        if node.module:
            base = f"{base}.{node.module}" if base else node.module
    if base:
        add_with_parents(base)
    for alias in node.names:
        candidate = f"{base}.{alias.name}" if base else alias.name
        if candidate in known:
            add_with_parents(candidate)
    return deps


def module_graph(ctx: LintContext):
    """(modules, edges): modules maps name -> SourceFile; edges maps
    name -> list of (dep_name, import_node)."""
    modules: dict[str, SourceFile] = {}
    is_pkg: dict[str, bool] = {}
    for src in ctx.files:
        name = _module_name(src.rel)
        if name is not None:
            modules[name] = src
            is_pkg[name] = src.rel.endswith("__init__.py")
    edges: dict[str, list[tuple[str, ast.stmt]]] = {}
    known = set(modules)
    for name, src in modules.items():
        deps: list[tuple[str, ast.stmt]] = []
        for node in _import_time_imports(src.tree):
            for dep in _resolve_deps(name, is_pkg[name], node, known):
                deps.append((dep, node))
        edges[name] = deps
    return modules, edges


def _reach(roots, modules, edges):
    """BFS over in-repo modules; returns (reached set, parent map)."""
    parent: dict[str, str | None] = {}
    queue = [r for r in roots if r in modules]
    for r in queue:
        parent.setdefault(r, None)
    while queue:
        name = queue.pop(0)
        for dep, _node in edges.get(name, ()):
            if dep in modules and dep not in parent:
                parent[dep] = name
                queue.append(dep)
    return set(parent), parent


def _chain(name: str, parent: dict) -> str:
    out = [name]
    while parent.get(name) is not None:
        name = parent[name]
        out.append(name)
    return " <- ".join(out)


def reachable_modules(
    root: str | None = None,
    roots: tuple[str, ...] | None = None,
    config: LintConfig | None = None,
) -> dict[str, str]:
    """name -> repo-relative path of every module statically reachable
    from the boundary roots (the set the runtime tripwire must stay
    inside). Stdlib-only: safe to call from any test or script."""
    config = config or LintConfig()
    if root is not None:
        config.root = root
    if roots is not None:
        config.boundary_roots = tuple(roots)
    files = []
    for abs_path, rel in iter_source_files(config.root, config.targets):
        try:
            with open(abs_path, encoding="utf-8") as f:
                files.append(SourceFile(abs_path, rel, f.read()))
        except (OSError, SyntaxError, ValueError):
            continue
    ctx = LintContext(config=config, files=files)
    modules, edges = module_graph(ctx)
    reached, _ = _reach(config.boundary_roots, modules, edges)
    return {name: modules[name].rel for name in sorted(reached)}


def _package_import_findings(src: SourceFile, forbidden: set, rule: str):
    """Boundary (a): every import of a forbidden root anywhere in the
    file, function bodies included (what runs later runs on the card)."""
    for node in ast.walk(src.tree):
        if isinstance(node, ast.Import):
            names = [alias.name for alias in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        for name in names:
            if name.split(".")[0] in forbidden:
                yield src.finding(
                    rule, node,
                    f"`{name}` imported in `{src.rel}` — the port runs "
                    f"where JAX and the JAX package are absent; keep a "
                    f"copy of what it needs")


class ImportBoundaryChecker(Checker):
    rule = "import-boundary"
    describe = ("the port imports JAX or the JAX package, or a module "
                "statically reachable from the torch-free router tier "
                "imports torch at import time")
    incident = ("the JAX router tier's eager import dragged the "
                "multi-second backend init into the milliseconds-restart "
                "tier (ntxent_tpu/analysis/imports.py)")

    def check(self, src: SourceFile, ctx: LintContext):
        yield from _package_import_findings(
            src, set(ctx.config.package_forbidden), self.rule)

    def finalize(self, ctx: LintContext):
        cfg = ctx.config
        modules, edges = module_graph(ctx)
        reached, parent = _reach(cfg.boundary_roots, modules, edges)
        forbidden = set(cfg.boundary_forbidden)
        for name in sorted(reached):
            src = modules[name]
            for dep, node in edges[name]:
                if dep.split(".")[0] in forbidden and "." not in dep:
                    yield src.finding(
                        self.rule, node,
                        f"`{dep}` imported at module level in `{name}`,"
                        f" which the torch-free router tier reaches "
                        f"({_chain(name, parent)}) — defer it into the "
                        f"function that needs it")
