"""Check: dead imports.

Unused imports in the concurrency-critical trees (``service/``,
``parallel/``) are not just lint: they widen the import graph the lock
and purity checks must reason about, and they rot into false "this module
depends on X" signals for readers. Scope is deliberately narrow on a
package scan; explicit file scans (fixtures) check everything they are
given. A package scan that holds no module of the scope reports that
instead of passing. ``# noqa`` on the import line and names listed in
``__all__`` are honored (the config-style re-export idiom).
"""

from __future__ import annotations

import ast
from typing import List, Set

from ..core import Finding, Module, ModuleIndex, pkg, unresolved

CHECK = "dead-import"

SCOPES = (pkg("service/"), pkg("parallel/"))


def _used_names(module: Module) -> Set[str]:
    used: Set[str] = set()
    for node in ast.walk(module.tree):
        if isinstance(node, ast.Name):
            used.add(node.id)
        elif isinstance(node, ast.Assign):
            targets = [
                t.id for t in node.targets if isinstance(t, ast.Name)
            ]
            if "__all__" in targets:
                for const in ast.walk(node.value):
                    if isinstance(const, ast.Constant) and isinstance(
                        const.value, str
                    ):
                        used.add(const.value)
    return used


def run(index: ModuleIndex) -> List[Finding]:
    findings: List[Finding] = []
    scanned = [
        m for m in index.modules
        if not index.narrow or any(s in m.relpath for s in SCOPES)
    ]
    if index.narrow:
        for scope in SCOPES:
            if not any(scope in m.relpath for m in scanned):
                findings.append(unresolved(CHECK, scope, f"scope {scope}"))
    for module in scanned:
        used = _used_names(module)
        for node in ast.walk(module.tree):
            if isinstance(node, ast.Import):
                bindings = [
                    (alias.asname or alias.name.split(".")[0], alias.name)
                    for alias in node.names
                ]
            elif isinstance(node, ast.ImportFrom):
                if node.module == "__future__":
                    continue
                bindings = [
                    (alias.asname or alias.name, alias.name)
                    for alias in node.names
                    if alias.name != "*"
                ]
            else:
                continue
            if module.line_has_noqa(node):
                continue
            for bound, _original in bindings:
                if bound not in used:
                    findings.append(Finding(
                        check=CHECK, path=module.relpath, line=node.lineno,
                        message=(
                            f"imported name {bound!r} is never used "
                            "(delete it, or `# noqa` a deliberate "
                            "re-export)"
                        ),
                        key=f"{bound}",
                    ))
    return findings
