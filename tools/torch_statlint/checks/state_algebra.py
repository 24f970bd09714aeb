"""Check: the state-merge algebra.

Persisted analyzer states are mergeable BY CONSTRUCTION — that is what
makes incremental verification, mesh salvage and cross-session coalescing
correct. Two machine-checked halves:

1. every ``*State`` class must implement (or visibly inherit) ``merge``;
2. the identity-merge-transparency registry
   (``IDENTITY_TRANSPARENT_STATES``) may only name classes that exist in
   its module and that themselves define both ``init`` and ``merge`` —
   a stale registry entry would silently route a non-transparent state
   onto the host fast path, the exact class of bit-drift the registry
   exists to prevent.

A package scan whose ``analyzers/states.py`` does not hold the registry
reports that instead of passing.
"""

from __future__ import annotations

import ast
from typing import List

from ..core import Finding, ModuleIndex, find_assign, pkg, unresolved

CHECK = "state-algebra"

REGISTRY_NAME = "IDENTITY_TRANSPARENT_STATES"

STATES = pkg("analyzers/states.py")


def _method_names(cls: ast.ClassDef) -> set:
    return {
        n.name for n in cls.body
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))
    }


def run(index: ModuleIndex) -> List[Finding]:
    findings: List[Finding] = []
    if index.narrow:
        states = index.get(STATES)
        if states is None or find_assign(states, REGISTRY_NAME) is None:
            findings.append(unresolved(
                CHECK, STATES, f"registry {STATES}:{REGISTRY_NAME}"
            ))
    classes_by_module = {}
    for module in index.modules:
        classes = {
            node.name: node
            for node in ast.walk(module.tree)
            if isinstance(node, ast.ClassDef)
        }
        classes_by_module[module.relpath] = classes
        for name, cls in sorted(classes.items()):
            if not name.endswith("State"):
                continue
            if "merge" in _method_names(cls):
                continue
            # a base class within the same module may provide merge
            base_names = [
                b.id for b in cls.bases if isinstance(b, ast.Name)
            ]
            if any(
                base in classes and "merge" in _method_names(classes[base])
                for base in base_names
            ):
                continue
            if base_names and not all(b in classes for b in base_names):
                continue  # inherits from outside the module: not provable
            findings.append(Finding(
                check=CHECK, path=module.relpath, line=cls.lineno,
                message=(
                    f"state class {name} has no merge() — every *State "
                    "must be a semigroup (mergeable by construction)"
                ),
                key=f"no-merge:{name}",
            ))
    # registry entries must name real, fully-algebraic classes
    for module in index.modules:
        classes = classes_by_module[module.relpath]
        for node in ast.walk(module.tree):
            if not (
                isinstance(node, ast.Assign)
                and len(node.targets) == 1
                and isinstance(node.targets[0], ast.Name)
                and node.targets[0].id == REGISTRY_NAME
            ):
                continue
            for name_node in ast.walk(node.value):
                if not isinstance(name_node, ast.Name):
                    continue
                if name_node.id in ("frozenset", "set", REGISTRY_NAME):
                    continue
                cls = classes.get(name_node.id)
                if cls is None:
                    findings.append(Finding(
                        check=CHECK, path=module.relpath,
                        line=name_node.lineno,
                        message=(
                            f"{REGISTRY_NAME} names {name_node.id}, which "
                            "is not a class defined in this module"
                        ),
                        key=f"registry-unknown:{name_node.id}",
                    ))
                    continue
                missing = {"init", "merge"} - _method_names(cls)
                if missing:
                    findings.append(Finding(
                        check=CHECK, path=module.relpath,
                        line=name_node.lineno,
                        message=(
                            f"{REGISTRY_NAME} entry {name_node.id} lacks "
                            f"{sorted(missing)} — transparency claims "
                            "require the full init/merge algebra"
                        ),
                        key=f"registry-incomplete:{name_node.id}",
                    ))
    return findings
