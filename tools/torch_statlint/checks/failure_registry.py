"""Check: the typed-failure and fault-site registries.

The reliability story rests on two registries staying exhaustive:

1. **Typed exceptions.** Every exception class defined in the package
   must live in a registry module (``exceptions.py``, ``service/errors.py``,
   ``runners/exceptions.py``, ``reliability/faults.py``) or be listed in
   ``exceptions._SUBSYSTEM_EXCEPTIONS`` (the lazy re-export map): a typed
   failure nobody can import from the taxonomy is not typed. Stale
   re-export entries (naming a class its module no longer binds, by
   definition or by import) are flagged too.
2. **Fault sites.** Every ``fault_point(site, ...)`` probe must name a
   site in ``reliability/faults.KNOWN_FAULT_SITES``, and every registered
   site must still have a live probe: the chaos tooling targets sites by
   name, and a dangling name means a drill that silently exercises
   nothing.

A package scan must hold all four registry modules and the two tables;
one that does not reports it. Fixture scans side-load the tables from
the repository's package.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional, Set, Tuple

from ..core import (
    Finding,
    Module,
    ModuleIndex,
    find_assign,
    literal_str,
    pkg,
    unresolved,
)

CHECK = "failure-registry"

EXCEPTIONS = pkg("exceptions.py")
FAULTS = pkg("reliability/faults.py")

REGISTRY_SUFFIXES = (
    EXCEPTIONS,
    pkg("service/errors.py"),
    pkg("runners/exceptions.py"),
    FAULTS,
)

_EXC_BASE_NAMES = {
    "Exception", "BaseException", "RuntimeError", "ValueError",
    "TypeError", "KeyError", "OSError", "KeyboardInterrupt",
    "ImportError", "ArithmeticError", "StopIteration",
}

_EXC_NAME_SUFFIXES = (
    "Error", "Exception", "Failure", "Interrupt", "Crash", "Exceeded",
    "Overloaded", "Timeout", "Closed",
)

FAULT_SITES_NAME = "KNOWN_FAULT_SITES"
REEXPORT_NAME = "_SUBSYSTEM_EXCEPTIONS"


def _is_exception_class(cls: ast.ClassDef) -> bool:
    for base in cls.bases:
        name = base.id if isinstance(base, ast.Name) else (
            base.attr if isinstance(base, ast.Attribute) else None
        )
        if name is None:
            continue
        if name in _EXC_BASE_NAMES or name.endswith(_EXC_NAME_SUFFIXES):
            return True
    return False


def _binds(module: Module, name: str) -> bool:
    """Whether ``module`` binds ``name`` at any level: a class of that
    name, or an import of it (a subsystem may re-export a class the
    taxonomy module defines)."""
    for node in ast.walk(module.tree):
        if isinstance(node, ast.ClassDef) and node.name == name:
            return True
        if isinstance(node, (ast.Import, ast.ImportFrom)) and any(
            (alias.asname or alias.name) == name for alias in node.names
        ):
            return True
    return False


def _fault_sites(module: Optional[Module]) -> Optional[Set[str]]:
    value = None if module is None else find_assign(module, FAULT_SITES_NAME)
    if value is None:
        return None
    return {
        node.value
        for node in ast.walk(value)
        if isinstance(node, ast.Constant) and isinstance(node.value, str)
    }


def _reexports(module: Optional[Module]) -> Optional[Dict[str, str]]:
    value = None if module is None else find_assign(module, REEXPORT_NAME)
    if not isinstance(value, ast.Dict):
        return None
    out: Dict[str, str] = {}
    for k, v in zip(value.keys, value.values):
        key, val = literal_str(k), literal_str(v)
        if key and val:
            out[key] = val
    return out


def run(index: ModuleIndex) -> List[Finding]:
    findings: List[Finding] = []
    if index.narrow:
        for suffix in REGISTRY_SUFFIXES:
            if index.get(suffix) is None:
                findings.append(unresolved(CHECK, suffix, f"registry {suffix}"))

    # -- half 1: exception classes must be registry-importable -------------
    exceptions_mod = index.registry(EXCEPTIONS)
    reexports = _reexports(exceptions_mod)
    if reexports is None:
        findings.append(unresolved(
            CHECK, EXCEPTIONS, f"registry {EXCEPTIONS}:{REEXPORT_NAME}"
        ))
        reexports = {}
    for module in index.modules:
        in_registry = module.relpath.endswith(REGISTRY_SUFFIXES)
        for node in ast.walk(module.tree):
            if not isinstance(node, ast.ClassDef):
                continue
            if not _is_exception_class(node):
                continue
            if in_registry or node.name in reexports:
                continue
            findings.append(Finding(
                check=CHECK, path=module.relpath, line=node.lineno,
                message=(
                    f"typed exception {node.name} is defined outside the "
                    "registry modules and not re-exported via "
                    f"exceptions.{REEXPORT_NAME}"
                ),
                key=f"exc-unregistered:{node.name}",
            ))
    if index.get(EXCEPTIONS) is not None:
        for name, dotted in sorted(reexports.items()):
            relpath = dotted.replace(".", "/")
            target = index.get(f"{relpath}.py") or index.get(
                f"{relpath}/__init__.py"
            )
            if target is None or not _binds(target, name):
                findings.append(Finding(
                    check=CHECK, path=exceptions_mod.relpath, line=1,
                    message=(
                        f"{REEXPORT_NAME} entry {name} -> {dotted} names a "
                        "class that module does not bind (stale registry)"
                    ),
                    key=f"exc-registry-stale:{name}",
                ))

    # -- half 2: fault_point sites <-> KNOWN_FAULT_SITES -------------------
    sites = _fault_sites(index.registry(FAULTS))
    if sites is None:
        findings.append(unresolved(
            CHECK, FAULTS, f"registry {FAULTS}:{FAULT_SITES_NAME}"
        ))
    probed: Dict[str, Tuple[str, int]] = {}
    for module in index.modules:
        for node in ast.walk(module.tree):
            if not isinstance(node, ast.Call):
                continue
            func = node.func
            name = func.attr if isinstance(func, ast.Attribute) else (
                func.id if isinstance(func, ast.Name) else None
            )
            if name != "fault_point" or not node.args:
                continue
            site = literal_str(node.args[0])
            if site is None:
                # line-free key (core.py's fingerprint contract): the
                # source expression itself is stable under edits above it
                expr = ast.unparse(node.args[0])
                findings.append(Finding(
                    check=CHECK, path=module.relpath, line=node.lineno,
                    message=(
                        "fault_point site is not a string literal: the "
                        "registry cannot vouch for dynamic site names"
                    ),
                    key=f"fault-site-dynamic:{expr}",
                ))
                continue
            probed.setdefault(site, (module.relpath, node.lineno))
            if sites is not None and site not in sites:
                findings.append(Finding(
                    check=CHECK, path=module.relpath, line=node.lineno,
                    message=(
                        f"fault_point site {site!r} is not registered in "
                        f"reliability/faults.{FAULT_SITES_NAME}"
                    ),
                    key=f"fault-site-unregistered:{site}",
                ))
    if sites is not None and index.get(FAULTS) is not None:
        for site in sorted(sites - set(probed)):
            findings.append(Finding(
                check=CHECK, path=FAULTS, line=1,
                message=(
                    f"{FAULT_SITES_NAME} lists {site!r} but no live "
                    "fault_point probes it (dead registry entry)"
                ),
                key=f"fault-site-dead:{site}",
            ))
    return findings
