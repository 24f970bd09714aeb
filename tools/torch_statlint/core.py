"""Core of the port's invariant linter: parse cache, findings, baseline.

The checks under ``tools/torch_statlint/checks`` machine-check the
contracts the port's service plane is built on (fold-body purity, lock
discipline, the env-knob convention, the typed-failure and fault-site
registries, export-plane HELP completeness, state-merge algebra, the
tuning registry, the span-kind registry, dead imports). It is the port's
own copy of ``tools/statlint``, which scans the JAX package: the same
checks, fixtures and CLI, pointed at :data:`PACKAGE`. It parses the
modules it scans and never imports them, so it needs neither ``torch``
nor a card.

Design:

- **PACKAGE** names the scanned package once. Every check takes its
  registry modules and scopes from :func:`pkg`, never from a literal.
- **ModuleIndex** walks the target tree ONCE and parses every module ONCE
  (the module-parse cache); each check receives the same index, so the
  whole suite is one parse pass plus one AST walk per check.
- **No vacuous pass**: a check whose registry module (or scope) does not
  resolve reports that as a finding of its own (:func:`unresolved`), so
  "zero findings" always means the check looked. Fixture scans resolve
  registries from the repo's package (:meth:`ModuleIndex.registry`).
- **Finding.fingerprint()** is line-number-free (check id, repo-relative
  path, a symbol-level key), so baselined findings survive unrelated edits
  to the same file.
- **Baseline**: ``baseline.json`` holds grandfathered findings, each with
  a mandatory human reason: no silent suppressions. The gate is zero
  NON-baselined findings; stale baseline entries (whose finding no longer
  fires) are themselves reported, so the file can only shrink honestly.
"""

from __future__ import annotations

import ast
import json
import os
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

REPO_ROOT = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)
DEFAULT_BASELINE = os.path.join(os.path.dirname(__file__), "baseline.json")

#: the package the linter scans, and under which every registry lives
PACKAGE = "deequ_tpu_torch"

#: what ``python -m tools.torch_statlint`` scans when given no paths
DEFAULT_TARGETS = (PACKAGE,)


def pkg(relpath: str) -> str:
    """A path inside the scanned package, repo-relative
    (``pkg("config.py")`` -> ``"deequ_tpu_torch/config.py"``)."""
    return f"{PACKAGE}/{relpath}"


@dataclass(frozen=True)
class Finding:
    check: str     #: check id (e.g. "lock-discipline")
    path: str      #: repo-relative module path
    line: int      #: 1-based line (display only; not part of the identity)
    message: str   #: one-line human statement of the violation
    key: str       #: line-free symbol-level identity within (check, path)

    def fingerprint(self) -> str:
        return f"{self.check}:{self.path}:{self.key}"

    def render(self) -> str:
        return f"{self.path}:{self.line}: [{self.check}] {self.message}"


def unresolved(check: str, relpath: str, what: str) -> Finding:
    """The finding a check reports when its registry module or scope does
    not resolve: the check cannot vouch for anything, so it must not pass."""
    return Finding(
        check=check, path=relpath, line=0,
        message=(
            f"{what} does not resolve on the scanned tree: the check "
            "cannot run, so it cannot pass"
        ),
        key=f"unresolved:{what}",
    )


class Module:
    """One parsed module plus the derived tables the checks share."""

    def __init__(self, path: str, relpath: str, source: str, tree: ast.Module):
        self.path = path
        self.relpath = relpath
        self.source = source
        self.tree = tree
        self._constants: Optional[Dict[str, str]] = None

    @property
    def constants(self) -> Dict[str, str]:
        """Module-level ``NAME = "literal"`` string constants (how env-var
        names are spelled at their read sites)."""
        if self._constants is None:
            out: Dict[str, str] = {}
            for node in self.tree.body:
                if (
                    isinstance(node, ast.Assign)
                    and len(node.targets) == 1
                    and isinstance(node.targets[0], ast.Name)
                    and isinstance(node.value, ast.Constant)
                    and isinstance(node.value.value, str)
                ):
                    out[node.targets[0].id] = node.value.value
            self._constants = out
        return self._constants

    def line_has_noqa(self, node: ast.AST) -> bool:
        lines = self.source.splitlines()
        start = getattr(node, "lineno", 1) - 1
        end = getattr(node, "end_lineno", start + 1)
        return any("noqa" in line for line in lines[start:end])


class ModuleIndex:
    """The shared parse cache: every check reads from here, nothing parses
    twice. ``narrow`` is True when scanning a package tree (some checks
    then restrict their sweep scope, e.g. dead-imports to ``service/`` +
    ``parallel/``, and require their registries to be in the scan);
    explicit file arguments (the fixture mode) scan everything they are
    given. ``root`` is the repository the relative paths and the
    registry side-loads are taken from."""

    def __init__(self, paths: Sequence[str], narrow: Optional[bool] = None,
                 root: str = REPO_ROOT):
        self.root = root
        self.modules: List[Module] = []
        self.errors: List[Finding] = []
        explicit_files = all(p.endswith(".py") for p in paths) if paths else False
        self.narrow = (not explicit_files) if narrow is None else narrow
        seen = set()
        for path in paths:
            for file_path in self._walk(path):
                if file_path in seen:
                    continue
                seen.add(file_path)
                self._load(file_path)
        self.modules.sort(key=lambda m: m.relpath)

    @staticmethod
    def _walk(path: str):
        path = os.path.abspath(path)
        if os.path.isfile(path):
            yield path
            return
        for dirpath, dirnames, filenames in os.walk(path):
            dirnames[:] = sorted(
                d for d in dirnames if d != "__pycache__" and not d.startswith(".")
            )
            for name in sorted(filenames):
                if name.endswith(".py"):
                    yield os.path.join(dirpath, name)

    def _relpath(self, file_path: str) -> str:
        relpath = os.path.relpath(file_path, self.root)
        return file_path if relpath.startswith("..") else relpath

    def _load(self, file_path: str) -> None:
        relpath = self._relpath(file_path)
        try:
            with open(file_path, "r", encoding="utf-8") as fh:
                source = fh.read()
            tree = ast.parse(source, filename=file_path)
        except (OSError, SyntaxError) as exc:
            self.errors.append(
                Finding(
                    check="parse-error", path=relpath,
                    line=getattr(exc, "lineno", 0) or 0,
                    message=f"module failed to parse: {exc}",
                    key=type(exc).__name__,
                )
            )
            return
        self.modules.append(Module(file_path, relpath, source, tree))

    def get(self, relpath_suffix: str) -> Optional[Module]:
        """The unique module whose repo-relative path ends with the given
        suffix (e.g. ``pkg("config.py")``), or None."""
        matches = [
            m for m in self.modules
            if m.relpath.endswith(relpath_suffix)
        ]
        return matches[0] if len(matches) == 1 else None

    def side_load(self, repo_relpath: str) -> Optional[Module]:
        """Parse one module from the repository tree without adding it to
        the scanned set: how fixture scans resolve registries (fault
        sites, span kinds) that live outside the fixture file."""
        path = os.path.join(self.root, repo_relpath)
        if not os.path.isfile(path):
            return None
        try:
            with open(path, "r", encoding="utf-8") as fh:
                source = fh.read()
            return Module(path, repo_relpath, source, ast.parse(source))
        except (OSError, SyntaxError):
            return None

    def registry(self, repo_relpath: str) -> Optional[Module]:
        """A registry module: from the scanned set, else side-loaded from
        the repository (a fixture or a subtree scan). None when it
        resolves in neither."""
        return self.get(repo_relpath) or self.side_load(repo_relpath)


# -- shared AST helpers ------------------------------------------------------

def attr_chain(node: ast.AST) -> Optional[List[str]]:
    """``a.b.c`` -> ["a", "b", "c"]; None when the chain bottoms out in a
    non-Name (a call result, a subscript)."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        parts.reverse()
        return parts
    return None


def literal_str(node: ast.AST) -> Optional[str]:
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    return None


def resolve_str(node: ast.AST, module: Module) -> Optional[str]:
    """A literal string, or a module-level constant holding one."""
    value = literal_str(node)
    if value is not None:
        return value
    if isinstance(node, ast.Name):
        return module.constants.get(node.id)
    return None


def find_assign(module: Module, target: str) -> Optional[ast.AST]:
    """The value of the module-level ``target = ...`` assignment, or None."""
    for node in module.tree.body:
        if (
            isinstance(node, ast.Assign)
            and len(node.targets) == 1
            and isinstance(node.targets[0], ast.Name)
            and node.targets[0].id == target
        ):
            return node.value
    return None


def iter_env_reads(module: Module):
    """Yield ``(node, env_name_or_None, style)`` for every environment
    read: style "direct" (``os.environ.get``/``os.getenv``/subscript,
    including the bound-name ``from os import environ``/``getenv`` idioms)
    or "helper" (``utils.env_number``/``env_str``/``env_flag``)."""
    helpers = {"env_number", "env_str", "env_flag"}
    for node in ast.walk(module.tree):
        if isinstance(node, ast.Call):
            chain = attr_chain(node.func)
            if chain is None:
                continue
            if (
                chain in (["os", "environ", "get"], ["environ", "get"],
                          ["os", "getenv"], ["getenv"])
            ):
                if node.args:
                    yield node, resolve_str(node.args[0], module), "direct"
            elif chain[-1] in helpers:
                arg = node.args[0] if node.args else None
                if arg is not None:
                    yield node, resolve_str(arg, module), "helper"
        elif isinstance(node, ast.Subscript) and isinstance(
            getattr(node, "ctx", None), ast.Load
        ):
            chain = attr_chain(node.value)
            if chain in (["os", "environ"], ["environ"]):
                yield node, resolve_str(node.slice, module), "direct"


# -- baseline ---------------------------------------------------------------

def load_baseline(path: str) -> Dict[str, str]:
    """fingerprint -> reason. Entries without a reason are rejected: a
    suppression nobody can explain is a silent suppression."""
    if not os.path.exists(path):
        return {}
    with open(path, "r", encoding="utf-8") as fh:
        payload = json.load(fh)
    out: Dict[str, str] = {}
    for entry in payload.get("entries", ()):
        fingerprint = entry["fingerprint"]
        reason = entry.get("reason", "").strip()
        if not reason:
            raise ValueError(
                f"baseline entry {fingerprint!r} has no reason; every "
                "grandfathered finding must say why it is deliberate"
            )
        out[fingerprint] = reason
    return out


def write_baseline(path: str, findings: Sequence[Finding]) -> None:
    entries = [
        {"fingerprint": f.fingerprint(), "reason": "TODO: explain why this is deliberate"}
        for f in sorted(findings, key=lambda f: f.fingerprint())
    ]
    with open(path, "w", encoding="utf-8") as fh:
        json.dump({"entries": entries}, fh, indent=2, sort_keys=False)
        fh.write("\n")


def apply_baseline(
    findings: Sequence[Finding], baseline: Dict[str, str], baseline_path: str
) -> Tuple[List[Finding], List[Finding]]:
    """Split findings into (new, stale-baseline-entries-as-findings)."""
    fired = {f.fingerprint() for f in findings}
    new = [f for f in findings if f.fingerprint() not in baseline]
    relpath = baseline_path
    if baseline_path:
        relpath = os.path.relpath(baseline_path, REPO_ROOT)
        if relpath.startswith(".."):
            relpath = baseline_path
    stale = [
        Finding(
            check="baseline-stale", path=relpath, line=0,
            message=(
                f"baseline entry {fp!r} no longer fires "
                f"(reason was: {reason}); delete it"
            ),
            key=fp,
        )
        for fp, reason in sorted(baseline.items())
        if fp not in fired
    ]
    return new, stale


def known_check_ids() -> List[str]:
    from .checks import ALL_CHECKS

    return [check.CHECK for check in ALL_CHECKS]


def run_checks(index: ModuleIndex, only: Optional[Sequence[str]] = None) -> List[Finding]:
    from .checks import ALL_CHECKS

    if only:
        unknown = sorted(set(only) - set(known_check_ids()))
        if unknown:
            # an unvalidated scope would silently run ZERO checks and
            # exit green: the one failure mode a gate must not have
            raise ValueError(
                f"unknown check id(s) {unknown}; known: {known_check_ids()}"
            )
    findings: List[Finding] = list(index.errors)
    for check in ALL_CHECKS:
        if only and check.CHECK not in only:
            continue
        findings.extend(check.run(index))
    findings.sort(key=lambda f: (f.path, f.line, f.check, f.key))
    return findings
