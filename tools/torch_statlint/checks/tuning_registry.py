"""Check: the tuning-registry convention.

Every tunable routing constant lives in ``deequ_tpu_torch/tuning/knobs.py``
(name, static default, bounds, substrate-sensitivity) and is read through
``knobs.value(...)`` so env overrides, boot-time calibration, and the
online controller move through ONE audited surface. Two drift shapes are
flagged:

(a) an env var REGISTERED in the knob registry read anywhere else — a
    module parsing a registered ``DEEQU_TPU_*`` override itself bypasses
    the tuned layer, so calibration silently stops applying to it;
(b) a new hand-coded routing threshold: a module-level numeric constant
    whose NAME says it is a routing/sizing cutoff (``*_MIN_ROWS``,
    ``*_MAX_DISTINCT``, ``*_THRESHOLD``, ``*_KNEE``, ``*_CROSSOVER``,
    ``*_PROBE_ROWS``, ...) used in a comparison — the exact pattern the
    registry exists to absorb. Deliberate non-tunable cutoffs carry
    baseline entries with reasons instead of silent exemptions.

A registry that does not resolve, or registers no env override, is a
finding of its own, never a silent pass.
"""

from __future__ import annotations

import ast
import re
from typing import List, Optional

from ..core import Finding, ModuleIndex, iter_env_reads, pkg, unresolved

CHECK = "tuning-registry"

#: modules allowed to read registry env vars (knobs.py IS the reader;
#: config.py documents/re-exports; utils.py implements the parsers)
KNOBS = pkg("tuning/knobs.py")

ALLOWED_SUFFIXES = (KNOBS, pkg("config.py"), pkg("utils.py"))

#: module-level constant names that smell like hand-coded routing
#: thresholds (the shapes the package accumulated before the registry)
_THRESHOLD_NAME = re.compile(
    r"(_(MIN|MAX)_(ROWS|DISTINCT|WIDTH|DEPTH|ENTRIES|SLOTS|CARDINALITY)$)"
    r"|(_THRESHOLD$)|(_KNEE$)|(_CROSSOVER$)|(_PROBE_ROWS$)"
)

#: the threshold scan exempts the registry itself (whose static defaults
#: ARE the record) and config.py (documentation/re-export surface)
_SCAN_EXEMPT = (pkg("tuning/"), pkg("config.py"))


def registered_envs(index: ModuleIndex) -> set:
    """Env names registered as knob overrides, parsed from knobs.py's AST
    (the string literals passed as the Knob constructor's env field)."""
    knobs = index.registry(KNOBS)
    if knobs is None:
        return set()
    registered = set()
    for node in ast.walk(knobs.tree):
        if not (isinstance(node, ast.Call)
                and isinstance(node.func, ast.Name)
                and node.func.id == "k"):
            continue
        env: Optional[str] = None
        if len(node.args) >= 2 and isinstance(node.args[1], ast.Constant):
            env = node.args[1].value
        for kw in node.keywords:
            if kw.arg == "env" and isinstance(kw.value, ast.Constant):
                env = kw.value.value
        if isinstance(env, str):
            registered.add(env)
    return registered


def _const_number(node: ast.AST) -> Optional[float]:
    """Evaluate a constant numeric expression — including the package's
    idiomatic ``1 << 21`` / ``4 * 1024`` shapes ``ast.literal_eval``
    refuses — or None."""
    if isinstance(node, ast.Constant):
        value = node.value
        if isinstance(value, (int, float)) and not isinstance(value, bool):
            return value
        return None
    if isinstance(node, ast.UnaryOp) and isinstance(node.op, ast.USub):
        inner = _const_number(node.operand)
        return None if inner is None else -inner
    if isinstance(node, ast.BinOp):
        left = _const_number(node.left)
        right = _const_number(node.right)
        if left is None or right is None:
            return None
        try:
            if isinstance(node.op, ast.LShift):
                return int(left) << int(right)
            if isinstance(node.op, ast.Mult):
                return left * right
            if isinstance(node.op, ast.Add):
                return left + right
            if isinstance(node.op, ast.Sub):
                return left - right
            if isinstance(node.op, ast.Pow):
                return left ** right
        except (ValueError, OverflowError):
            return None
    return None


def _numeric_threshold_constants(module) -> List[ast.Assign]:
    out = []
    for node in module.tree.body:
        if (
            isinstance(node, ast.Assign)
            and len(node.targets) == 1
            and isinstance(node.targets[0], ast.Name)
            and _THRESHOLD_NAME.search(node.targets[0].id)
            and _const_number(node.value) is not None
        ):
            out.append(node)
    return out


def _compared_names(module) -> set:
    """Names appearing inside an ast.Compare anywhere in the module — a
    constant merely re-exported or passed as a parser default is not a
    routing decision; one something is compared AGAINST is."""
    names = set()
    for node in ast.walk(module.tree):
        if isinstance(node, ast.Compare):
            for sub in ast.walk(node):
                if isinstance(sub, ast.Name):
                    names.add(sub.id)
    return names


def run(index: ModuleIndex) -> List[Finding]:
    findings: List[Finding] = []
    registered = registered_envs(index)
    if not registered:
        findings.append(unresolved(CHECK, KNOBS, f"registry {KNOBS}"))
    for module in index.modules:
        if module.relpath.endswith(ALLOWED_SUFFIXES):
            continue
        for node, env_name, _style in iter_env_reads(module):
            if env_name in registered:
                findings.append(Finding(
                    check=CHECK, path=module.relpath, line=node.lineno,
                    message=(
                        f"{env_name} is registered in tuning/knobs.py but "
                        "read directly here: resolve through knobs.value() "
                        "so env overrides, calibration, and the online "
                        "controller stay on one surface"
                    ),
                    key=f"bypass:{env_name}",
                ))
        if module.relpath.startswith(_SCAN_EXEMPT):
            continue
        compared = _compared_names(module)
        for node in _numeric_threshold_constants(module):
            name = node.targets[0].id
            if name not in compared:
                continue
            findings.append(Finding(
                check=CHECK, path=module.relpath, line=node.lineno,
                message=(
                    f"hand-coded routing threshold {name}: register it as "
                    "a tuning knob (tuning/knobs.py) with the measured "
                    "value as its static default, or baseline with a "
                    "reason why it must stay fixed"
                ),
                key=f"threshold:{name}",
            ))
    return findings
