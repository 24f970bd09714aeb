"""Check: export-plane completeness.

Every ``deequ_service_*`` series the code can emit must carry a HELP
description (``ServiceMetrics.describe`` or the help argument of
``set_gauge_fn``) somewhere in the package. The Prometheus renderer
falls back to a generated placeholder for undescribed series, so this
never breaks a scrape — but a counter nobody can interpret is telemetry
debt, and ``promtool``-grade HELP text is cheap at authoring time and
impossible to reconstruct later.

Series names are collected as STRING LITERALS matching
``deequ_service_[a-z0-9_]+`` anywhere in the scanned tree (increments are
built through ``inc``, ``inc_many`` tuples, list-comps and batched-update
lists — chasing every shape is fragile; any mention of an undescribed
series is close enough to an emission to demand the description).
Histogram families (``ServiceMetrics.observe``) are series too:
``describe_histogram`` marks them described, same contract as counters.
"""

from __future__ import annotations

import ast
import re
from typing import Dict, List, Tuple

from ..core import Finding, ModuleIndex, literal_str

CHECK = "export-help"

_SERIES_RE = re.compile(r"^deequ_service_[a-z0-9_]+$")


def run(index: ModuleIndex) -> List[Finding]:
    mentions: Dict[str, Tuple[str, int]] = {}
    described = set()
    for module in index.modules:
        for node in ast.walk(module.tree):
            if isinstance(node, ast.Constant) and isinstance(node.value, str):
                if _SERIES_RE.match(node.value):
                    mentions.setdefault(
                        node.value, (module.relpath, node.lineno)
                    )
            elif isinstance(node, ast.Call):
                func = node.func
                name = func.attr if isinstance(func, ast.Attribute) else (
                    func.id if isinstance(func, ast.Name) else None
                )
                first = literal_str(node.args[0]) if node.args else None
                if first is None:
                    continue
                if name == "describe" and len(node.args) >= 2:
                    described.add(first)
                elif name == "describe_histogram" and (
                    len(node.args) >= 2
                    or any(k.arg == "help_text" for k in node.keywords)
                ):
                    described.add(first)
                elif name == "set_gauge_fn" and (
                    len(node.args) >= 3
                    or any(k.arg == "help_text" for k in node.keywords)
                ):
                    described.add(first)
    findings: List[Finding] = []
    for series, (path, line) in sorted(mentions.items()):
        if series not in described:
            findings.append(Finding(
                check=CHECK, path=path, line=line,
                message=(
                    f"series {series} is emitted but never described "
                    "(ServiceMetrics.describe / set_gauge_fn help text)"
                ),
                key=series,
            ))
    return findings
