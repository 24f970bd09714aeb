"""Check: the span-kind registry.

Every span opened through the tracing API (``trace.span`` /
``trace.start_span`` and their ``_trace``-aliased forms) must carry a
``kind=`` drawn from :data:`deequ_tpu_torch.observability.trace.SPAN_KINDS`,
the registry consumers key on (torch_trace_summarize groups by kind, the
Chrome export uses it as the category, the fleetwatch series derive
from it). A kind invented at a call site renders fine and then silently
falls out of every kind-keyed view; the registry makes adding one a
one-line, reviewed change instead of a typo.

Matching is deliberately NARROW: only calls whose callee is ``span`` or
``start_span`` reached through a ``trace``/``_trace`` name (or bare,
when imported from the observability package) are considered — a
``kind=`` keyword on anything else (``np.argsort(kind="stable")``,
``np.sort``) is someone else's API, not ours. Non-literal kinds
(variables, f-strings) are skipped: this is a spelling gate, not a
dataflow analysis. A registry that does not resolve is a finding, never
a silent pass.
"""

from __future__ import annotations

import ast
from typing import List, Optional, Set

from ..core import Finding, ModuleIndex, attr_chain, find_assign, literal_str, pkg, unresolved

CHECK = "span-kind-registry"

#: where the registry lives, parsed from source so the check needs no
#: package import (fixture scans run it against arbitrary files)
_REGISTRY_MODULE = pkg("observability/trace.py")

_SPAN_FUNCS = {"span", "start_span"}
_TRACE_BASES = {"trace", "_trace"}


def _registry_kinds(index: ModuleIndex) -> Optional[Set[str]]:
    """The SPAN_KINDS literal from trace.py: from the scanned set when it
    is in scope, side-loaded from the repo tree otherwise (fixture mode).
    None when the registry cannot be resolved at all."""
    module = index.registry(_REGISTRY_MODULE)
    value = None if module is None else find_assign(module, "SPAN_KINDS")
    if value is None:
        return None
    kinds = {
        sub.value for sub in ast.walk(value)
        if isinstance(sub, ast.Constant) and isinstance(sub.value, str)
    }
    return kinds or None


def _is_span_call(node: ast.Call) -> bool:
    chain = attr_chain(node.func)
    if chain is None or chain[-1] not in _SPAN_FUNCS:
        return False
    if len(chain) == 1:
        # bare span()/start_span(): the from-import idiom — still ours;
        # nothing else in the tree spells a callable that way
        return True
    return chain[-2] in _TRACE_BASES


def run(index: ModuleIndex) -> List[Finding]:
    kinds = _registry_kinds(index)
    if kinds is None:
        return [unresolved(CHECK, _REGISTRY_MODULE,
                           f"registry {_REGISTRY_MODULE}:SPAN_KINDS")]
    findings: List[Finding] = []
    for module in index.modules:
        if module.relpath.endswith(_REGISTRY_MODULE):
            continue  # the registry's own internals construct Spans freely
        for node in ast.walk(module.tree):
            if not (isinstance(node, ast.Call) and _is_span_call(node)):
                continue
            for kw in node.keywords:
                if kw.arg != "kind":
                    continue
                value = literal_str(kw.value)
                if value is None or value in kinds:
                    continue
                findings.append(Finding(
                    check=CHECK, path=module.relpath, line=node.lineno,
                    message=(
                        f"span kind {value!r} is not in the SPAN_KINDS "
                        f"registry ({_REGISTRY_MODULE}): register it, "
                        "or use an existing kind; unknown kinds fall out "
                        "of every kind-keyed view"
                    ),
                    key=f"kind:{value}",
                ))
    return findings
