"""Where the PyTorch/CUDA port traces, records failures, places fault sites
and bumps counters, against the JAX reference.

A walk over both packages' syntax trees collects every call of
:data:`CALLS` as ``(call, first literal argument, module)``: ``module`` is
the file's dotted path under its package root, the argument None where it
is not a literal string. Every key of the reference must be the port's
too, and every span name the reference opens in a module the port opens
there at least as often. ``RunMonitor``'s fields must contain the
reference's. What the port lacks by design stands in :data:`EXCEPTIONS`,
each with its reason; a row that no longer excuses anything fails too.
"""

from __future__ import annotations

import ast
import collections
import dataclasses
import os
from typing import Counter, Tuple

import pytest

from deequ_tpu.runners.engine import RunMonitor as RefMonitor
from deequ_tpu_torch.runners.engine import RunMonitor as PortMonitor

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: the calls compared: tracing, the failure recorder, fault sites, counters
CALLS = frozenset({"span", "start_span", "add_event", "record_phase", "record_failure",
                   "fault_point", "bump", "capture", "attach"})
#: the calls compared by count within a module
COUNTED = frozenset({"span", "start_span"})

#: what the reference has and the port lacks by design, with the reason:
#: call sites as ``(call, argument, module)``, monitor fields as
#: ``("RunMonitor", field)``
EXCEPTIONS = {
    ("RunMonitor", "cost_probes"):
        "counts the reference's block_until_ready probes of XLA's asynchronous "
        "dispatch; the port waits for every batch's kernels inside its kernels "
        "phase, so each batch's time is already its execution",
    ("RunMonitor", "jit_compiles"): "counts XLA's compiled programs; the port compiles none",
    ("RunMonitor", "program_compiles"): "counts XLA's program traces; the port traces none",
}

Site = Tuple[str, object, str]


def call_sites(package: str) -> Counter[Site]:
    root = os.path.join(_ROOT, package)
    sites: Counter[Site] = collections.Counter()
    for dirpath, _, files in os.walk(root):
        for name in files:
            if not name.endswith(".py"):
                continue
            path = os.path.join(dirpath, name)
            module = os.path.relpath(path, root)[:-3].replace(os.sep, ".")
            with open(path, encoding="utf-8") as fh:
                tree = ast.parse(fh.read(), filename=path)
            for node in ast.walk(tree):
                if not isinstance(node, ast.Call):
                    continue
                func = node.func
                call = func.attr if isinstance(func, ast.Attribute) else getattr(func, "id", None)
                if call not in CALLS:
                    continue
                first = node.args[0] if node.args else None
                arg = first.value if isinstance(first, ast.Constant) and isinstance(
                    first.value, str) else None
                sites[(call, arg, module)] += 1
    return sites


@pytest.fixture(scope="module")
def sites():
    return call_sites("deequ_tpu"), call_sites("deequ_tpu_torch")


def _fields(cls) -> set:
    return {f.name for f in dataclasses.fields(cls) if not f.name.startswith("_")}


def test_reference_call_sites_are_the_ports(sites):
    ref, port = sites
    missing = sorted((k for k in ref if k not in port and k not in EXCEPTIONS), key=repr)
    assert not missing, "call sites of the reference the port lacks:\n" + "\n".join(
        f"  {call}({arg!r}) in {module}" for call, arg, module in missing)


def test_spans_opened_as_often(sites):
    ref, port = sites
    short = sorted((k, n, port.get(k, 0)) for k, n in ref.items()
                   if k[0] in COUNTED and port.get(k, 0) < n and k not in EXCEPTIONS)
    assert not short, "spans the port opens less often than the reference:\n" + "\n".join(
        f"  {call}({arg!r}) in {module}: {n} vs {got}" for (call, arg, module), n, got in short)


def test_monitor_fields_contain_the_references():
    missing = sorted(f for f in _fields(RefMonitor) - _fields(PortMonitor)
                     if ("RunMonitor", f) not in EXCEPTIONS)
    assert not missing, f"RunMonitor fields of the reference the port lacks: {missing}"


def test_every_exception_has_a_reason_and_is_live(sites):
    ref, port = sites
    ref_fields, port_fields = _fields(RefMonitor), _fields(PortMonitor)
    for key, reason in EXCEPTIONS.items():
        assert reason.strip(), key
        if key[0] == "RunMonitor":
            assert key[1] in ref_fields and key[1] not in port_fields, key
        else:
            assert key in ref and port.get(key, 0) < ref[key], key


def test_the_walk_sees_the_known_sites(sites):
    """The walk itself: sites both packages are known to hold."""
    ref, port = sites
    for key in (("span", "engine_pass", "runners.engine"),
                ("span", "analysis_run", "runners.analysis_runner"),
                ("fault_point", "repository_load", "repository.fs"),
                ("record_phase", None, "runners.engine")):
        assert key in ref and key in port, key
