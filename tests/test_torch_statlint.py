"""tools/torch_statlint: the port's invariant linter, which machine-checks
the contracts ``deequ_tpu_torch``'s service plane is built on.

What is pinned here:

- the ZERO-FINDING GATE: the port's tree produces no non-baselined
  findings (the tier-1 wire), inside the 30 s budget;
- per-check POSITIVE fixtures: each seeded violation in
  ``tools/torch_statlint/fixtures`` makes the CLI exit 1 with its check id;
- the baseline round trip: an entry suppresses exactly itself, a stale
  entry is reported, an entry without a reason is rejected;
- NO VACUOUS PASS: every check's registry modules and scopes resolve on
  the port, and a tree without them is reported, never passed;
- the fold-body purity check's root table against the reference's roots;
- the linter's isolation: it imports no JAX, no ``deequ_tpu``, no
  ``tools.statlint`` and no ``torch``;
- the three faults of the port the linter found: the lazy subsystem
  exceptions, the undocumented knobs (``tests/test_torch_public_surface.py``)
  and the scheduler's partition series.
"""

from __future__ import annotations

import ast
import json
import os
import subprocess
import sys
import time
from types import SimpleNamespace

import pytest

from tools.torch_statlint import ModuleIndex, load_baseline, pkg, run_checks
from tools.torch_statlint.__main__ import main
from tools.torch_statlint.checks import (
    dead_imports,
    env_knobs,
    failure_registry,
    span_kinds,
    state_algebra,
    trace_purity,
    tuning_registry,
)
from tools.torch_statlint.core import DEFAULT_BASELINE, PACKAGE, REPO_ROOT

pytestmark = pytest.mark.lint

FIXTURES = os.path.join(REPO_ROOT, "tools", "torch_statlint", "fixtures")
PACKAGE_DIR = os.path.join(REPO_ROOT, PACKAGE)


def _fixture(name: str) -> str:
    return os.path.join(FIXTURES, name)


@pytest.fixture(scope="module")
def package_findings():
    return run_checks(ModuleIndex([PACKAGE_DIR]))


# ---------------------------------------------------------------------------
# the zero-finding gate (the tier-1 wire)
# ---------------------------------------------------------------------------

def test_zero_finding_gate_over_the_port():
    """`python -m tools.torch_statlint` exits 0 on the tree: zero
    non-baselined findings and no stale baseline entry. Run in-process so
    tier-1 pays one parse pass, not an interpreter start."""
    assert main([]) == 0


def test_gate_runs_inside_timing_budget():
    t0 = time.monotonic()
    findings = run_checks(ModuleIndex([PACKAGE_DIR]))
    elapsed = time.monotonic() - t0
    assert elapsed < 30, f"torch_statlint took {elapsed:.1f}s"
    baseline = load_baseline(DEFAULT_BASELINE)
    new = [f for f in findings if f.fingerprint() not in baseline]
    assert new == [], "\n".join(f.render() for f in new)


def test_every_baseline_entry_still_fires(package_findings):
    fired = {f.fingerprint() for f in package_findings}
    baseline = load_baseline(DEFAULT_BASELINE)
    assert sorted(set(baseline) - fired) == []
    # each entry names a check that exists, with a reason
    from tools.torch_statlint.core import known_check_ids

    for fingerprint, reason in baseline.items():
        assert fingerprint.split(":", 1)[0] in known_check_ids(), fingerprint
        assert len(reason) > 20, fingerprint


# ---------------------------------------------------------------------------
# per-check positive fixtures: the seeded violation must fire
# ---------------------------------------------------------------------------

FIXTURE_EXPECTATIONS = [
    ("trace_purity_bad.py", "trace-purity", "wall-clock read"),
    ("lock_discipline_bad.py", "lock-discipline", "commit-inversion shape"),
    ("env_knobs_bad.py", "env-knob", "DEEQU_TPU_FIXTURE_KNOB"),
    ("failure_registry_bad.py", "failure-registry", "RogueSubsystemError"),
    ("export_help_bad.py", "export-help",
     "deequ_service_fixture_undescribed_total"),
    ("state_algebra_bad.py", "state-algebra", "no merge()"),
    ("dead_imports_bad.py", "dead-import", "'json'"),
    ("tuning_registry_bad.py", "tuning-registry", "FIXTURE_ROUTE_MIN_ROWS"),
    ("span_kinds_bad.py", "span-kind-registry", "freestyle_kind"),
]


def test_every_check_has_a_fixture():
    from tools.torch_statlint.core import known_check_ids

    assert sorted(c for _, c, _ in FIXTURE_EXPECTATIONS) == sorted(known_check_ids())
    assert sorted(f for f, _, _ in FIXTURE_EXPECTATIONS) == sorted(
        n for n in os.listdir(FIXTURES) if n.endswith("_bad.py"))


@pytest.mark.parametrize(
    "fixture,check,needle", FIXTURE_EXPECTATIONS,
    ids=[c for _, c, _ in FIXTURE_EXPECTATIONS],
)
def test_fixture_violation_fires(fixture, check, needle, capsys):
    path = _fixture(fixture)
    assert main([path]) == 1, f"{fixture} should fail the gate"
    assert f"[{check}]" in capsys.readouterr().out
    findings = [f for f in run_checks(ModuleIndex([path])) if f.check == check]
    assert any(needle in f.message for f in findings), [f.message for f in findings]


def test_cli_module_entry_point():
    """`python -m tools.torch_statlint <fixture>` (the real CLI) exits 1:
    one subprocess to pin the module wiring."""
    proc = subprocess.run(
        [sys.executable, "-m", "tools.torch_statlint",
         _fixture("lock_discipline_bad.py")],
        cwd=REPO_ROOT, capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 1, proc.stdout + proc.stderr
    assert "lock-discipline" in proc.stdout


def test_span_kind_check_ignores_foreign_kind_kwargs():
    """np.argsort(kind="stable") is someone else's API: the span-kind
    check fires only on the trace call beside it."""
    index = ModuleIndex([_fixture("span_kinds_bad.py")])
    findings = [f for f in run_checks(index) if f.check == "span-kind-registry"]
    assert [f.key for f in findings] == ["kind:freestyle_kind"]


def test_trace_purity_catches_wall_clock_and_host_syncs():
    index = ModuleIndex([_fixture("trace_purity_bad.py")])
    found = {f.key for f in run_checks(index, only=["trace-purity"])}
    assert found == {
        "FixtureState.merge:time.time (wall-clock read)",
        "chained_helper:host sync (.item())",
        "FixtureAnalyzer.fold_slot:float() of a tensor (host sync)",
    }


@pytest.mark.parametrize("body,impure", [
    ("x = state.total.tolist()", True),
    ("x = state.total.cpu()", True),
    ("x = int(torch.count_nonzero(state.total))", True),
    ("x = bool(state.total.any())", True),
    ("x = np.asarray(state.total)", True),
    ("torch.cuda.synchronize()", True),
    ("x = os.environ.get('DEEQU_TPU_X')", True),
    ("x = np.random.rand(3)", True),
    ("x = torch.rand(3)", True),
    ("x = torch.rand(3, generator=gen)", False),
    ("x = np.random.default_rng(0)", False),
    ("x = int(state.width)", False),
    ("x = state.total + 1", False),
], ids=lambda v: v if isinstance(v, str) else str(v))
def test_trace_purity_classifies_fold_body_calls(tmp_path, body, impure):
    module = tmp_path / "fold.py"
    module.write_text(
        "import os\nfrom dataclasses import dataclass\n\nimport numpy as np\nimport torch\n\n\n"
        "@dataclass\nclass ProbeState:\n    total: object\n\n"
        f"    def merge(state, other):\n        {body}\n        return state\n"
    )
    found = run_checks(ModuleIndex([str(module)]), only=["trace-purity"])
    assert bool(found) == impure, [f.message for f in found]


def test_trace_purity_roots_are_class_body_methods(tmp_path):
    """A nested state class's fold method is a root; a function nested in
    a method is not a method, even when it shares a fold method's name."""
    module = tmp_path / "nested.py"
    module.write_text(
        "import time\nfrom dataclasses import dataclass\n\n\n"
        "class Holder:\n"
        "    @dataclass\n"
        "    class InnerState:\n"
        "        def merge(self, other):\n"
        "            return time.time()\n\n\n"
        "@dataclass\nclass OuterState:\n"
        "    def metric_value(self):\n"
        "        def merge():\n"
        "            return time.time()\n"
        "        return merge()\n"
    )
    index = ModuleIndex([str(module)])
    assert [r.rsplit(":", 1)[1] for r in trace_purity.roots(index)] == [
        "Holder.InnerState.merge"]
    found = {f.key for f in run_checks(index, only=["trace-purity"])}
    assert found == {"Holder.InnerState.merge:time.time (wall-clock read)"}


# ---------------------------------------------------------------------------
# lock discipline
# ---------------------------------------------------------------------------

def test_lock_check_reproduces_commit_inversion_shape():
    """A shared-field write reachable with and without the owning lock,
    with both paths named."""
    index = ModuleIndex([_fixture("lock_discipline_bad.py")])
    findings = [
        f for f in run_checks(index)
        if f.check == "lock-discipline" and "unguarded-write" in f.key
    ]
    assert len(findings) == 1
    message = findings[0].message
    assert "commit" in message and "commit_unlocked" in message
    assert "_committed" in message


def test_lock_check_finds_acquisition_order_cycle():
    index = ModuleIndex([_fixture("lock_discipline_bad.py")])
    cycles = [
        f for f in run_checks(index)
        if f.check == "lock-discipline" and f.key.startswith("cycle:")
    ]
    assert len(cycles) == 1
    assert "AccountA._lock" in cycles[0].message
    assert "AccountB._lock" in cycles[0].message


def test_locked_helper_convention_not_flagged(tmp_path):
    """A `_foo_locked` helper whose every call site holds the lock, also
    through another helper, is guarded."""
    module = tmp_path / "helper_convention.py"
    module.write_text(
        "import threading\n"
        "class Fine:\n"
        "    def __init__(self):\n"
        "        self._lock = threading.Lock()\n"
        "        self._state = 0\n"
        "    def public(self):\n"
        "        with self._lock:\n"
        "            self._outer_locked()\n"
        "    def _outer_locked(self):\n"
        "        self._inner_locked()\n"
        "    def _inner_locked(self):\n"
        "        self._state += 1\n"
    )
    findings = run_checks(ModuleIndex([str(module)]), only=["lock-discipline"])
    assert findings == [], [f.message for f in findings]


# ---------------------------------------------------------------------------
# baseline round trip
# ---------------------------------------------------------------------------

def test_baseline_round_trip(tmp_path):
    fixture = _fixture("env_knobs_bad.py")
    baseline = tmp_path / "baseline.json"
    assert main(["--write-baseline", str(baseline), fixture]) == 0
    entries = json.loads(baseline.read_text())["entries"]
    assert entries, "write-baseline must capture the findings"
    for entry in entries:
        entry["reason"] = "captured by the round-trip test"
    # one entry suppresses exactly itself: the rest still fail the gate
    baseline.write_text(json.dumps({"entries": entries[:1]}))
    assert main(["--baseline", str(baseline), fixture]) == (1 if len(entries) > 1 else 0)
    baseline.write_text(json.dumps({"entries": entries}))
    assert main(["--baseline", str(baseline), fixture]) == 0
    # a clean module against the same baseline reports the entries as STALE
    clean = tmp_path / "clean.py"
    clean.write_text("VALUE = 1\n")
    assert main(["--baseline", str(baseline), str(clean)]) == 1


def test_baseline_requires_reasons(tmp_path):
    baseline = tmp_path / "noreason.json"
    baseline.write_text(json.dumps(
        {"entries": [{"fingerprint": "env-knob:x:y", "reason": "  "}]}
    ))
    with pytest.raises(ValueError):
        load_baseline(str(baseline))
    assert main(["--baseline", str(baseline), _fixture("env_knobs_bad.py")]) == 2


def test_unknown_check_id_is_an_error_not_a_silent_green():
    rc = main(["--checks", "lock_discipline",  # underscore typo
               _fixture("lock_discipline_bad.py")])
    assert rc == 2
    with pytest.raises(ValueError):
        run_checks(ModuleIndex([_fixture("lock_discipline_bad.py")]), only=["nope"])


def test_scoped_run_does_not_report_foreign_baseline_as_stale():
    """--checks scoping must not flag unselected checks' baseline entries
    as stale (obeying 'delete it' would break the full run)."""
    assert main(["--checks", "lock-discipline"]) == 0


def test_env_check_catches_bound_name_import_idiom(tmp_path):
    """`from os import environ` / `from os import getenv` reads must not
    evade the convention check."""
    module = tmp_path / "evader.py"
    module.write_text(
        "from os import environ, getenv\n"
        "A = environ.get('DEEQU_TPU_EVADED_A')\n"
        "B = getenv('DEEQU_TPU_EVADED_B')\n"
        "C = environ['DEEQU_TPU_EVADED_C']\n"
    )
    found = {f.key for f in run_checks(ModuleIndex([str(module)]), only=["env-knob"])}
    assert {k for k in found if k.startswith("direct:")} == {
        "direct:DEEQU_TPU_EVADED_A",
        "direct:DEEQU_TPU_EVADED_B",
        "direct:DEEQU_TPU_EVADED_C",
    }
    # and none of the three is documented in the port's config.py
    assert {k for k in found if k.startswith("undocumented:")} == {
        "undocumented:DEEQU_TPU_EVADED_A",
        "undocumented:DEEQU_TPU_EVADED_B",
        "undocumented:DEEQU_TPU_EVADED_C",
    }


# ---------------------------------------------------------------------------
# no vacuous pass: registries and scopes resolve, or the check says so
# ---------------------------------------------------------------------------

REGISTRIES = {
    "trace-purity": list(trace_purity.STATE_MODULES) + [trace_purity.ENGINE],
    "env-knob": [env_knobs.CONFIG],
    "failure-registry": list(failure_registry.REGISTRY_SUFFIXES),
    "state-algebra": [state_algebra.STATES],
    "dead-import": list(dead_imports.SCOPES),
    "tuning-registry": [tuning_registry.KNOBS],
    "span-kind-registry": [span_kinds._REGISTRY_MODULE],
}


@pytest.mark.parametrize("check", sorted(REGISTRIES))
def test_each_registry_and_scope_resolves_on_the_port(check, package_findings):
    index = ModuleIndex([PACKAGE_DIR])
    for path in REGISTRIES[check]:
        assert path.startswith(f"{PACKAGE}/"), path
        if path.endswith("/"):
            assert any(m.relpath.startswith(path) for m in index.modules), path
        else:
            assert index.get(path) is not None, path
    assert [f for f in package_findings
            if f.check == check and f.key.startswith("unresolved:")] == []


@pytest.mark.parametrize("check", sorted(REGISTRIES))
def test_a_tree_without_the_registry_is_reported(check, tmp_path):
    """A package tree that lacks the check's registry (or scope) gets a
    finding saying so: the check never returns an empty result it did not
    earn. The side-load fallback reads the same tree, so it cannot hide
    the gap."""
    tree = tmp_path / PACKAGE
    tree.mkdir()
    (tree / "__init__.py").write_text("")
    (tree / "mod.py").write_text("VALUE = 1\n")
    index = ModuleIndex([str(tree)], root=str(tmp_path))
    found = [f for f in run_checks(index, only=[check]) if f.key.startswith("unresolved:")]
    assert found, check
    assert all(f.check == check and f.path.startswith(f"{PACKAGE}/") for f in found)


def test_checks_without_a_registry_report_nothing_on_an_empty_tree(tmp_path):
    tree = tmp_path / PACKAGE
    tree.mkdir()
    (tree / "mod.py").write_text("VALUE = 1\n")
    index = ModuleIndex([str(tree)], root=str(tmp_path))
    assert run_checks(index, only=["lock-discipline", "export-help"]) == []


def test_registry_paths_are_named_once_in_core():
    """Every check takes its paths from core.pkg(): no check module spells
    the package name in a string literal of its own (docstrings aside)."""
    checks_dir = os.path.join(REPO_ROOT, "tools", "torch_statlint", "checks")
    for name in sorted(os.listdir(checks_dir)):
        if not name.endswith(".py"):
            continue
        tree = ast.parse(open(os.path.join(checks_dir, name)).read())
        docstrings = {
            id(node.body[0].value) for node in ast.walk(tree)
            if isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef))
            and node.body and isinstance(node.body[0], ast.Expr)
            and isinstance(node.body[0].value, ast.Constant)
        }
        literals = [
            node.value for node in ast.walk(tree)
            if isinstance(node, ast.Constant) and isinstance(node.value, str)
            and id(node) not in docstrings
            and (PACKAGE in node.value or "deequ_tpu/" in node.value)
        ]
        assert literals == [], name


# ---------------------------------------------------------------------------
# fold-body purity: the root table against the reference's roots
# ---------------------------------------------------------------------------

def _root_table():
    """(reference root, registrations, port counterpart or None) rows of
    the table in trace_purity's docstring."""
    doc = trace_purity.__doc__.splitlines()
    rules = [i for i, line in enumerate(doc) if line.startswith("=====")]
    assert len(rules) == 3, rules
    width = len(doc[rules[0]].split("  ")[0])
    rows = []
    for line in doc[rules[1] + 1:rules[2]]:
        ref, port = line[:width].rstrip(), line[width + 2:].strip()
        if ref and not ref.startswith(" "):
            rows.append([ref, port])
            continue
        if ref:
            rows[-1][0] += ref.strip()
        if port:
            joint = "" if port.startswith(".") else " "
            rows[-1][1] += joint + port
    out = []
    for ref, port in rows:
        times = 2 if ref.endswith(" (x2)") else 1
        ref = ref.replace(" (x2)", "")
        out.append((ref, times, None if port.startswith("none:") else port))
    return out


def test_root_table_maps_every_reference_root():
    """The table's reference column is exactly the reference check's root
    set over ``deequ_tpu``, registrations counted (the reference linter is
    run here, in the test, never by the port's tool)."""
    from collections import Counter

    from tools.statlint.checks import trace_purity as reference_check
    from tools.statlint.core import ModuleIndex as ReferenceIndex

    index = ReferenceIndex([os.path.join(REPO_ROOT, "deequ_tpu")])
    tables = reference_check._index_functions(index)
    registered = Counter(
        f"{r.module.relpath}:{r.qualname}"
        for r in reference_check._roots(index, *tables)
    )
    rows = _root_table()
    assert len(rows) == 48 and sum(t for _, t, _ in rows) == 53
    assert Counter({f"deequ_tpu/{ref}": times for ref, times, _ in rows}) == registered


def test_port_roots_cover_every_mapped_row(capsys):
    roots = trace_purity.roots(ModuleIndex([PACKAGE_DIR]))
    mapped = [port for _, _, port in _root_table() if port is not None]
    with capsys.disabled():
        print(f"\n[torch_statlint] trace-purity roots on the port: {len(roots)}; "
              f"mapped rows: {len(mapped)}")
    assert len(roots) >= len(mapped)
    assert sorted(set(pkg(p) for p in mapped) - set(roots)) == []


# ---------------------------------------------------------------------------
# isolation: the linter parses the port, it imports nothing of it
# ---------------------------------------------------------------------------

def test_linter_imports_no_jax_reference_or_torch():
    code = (
        "import sys\n"
        "import tools.torch_statlint\n"
        "from tools.torch_statlint.__main__ import main\n"
        "rc = main(['--json'])\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'deequ_tpu', 'deequ_tpu_torch', 'torch') "
        "or m.startswith('tools.statlint'))\n"
        "print('BAD=' + ','.join(bad))\n"
        "sys.exit(rc)\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO_ROOT, capture_output=True,
        text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.strip().splitlines()[-1] == "BAD="


# ---------------------------------------------------------------------------
# live registries of the port (cheap spot checks)
# ---------------------------------------------------------------------------

def test_fault_site_registry_matches_live_probes():
    from deequ_tpu_torch.reliability.faults import KNOWN_FAULT_SITES

    assert "worker" in KNOWN_FAULT_SITES
    assert "coalesced_fold" in KNOWN_FAULT_SITES


def test_subsystem_exceptions_import_lazily():
    import deequ_tpu_torch.exceptions as exc

    assert exc.ExpressionError.__name__ == "ExpressionError"
    assert exc.SerializationError.__name__ == "SerializationError"
    assert exc.MeshExhaustedError.__name__ == "MeshExhaustedError"
    assert exc.FrequencyBudgetExceeded.__name__ == "FrequencyBudgetExceeded"
    with pytest.raises(AttributeError):
        exc.NoSuchThing


def test_env_helpers_follow_convention(monkeypatch):
    from deequ_tpu_torch.utils import env_flag, env_str

    monkeypatch.delenv("DEEQU_TPU_TEST_FLAG", raising=False)
    assert env_flag("DEEQU_TPU_TEST_FLAG", True) is True
    monkeypatch.setenv("DEEQU_TPU_TEST_FLAG", "0")
    assert env_flag("DEEQU_TPU_TEST_FLAG", True) is False
    monkeypatch.setenv("DEEQU_TPU_TEST_FLAG", "1")
    assert env_flag("DEEQU_TPU_TEST_FLAG", False) is True
    monkeypatch.setenv("DEEQU_TPU_TEST_FLAG", "")
    assert env_flag("DEEQU_TPU_TEST_FLAG", True) is True  # empty = unset
    monkeypatch.setenv("DEEQU_TPU_TEST_STR", "s3://bucket")
    assert env_str("DEEQU_TPU_TEST_STR") == "s3://bucket"
    assert env_str("DEEQU_TPU_TEST_STR_MISSING", "dflt") == "dflt"


def test_trace_ring_clamps_to_floor(monkeypatch):
    """DEEQU_TPU_TRACE_RING below the floor clamps to 16."""
    import importlib

    recorder_mod = importlib.import_module("deequ_tpu_torch.observability.recorder")
    monkeypatch.setenv("DEEQU_TPU_TRACE_RING", "8")
    assert recorder_mod.ring_capacity() == 16
    monkeypatch.setenv("DEEQU_TPU_TRACE_RING", "64")
    assert recorder_mod.ring_capacity() == 64


# ---------------------------------------------------------------------------
# the scheduler's partition series: literals, same values
# ---------------------------------------------------------------------------

PARTITION_SERIES = {
    "partitions_scanned": "deequ_service_partitions_scanned_total",
    "partitions_reused": "deequ_service_partitions_reused_total",
    "partitions_invalidated": "deequ_service_partitions_invalidated_total",
    "partitions_dropped": "deequ_service_partitions_dropped_total",
    "partitions_rolled_up": "deequ_service_partitions_rolled_up_total",
}


def test_partition_series_are_spelled_as_literals(package_findings):
    path = os.path.join(PACKAGE_DIR, "service", "scheduler.py")
    harvest = next(
        node for node in ast.walk(ast.parse(open(path).read()))
        if isinstance(node, ast.FunctionDef) and node.name == "_harvest_monitor"
    )
    literals = {node.value for node in ast.walk(harvest)
                if isinstance(node, ast.Constant) and isinstance(node.value, str)}
    assert set(PARTITION_SERIES.values()) <= literals
    assert not any(isinstance(node, ast.JoinedStr) for node in ast.walk(harvest))
    assert [f for f in package_findings if f.check == "export-help"] == []


def test_partition_series_export_the_monitor_counts():
    from deequ_tpu_torch.runners.engine import RunMonitor
    from deequ_tpu_torch.service.scheduler import JobScheduler

    monitor = RunMonitor()
    for value, field in enumerate(PARTITION_SERIES, start=1):
        setattr(monitor, field, value)
    scheduler = SimpleNamespace(router=None, fleet=None, _harvest_listeners=[])
    updates: list = []
    JobScheduler._harvest_monitor(
        scheduler, "ten", monitor, SimpleNamespace(phase_seconds={}), updates=updates)
    got = {name: (value, labels) for name, value, labels in updates
           if name.startswith("deequ_service_partitions_")}
    assert got == {
        series: (float(value), {"tenant": "ten"})
        for value, series in enumerate(PARTITION_SERIES.values(), start=1)
    }
