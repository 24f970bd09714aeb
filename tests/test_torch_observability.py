"""Tracing of a run in the PyTorch/CUDA port (``deequ_tpu_torch``: the
``analysis_run`` / ``verification_run`` roots, the engine's phase spans,
the trace context on the host tier's pool and the feed thread, the flight
recorder's dumps, cost attribution) against the JAX reference: every case
of ``tests/test_observability.py`` through both packages (``m`` is either
package, the port on ``device="cpu"``), then the two packages' span trees
compared run for run, and the FS metrics repository's ``repository_load``
fault site.

Each package names its own phases: the reference's device tier times
``device_dispatch``, the port's ``kernels``. The reference's
``cost_probes`` (synchronised probes of XLA's asynchronous dispatch) has no
counterpart: the port waits for every batch's kernels inside its
``kernels`` phase, which the probe case checks instead.

Tolerances: phase spans sum to ``phase_seconds`` within 1e-6 relative
(1e-9 s absolute), cost shares to ``bundle_dispatch_seconds`` within 1%;
span trees, events and counters are compared exactly. The stall drills
stall 3 s under a 1 s deadline (the reference's file: 30 s) and join the
passes they abandoned before the next test reads a ring.
"""

from __future__ import annotations

import json
import threading

import numpy as np
import pytest
import torch

import tools.torch_trace_summarize as port_summarize
import tools.trace_summarize as ref_summarize
from deequ_tpu_torch.reliability.watchdog import rate_key
from torch_pairs import pair, reference_isolated  # noqa: F401 (autouse)

pytestmark = pytest.mark.trace

NAMES = {
    "AnalysisRunner": "runners.analysis_runner:AnalysisRunner",
    "Check": "checks:Check",
    "CheckLevel": "checks:CheckLevel",
    "CheckStatus": "checks:CheckStatus",
    "Completeness": "analyzers:Completeness",
    "CorruptStateError": "exceptions:CorruptStateError",
    "Dataset": "data:Dataset",
    "FLIGHT_DIR_ENV": "observability.recorder:FLIGHT_DIR_ENV",
    "FaultSpec": "reliability:FaultSpec",
    "FileSystemMetricsRepository": "repository:FileSystemMetricsRepository",
    "FlightRecorder": "observability.recorder:FlightRecorder",
    "Maximum": "analyzers:Maximum",
    "Mean": "analyzers:Mean",
    "MetricsExporter": "service:MetricsExporter",
    "Minimum": "analyzers:Minimum",
    "ResultKey": "repository:ResultKey",
    "RunMonitor": "runners.engine:RunMonitor",
    "SCAN_DEADLINE_ENV": "reliability.watchdog:SCAN_DEADLINE_ENV",
    "SchemaDriftError": "exceptions:SchemaDriftError",
    "ServiceMetrics": "service:ServiceMetrics",
    "StandardDeviation": "analyzers:StandardDeviation",
    "Sum": "analyzers:Sum",
    "VerificationService": "service:VerificationService",
    "VerificationSuite": "verification:VerificationSuite",
    "checksum_bytes": "integrity:checksum_bytes",
    "inject": "reliability:inject",
    "obs_export": "observability.export",
    "rate_tracker": "reliability.watchdog:rate_tracker",
    "recorder": "observability.recorder:recorder",
    "trace": "observability.trace",
    "verify_checksum": "integrity:verify_checksum",
}
REF, PORT = pair(NAMES)
#: each package's device-tier phases the reference's case names
REF.device_phases = ("feature_build", "device_dispatch", "state_fetch")
PORT.device_phases = ("feature_build", "kernels", "state_fetch")
REF.summarize, PORT.summarize = ref_summarize, port_summarize

#: the port's phases that are summed into ``phase_seconds`` alone, with no
#: span (RunMonitor's docstring)
PORT_MONITOR_ONLY = ("feed_wait", "feature_build.")


@pytest.fixture(params=[REF, PORT], ids=["jax", "torch"])
def m(request):
    return request.param


def settle() -> None:
    """Join both packages' abandoned passes (their threads are named
    ``scan-watchdog-<site>``), so none records into a later test's ring."""
    for thread in threading.enumerate():
        if thread.name.startswith("scan-watchdog"):
            thread.join(timeout=60)


@pytest.fixture(autouse=True)
def _clean_recorder():
    for ns in (REF, PORT):
        ns.recorder().clear()
    yield
    settle()
    for ns in (REF, PORT):
        ns.recorder().clear()


def _data(m, rows=4096, seed=0):
    rng = np.random.default_rng(seed)
    return m.Dataset.from_dict(
        {"x": rng.normal(size=rows), "y": rng.normal(10, 2, size=rows)}
    )


def battery(m):
    return [
        m.Completeness("x"), m.Mean("x"), m.Sum("x"), m.Minimum("x"), m.Maximum("x"),
        m.StandardDeviation("x"), m.Mean("y"), m.Sum("y"),
    ]


def _check(m):
    return (
        m.Check(m.CheckLevel.ERROR, "obs battery")
        .is_complete("x")
        .has_mean("y", lambda v: 5 < v < 15)
    )


def run(m, rows=4096, **kwargs):
    kwargs.setdefault("batch_size", 1024)
    return m.AnalysisRunner.do_analysis_run(_data(m, rows), battery(m), **kwargs, **m.dev)


def phase_totals(spans):
    totals = {}
    for s in spans:
        if s.kind == "phase":
            totals[s.name] = totals.get(s.name, 0.0) + s.duration_s()
    return totals


def stall_drill(m, monkeypatch, placement="device"):
    """The reference's stall drill: warm both tiers, then a verification
    run whose first device batch stalls past a 1 s deadline."""
    for tier in ("device", "host"):
        run(m, placement=tier)
    m.recorder().clear()
    monkeypatch.setenv(m.SCAN_DEADLINE_ENV, "1.0")
    mon = m.RunMonitor()
    with m.inject(m.FaultSpec("device_update", "stall", at=1, delay_s=3.0)):
        result = (
            m.VerificationSuite.on_data(_data(m), **m.dev)
            .add_check(_check(m))
            .with_monitor(mon)
            .with_batch_size(1024)
            .with_placement(placement)
            .run()
        )
    monkeypatch.delenv(m.SCAN_DEADLINE_ENV)
    return mon, result


class TestSpanBasics:
    def test_nesting_and_ids(self, m):
        with m.trace.span("outer", kind="test") as outer:
            assert m.trace.current_span() is outer
            with m.trace.span("inner") as inner:
                assert inner.trace_id == outer.trace_id
                assert inner.parent_id == outer.span_id
                inner.add_event("hello", n=1)
        assert m.trace.current_span() is None
        spans = m.recorder().spans()
        assert [s.name for s in spans] == ["inner", "outer"]  # children finish first
        assert spans[0].events[0]["name"] == "hello"
        assert spans[0].end_ns >= spans[0].start_ns

    def test_disabled_env_suppresses_everything(self, m, monkeypatch):
        monkeypatch.setenv(m.trace.TRACE_ENV, "0")
        with m.trace.span("invisible") as sp:
            assert sp is m.trace.NULL
            assert m.trace.current_span() is None
            m.trace.add_event("nope")
        assert m.recorder().spans() == []

    def test_unsampled_root_suppresses_descendants(self, m, monkeypatch):
        monkeypatch.setenv(m.trace.TRACE_ENV, "0.000001")
        with m.trace.span("root") as root:
            with m.trace.span("child") as child:
                assert (root is m.trace.NULL) == (child is m.trace.NULL)

    def test_cross_thread_attach(self, m):
        seen = {}
        with m.trace.span("parent") as parent:
            ctx = m.trace.capture()

            def worker():
                with m.trace.attach(ctx):
                    with m.trace.span("on-thread") as sp:
                        seen["trace"] = sp.trace_id
                        seen["parent"] = sp.parent_id

            t = threading.Thread(target=worker)
            t.start()
            t.join()
        assert seen == {"trace": parent.trace_id, "parent": parent.span_id}

    def test_ring_is_bounded(self, m):
        ring = m.FlightRecorder(capacity=16)
        for i in range(64):
            ring.on_span_finish(m.trace.start_span(f"s{i}", parent=None))
        assert len(ring.spans()) == 16
        assert ring.spans()[-1].name == "s63"


class TestPhaseSpans:
    def test_phase_spans_match_phase_seconds(self, m):
        mon = m.RunMonitor()
        run(m, monitor=mon, placement="device")
        spans = m.recorder().spans()
        assert spans, "tracing is default-on"
        assert len({s.trace_id for s in spans}) == 1
        totals = phase_totals(spans)
        for phase in m.device_phases + ("metric_derivation",):
            assert phase in totals, phase
        # every span-backed phase equals the monitor's number (same clock)
        for phase, seconds in totals.items():
            assert seconds == pytest.approx(mon.phase_seconds[phase], rel=1e-6, abs=1e-9)

    def test_engine_pass_span_carries_tier(self, m):
        run(m, placement="host")
        passes = [s for s in m.recorder().spans() if s.name == "engine_pass"]
        assert passes and passes[0].attrs["tier"] == "host"

    @pytest.mark.parametrize("placement", ["device", "host"])
    def test_every_timed_phase_is_a_span(self, placement):
        """The port: each phase of ``phase_seconds`` but the monitor-only
        ones is span-backed, the host tier's ``host_partials`` (the pool's
        threads) included."""
        mon = PORT.RunMonitor()
        run(PORT, monitor=mon, placement=placement)
        timed = {p for p in mon.phase_seconds if not p.startswith(PORT_MONITOR_ONLY)}
        assert set(phase_totals(PORT.recorder().spans())) == timed


class TestCostAttribution:
    @pytest.mark.parametrize("placement", ["device", "host"])
    def test_shares_sum_to_measured_dispatch_time(self, m, placement):
        mon = m.RunMonitor()
        run(m, 16384, monitor=mon, placement=placement)
        assert mon.cost_by_analyzer, "attribution must populate"
        assert mon.bundle_dispatch_seconds > 0
        assert sum(mon.cost_by_analyzer.values()) == pytest.approx(
            mon.bundle_dispatch_seconds, rel=0.01)
        for a in battery(m):
            assert repr(a) in mon.cost_by_analyzer

    def test_merge_from_sums_dispatch_seconds(self, m):
        total = m.RunMonitor()
        for _ in range(2):
            mon = m.RunMonitor()
            run(m, monitor=mon, placement="device")
            total.merge_from(mon)
        assert sum(total.cost_by_analyzer.values()) == pytest.approx(
            total.bundle_dispatch_seconds, rel=0.01)

    def test_solo_probe_fires_periodically(self, m):
        """80 batches of 512 rows. The reference probes batches 1 and 65
        (``cost_probes`` 2); the port has no probe, since it waits for every
        batch's kernels inside its ``kernels`` phase: 80 spans."""
        mon = m.RunMonitor()
        run(m, 80 * 512, batch_size=512, monitor=mon, placement="device")
        if m is REF:
            assert mon.cost_probes == 2
        else:
            assert not hasattr(mon, "cost_probes")
            kernels = [s for s in m.recorder().spans() if s.name == "kernels"]
            assert len(kernels) == mon.device_updates == 80

    def test_verification_result_carries_cost_table(self, m):
        result = (
            m.VerificationSuite.on_data(_data(m), **m.dev)
            .add_check(_check(m))
            .with_batch_size(1024)
            .run()
        )
        assert result.cost_by_analyzer
        rows = json.loads(result.cost_by_analyzer_as_json())
        assert {r["analyzer"]: r["seconds"] for r in rows} == pytest.approx(
            result.cost_by_analyzer)

    def test_cost_series_reach_export_plane(self, m):
        with m.VerificationService(workers=2, background_warm=False, **m.svc) as svc:
            svc.verify(_data(m), [_check(m)], timeout=120)
            text = svc.prometheus_text()
        assert "deequ_service_analyzer_cost_seconds_total{" in text


class TestConnectedDegradedTrace:
    def test_device_failover_is_one_connected_trace(self, m):
        mon = m.RunMonitor()
        with m.inject(m.FaultSpec("device_update", "device", at=1)):
            ctx = run(m, monitor=mon, placement="device")
        assert mon.device_failovers == 1
        for metric in ctx.metric_map.values():
            assert metric.value.is_success
        spans = m.recorder().spans()
        passes = [s for s in spans if s.name == "engine_pass"]
        assert len(passes) == 2
        assert len({s.trace_id for s in spans}) == 1
        assert (passes[0].attrs["tier"], passes[0].status) == ("device", "error")
        assert (passes[1].attrs["tier"], passes[1].status) == ("host", "ok")
        events = [ev for s in spans for ev in s.events]
        assert any(ev["name"] == "failure" and ev["attrs"]["type"] == "DeviceFailureException"
                   for ev in events)
        assert any(ev["name"] == "device_failover" for ev in events)

    @pytest.mark.chaos
    def test_watchdog_stall_joins_the_same_trace(self, m, monkeypatch):
        mon, result = stall_drill(m, monkeypatch)
        assert mon.stalls == 1
        assert mon.device_failovers == 1
        assert result.status == m.CheckStatus.SUCCESS
        spans = m.recorder().spans()
        assert len({s.trace_id for s in spans}) == 1
        tiers = [s.attrs["tier"] for s in spans if s.name == "engine_pass"]
        assert tiers.count("host") >= 1 and tiers.count("device") >= 1
        stalls = [ev for s in spans for ev in s.events if ev["name"] == "scan_stall"]
        assert stalls and stalls[0]["attrs"]["site"] == "device"
        failures = [ev["attrs"]["type"] for s in spans for ev in s.events
                    if ev["name"] == "failure"]
        assert "ScanStallError" in failures


class TestFlightRecorder:
    def test_dump_fires_for_every_typed_failure_kind(self, m, monkeypatch, tmp_path):
        monkeypatch.setenv(m.FLIGHT_DIR_ENV, str(tmp_path))
        rec = m.recorder()
        # 1. DeviceFailure: an injected device fault, the failover path
        with m.inject(m.FaultSpec("device_update", "device", at=1)):
            run(m, placement="device")
        # 2. ScanStallError: a watchdog-cancelled stall
        monkeypatch.setenv(m.SCAN_DEADLINE_ENV, "0.2")
        with m.inject(m.FaultSpec("device_update", "stall", at=1, delay_s=2.0)):
            run(m, placement="device")
        monkeypatch.delenv(m.SCAN_DEADLINE_ENV)
        # 3. CorruptStateError: a checksum trip inside a traced region
        with m.trace.span("corrupt-drill"):
            with pytest.raises(m.CorruptStateError):
                m.verify_checksum(b"payload", "bogus", "state blob", "mem://x")
        assert m.checksum_bytes(b"payload") != "bogus"
        # 4. SchemaDriftError: a streaming session rejects a drifted batch
        with m.VerificationService(workers=1, background_warm=False, **m.svc) as svc:
            session = svc.session("t", "d", [_check(m)])
            session.ingest(_data(m, 512), timeout=120)
            drifted = m.Dataset.from_dict({"x": np.arange(8, dtype=np.float64)})
            with pytest.raises(m.SchemaDriftError):
                session.ingest(drifted, timeout=120)
        for kind in ("DeviceFailureException", "ScanStallError", "CorruptStateError",
                     "SchemaDriftError"):
            assert rec.dump_counts.get(kind, 0) >= 1, kind
        assert rec.dump_paths
        with open(rec.dump_paths[0]) as fh:
            header = json.loads(fh.readline())
        assert header["flight_record"] is True
        assert header["failures"]

    def test_dump_releases_on_unit_of_work_not_outer_root(self, m, monkeypatch, tmp_path):
        """A typed failure under a long-lived caller span dumps when the
        run's own ``analysis_run`` span closes."""
        monkeypatch.setenv(m.FLIGHT_DIR_ENV, str(tmp_path))
        rec = m.recorder()
        with m.trace.span("long-lived-poller"):
            with m.inject(m.FaultSpec("device_update", "device", at=1)):
                run(m, placement="device")
            # the artifact is there already: the outer span is still open
            assert rec.dump_counts.get("DeviceFailureException", 0) >= 1
            assert rec.dump_paths

    def test_untraced_failure_still_counts_and_dumps(self, m, monkeypatch, tmp_path):
        monkeypatch.setenv(m.FLIGHT_DIR_ENV, str(tmp_path))
        monkeypatch.setenv(m.trace.TRACE_ENV, "0")
        with pytest.raises(m.CorruptStateError):
            m.verify_checksum(b"payload", "bogus", "state blob", "mem://y")
        rec = m.recorder()
        assert rec.dump_counts.get("CorruptStateError", 0) >= 1
        assert any("untraced" in p for p in rec.dump_paths)


class TestExporters:
    def _run_and_export(self, m, tmp_path):
        run(m)
        path = str(tmp_path / "run.trace.json")
        m.obs_export.write_chrome_trace(path)
        with open(path) as fh:
            return json.load(fh)

    def test_chrome_artifact_validates_against_schema(self, m, tmp_path):
        events = self._run_and_export(m, tmp_path)["traceEvents"]
        assert events
        span_ids = set()
        for ev in events:
            assert ev["ph"] in ("X", "i")
            for key in ("name", "cat", "ts", "pid", "tid"):
                assert key in ev, f"missing {key}: {ev}"
            assert ev["ts"] >= 0
            if ev["ph"] == "X":
                assert ev["dur"] >= 0
                span_ids.add(ev["args"]["span_id"])
        for ev in events:
            parent = ev["args"].get("parent_id")
            if ev["ph"] == "X" and parent is not None:
                assert parent in span_ids, f"dangling parent ref {parent}"
            assert ev["args"]["trace_id"] is not None
        by_id = {e["args"]["span_id"]: e for e in events if e["ph"] == "X"}
        for ev in by_id.values():
            parent = ev["args"].get("parent_id")
            if parent is None:
                continue
            p = by_id[parent]
            assert ev["ts"] >= p["ts"] - 1e3  # 1 ms of clock-read slack
            assert ev["ts"] + ev["dur"] <= p["ts"] + p["dur"] + 1e3

    def test_jsonl_journal_round_trips(self, m, tmp_path):
        run(m)
        path = str(tmp_path / "run.jsonl")
        m.obs_export.write_jsonl(path)
        with open(path) as fh:
            rows = [json.loads(line) for line in fh]
        assert rows
        live = {s.span_id for s in m.recorder().spans()}
        for row in rows:
            assert row["span_id"] in live
            assert row["start_ns"] <= row["end_ns"]

    def test_trace_endpoint_serves_ring(self, m):
        import urllib.request

        run(m)
        exporter = m.MetricsExporter(m.ServiceMetrics())
        try:
            url = f"http://{exporter.host}:{exporter.port}"
            with urllib.request.urlopen(f"{url}/trace") as resp:
                assert json.loads(resp.read())["traceEvents"]
            with urllib.request.urlopen(f"{url}/trace.jsonl") as resp:
                lines = resp.read().decode().strip().splitlines()
            assert lines and json.loads(lines[0])["span_id"]
        finally:
            exporter.close()


class TestTraceSummarize:
    def test_summary_from_degraded_run_artifact(self, m, tmp_path):
        with m.inject(m.FaultSpec("device_update", "device", at=1)):
            run(m, placement="device")
        chrome = str(tmp_path / "degraded.trace.json")
        m.obs_export.write_chrome_trace(chrome)
        spans = m.summarize.load_spans(chrome)
        assert spans
        path = m.summarize.critical_path(spans)
        assert path and path[0]["parent_id"] is None
        for parent, child in zip(path, path[1:]):
            assert child["parent_id"] == parent["span_id"]
        degrade = m.summarize.degradations(spans)
        assert any(ev["name"] == "device_failover" for _, _, ev in degrade)
        text = m.summarize.summarize(chrome)
        assert "critical path:" in text
        assert "device_failover" in text
        assert "top 5 spans by self-time:" in text

    def test_summary_reads_jsonl_too(self, m, tmp_path):
        run(m)
        path = str(tmp_path / "run.jsonl")
        m.obs_export.write_jsonl(path)
        text = m.summarize.summarize(path)
        assert "critical path:" in text
        assert "(none — clean run)" in text


class TestOverheadGuards:
    def test_tracing_off_still_counts_costs(self, m, monkeypatch):
        monkeypatch.setenv(m.trace.TRACE_ENV, "0")
        mon = m.RunMonitor()
        run(m, monitor=mon, placement="device")
        assert m.recorder().spans() == []
        assert mon.cost_by_analyzer
        assert mon.phase_seconds  # phase timers unaffected

    def test_rate_tracker_unaffected_by_tracing(self, m):
        m.rate_tracker().clear()
        m.AnalysisRunner.do_analysis_run(_data(m), [m.Mean("x")], batch_size=1024, **m.dev)
        key = "device" if m is REF else rate_key("device", torch.device("cpu"))
        assert m.rate_tracker().per_row_s(key) is not None


# ---------------------------------------------------------------------------
# the two packages' span trees, run for run
# ---------------------------------------------------------------------------


def span_tree(m):
    """Each non-phase span of ``m``'s ring as (name, kind, parent's name,
    status, its tier/checks/analyzers attributes, its events' names),
    sorted; plus the number of traces."""
    spans = m.recorder().spans()
    by_id = {s.span_id: s for s in spans}
    rows = []
    for s in spans:
        if s.kind == "phase":
            continue
        parent = by_id.get(s.parent_id)
        rows.append((
            s.name, s.kind, None if parent is None else parent.name, s.status,
            tuple((k, s.attrs[k]) for k in ("tier", "checks", "analyzers") if k in s.attrs),
            tuple(sorted(ev["name"] for ev in s.events)),
        ))
    return sorted(rows, key=repr), len({s.trace_id for s in spans})


def _device_run(m, monkeypatch):
    run(m, placement="device")


def _host_run(m, monkeypatch):
    run(m, placement="host")


def _verification_run(m, monkeypatch):
    (m.VerificationSuite.on_data(_data(m), **m.dev).add_check(_check(m))
     .with_batch_size(1024).with_placement("device").run())


def _failover_run(m, monkeypatch):
    with m.inject(m.FaultSpec("device_update", "device", at=1)):
        run(m, placement="device")


def _stall_run(m, monkeypatch):
    stall_drill(m, monkeypatch)
    settle()


@pytest.mark.parametrize("drive", [_device_run, _host_run, _verification_run, _failover_run,
                                   pytest.param(_stall_run, marks=pytest.mark.chaos)],
                         ids=["device", "host", "verification", "failover", "stall"])
def test_span_trees_equal(drive, monkeypatch):
    trees = []
    for ns in (REF, PORT):
        ns.recorder().clear()
        drive(ns, monkeypatch)
        trees.append(span_tree(ns))
    assert trees[1] == trees[0]
    assert trees[0][1] == 1  # one trace


# ---------------------------------------------------------------------------
# the FS metrics repository's repository_load site
# ---------------------------------------------------------------------------


class TestRepositoryLoad:
    def test_corrupt_quarantines_the_whole_file(self, m, tmp_path):
        """An injected ``corrupt`` at ``repository_load`` quarantines the
        whole history file: the read serves an empty history, the monitor
        counts one quarantine, and the span carries the event."""
        path = str(tmp_path / "history.json")
        monitor = m.RunMonitor()
        repo = m.FileSystemMetricsRepository(path, monitor=monitor)
        repo.save(m.ResultKey(1), run(m, placement="device"))
        m.recorder().clear()
        with m.trace.span("history-read"):
            with m.inject(m.FaultSpec("repository_load", "corrupt", at=1)) as inj:
                assert repo._read_all() == []
        assert inj.fired
        assert monitor.corrupt_quarantined == 1
        assert repo.quarantines == 1
        (span,) = m.recorder().spans()
        assert [ev["name"] for ev in span.events] == ["repository_quarantined"]
        assert span.events[0]["attrs"]["kind"] == "file"
        assert (tmp_path / "history.json.quarantine").is_dir()
        # the file itself is kept: the next read serves it
        assert len(repo._read_all()) == 1
