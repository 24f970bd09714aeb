"""Trace propagation in the PyTorch/CUDA port against the JAX reference:
every case of ``tests/test_trace_propagation.py`` through both packages
(``m`` is either package, the port's service on ``device="cpu"``): the
``X-Deequ-Trace`` wire format, deterministic sampling across two
processes, the HTTP ingest endpoint's propagation, a cluster worker's
protocol spans, the span journal and the summariser's orphan accounting.

Then orphan accounting over the runs whose spans come from threads of
their own: a host-tier run (the pool's ``host_partials``) and a
feed-depth-2 run (the feed thread's ``feature_build``). Each is one trace
with one root and no orphan, and the thread's phase spans sum to its
``phase_seconds`` within 1e-6 relative (1e-9 s absolute).
"""

from __future__ import annotations

import io
import json
import os
import subprocess
import sys

import numpy as np
import pyarrow as pa
import pytest

import tools.torch_trace_summarize as port_summarize
import tools.trace_summarize as ref_summarize
from torch_pairs import pair, reference_isolated  # noqa: F401 (autouse)

pytestmark = pytest.mark.trace

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

NAMES = {
    "AnalysisRunner": "runners.analysis_runner:AnalysisRunner",
    "Check": "checks:Check",
    "CheckLevel": "checks:CheckLevel",
    "Dataset": "data:Dataset",
    "IngestEndpoint": "ingest.endpoint:IngestEndpoint",
    "LocalWorker": "cluster:LocalWorker",
    "Mean": "analyzers:Mean",
    "RunMonitor": "runners.engine:RunMonitor",
    "StandardDeviation": "analyzers:StandardDeviation",
    "TRACE_HOST_ENV": "observability.recorder:TRACE_HOST_ENV",
    "TRACE_JOURNAL_ENV": "observability.recorder:TRACE_JOURNAL_ENV",
    "VerificationService": "service:VerificationService",
    "encode_ipc_stream": "ingest:encode_ipc_stream",
    "obs_export": "observability.export",
    "recorder": "observability.recorder:recorder",
    "trace": "observability.trace",
}
REF, PORT = pair(NAMES)
REF.summarize, PORT.summarize = ref_summarize, port_summarize


@pytest.fixture(params=[REF, PORT], ids=["jax", "torch"])
def m(request):
    return request.param


@pytest.fixture(autouse=True)
def _clean_recorder():
    for ns in (REF, PORT):
        ns.recorder().clear()
    yield
    for ns in (REF, PORT):
        ns.recorder().clear()


def _checks(m):
    return [m.Check(m.CheckLevel.ERROR, "wire battery").has_size(lambda n: n > 0)
            .is_complete("x")]


def _payload(m, rows=512, seed=3):
    rng = np.random.default_rng(seed)
    table = pa.table({"x": rng.normal(size=rows), "y": rng.normal(10.0, 2.0, size=rows)})
    return m.encode_ipc_stream(table)


# ---------------------------------------------------------------------------
# wire format: inject / extract
# ---------------------------------------------------------------------------


class TestWireFormat:
    def test_inject_extract_round_trip(self, m):
        with m.trace.span("origin", kind="rpc") as origin:
            header = m.trace.inject()
            assert header == f"{origin.trace_id};{origin.span_id};1"
        ctx = m.trace.extract(header)
        assert isinstance(ctx, m.trace.TraceContext)
        assert ctx.to_header() == header
        child = m.trace.start_span("remote_side", kind="rpc", parent=ctx)
        assert child.trace_id == origin.trace_id
        assert child.parent_id == origin.span_id
        child.finish()

    def test_inject_without_context_sends_no_header(self, m):
        assert m.trace.inject() is None

    def test_explicit_span_injects_its_own_identity(self, m):
        with m.trace.span("outer", kind="rpc") as outer:
            with m.trace.span("inner", kind="rpc") as inner:
                assert m.trace.inject(outer) == f"{outer.trace_id};{outer.span_id};1"
                assert m.trace.inject() == f"{inner.trace_id};{inner.span_id};1"

    def test_suppression_crosses_the_wire(self, m, monkeypatch):
        monkeypatch.setenv(m.trace.TRACE_ENV, "0")
        root = m.trace.start_span("off", kind="rpc", parent=None)
        assert root is m.trace.NULL
        header = m.trace.inject(root)
        assert header == ";;0"
        remote_parent = m.trace.extract(header)
        assert remote_parent is m.trace.NULL
        # the remote side starts no fresh root for half a trace
        assert m.trace.start_span("remote", kind="rpc", parent=remote_parent) is m.trace.NULL

    @pytest.mark.parametrize(
        "bad", [None, "", "tid;sid", "a;b;c;d", "tid;;1", ";sid;1", "tid;sid;2"])
    def test_malformed_headers_degrade_to_fresh_root(self, m, bad):
        assert m.trace.extract(bad) is None


# ---------------------------------------------------------------------------
# deterministic fractional sampling
# ---------------------------------------------------------------------------


class TestDeterministicSampling:
    def test_verdict_is_pure_function_of_trace_id(self, m):
        ids = [f"t-{i}" for i in range(256)]
        verdicts = [m.trace.sampled_trace(t, 0.5) for t in ids]
        assert verdicts == [m.trace.sampled_trace(t, 0.5) for t in ids]
        assert any(verdicts) and not all(verdicts)

    def test_rate_bounds(self, m):
        assert m.trace.sampled_trace("anything", 1.0) is True
        assert m.trace.sampled_trace("anything", 0.0) is False

    def test_two_processes_agree_per_trace_id(self, m):
        """A second process reading the same ``DEEQU_TPU_TRACE`` fraction
        reaches the same verdict for every trace id, and so does the other
        package."""
        ids = [f"cross-{i}" for i in range(64)]
        program = (
            "import json, sys\n"
            f"from {m.root}.observability.trace import sampled_trace\n"
            "ids = json.load(sys.stdin)\n"
            "print(json.dumps([sampled_trace(t) for t in ids]))\n"
        )
        env = dict(os.environ, DEEQU_TPU_TRACE="0.5", JAX_PLATFORMS="cpu")
        proc = subprocess.run(
            [sys.executable, "-c", program], input=json.dumps(ids), capture_output=True,
            text=True, env=env, cwd=_REPO_ROOT, timeout=240,
        )
        assert proc.returncode == 0, proc.stderr
        remote = json.loads(proc.stdout.strip().splitlines()[-1])
        local = [m.trace.sampled_trace(t, 0.5) for t in ids]
        assert remote == local
        assert local == [REF.trace.sampled_trace(t, 0.5) for t in ids]
        assert any(local) and not all(local)


# ---------------------------------------------------------------------------
# the Arrow ingest wire: X-Deequ-Trace through the HTTP endpoint
# ---------------------------------------------------------------------------


@pytest.fixture()
def service(m):
    with m.VerificationService(workers=2, max_queue_depth=64, background_warm=False,
                               **m.svc) as svc:
        yield svc


def _post(m, endpoint, body, header=None):
    headers = {"Content-Length": str(len(body))}
    if header is not None:
        headers[m.trace.TRACE_HEADER] = header
    return endpoint.handle_post("/ingest/v1/t/d", headers, io.BytesIO(body))


def _requests(m):
    return [s for s in m.recorder().spans() if s.name == "ingest_request"]


class TestEndpointPropagation:
    def test_header_joins_remote_trace(self, m, service):
        service.session("t", "d", _checks(m))
        endpoint = m.IngestEndpoint(service)
        status, resp = _post(m, endpoint, _payload(m), header="t-producer;s-producer;1")
        assert status == 200, resp
        requests = _requests(m)
        assert len(requests) == 1
        assert requests[0].trace_id == "t-producer"
        assert requests[0].parent_id == "s-producer"
        assert requests[0].status == "ok"
        # the fold under the request rides the remote trace too
        joined = [s for s in m.recorder().spans() if s.trace_id == "t-producer"]
        assert len(joined) >= 2

    def test_no_header_starts_fresh_root(self, m, service):
        service.session("t", "d", _checks(m))
        endpoint = m.IngestEndpoint(service)
        status, _ = _post(m, endpoint, _payload(m))
        assert status == 200
        requests = _requests(m)
        assert len(requests) == 1
        assert requests[0].parent_id is None
        assert requests[0].trace_id

    def test_suppressed_header_keeps_no_spans(self, m, service):
        service.session("t", "d", _checks(m))
        endpoint = m.IngestEndpoint(service)
        m.recorder().clear()
        status, _ = _post(m, endpoint, _payload(m), header=";;0")
        assert status == 200  # suppression never affects the fold itself
        assert _requests(m) == []

    def test_error_status_marks_span(self, m, service):
        endpoint = m.IngestEndpoint(service)
        status, _ = _post(m, endpoint, _payload(m), header="t-err;s-err;1")
        assert status == 404  # no such session
        requests = _requests(m)
        assert len(requests) == 1
        assert requests[0].status == "error"
        assert requests[0].trace_id == "t-err"


# ---------------------------------------------------------------------------
# a cluster worker's protocol spans join the front's trace
# ---------------------------------------------------------------------------


class TestWorkerSpans:
    def _batch(self, i=0, rows=16):
        base = float(i * rows)
        return {"x": np.arange(base, base + rows, dtype=np.float64),
                "y": np.ones(rows, dtype=np.float64)}

    def test_protocol_spans_join_remote_trace(self, m, tmp_path):
        svc = m.VerificationService(workers=1, background_warm=False,
                                    partition_store=str(tmp_path / "store"), **m.svc)
        worker = m.LocalWorker("w0", svc)
        try:
            worker.open_session("t", "d", _checks(m), trace_ctx="t-front;s-open;1")
            worker.ingest("t", "d", self._batch(), trace_ctx="t-front;s-ingest;1")
            worker.flush("t", "d", trace_ctx="t-front;s-flush;1")
        finally:
            worker.close()
        by_name = {s.name: s for s in m.recorder().spans()}
        for name, parent in (("worker_open", "s-open"), ("worker_ingest", "s-ingest"),
                             ("worker_flush", "s-flush")):
            sp = by_name[name]
            assert sp.trace_id == "t-front"
            assert sp.parent_id == parent
            assert sp.kind == "cluster"
            assert sp.attrs["host"] == "w0"

    def test_without_ctx_worker_starts_its_own_root(self, m):
        svc = m.VerificationService(workers=1, background_warm=False, **m.svc)
        worker = m.LocalWorker("w1", svc)
        try:
            worker.open_session("t", "d", _checks(m))
            worker.ingest("t", "d", self._batch())
        finally:
            worker.close()
        ingest = [s for s in m.recorder().spans() if s.name == "worker_ingest"]
        assert len(ingest) == 1
        assert ingest[0].parent_id is None


# ---------------------------------------------------------------------------
# per-host span journals and the multi-host merge
# ---------------------------------------------------------------------------


class TestSpanJournal:
    def test_journal_header_and_line_per_span(self, m, tmp_path, monkeypatch):
        monkeypatch.setenv(m.TRACE_JOURNAL_ENV, str(tmp_path))
        monkeypatch.setenv(m.TRACE_HOST_ENV, "alpha")
        m.recorder().clear()  # re-probe the journal env
        with m.trace.span("unit_alpha", kind="span"):
            pass
        path = tmp_path / "spans-alpha.jsonl"
        # line-buffered: readable without closing
        lines = [json.loads(line) for line in path.read_text().splitlines()]
        assert lines[0]["journal_header"] is True
        assert lines[0]["host"] == "alpha"
        assert "epoch_anchor_s" in lines[0]
        assert lines[1]["name"] == "unit_alpha"
        assert lines[1]["span_id"]

    def _write_host_journals(self, m, tmp_path, monkeypatch):
        for host in ("alpha", "beta"):
            monkeypatch.setenv(m.TRACE_JOURNAL_ENV, str(tmp_path))
            monkeypatch.setenv(m.TRACE_HOST_ENV, host)
            m.recorder().clear()
            with m.trace.span(f"work_{host}", kind="span"):
                pass
        m.recorder().clear()
        journals = sorted(str(p) for p in tmp_path.glob("spans-*.jsonl"))
        assert len(journals) == 2
        return journals

    def test_merge_journals_one_timeline(self, m, tmp_path, monkeypatch):
        journals = self._write_host_journals(m, tmp_path, monkeypatch)
        out = tmp_path / "merged.trace.json"
        doc = m.obs_export.merge_journals(journals, out_path=str(out))
        hosts = {e["args"]["name"] for e in doc["traceEvents"] if e.get("ph") == "M"}
        assert hosts == {"alpha", "beta"}
        pids = {e["pid"] for e in doc["traceEvents"] if e.get("ph") == "X"}
        assert len(pids) == 2  # one track per journal
        assert len(doc["otherData"]["journals"]) == 2
        spans = m.summarize.load_spans(str(out))
        assert {s["name"] for s in spans} == {"work_alpha", "work_beta"}

    def test_summarizer_reads_a_journal_directory(self, m, tmp_path, monkeypatch):
        self._write_host_journals(m, tmp_path, monkeypatch)
        spans = m.summarize.load_spans(str(tmp_path))
        assert {s["name"] for s in spans} == {"work_alpha", "work_beta"}
        assert "2 distinct trace_ids" in m.summarize.summarize(str(tmp_path))

    def test_torn_final_line_is_skipped_not_fatal(self, m, tmp_path):
        path = tmp_path / "spans-torn.jsonl"
        good = {
            "trace_id": "t1", "span_id": "a", "parent_id": None, "name": "ok",
            "kind": "span", "start_ns": 0, "end_ns": 5, "status": "ok", "thread": 0,
            "attrs": {}, "events": [],
        }
        path.write_text(
            json.dumps({"journal_header": True, "host": "torn", "pid": 1,
                        "epoch_anchor_s": 0.0}) + "\n"
            + json.dumps(good) + "\n"
            + '{"trace_id": "t1", "span_id": "b", "star'  # a SIGKILL's tear
        )
        header, spans, skipped = m.obs_export.load_journal(str(path))
        assert header["host"] == "torn"
        assert [s["span_id"] for s in spans] == ["a"]
        assert skipped == 1


# ---------------------------------------------------------------------------
# orphan accounting in the summariser
# ---------------------------------------------------------------------------


def _synthetic_spans(with_orphan=True):
    base = {"kind": "span", "status": "ok", "thread": 0, "attrs": {}, "events": []}
    spans = [
        dict(base, trace_id="t1", span_id="a", parent_id=None, name="root", start_ns=0,
             end_ns=10),
        dict(base, trace_id="t1", span_id="b", parent_id="a", name="child", start_ns=1,
             end_ns=5),
    ]
    if with_orphan:
        spans.append(dict(base, trace_id="t1", span_id="c", parent_id="missing", name="lost",
                          start_ns=2, end_ns=4))
    return spans


class TestOrphanAccounting:
    def test_span_accounting_counts(self, m):
        acct = m.summarize.span_accounting(_synthetic_spans())
        assert acct == {"total": 3, "roots": 1, "orphans": 1, "trace_ids": 1}

    def test_summarize_warns_on_orphans(self, m, tmp_path):
        path = tmp_path / "spans.jsonl"
        path.write_text("".join(json.dumps(s) + "\n" for s in _synthetic_spans()))
        text = m.summarize.summarize(str(path))
        assert "1 orphaned" in text
        assert "WARNING: orphaned spans" in text

    def test_clean_artifact_has_no_warning(self, m, tmp_path):
        path = tmp_path / "spans.jsonl"
        path.write_text("".join(json.dumps(s) + "\n"
                                for s in _synthetic_spans(with_orphan=False)))
        text = m.summarize.summarize(str(path))
        assert "0 orphaned" in text
        assert "WARNING" not in text


class TestThreadSpansOrphanFree:
    """The spans that threads of a pass's own record: the host tier's pool
    and the device tier's feed thread carry the pass's trace context."""

    def _run_and_account(self, m, tmp_path, placement):
        rng = np.random.default_rng(0)
        data = m.Dataset.from_dict({"x": rng.normal(size=8192),
                                    "y": rng.normal(10, 2, size=8192)})
        mon = m.RunMonitor()
        m.AnalysisRunner.do_analysis_run(
            data, [m.Mean("x"), m.StandardDeviation("y")], batch_size=1024, monitor=mon,
            placement=placement, **m.dev)
        path = str(tmp_path / "run.jsonl")
        m.obs_export.write_jsonl(path)
        spans = m.summarize.load_spans(path)
        assert m.summarize.span_accounting(spans) == {
            "total": len(spans), "roots": 1, "orphans": 0, "trace_ids": 1}
        assert "0 orphaned" in m.summarize.summarize(path)
        return mon, spans

    @staticmethod
    def _span_seconds(spans, phase):
        return sum(s["end_ns"] - s["start_ns"] for s in spans if s["name"] == phase) / 1e9

    def test_host_tier_pool(self, m, tmp_path):
        mon, spans = self._run_and_account(m, tmp_path, "host")
        assert self._span_seconds(spans, "host_partials") == pytest.approx(
            mon.phase_seconds["host_partials"], rel=1e-6, abs=1e-9)

    def test_feed_depth_two(self, m, tmp_path, monkeypatch):
        monkeypatch.setenv("DEEQU_TPU_PREFETCH_DEPTH", "2")
        mon, spans = self._run_and_account(m, tmp_path, "device")
        assert self._span_seconds(spans, "feature_build") == pytest.approx(
            mon.phase_seconds["feature_build"], rel=1e-6, abs=1e-9)
