"""The ingestion plane of the PyTorch/CUDA port (deequ_tpu_torch.ingest:
the row gate, the Arrow IPC stream, its fault kinds and the HTTP
endpoint on 127.0.0.1) against the JAX reference: the cases of
``tests/test_rowgate.py`` and ``tests/test_ingest.py`` run through both
packages (``m`` is either package, its service on the CPU), then the same
frames go through both packages' gated sessions and endpoints.

Tolerances: bit for bit between feeds and between gated and pre-filtered
streams within one package, as in the reference; across the packages
moments agree within 1e-12 relative and everything else exactly.
"""

import json
import threading
import time

import numpy as np
import pyarrow as pa
import pytest

from torch_pairs import pair, reference_isolated  # noqa: F401 (autouse)

pytestmark = pytest.mark.ingest

NAMES = {
    'AnalysisRunner': 'runners:AnalysisRunner',
    'ApproxCountDistinct': 'analyzers:ApproxCountDistinct',
    'BoundedReader': 'ingest.arrow_stream:BoundedReader',
    'CHECKSUM_HEADER': 'ingest:CHECKSUM_HEADER',
    'Check': 'checks:Check',
    'CheckLevel': 'checks:CheckLevel',
    'CheckStatus': 'checks:CheckStatus',
    'Completeness': 'analyzers:Completeness',
    'Dataset': 'data:Dataset',
    'FAULT_KINDS': 'reliability.faults:FAULT_KINDS',
    'FaultSpec': 'reliability:FaultSpec',
    'FeedDisconnectError': 'exceptions:FeedDisconnectError',
    'FrameQuarantinedError': 'ingest:FrameQuarantinedError',
    'MalformedFrameError': 'exceptions:MalformedFrameError',
    'Mean': 'analyzers:Mean',
    'MetricCalculationRuntimeException': 'exceptions:MetricCalculationRuntimeException',
    'QuarantineSidecar': 'ingest:QuarantineSidecar',
    'RowGate': 'ingest:RowGate',
    'RowLevelSchema': 'schema:RowLevelSchema',
    'RowLevelSchemaValidator': 'schema:RowLevelSchemaValidator',
    'RunMonitor': 'runners.engine:RunMonitor',
    'SchemaDriftError': 'exceptions:SchemaDriftError',
    'ServiceMetrics': 'service.metrics:ServiceMetrics',
    'ServiceOverloaded': 'service:ServiceOverloaded',
    'StandardDeviation': 'analyzers:StandardDeviation',
    'Sum': 'analyzers:Sum',
    'VerificationService': 'service:VerificationService',
    'VerificationSuite': 'verification:VerificationSuite',
    'as_dataset': 'ingest:as_dataset',
    'checksum_bytes': 'integrity:checksum_bytes',
    'encode_ipc_stream': 'ingest:encode_ipc_stream',
    'faults': 'reliability.faults',
    'fold_stream': 'ingest:fold_stream',
    'inject': 'reliability:inject',
    'iter_frames': 'ingest:iter_frames',
    'streaming_mod': 'service.streaming',
}
REF, PORT = pair(NAMES)


@pytest.fixture(params=[REF, PORT], ids=["jax", "torch"])
def m(request):
    return request.param


# ---------------------------------------------------------------------------
# the row gate (the cases of tests/test_rowgate.py)
# ---------------------------------------------------------------------------




def _split_via_gate(m, data, schema, tmp_path=None):
    """Run one frame through a fresh RowGate; returns (accepted_dataset,
    rejected_table_or_None). A full rejection surfaces as (None, table)."""
    sidecar = m.QuarantineSidecar(str(tmp_path / "q")) if tmp_path else None
    gate = m.RowGate(schema, sidecar=sidecar, metrics=m.ServiceMetrics())
    try:
        accepted = gate.split(data, "t", "d")
    except m.FrameQuarantinedError:
        accepted = None
    rejected = sidecar.read_all("t", "d") if sidecar else None
    return accepted, rejected


#: the reference RowLevelSchemaValidatorTest scenarios: (columns,
#: schema builder, expected valid count). Each runs through the batch
#: validator AND the streaming gate, and both must agree row for row.
_SCENARIOS = [
    (
        "int_cast_non_nullable",
        {"id": ["1", "2", "not-a-number", "4", None],
         "name": list("abcde")},
        lambda s: s.with_int_column("id", is_nullable=False),
        3,
    ),
    (
        "int_bounds",
        {"v": ["5", "15", "25"]},
        lambda s: s.with_int_column("v", min_value=10, max_value=20),
        1,
    ),
    (
        "string_length_and_regex",
        {"code": ["AB", "ABC", "ABCD", "xy", None]},
        lambda s: s.with_string_column(
            "code", min_length=2, max_length=3, matches="^[A-Z]+$"
        ),
        3,
    ),
    (
        "non_nullable_string",
        {"x": ["a", None, "b"]},
        lambda s: s.with_string_column("x", is_nullable=False),
        2,
    ),
    (
        "decimal_precision_scale",
        {"d": ["12.34", "123456.7", "abc"]},
        lambda s: s.with_decimal_column("d", precision=6, scale=2),
        1,
    ),
    (
        "timestamp_mask",
        {"ts": ["2024-01-31 10:30:00", "not a date",
                "2024-13-99 99:99:99"]},
        lambda s: s.with_timestamp_column("ts", mask="yyyy-MM-dd HH:mm:ss"),
        1,
    ),
    (
        "multi_column_cnf",
        {"id": ["1", "2", "x"], "name": ["alice", "bob", "carol"]},
        lambda s: (s.with_int_column("id", is_nullable=False)
                   .with_string_column("name", max_length=5)),
        2,
    ),
]


class TestGateValidatorParity:
    @pytest.mark.parametrize(
        "name,columns,build,expected_valid",
        _SCENARIOS, ids=[s[0] for s in _SCENARIOS],
    )
    def test_identical_verdicts(
        self, m, name, columns, build, expected_valid, tmp_path
    ):
        data = m.Dataset.from_dict(columns)
        schema = build(m.RowLevelSchema())
        result = m.RowLevelSchemaValidator.validate(data, schema)
        assert result.num_valid_rows == expected_valid

        accepted, rejected = _split_via_gate(m, data, schema, tmp_path)
        gate_valid = 0 if accepted is None else accepted.num_rows
        gate_invalid = 0 if rejected is None else rejected.num_rows
        assert gate_valid == result.num_valid_rows
        assert gate_invalid == result.num_invalid_rows

    def test_cast_semantics_differ_by_design(self, m):
        """The VALIDATOR casts its valid side (string "1" becomes int 1,
        the reference's `castColumn`); the GATE keeps the original Arrow
        buffers untouched so clean rows fold bit-exact. Same verdicts,
        different output types — pinned so nobody 'fixes' one into the
        other."""
        data = m.Dataset.from_dict({"id": ["1", "2", "x"]})
        schema = m.RowLevelSchema().with_int_column("id")
        result = m.RowLevelSchemaValidator.validate(data, schema)
        assert list(result.valid_rows.to_pandas()["id"]) == [1, 2]

        accepted, _ = _split_via_gate(m, data, schema)
        assert accepted.arrow.column("id").to_pylist() == ["1", "2"]
        assert pa.types.is_string(
            accepted.arrow.schema.field("id").type
        ) or pa.types.is_large_string(accepted.arrow.schema.field("id").type)


class TestRowGate:
    def _schema(self, m):
        return (m.RowLevelSchema()
                .with_int_column("id", is_nullable=False)
                .with_string_column("s", max_length=3))

    def test_all_conforming_is_zero_copy_passthrough(self, m):
        data = m.Dataset.from_dict({"id": ["1", "2"], "s": ["ab", "cd"]})
        gate = m.RowGate(self._schema(m), metrics=m.ServiceMetrics())
        assert gate.split(data, "t", "d") is data

    def test_quarantine_decodes_back_to_exact_rejects(self, m, tmp_path):
        data = m.Dataset.from_dict({
            "id": ["1", "nope", "3", "4"],
            "s": ["ok", "ok", "way-too-long", "ok"],
        })
        accepted, rejected = _split_via_gate(m, data, self._schema(m), tmp_path)
        assert accepted.num_rows == 2
        assert accepted.arrow.column("id").to_pylist() == ["1", "4"]
        assert rejected.num_rows == 2
        assert sorted(rejected.column("id").to_pylist()) == ["3", "nope"]
        assert sorted(rejected.column("s").to_pylist()) == [
            "ok", "way-too-long"
        ]

    def test_full_rejection_raises_typed_and_counts(self, m, tmp_path):
        metrics = m.ServiceMetrics()
        sidecar = m.QuarantineSidecar(str(tmp_path / "q"))
        gate = m.RowGate(self._schema(m), sidecar=sidecar, metrics=metrics)
        data = m.Dataset.from_dict({"id": ["x", "y"], "s": ["ab", "cd"]})
        with pytest.raises(m.FrameQuarantinedError) as exc_info:
            gate.split(data, "t", "d")
        assert exc_info.value.tenant == "t"
        assert exc_info.value.rows == 2
        assert metrics.counter_value(
            "deequ_service_rowgate_quarantined_frames_total",
            tenant="t", dataset="d",
        ) == 1
        assert sidecar.read_all("t", "d").num_rows == 2

    def test_quarantine_budget_drops_counted(self, m, tmp_path):
        metrics = m.ServiceMetrics()
        sidecar = m.QuarantineSidecar(str(tmp_path / "q"), max_rows=3)
        gate = m.RowGate(self._schema(m), sidecar=sidecar, metrics=metrics)
        data = m.Dataset.from_dict({
            "id": ["bad"] * 5 + ["1"],
            "s": ["x"] * 6,
        })
        accepted = gate.split(data, "t", "d")
        assert accepted.num_rows == 1
        assert sidecar.rows_written == 3 and sidecar.rows_dropped == 2
        assert sidecar.read_all("t", "d").num_rows == 3
        assert metrics.counter_value(
            "deequ_service_rowgate_quarantine_dropped_rows_total",
            tenant="t", dataset="d",
        ) == 2
        assert metrics.counter_value(
            "deequ_service_rowgate_rejected_rows_total",
            tenant="t", dataset="d",
        ) == 5  # dropped rows still COUNT as rejected

    def test_row_gate_fault_site(self, m):
        gate = m.RowGate(self._schema(m), metrics=m.ServiceMetrics())
        data = m.Dataset.from_dict({"id": ["1"], "s": ["ab"]})

        with m.inject(m.FaultSpec("row_gate", "corrupt", at=1)) as inj:
            with pytest.raises(m.MetricCalculationRuntimeException):
                gate.split(data, "t", "d")
        assert inj.fired == ["row_gate:t/d:corrupt"]

    def test_gated_fold_bit_exact_with_prefiltered(self, m):
        """Folding the gate's accept side must equal folding a
        pre-filtered copy of the stream, metric for metric — the accept
        side is an Arrow filter of the ORIGINAL buffers, no pandas hop,
        no cast."""
        rng = np.random.default_rng(7)
        ids = np.arange(600)
        vals = rng.normal(10.0, 2.0, size=600)
        good = ids % 3 != 0  # a third of rows nonconforming (id < 0 gate)
        gated_ids = np.where(good, ids, -ids - 1)
        checks = [m.Check(m.CheckLevel.ERROR, "c")
                  .has_size(lambda n: n > 0)
                  .has_mean("v", lambda m: True)
                  .has_sum("v", lambda s: True)]
        schema = m.RowLevelSchema().with_int_column("id", min_value=0)
        gate = m.RowGate(schema, metrics=m.ServiceMetrics())
        with m.VerificationService(workers=2, background_warm=False, **m.svc) as svc:
            gated = svc.session("t", "gated", checks, row_gate=gate)
            plain = svc.session("t", "plain", checks)
            for lo in range(0, 600, 200):
                sl = slice(lo, lo + 200)
                gated.ingest({"id": gated_ids[sl], "v": vals[sl]})
                keep = good[sl]
                plain.ingest({
                    "id": gated_ids[sl][keep], "v": vals[sl][keep]
                })
            rg = gated.current()
            rp = plain.current()
            mg = {(a.name, a.instance): mt.value.get()
                  for a, mt in rg.metrics.items() if mt.value.is_success}
            mp = {(a.name, a.instance): mt.value.get()
                  for a, mt in rp.metrics.items() if mt.value.is_success}
            assert mg == mp  # bit-exact, not approx
            assert gated.rows_ingested == int(good.sum())


class TestSessionIntegration:
    def test_partial_reject_folds_clean_rows(self, m, tmp_path):
        schema = m.RowLevelSchema().with_int_column("id", min_value=0)
        with m.VerificationService(workers=2, background_warm=False, **m.svc) as svc:
            gate = m.RowGate(
                schema,
                sidecar=m.QuarantineSidecar(str(tmp_path / "q")),
                metrics=svc.metrics,
            )
            session = svc.session(
                "t", "d",
                [m.Check(m.CheckLevel.ERROR, "c").has_size(lambda n: n > 0)],
                row_gate=gate,
            )
            session.ingest({"id": np.array([1, -2, 3, -4, 5])})
            assert session.rows_ingested == 3
            assert svc.metrics.counter_value(
                "deequ_service_rowgate_rejected_rows_total",
                tenant="t", dataset="d",
            ) == 2
            q = gate.sidecar.read_all("t", "d")
            assert q.column("id").to_pylist() == [-2, -4]

    def test_reconfigure_swaps_gate_live(self, m):
        schema_strict = m.RowLevelSchema().with_int_column("id", min_value=0)
        with m.VerificationService(workers=2, background_warm=False, **m.svc) as svc:
            session = svc.session(
                "t", "d",
                [m.Check(m.CheckLevel.ERROR, "c").has_size(lambda n: n > 0)],
                row_gate=m.RowGate(schema_strict, metrics=svc.metrics),
            )
            with pytest.raises(m.FrameQuarantinedError):
                session.ingest({"id": np.array([-1, -2])})
            session.reconfigure(row_gate=None)  # explicit removal
            session.ingest({"id": np.array([-1, -2])})
            assert session.rows_ingested == 2


# ---------------------------------------------------------------------------
# the Arrow IPC plane, the endpoint and the fault kinds (the cases of
# tests/test_ingest.py)
# ---------------------------------------------------------------------------




def _checks(m):
    return [
        m.Check(m.CheckLevel.ERROR, "ingest")
        .has_size(lambda n: n > 0)
        .is_complete("x")
        .has_mean("y", lambda m: 0.0 < m < 20.0),
    ]


def _table(rows=2000, seed=0, nulls=True):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=rows)
    y = rng.normal(10.0, 2.0, size=rows)
    y_mask = (rng.random(rows) < 0.05) if nulls else np.zeros(rows, bool)
    cats = np.array(["alpha", "beta", "gamma", "delta"])
    c = cats[rng.integers(0, len(cats), rows)].astype(object)
    if nulls:
        c[rng.random(rows) < 0.03] = None
    return pa.table({
        "x": pa.array(x),
        "y": pa.array(y, mask=y_mask),
        "c": pa.array(c).dictionary_encode(),
    })


def _success_metrics(result):
    return {
        (a.name, a.instance): mt.value.get()
        for a, mt in result.metrics.items() if mt.value.is_success
    }


@pytest.fixture
def service(m):
    with m.VerificationService(
        workers=2, max_queue_depth=64, background_warm=False, **m.svc
    ) as svc:
        yield svc


class TestAsDataset:
    def test_dataset_passthrough_is_identity(self, m):
        ds = m.Dataset.from_dict({"a": [1, 2, 3]})
        assert m.as_dataset(ds) is ds

    def test_table_and_record_batch(self, m):
        t = _table(100)
        assert m.as_dataset(t).num_rows == 100
        rb = t.to_batches()[0]
        ds = m.as_dataset(rb)
        assert ds.num_rows == len(rb)
        assert set(ds.schema.names) == {"x", "y", "c"}

    def test_dict_of_numpy_no_pandas(self, m):
        ds = m.as_dataset({
            "x": np.arange(5, dtype=np.float64),
            "n": np.array([1, 2, 3, 4, 5], dtype=np.int32),
        })
        assert ds.num_rows == 5
        assert ds.arrow["x"].to_pylist() == [0.0, 1.0, 2.0, 3.0, 4.0]

    def test_rejects_unknown_type(self, m):
        with pytest.raises(TypeError, match="cannot ingest"):
            m.as_dataset(42)

    def test_session_ingest_accepts_dict(self, m, service):
        rng = np.random.default_rng(1)
        session = service.session("t", "dict", _checks(m))
        result = session.ingest({
            "x": rng.normal(size=512), "y": rng.normal(10, 1, 512),
        })
        assert result.status == m.CheckStatus.SUCCESS
        assert session.batches_ingested == 1
        assert session.bytes_ingested > 0


class TestRoundTrip:
    def test_encode_decode_frames(self, m):
        t = _table(3000)
        payload = m.encode_ipc_stream(t, max_chunksize=1000)
        frames = list(m.iter_frames(payload))
        assert [i for i, _ in frames] == [0, 1, 2]
        got = pa.Table.from_batches([b for _, b in frames])
        assert got.num_rows == 3000

    def test_fold_stream_counts_and_checksum(self, m, service):
        t = _table(2000)
        payload = m.encode_ipc_stream(t, max_chunksize=1000)
        session = service.session("t", "rt", _checks(m))
        report = m.fold_stream(
            session, payload, checksum=m.checksum_bytes(payload), source="test"
        )
        assert report.frames == 2
        assert report.rows == 2000
        assert report.bytes == len(payload)
        assert session.batches_ingested == 2
        sm = service.metrics
        labels = dict(tenant="t", dataset="rt")
        assert sm.counter_value(
            "deequ_service_ingest_batches_total", **labels) == 2
        assert sm.counter_value(
            "deequ_service_ingest_bytes_total", **labels) == len(payload)
        assert sm.counter_value(
            "deequ_service_ingest_sessions_total", **labels) == 1


class TestParity:
    """Bit-exact metric parity between Arrow-fed, dict-fed and pandas-fed
    sessions — dictionary-encoded and null-bearing columns included."""

    def _battery(self, m):

        return [
            m.Completeness("x"), m.Completeness("y"), m.Completeness("c"),
            m.Mean("y"), m.StandardDeviation("y"), m.ApproxCountDistinct("c"),
        ]

    def test_three_feeds_bit_exact(self, m, service):
        t = _table(4000, seed=3)
        required = self._battery(m)

        arrow_s = service.session("p", "arrow", (),
                                  required_analyzers=required)
        m.fold_stream(arrow_s, m.encode_ipc_stream(t, max_chunksize=2000),
                    source="parity")

        dict_s = service.session("p", "dict", (), required_analyzers=required)
        for lo in (0, 2000):
            sl = t.slice(lo, 2000)
            dict_s.ingest({
                "x": sl["x"].to_numpy(),
                # null-bearing float column: NaN marks the nulls
                "y": sl["y"].to_numpy(zero_copy_only=False),
                "c": sl["c"].to_pylist(),
            })

        pandas_s = service.session("p", "pandas", (),
                                   required_analyzers=required)
        df = t.to_pandas()
        for lo in (0, 2000):
            pandas_s.ingest(m.Dataset.from_pandas(df.iloc[lo:lo + 2000]))

        ma = _success_metrics(arrow_s.current())
        md = _success_metrics(dict_s.current())
        mp = _success_metrics(pandas_s.current())
        assert len(ma) == len(required)
        assert ma == md == mp  # bit-exact, not approx

    def test_dictionary_and_null_frames_match_direct_run(self, m, service):

        t = _table(3000, seed=9)
        session = service.session("p", "direct", _checks(m))
        m.fold_stream(session, m.encode_ipc_stream(t, max_chunksize=1000),
                    source="parity")
        direct = m.VerificationSuite.on_data(m.Dataset(t), **m.dev).add_checks(
            _checks(m)
        ).run()
        streamed = _success_metrics(session.current())
        oracle = _success_metrics(direct)
        assert set(streamed) == set(oracle)
        # the streamed run folded 3 frames (different summation order than
        # the one-pass oracle): counts are exact, float aggregates agree
        # to 1e-12 relative
        for k, want in oracle.items():
            assert streamed[k] == pytest.approx(want, rel=1e-12, abs=1e-12)


class TestDriftGuard:
    """Drift policies fire identically on the Arrow path."""

    def test_retyped_column_rejected_typed(self, m, service):
        session = service.session("d", "reject", _checks(m))
        m.fold_stream(session, m.encode_ipc_stream(_table(1000)), source="drift")
        assert session.batches_ingested == 1
        drifted = pa.table({
            "x": pa.array(np.zeros(100)),
            "y": pa.array(["oops"] * 100),  # float -> string retype
            "c": pa.array(["alpha"] * 100).dictionary_encode(),
        })
        with pytest.raises(m.SchemaDriftError):
            m.fold_stream(session, m.encode_ipc_stream(drifted), source="drift")
        assert session.batches_ingested == 1  # states untouched

    def test_widening_coerces_on_arrow_path(self, m, service):
        rng = np.random.default_rng(4)
        first = pa.table({
            "x": pa.array(rng.normal(size=500)),
            "y": pa.array(rng.normal(10, 1, 500)),
        })
        session = service.session("d", "widen", _checks(m))
        m.fold_stream(session, m.encode_ipc_stream(first), source="drift")
        # float32 arriving where float64 was promised: same-family
        # widening — coerced and counted, never rejected
        narrow = pa.table({
            "x": pa.array(rng.normal(size=500).astype(np.float32)),
            "y": pa.array(rng.normal(10, 1, 500).astype(np.float32)),
        })
        m.fold_stream(session, m.encode_ipc_stream(narrow), source="drift")
        assert session.batches_ingested == 2
        assert session.drift_coercions >= 1

    def test_degrade_policy_folds_surviving_columns(self, m, service):
        session = service.session(
            "d", "degrade", _checks(m), drift_policy="degrade"
        )
        m.fold_stream(session, m.encode_ipc_stream(_table(1000)), source="drift")
        drifted = pa.table({
            "x": pa.array(np.zeros(200)),
            "y": pa.array(["oops"] * 200),
            "c": pa.array(["alpha"] * 200).dictionary_encode(),
        })
        m.fold_stream(session, m.encode_ipc_stream(drifted), source="drift")
        assert session.batches_ingested == 2
        assert session.drift_degraded_batches == 1


class TestMalformedAndDisconnect:
    def test_garbage_nothing_folds(self, m, service):
        session = service.session("m", "garbage", _checks(m))
        with pytest.raises(m.MalformedFrameError):
            m.fold_stream(session, b"definitely not an arrow stream",
                        source="test")
        assert session.batches_ingested == 0
        assert service.metrics.counter_value(
            "deequ_service_ingest_malformed_total",
            tenant="m", dataset="garbage",
        ) == 1

    def test_checksum_mismatch_nothing_folds(self, m, service):
        payload = m.encode_ipc_stream(_table(1000))
        bad = bytearray(payload)
        bad[len(bad) // 2] ^= 0xFF  # silent under IPC decode...
        session = service.session("m", "sum", _checks(m))
        with pytest.raises(m.MalformedFrameError, match="checksum"):
            m.fold_stream(session, bytes(bad),
                        checksum=m.checksum_bytes(payload), source="test")
        assert session.batches_ingested == 0

    def test_truncated_stream_commits_leading_frames(self, m, service):
        import io

        tables = [_table(800, seed=s) for s in (1, 2, 3)]
        sink = io.BytesIO()
        bounds = []
        with pa.ipc.new_stream(sink, tables[0].schema) as w:
            for t in tables:
                for b in t.to_batches():
                    w.write_batch(b)
                bounds.append(sink.tell())
        payload = sink.getvalue()
        cut = bounds[1] + (bounds[2] - bounds[1]) // 2
        session = service.session("m", "torn", _checks(m))
        with pytest.raises(m.FeedDisconnectError) as exc_info:
            m.fold_stream(session, payload[:cut], complete=False, source="t")
        assert exc_info.value.frames_decoded == 2
        assert session.batches_ingested == 2
        assert service.metrics.counter_value(
            "deequ_service_ingest_disconnects_total",
            tenant="m", dataset="torn",
        ) == 1

    def test_injected_frame_corrupt(self, m, service):
        session = service.session("m", "inject", _checks(m))
        payload = m.encode_ipc_stream(_table(2000), max_chunksize=1000)
        with m.inject(m.FaultSpec("frame_decode", "frame_corrupt", at=2)) as inj:
            with pytest.raises(m.MalformedFrameError):
                m.fold_stream(session, payload, source="test")
        assert inj.fired == ["frame_decode:1:frame_corrupt"]
        assert session.batches_ingested == 1  # first frame stayed committed


class TestHttpEndpoint:
    def _post(self, exporter, path, body, headers=None):
        import http.client
        import json

        conn = http.client.HTTPConnection(
            exporter.host, exporter.port, timeout=30
        )
        try:
            conn.request("POST", path, body=body, headers=headers or {})
            resp = conn.getresponse()
            return resp.status, json.loads(resp.read().decode())
        finally:
            conn.close()

    def test_post_folds_and_counts(self, m, service):
        service.session("h", "ok", _checks(m))
        exporter = service.start_exporter()
        payload = m.encode_ipc_stream(_table(2000), max_chunksize=1000)
        status, body = self._post(
            exporter, "/ingest/v1/h/ok", payload,
            {m.CHECKSUM_HEADER: m.checksum_bytes(payload)},
        )
        assert status == 200
        assert body["frames"] == 2 and body["rows"] == 2000
        assert body["statuses"] == ["Success", "Success"]
        text = service.prometheus_text()
        assert "deequ_service_ingest_batches_total" in text
        assert "# HELP deequ_service_ingest_bytes_total" in text

    def test_unknown_session_is_404_never_autocreated(self, m, service):
        exporter = service.start_exporter()
        status, body = self._post(
            exporter, "/ingest/v1/nope/nothing",
            m.encode_ipc_stream(_table(100)),
        )
        assert status == 404 and body["error"] == "unknown_session"
        assert service.get_session("nope", "nothing") is None

    def test_closed_session_is_410_gone(self, m, service):
        session = service.session("h", "closed", _checks(m))
        session.close()
        exporter = service.start_exporter()
        status, body = self._post(
            exporter, "/ingest/v1/h/closed", m.encode_ipc_stream(_table(100))
        )
        # "gone", not "never existed": a producer must not be told to
        # re-register a deliberately closed session
        assert status == 410 and body["error"] == "session_closed"

    def test_malformed_body_is_400(self, m, service):
        session = service.session("h", "bad", _checks(m))
        exporter = service.start_exporter()
        status, body = self._post(
            exporter, "/ingest/v1/h/bad", b"garbage not arrow"
        )
        assert status == 400 and body["error"] == "malformed_frame"
        assert session.batches_ingested == 0

    def test_drift_is_409(self, m, service):
        session = service.session("h", "drift", _checks(m))
        exporter = service.start_exporter()
        self._post(exporter, "/ingest/v1/h/drift",
                   m.encode_ipc_stream(_table(500)))
        drifted = pa.table({"x": pa.array(np.zeros(10))})
        status, body = self._post(
            exporter, "/ingest/v1/h/drift", m.encode_ipc_stream(drifted)
        )
        assert status == 409 and body["error"] == "schema_drift"
        assert session.batches_ingested == 1

    def test_disconnect_mid_body_counts_and_commits_nothing_torn(
        self, m, service
    ):
        import socket

        session = service.session("h", "torn", _checks(m))
        exporter = service.start_exporter()
        payload = m.encode_ipc_stream(_table(2000), max_chunksize=1000)
        sock = socket.create_connection((exporter.host, exporter.port))
        head = (
            f"POST /ingest/v1/h/torn HTTP/1.1\r\nHost: t\r\n"
            f"Content-Length: {len(payload)}\r\n\r\n"
        ).encode()
        sock.sendall(head + payload[: len(payload) // 4])
        sock.close()
        deadline = time.time() + 10
        while time.time() < deadline:
            if service.metrics.counter_value(
                "deequ_service_ingest_disconnects_total",
                tenant="h", dataset="torn",
            ) >= 1:
                break
            time.sleep(0.05)
        assert service.metrics.counter_value(
            "deequ_service_ingest_disconnects_total",
            tenant="h", dataset="torn",
        ) == 1
        # bytes of the torn stream never count as ingested
        assert service.metrics.counter_value(
            "deequ_service_ingest_bytes_total", tenant="h", dataset="torn"
        ) == 0

    def test_checksummed_torn_body_folds_nothing(self, m, service):
        import socket

        session = service.session("h", "csum-torn", _checks(m))
        exporter = service.start_exporter()
        payload = m.encode_ipc_stream(_table(2000), max_chunksize=1000)
        digest = m.checksum_bytes(payload)
        sock = socket.create_connection((exporter.host, exporter.port))
        head = (
            f"POST /ingest/v1/h/csum-torn HTTP/1.1\r\nHost: t\r\n"
            f"{m.CHECKSUM_HEADER}: {digest}\r\n"
            f"Content-Length: {len(payload)}\r\n\r\n"
        ).encode()
        # ship MOST of the payload (several complete frames' worth), then
        # die: the declared digest can never verify, so NOTHING folds
        sock.sendall(head + payload[: len(payload) - 50])
        sock.close()
        deadline = time.time() + 10
        while time.time() < deadline:
            if service.metrics.counter_value(
                "deequ_service_ingest_disconnects_total",
                tenant="h", dataset="csum-torn",
            ) >= 1:
                break
            time.sleep(0.05)
        assert session.batches_ingested == 0
        assert service.metrics.counter_value(
            "deequ_service_ingest_disconnects_total",
            tenant="h", dataset="csum-torn",
        ) == 1

    def test_overload_is_429(self, m):
        with m.VerificationService(
            workers=1, max_queue_depth=1, background_warm=False, **m.svc
        ) as svc:
            session = svc.session("h", "busy", _checks(m))
            exporter = svc.start_exporter()
            release = threading.Event()
            # wedge the single worker, then fill the single queue slot
            svc.scheduler.submit(lambda ctx: release.wait(10))
            time.sleep(0.1)  # let the worker pick the wedge up
            svc.scheduler.submit(lambda ctx: None)
            payload = m.encode_ipc_stream(_table(100))
            status, body = self._post(
                exporter, "/ingest/v1/h/busy", payload
            )
            release.set()
            assert status == 429 and body["error"] == "overloaded"
            assert svc.metrics.counter_value(
                "deequ_service_ingest_shed_total",
                tenant="h", dataset="busy",
            ) == 1
            assert session.batches_ingested == 0


class TestFaultKinds:
    """The port's fault kinds raise what the reference's raise, and the
    kinds of planes the port has not taken (the engine's feed pipeline,
    the cluster) are refused rather than accepted and never fired."""

    @pytest.mark.parametrize("kind", [k for k in PORT.FAULT_KINDS if k != "stall"])
    def test_injected_error_is_the_references(self, kind):
        got = PORT.faults._make_error(kind, "frame_decode", "3", shard=1)
        want = REF.faults._make_error(kind, "frame_decode", "3", shard=1)
        assert type(got).__name__ == type(want).__name__
        assert str(got) == str(want)
        assert getattr(got, "frame_index", None) == getattr(want, "frame_index", None)

    @pytest.mark.parametrize("kind", sorted(set(REF.FAULT_KINDS) - set(PORT.FAULT_KINDS)))
    def test_kinds_of_planes_not_ported_are_refused(self, kind):
        REF.FaultSpec("frame_decode", kind)
        with pytest.raises(ValueError, match="fault kind"):
            PORT.FaultSpec("frame_decode", kind)

    def test_every_site_of_the_port_is_a_site_of_the_reference(self):
        assert set(PORT.faults.KNOWN_FAULT_SITES) <= set(REF.faults.KNOWN_FAULT_SITES)
        assert {"frame_decode", "catalog_load", "row_gate"} <= set(PORT.faults.KNOWN_FAULT_SITES)


class TestBackpressure:
    def test_block_s_waits_for_space_instead_of_shedding(self, m):
        with m.VerificationService(
            workers=1, max_queue_depth=1, background_warm=False, **m.svc
        ) as svc:
            release = threading.Event()
            svc.scheduler.submit(lambda ctx: release.wait(10))
            time.sleep(0.1)
            filler = svc.scheduler.submit(lambda ctx: "filler")
            # without backpressure: immediate typed shed
            with pytest.raises(m.ServiceOverloaded):
                svc.scheduler.submit(lambda ctx: "shed")

            def free():
                time.sleep(0.3)
                release.set()

            threading.Thread(target=free, daemon=True).start()
            handle = svc.scheduler.submit(
                lambda ctx: "waited", block_s=10.0
            )
            assert handle.result(timeout=10) == "waited"
            assert filler.result(timeout=10) == "filler"

    def test_block_s_expiry_sheds_typed(self, m):
        with m.VerificationService(
            workers=1, max_queue_depth=1, background_warm=False, **m.svc
        ) as svc:
            release = threading.Event()
            try:
                svc.scheduler.submit(lambda ctx: release.wait(10))
                time.sleep(0.1)
                svc.scheduler.submit(lambda ctx: None)
                t0 = time.perf_counter()
                with pytest.raises(m.ServiceOverloaded):
                    svc.scheduler.submit(lambda ctx: None, block_s=0.3)
                assert 0.2 <= time.perf_counter() - t0 < 5.0
            finally:
                release.set()


class TestSoakSmoke:
    def test_concurrency_soak_completes(self, m):
        """The soak tool's concurrency shape, small: 12 sessions x 2
        batches from 4 feeder threads with bounded backpressure; every fold
        commits and nothing sheds."""
        with m.VerificationService(workers=4, max_queue_depth=16, background_warm=False,
                                   **m.svc) as svc:
            sessions = [svc.session(f"soak-{i}", "d", _checks(m), admission_block_s=30.0)
                        for i in range(12)]
            errors = []

            def feed(chunk):
                try:
                    handles = [s.ingest(_table(512, seed=j), wait=False)
                               for s in chunk for j in range(2)]
                    for h in handles:
                        h.result(60)
                except Exception as exc:  # noqa: BLE001 - reported below
                    errors.append(exc)

            threads = [threading.Thread(target=feed, args=(sessions[i::4],)) for i in range(4)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(120)
            assert errors == []
            assert [s.batches_ingested for s in sessions] == [2] * 12
            assert svc.metrics.counter_value("deequ_service_jobs_shed_total") == 0

    def test_stream_throughput_parity(self, m, service):
        """The soak tool's stream shape, small: Arrow IPC frames folded by
        fold_stream equal the same frames given to session.ingest, bit for
        bit."""
        table = _table(1 << 14, seed=11)
        payload = m.encode_ipc_stream(table, max_chunksize=1 << 12)
        streamed = service.session("tp", "stream", _checks(m))
        report = m.fold_stream(streamed, payload, source="tp")
        direct = service.session("tp", "direct", _checks(m))
        for batch in table.to_batches(max_chunksize=1 << 12):
            direct.ingest(batch)
        assert report.frames == 4 and report.rows == 1 << 14
        assert _success_metrics(streamed.current()) == _success_metrics(direct.current())


class TestIncrementalHttpDecode:
    """The unbuffered ingest path: an unchecksummed POST decodes frame by
    frame straight off the socket — one frame in memory, not the body."""

    def _post_chunked(self, exporter, path, payload, chunks, gap_s=0.02):
        import socket

        sock = socket.create_connection((exporter.host, exporter.port))
        head = (
            f"POST {path} HTTP/1.1\r\nHost: t\r\n"
            f"Content-Length: {len(payload)}\r\n\r\n"
        ).encode()
        sock.sendall(head)
        step = -(-len(payload) // chunks)
        for i in range(0, len(payload), step):
            sock.sendall(payload[i:i + step])
            time.sleep(gap_s)
        resp = b""
        sock.settimeout(20)
        try:
            while b"\r\n\r\n" not in resp or len(resp) < 10:
                part = sock.recv(65536)
                if not part:
                    break
                resp += part
        except OSError:
            pass
        sock.close()
        status = int(resp.split(b" ", 2)[1])
        body = json.loads(resp.split(b"\r\n\r\n", 1)[1])
        return status, body

    def test_frames_fold_while_body_still_arriving(self, m, service):
        """Frames committed BEFORE the transport delivered the full body
        prove the decode is incremental, not buffered."""
        session = service.session("inc", "stream", _checks(m))
        exporter = service.start_exporter()
        table = _table(4000)
        payload = m.encode_ipc_stream(table, max_chunksize=1000)
        committed_mid_body = []

        orig = type(session)._commit_fold

        def spy(self, result, data, pending_contract, done):
            committed_mid_body.append(time.perf_counter())
            return orig(self, result, data, pending_contract, done)


        m.streaming_mod.StreamingSession._commit_fold = spy
        try:
            t0 = time.perf_counter()
            status, body = self._post_chunked(
                exporter, "/ingest/v1/inc/stream", payload, chunks=8,
                gap_s=0.05,
            )
            last_byte_at = t0 + 7 * 0.05  # the 8th chunk leaves then
        finally:
            m.streaming_mod.StreamingSession._commit_fold = orig
        assert status == 200 and body["frames"] == 4
        assert session.batches_ingested == 4
        # at least the first frame folded before the final chunk was sent
        assert committed_mid_body[0] < last_byte_at

    def test_incremental_equivalent_to_buffered(self, m, service):
        """HTTP-fed (incremental) == checksummed HTTP-fed (buffered) ==
        in-process fold_stream, bit-exact."""
        import urllib.request

        table = _table(3000)
        payload = m.encode_ipc_stream(table, max_chunksize=1000)
        exporter = service.start_exporter()
        for name, headers in (
            ("plain", {}),
            ("csum", {m.CHECKSUM_HEADER: m.checksum_bytes(payload)}),
        ):
            service.session(f"eq-{name}", "s", _checks(m))
            req = urllib.request.Request(
                f"http://{exporter.host}:{exporter.port}"
                f"/ingest/v1/eq-{name}/s",
                data=payload, headers=headers, method="POST",
            )
            with urllib.request.urlopen(req, timeout=30) as resp:
                assert resp.status == 200
        direct = service.session("eq-direct", "s", _checks(m))
        m.fold_stream(direct, payload, source="direct")
        maps = []
        for name in ("eq-plain", "eq-csum", "eq-direct"):
            s = service.get_session(name, "s")
            cum = s.current()
            maps.append({
                repr(a): mt.value.get()
                for a, mt in cum.metrics.items() if mt.value.is_success
            })
        assert maps[0] == maps[1] == maps[2]

    def test_incremental_malformed_drains_and_400s(self, m, service):
        import urllib.error
        import urllib.request

        service.session("inc", "bad", _checks(m))
        exporter = service.start_exporter()
        req = urllib.request.Request(
            f"http://{exporter.host}:{exporter.port}/ingest/v1/inc/bad",
            data=b"definitely not an arrow stream, padded " + b"x" * 500,
            method="POST",
        )
        with pytest.raises(urllib.error.HTTPError) as err:
            urllib.request.urlopen(req, timeout=30)
        assert err.value.code == 400
        assert json.loads(err.value.read())["error"] == "malformed_frame"

    def test_bounded_reader_contract(self, m):
        import io


        raw = io.BytesIO(b"abcdefghij")
        r = m.BoundedReader(raw, 6)
        assert r.read(4) == b"abcd"
        assert r.read(100) == b"ef"  # capped at the declared limit
        assert r.read(1) == b""
        assert r.bytes_read == 6 and not r.short
        short = m.BoundedReader(io.BytesIO(b"ab"), 10)
        assert short.read(10) == b"ab"
        assert short.short and short.bytes_read == 2
        short.drain()
        assert short.bytes_read == 2

