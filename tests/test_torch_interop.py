"""JVM interop of the PyTorch/CUDA port (deequ_tpu_torch.interop and
``PartitionedMetricsRepository.import_jvm_history``) against the JAX
reference: the cases of ``tests/test_interop_jvm.py`` run through both
packages (``m`` is either package; the port reads blobs onto
``device="cpu"``), then HLL and KLL blobs written by either package read
into the other and merge to the same registers and items, and a JVM
metrics history imports into either package's partitioned repository
with equal entries.

Tolerances: bit for bit throughout (registers, KLL items, sizes, parities,
counts, min and max, and the history's JSON values).
"""

import json
import struct

import numpy as np
import pytest
import torch

from torch_pairs import pair, reference_isolated  # noqa: F401 (autouse)

NAMES = {
    'AnalysisResult': 'repository:AnalysisResult',
    'AnalysisRunner': 'runners.analysis_runner:AnalysisRunner',
    'ApproxCountDistinct': 'analyzers:ApproxCountDistinct',
    'Completeness': 'analyzers:Completeness',
    'CorruptStateError': 'exceptions:CorruptStateError',
    'Dataset': 'data:Dataset',
    'HostKLL': 'ops.kll_host:HostKLL',
    'InMemoryStateProvider': 'analyzers.state_provider:InMemoryStateProvider',
    'JVM_HLL_BLOB_BYTES': 'interop:JVM_HLL_BLOB_BYTES',
    'M': 'ops.hll:M',
    'Mean': 'analyzers:Mean',
    'NUM_WORDS': 'ops.hll:NUM_WORDS',
    'ResultKey': 'repository:ResultKey',
    'Size': 'analyzers:Size',
    'Uniqueness': 'analyzers:Uniqueness',
    'kll_init': 'ops.kll:kll_init',
    'kll_update': 'ops.kll:kll_update',
    'merge_states_batched': 'analyzers.base:merge_states_batched',
    'read_jvm_hll_state_blob': 'interop:read_jvm_hll_state_blob',
    'read_jvm_kll_state_blob': 'interop:read_jvm_kll_state_blob',
    'read_jvm_metrics_history_json': 'interop:read_jvm_metrics_history_json',
    'registers_to_words': 'ops.hll:registers_to_words',
    'write_jvm_hll_state_blob': 'interop:write_jvm_hll_state_blob',
    'write_jvm_kll_state_blob': 'interop:write_jvm_kll_state_blob',
    'write_jvm_metrics_history_json': 'interop:write_jvm_metrics_history_json',
    'kll_merge': 'ops.kll:kll_merge',
    'PartitionedMetricsRepository': 'repository:PartitionedMetricsRepository',
}
REF, PORT = pair(NAMES)


@pytest.fixture(params=[REF, PORT], ids=["jax", "torch"])
def m(request):
    return request.param


def read_hll(m, blob):
    return m.read_jvm_hll_state_blob(blob, **m.dev)


def read_kll(m, blob):
    return m.read_jvm_kll_state_blob(blob, **m.dev)


def kll_fold(m, state, values):
    """One batch into a sketch: the reference's ``kll_update(state, values,
    valid)`` on jax arrays, the port's ``kll_update(state, values, rows)`` on
    CPU tensors (its kernels' plain versions)."""
    if m.name == "jax":
        import jax.numpy as jnp

        return m.kll_update(state, jnp.asarray(values), jnp.ones(len(values), dtype=bool))
    return m.kll_update(state, torch.as_tensor(values, dtype=torch.float64),
                        torch.ones(len(values), dtype=torch.bool))


def host(leaf):
    return leaf.numpy() if isinstance(leaf, torch.Tensor) else np.asarray(leaf)


def _engine_state(m, rows=5000, distinct=700):
    data = m.Dataset.from_dict({"c": [f"v{i % distinct}" for i in range(rows)]})
    provider = m.InMemoryStateProvider()
    m.AnalysisRunner.do_analysis_run(
        data, [m.ApproxCountDistinct("c")], save_states_with=provider, **m.dev
    )
    return provider.load(m.ApproxCountDistinct("c"))


class TestBlobLayout:
    def test_fixture_blob_layout_pinned(self, m):
        """A hand-built blob in the reference layout: register i holds
        value (i % 61). 6-bit registers, 10 per word, little-endian within
        the word; the FILE layout is big-endian JVM DataOutputStream."""
        registers = np.array([i % 61 for i in range(m.M)], dtype=np.int32)
        words = m.registers_to_words(registers)
        blob = struct.pack(">i", m.NUM_WORDS) + words.view(np.int64).astype(
            ">i8"
        ).tobytes()
        assert len(blob) == m.JVM_HLL_BLOB_BYTES
        state = read_hll(m, blob)
        np.testing.assert_array_equal(np.asarray(state.registers), registers)

    def test_word_zero_bit_layout_pinned(self, m):
        """Registers [1, 2, 3, 0, ...] pack into word0 as 1 | 2<<6 | 3<<12
        (the StatefulHyperloglogPlus 6-bit stride); pin the exact long so
        the byte layout can never silently flip endianness or stride."""
        registers = np.zeros(m.M, dtype=np.int32)
        registers[0], registers[1], registers[2] = 1, 2, 3
        blob = m.write_jvm_hll_state_blob(
            type("S", (), {"registers": registers})()
        )
        (count,) = struct.unpack_from(">i", blob, 0)
        (word0,) = struct.unpack_from(">q", blob, 4)
        assert count == m.NUM_WORDS
        assert word0 == (1 | (2 << 6) | (3 << 12))


class TestRoundTrip:
    def test_engine_state_round_trips_bit_exact(self, m):
        state = _engine_state(m)
        blob = m.write_jvm_hll_state_blob(state)
        assert len(blob) == m.JVM_HLL_BLOB_BYTES
        back = read_hll(m, blob)
        np.testing.assert_array_equal(
            np.asarray(state.registers), np.asarray(back.registers)
        )
        assert back.metric_value() == state.metric_value()

    def test_blob_state_merges_into_engine_run(self, m):
        """The interop state is LIVE: it merges with engine-computed
        states through the ordinary aggregate machinery, like a JVM
        day-partition handed to this engine."""

        a = _engine_state(m, rows=2000, distinct=300)
        b = read_hll(m, 
            m.write_jvm_hll_state_blob(_engine_state(m, rows=2000, distinct=500))
        )
        merged = m.merge_states_batched(m.ApproxCountDistinct("c"), [a, b], **m.dev)
        # max-merge of registers: the merged estimate covers the union and
        # equals merging the two native states directly
        native = m.merge_states_batched(m.ApproxCountDistinct("c"), [a, b], **m.dev)
        np.testing.assert_array_equal(
            np.asarray(merged.registers), np.asarray(native.registers)
        )
        assert merged.metric_value() >= b.metric_value()


class TestMalformedBlobs:
    def test_short_blob_typed(self, m):
        with pytest.raises(m.CorruptStateError):
            read_hll(m, b"\x00\x00")

    def test_wrong_word_count_typed(self, m):
        blob = struct.pack(">i", 13) + b"\x00" * 8 * 13
        with pytest.raises(m.CorruptStateError, match="word count"):
            read_hll(m, blob)

    def test_truncated_words_typed(self, m):
        good = m.write_jvm_hll_state_blob(_engine_state(m, rows=100, distinct=10))
        with pytest.raises(m.CorruptStateError):
            read_hll(m, good[:-8])

    def test_wrong_register_shape_rejected_on_write(self, m):
        with pytest.raises(ValueError, match="registers"):
            m.write_jvm_hll_state_blob(
                type("S", (), {"registers": np.zeros(7, dtype=np.int32)})()
            )


# ---------------------------------------------------------------------------
# Second leg: the KLL sketch codec (KLLSketchSerializer.scala
# layout + KLLState's global min/max trailer)
# ---------------------------------------------------------------------------


def _kll_state(m, rows=20_000, sketch_size=64, seed=5):
    rng = np.random.default_rng(seed)
    state = m.kll_init(sketch_size)
    for _ in range(5):
        state = kll_fold(m, state, rng.normal(0, 10, rows // 5))
    return state


class TestKLLBlob:
    def test_round_trip_preserves_sketch_contents(self, m):

        state = _kll_state(m)
        blob = m.write_jvm_kll_state_blob(state, shrinking_factor=0.64)
        back, shrinking = read_kll(m, blob)
        assert shrinking == 0.64
        assert back.sketch_size == state.sketch_size
        assert int(back.count) == int(state.count)
        assert float(back.g_min) == float(state.g_min)
        assert float(back.g_max) == float(state.g_max)
        assert np.array_equal(np.asarray(back.sizes), np.asarray(state.sizes))
        assert np.array_equal(
            np.asarray(back.parity), np.asarray(state.parity)
        )
        sizes = np.asarray(state.sizes)
        for level in range(len(sizes)):
            n = int(sizes[level])
            assert np.array_equal(
                np.asarray(back.items)[level, :n],
                np.asarray(state.items)[level, :n],
            ), level

    def test_round_trip_quantiles_identical(self, m):

        state = _kll_state(m)
        back, _ = read_kll(m, m.write_jvm_kll_state_blob(state))
        a, b = m.HostKLL.from_state(state), m.HostKLL.from_state(back)
        for q in (0.0, 0.1, 0.5, 0.9, 1.0):
            assert a.quantile(q) == b.quantile(q), q

    def test_header_layout_pinned(self, m):
        """int32 sketchSize, float64 shrinkingFactor, int64 count, int32
        compactor count — big-endian DataOutputStream conventions."""

        blob = m.write_jvm_kll_state_blob(m.kll_init(128), shrinking_factor=0.5)
        sketch_size, shrink, count, n_comp = struct.unpack_from(">idqi", blob, 0)
        assert (sketch_size, shrink, count, n_comp) == (128, 0.5, 0, 0)
        # empty sketch: header + max/min trailer only
        assert len(blob) == struct.calcsize(">idqi") + 16

    def test_malformed_blobs_typed(self, m):

        blob = m.write_jvm_kll_state_blob(_kll_state(m))
        for bad in (b"", blob[:8], blob[:-3], blob + b"\x00"):
            with pytest.raises(m.CorruptStateError):
                read_kll(m, bad)
        # implausible header fields are structural violations too
        bad_sketch = struct.pack(">idqi", -5, 0.64, 0, 0) + b"\x00" * 16
        with pytest.raises(m.CorruptStateError):
            read_kll(m, bad_sketch)
        bad_shrink = struct.pack(">idqi", 64, 7.5, 0, 0) + b"\x00" * 16
        with pytest.raises(m.CorruptStateError):
            read_kll(m, bad_shrink)


# ---------------------------------------------------------------------------
# Third leg: the Gson metrics-history JSON dialect
# (AnalysisResultSerde.scala)
# ---------------------------------------------------------------------------


class TestGsonMetricsHistory:
    def _history(self, m):

        data = m.Dataset.from_dict(
            {
                "x": np.arange(200, dtype=np.float64),
                "y": (np.arange(200) % 9).astype(np.float64),
            }
        )
        ctx = m.AnalysisRunner.do_analysis_run(
            data, [m.Size(), m.Mean("x"), m.Uniqueness(("x", "y"))], **m.dev
        )
        return [
            m.AnalysisResult(m.ResultKey(1111, {"env": "prod"}), ctx),
            m.AnalysisResult(m.ResultKey(2222, {"env": "dev"}), ctx),
        ]

    def test_round_trip(self, m):

        history = self._history(m)
        payload = m.write_jvm_metrics_history_json(history)
        back = m.read_jvm_metrics_history_json(payload)
        assert [r.result_key.data_set_date for r in back] == [1111, 2222]
        assert back[0].result_key.tags_dict == {"env": "prod"}
        want = history[0].analyzer_context
        got = back[0].analyzer_context
        for a in (m.Size(), m.Mean("x"), m.Uniqueness(("x", "y"))):
            assert got.metric(a).value.get() == want.metric(a).value.get(), a

    def test_jvm_dialect_shape(self, m):
        """No formatVersion/checksum envelope, successful metrics only,
        and the reference's literal 'Mutlicolumn' entity spelling."""
        import json


        payload = m.write_jvm_metrics_history_json(self._history(m))
        assert "formatVersion" not in payload
        assert "checksum" not in payload
        assert "Mutlicolumn" in payload  # the reference's famous typo
        records = json.loads(payload)
        assert isinstance(records, list) and len(records) == 2
        assert set(records[0]) == {"resultKey", "analyzerContext"}

    def test_failure_metrics_skipped_on_write(self, m):

        data = m.Dataset.from_dict({"x": np.arange(10, dtype=np.float64)})
        # Completeness over a MISSING column precondition-fails -> Failure
        ctx = m.AnalysisRunner.do_analysis_run(
            data, [m.Size(), m.Completeness("nope")], **m.dev
        )
        assert ctx.metric(m.Completeness("nope")).value.is_failure
        payload = m.write_jvm_metrics_history_json(
            [m.AnalysisResult(m.ResultKey(1), ctx)]
        )
        back = m.read_jvm_metrics_history_json(payload)
        metric_map = back[0].analyzer_context.metric_map
        assert len(metric_map) == 1  # only the successful Size survived

    def test_reference_written_payload_loads(self, m):
        """A hand-written JVM-side payload (the dialect a Gson
        AnalysisResultSerde emits) loads without our envelope fields."""

        payload = (
            '[{"resultKey": {"dataSetDate": 1630000000000, '
            '"tags": {"table": "orders"}}, '
            '"analyzerContext": {"metricMap": ['
            '{"analyzer": {"analyzerName": "Size", "where": null}, '
            '"metric": {"entity": "Dataset", "instance": "*", '
            '"name": "Size", "metricName": "DoubleMetric", "value": 42.0}}, '
            '{"analyzer": {"analyzerName": "Uniqueness", '
            '"columns": ["a", "b"]}, '
            '"metric": {"entity": "Mutlicolumn", "instance": "a,b", '
            '"name": "Uniqueness", "metricName": "DoubleMetric", '
            '"value": 0.25}}]}}]'
        )
        results = m.read_jvm_metrics_history_json(payload)
        assert results[0].result_key.data_set_date == 1630000000000
        values = {
            type(a).__name__: mt.value.get()
            for a, mt in results[0].analyzer_context.metric_map.items()
        }
        assert values == {"Size": 42.0, "Uniqueness": 0.25}

    def test_corrupt_payloads_typed(self, m):

        for bad in (
            "{not json",
            '{"a": 1}',
            '[{"resultKey": {}}]',
            '[{"resultKey": {"dataSetDate": 1}, "analyzerContext": '
            '{"metricMap": [{"analyzer": {"analyzerName": "NoSuch"}, '
            '"metric": {}}]}}]',
        ):
            with pytest.raises(m.CorruptStateError):
                m.read_jvm_metrics_history_json(bad)



# ---------------------------------------------------------------------------
# state across the packages
# ---------------------------------------------------------------------------


def _leaves(state):
    return {name: host(getattr(state, name))
            for name in ("items", "sizes", "parity", "count", "g_min", "g_max")}


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_an_hll_blob_of_either_package_reads_and_merges_in_the_other(writer):
    first, second = (REF, PORT) if writer == "jax" else (PORT, REF)
    blob = first.write_jvm_hll_state_blob(_engine_state(first, rows=3000, distinct=900))
    assert blob == second.write_jvm_hll_state_blob(_engine_state(second, rows=3000,
                                                                 distinct=900))
    read = read_hll(second, blob)
    own = _engine_state(second, rows=2000, distinct=400)
    merged = second.merge_states_batched(second.ApproxCountDistinct("c"), [own, read],
                                         **second.dev)
    other = read_hll(first, blob)
    want = first.merge_states_batched(first.ApproxCountDistinct("c"),
                                      [_engine_state(first, rows=2000, distinct=400), other],
                                      **first.dev)
    np.testing.assert_array_equal(host(merged.registers), host(want.registers))
    assert merged.metric_value() == want.metric_value()


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_a_kll_blob_of_either_package_reads_and_merges_in_the_other(writer):
    """The same batches make the same sketch in both packages; its blob,
    read by the other package and merged with that package's own sketch
    (K5's merge on the port's side), gives the same items as merging in
    the writer's package."""
    first, second = (REF, PORT) if writer == "jax" else (PORT, REF)
    blob = first.write_jvm_kll_state_blob(_kll_state(first, rows=6000, sketch_size=32))
    assert blob == second.write_jvm_kll_state_blob(_kll_state(second, rows=6000,
                                                              sketch_size=32))
    read, shrinking = read_kll(second, blob)
    assert shrinking == 0.64
    native = _kll_state(second, rows=6000, sketch_size=32)
    for name, leaf in _leaves(read).items():
        np.testing.assert_array_equal(leaf, _leaves(native)[name], err_msg=name)
    got = second.kll_merge(native, read)
    want = first.kll_merge(_kll_state(first, rows=6000, sketch_size=32), read_kll(first, blob)[0])
    for name, leaf in _leaves(got).items():
        np.testing.assert_array_equal(leaf, _leaves(want)[name], err_msg=name)


DAY_MS = 86_400_000


def _jvm_history(days):
    """A JVM-side Gson history of ``days`` dailies (Size, Mean and a
    multicolumn Uniqueness with the reference's "Mutlicolumn" spelling)."""
    rng = np.random.default_rng(3)
    records = []
    for d in range(days):
        records.append({
            "resultKey": {"dataSetDate": 1_735_689_600_000 + d * DAY_MS,
                          "tags": {"table": "orders"}},
            "analyzerContext": {"metricMap": [
                {"analyzer": {"analyzerName": "Size", "where": None},
                 "metric": {"entity": "Dataset", "instance": "*", "name": "Size",
                            "metricName": "DoubleMetric", "value": float(1000 + d)}},
                {"analyzer": {"analyzerName": "Mean", "column": "x", "where": None},
                 "metric": {"entity": "Column", "instance": "x", "name": "Mean",
                            "metricName": "DoubleMetric", "value": float(rng.normal(10, 1))}},
                {"analyzer": {"analyzerName": "Uniqueness", "columns": ["a", "b"]},
                 "metric": {"entity": "Mutlicolumn", "instance": "a,b", "name": "Uniqueness",
                            "metricName": "DoubleMetric", "value": float(rng.random())}},
            ]},
        })
    return json.dumps(records)


def _entries(repo):
    return sorted(
        (r.result_key.data_set_date, tuple(sorted(r.result_key.tags_dict.items())),
         tuple(sorted((repr(a), mt.value.get())
                      for a, mt in r.analyzer_context.metric_map.items())))
        for r in repo.load().get())


@pytest.mark.parametrize("source", ["jvm", "jax", "torch"])
def test_a_jvm_history_imports_into_either_packages_repository(source, tmp_path):
    """A JVM history (hand-written, or written by either package's
    ``write_jvm_metrics_history_json``) imports into both packages'
    partitioned repositories with equal entries, and each package reads the
    other's imported store."""
    payload = _jvm_history(40)
    if source != "jvm":
        writer = REF if source == "jax" else PORT
        payload = writer.write_jvm_metrics_history_json(writer.read_jvm_metrics_history_json(payload))
    got = {}
    for m in (REF, PORT):
        repo = m.PartitionedMetricsRepository(str(tmp_path / m.name))
        assert repo.import_jvm_history(payload, source="orders.json") == 40
        got[m.name] = _entries(repo)
    assert got["torch"] == got["jax"]
    assert len(got["torch"]) == 40
    assert _entries(REF.PartitionedMetricsRepository(str(tmp_path / "torch"))) == got["jax"]
    assert _entries(PORT.PartitionedMetricsRepository(str(tmp_path / "jax"))) == got["torch"]


def test_a_corrupt_jvm_history_imports_nothing(tmp_path):
    repo = PORT.PartitionedMetricsRepository(str(tmp_path / "hist"))
    with pytest.raises(PORT.CorruptStateError):
        repo.import_jvm_history('[{"resultKey": {}}]')
    assert repo.load().get() == []
