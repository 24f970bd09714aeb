"""The persisted-state contract between the JAX package (deequ_tpu) and the
PyTorch/CUDA port (deequ_tpu_torch).

A v2 state blob (``.npz`` with the type name, the static fields as JSON,
the leaves in the reference's flatten order and dtypes, and an xxhash64
checksum; a grouping state as ``-frequencies.parquet`` plus a checksummed
``-meta.json``) written by either package's ``FileSystemStateProvider``
must load in the other, verify, and give the same metric; merged with the
other package's own state it must give the metric the other package's
merge gives. For every type of the reference's registry and for
``FrequenciesAndNumRows``. A flipped byte raises ``CorruptStateError`` in
both packages, a blob from a future version ``UnsupportedFormatVersionError``.
``checksum_bytes`` equals the reference's digest bit for bit.

Both packages fold the same data at the same batch size (the JAX package at
``placement="device"``). Tolerances: metrics of counts, min, max, HLL,
frequencies, type counts and KLL sketches equal; means, sums, standard
deviations and correlations within 1e-9 (their states within 1e-12
relative: the two packages add in different orders).
"""

from __future__ import annotations

import glob
import json
import math
import os

import jax  # noqa: F401 - the reference package runs on JAX's CPU backend
import numpy as np
import pyarrow as pa
import pytest
import torch

import deequ_tpu.analyzers as J
import deequ_tpu.analyzers.base as JB
import deequ_tpu.analyzers.state_provider as JSP
import deequ_tpu.exceptions as JE
import deequ_tpu.integrity as JI
from deequ_tpu.data import Dataset as JDataset
from deequ_tpu.runners import AnalysisRunner as JaxRunner
import deequ_tpu_torch as dq
import deequ_tpu_torch.analyzers.state_provider as TSP
import deequ_tpu_torch.exceptions as TE
import deequ_tpu_torch.integrity as TI
from deequ_tpu_torch.analyzers.base import merge_states_batched
from deequ_tpu_torch.analyzers.states import FrequencyCountsState

BATCH = 2048
MOMENT_METRICS = ("Mean", "Sum", "StandardDeviation", "Correlation")


def _table(n: int = 9000, seed: int = 21) -> pa.Table:
    rng = np.random.default_rng(seed)
    x = rng.normal(10.0, 3.0, n)
    x[rng.random(n) < 0.01] = np.nan
    words = np.array(["12", "3.5", "true", "abc", "-7", "x1", "0.25", "false"])
    strings = [None if rng.random() < 0.1 else str(w) for w in words[rng.integers(0, 8, n)]]
    codes = rng.integers(0, 30, n).astype(np.int32)
    return pa.table({
        "x": pa.array(x, mask=rng.random(n) < 0.05),
        "y": pa.array(2.0 * np.nan_to_num(x) + rng.normal(0, 1, n)),
        "s": pa.array(strings),
        "cat": pa.array(rng.integers(0, 2000, n)),
        "d": pa.DictionaryArray.from_arrays(
            pa.array(codes, mask=rng.random(n) < 0.1), pa.array([f"k{i}" for i in range(30)])),
    })


#: one analyzer per persisted state type of the reference's registry
#: (FrequencyCountsState, which no analyzer persists, has its own test),
#: and the grouping analyzers' FrequenciesAndNumRows
STATE_CASES = {
    "NumMatches": lambda m: m.Size(),
    "NumMatchesAndCount": lambda m: m.Completeness("x"),
    "MeanState": lambda m: m.Mean("x", "y > 15"),
    "SumState": lambda m: m.Sum("y"),
    "MinState": lambda m: m.Minimum("x"),
    "MaxState": lambda m: m.Maximum("x"),
    "StandardDeviationState": lambda m: m.StandardDeviation("y"),
    "CorrelationState": lambda m: m.Correlation("x", "y"),
    "DataTypeHistogram": lambda m: m.DataType("s"),
    "ApproxCountDistinctState": lambda m: m.ApproxCountDistinct("cat"),
    "KLLSketchState": lambda m: m.KLLSketch("y", m.KLLParameters(256, 0.64, 10)),
    "FrequenciesAndNumRows": lambda m: m.Uniqueness(["cat"]),
    "FrequenciesAndNumRows-histogram": lambda m: m.Histogram("d"),
}


def _metric_value(metric):
    v = metric.value
    if v.is_failure:
        return ("failure", type(v.exception).__name__)
    got = v.get()
    if hasattr(got, "buckets"):
        return ([(b.low_value, b.high_value, b.count) for b in got.buckets], got.parameters,
                got.data)
    if hasattr(got, "values"):
        return (got.number_of_bins, {k: (d.absolute, d.ratio) for k, d in got.values.items()})
    return got


def _assert_same_metric(name, want, got):
    want, got = _metric_value(want), _metric_value(got)
    if isinstance(want, float) and math.isnan(want):
        assert isinstance(got, float) and math.isnan(got), (name, want, got)
    elif name in MOMENT_METRICS and isinstance(want, float):
        assert (math.isnan(want) and math.isnan(got)) or abs(got - want) <= 1e-9 * max(
            1.0, abs(want)), (name, want, got)
    else:
        assert got == want, (name, want, got)


def _run_both(case, tmp_path):
    """Each package runs the case's analyzer over the table and persists
    its state through its own FileSystemStateProvider; returns both
    analyzers, both contexts and the two store directories."""
    table = _table()
    ja, ta = STATE_CASES[case](J), STATE_CASES[case](dq)
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "torch")
    jctx = JaxRunner.do_analysis_run(
        JDataset.from_arrow(table), [ja], save_states_with=JSP.FileSystemStateProvider(jdir),
        batch_size=BATCH, placement="device")
    tctx = dq.AnalysisRunner.do_analysis_run(
        dq.Dataset.from_arrow(table), [ta], save_states_with=TSP.FileSystemStateProvider(tdir),
        batch_size=BATCH, device="cpu")
    return ja, ta, jctx, tctx, jdir, tdir


@pytest.mark.parametrize("case", sorted(STATE_CASES))
def test_state_blob_loads_and_merges_across_packages(case, tmp_path):
    ja, ta, jctx, tctx, jdir, tdir = _run_both(case, tmp_path)
    name = ta.name
    _assert_same_metric(name, jctx.metric(ja), tctx.metric(ta))
    # the same file name in both stores (sha1 of the reference's repr)
    assert sorted(os.listdir(jdir)) == sorted(os.listdir(tdir))

    # the port's blob in the reference, the reference's blob in the port
    from_port = JSP.FileSystemStateProvider(tdir).load(ja)
    from_jax = TSP.FileSystemStateProvider(jdir).load(ta)
    _assert_same_metric(name, jctx.metric(ja), ja.compute_metric_from(from_port))
    _assert_same_metric(name, tctx.metric(ta), ta.compute_metric_from(from_jax))

    # merged with the other package's own state: both merges agree
    own_jax = JSP.FileSystemStateProvider(jdir).load(ja)
    own_port = TSP.FileSystemStateProvider(tdir).load(ta)
    jm = ja.compute_metric_from(JB.merge_states_batched(ja, [own_jax, from_port]))
    tm = ta.compute_metric_from(merge_states_batched(ta, [from_jax, own_port], "cpu"))
    _assert_same_metric(name, jm, tm)


@pytest.mark.parametrize("case", sorted(c for c in STATE_CASES if "Frequencies" not in c))
def test_state_blob_layout_and_checksum_match_the_reference(case, tmp_path):
    _, _, _, _, jdir, tdir = _run_both(case, tmp_path)
    (jpath,) = glob.glob(os.path.join(jdir, "*-state.npz"))
    (tpath,) = glob.glob(os.path.join(tdir, "*-state.npz"))
    jblob, tblob = np.load(jpath, allow_pickle=False), np.load(tpath, allow_pickle=False)
    assert sorted(jblob.files) == sorted(tblob.files)
    for key in ("__format_version__", "__state_type__", "__static__"):
        assert str(jblob[key]) == str(tblob[key]), key
    leaves = [tblob[f"leaf{i}"] for i in range(sum(f.startswith("leaf") for f in tblob.files))]
    for i, leaf in enumerate(leaves):
        want = jblob[f"leaf{i}"]
        assert leaf.dtype == want.dtype and leaf.shape == want.shape, (case, i)
    # the stored checksum is what both packages compute over the leaves
    static = json.loads(str(tblob["__static__"]))
    type_name = str(tblob["__state_type__"])
    stored = str(tblob["__checksum__"])
    assert stored == JSP._blob_checksum(type_name, static, leaves)
    assert stored == TSP._blob_checksum(type_name, static, leaves)


def test_frequency_counts_state_round_trips(tmp_path):
    key = dq.Size()
    state = FrequencyCountsState(torch.tensor([3, 0, 7, 1], dtype=torch.int64),
                                 torch.tensor(12, dtype=torch.int64))
    TSP.FileSystemStateProvider(str(tmp_path)).persist(key, state)
    loaded = JSP.FileSystemStateProvider(str(tmp_path)).load(J.Size())
    assert type(loaded).__name__ == "FrequencyCountsState"
    assert np.asarray(loaded.counts).tolist() == [3, 0, 7, 1] and int(loaded.num_rows) == 12
    JSP.FileSystemStateProvider(str(tmp_path / "j")).persist(J.Size(), loaded)
    back = TSP.FileSystemStateProvider(str(tmp_path / "j")).load(key)
    assert torch.equal(back.counts, state.counts) and torch.equal(back.num_rows, state.num_rows)
    merged = merge_states_batched(key, [back, state], "cpu")
    assert merged.counts.tolist() == [6, 0, 14, 2] and int(merged.num_rows) == 24


def _flip_byte(path: str, offset: int) -> None:
    with open(path, "r+b") as fh:
        fh.seek(offset)
        b = fh.read(1)
        fh.seek(offset)
        fh.write(bytes([b[0] ^ 0x5A]))


@pytest.mark.parametrize("case", ["CorrelationState", "KLLSketchState", "FrequenciesAndNumRows"])
@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_flipped_byte_raises_corrupt_state_in_both(case, writer, tmp_path):
    ja, ta, _, _, jdir, tdir = _run_both(case, tmp_path)
    store = jdir if writer == "jax" else tdir
    (path,) = [p for p in glob.glob(os.path.join(store, "*"))
               if p.endswith((".npz", ".parquet"))]
    _flip_byte(path, os.path.getsize(path) // 2)
    with pytest.raises(JE.CorruptStateError):
        JSP.FileSystemStateProvider(store).load(ja)
    with pytest.raises(TE.CorruptStateError):
        TSP.FileSystemStateProvider(store).load(ta)


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_blob_from_a_future_version_is_refused_by_both(writer, tmp_path):
    ja, ta, _, _, jdir, tdir = _run_both("MeanState", tmp_path)
    store = jdir if writer == "jax" else tdir
    (path,) = glob.glob(os.path.join(store, "*-state.npz"))
    blob = dict(np.load(path, allow_pickle=False))
    blob["__format_version__"] = np.int64(3)
    with open(path, "wb") as fh:
        np.savez(fh, **blob)
    with pytest.raises(JE.UnsupportedFormatVersionError):
        JSP.FileSystemStateProvider(store).load(ja)
    with pytest.raises(TE.UnsupportedFormatVersionError):
        TSP.FileSystemStateProvider(store).load(ta)


def test_future_frequency_sidecar_is_refused_by_both(tmp_path):
    ja, ta, _, _, jdir, tdir = _run_both("FrequenciesAndNumRows", tmp_path)
    for store in (jdir, tdir):
        (meta,) = glob.glob(os.path.join(store, "*-meta.json"))
        with open(meta) as fh:
            payload = json.load(fh)
        payload["formatVersion"] = 3
        with open(meta, "w") as fh:
            json.dump(payload, fh)
        with pytest.raises(JE.UnsupportedFormatVersionError):
            JSP.FileSystemStateProvider(store).load(ja)
        with pytest.raises(TE.UnsupportedFormatVersionError):
            TSP.FileSystemStateProvider(store).load(ta)


def test_v1_blob_loads_from_the_analyzer_structure(tmp_path):
    ja, ta, _, tctx, _, tdir = _run_both("StandardDeviationState", tmp_path)
    (path,) = glob.glob(os.path.join(tdir, "*-state.npz"))
    blob = np.load(path, allow_pickle=False)
    v1 = {k: blob[k] for k in blob.files if k.startswith("leaf")}
    with open(path, "wb") as fh:
        np.savez(fh, **v1)
    _assert_same_metric("StandardDeviation", tctx.metric(ta),
                        ta.compute_metric_from(TSP.FileSystemStateProvider(tdir).load(ta)))
    _assert_same_metric("StandardDeviation", tctx.metric(ta),
                        ja.compute_metric_from(JSP.FileSystemStateProvider(tdir).load(ja)))


@pytest.mark.parametrize("size", [0, 7, 1023, 1024, 10**6])
def test_checksum_bytes_matches_the_reference(size):
    payload = np.random.default_rng(size).integers(0, 256, size, dtype=np.uint8).tobytes()
    assert TI.checksum_bytes(payload) == JI.checksum_bytes(payload)
    assert TI.checksum_bytes(memoryview(payload)) == JI.checksum_bytes(payload)
    doc = {"b": [1, 2.5, "x"], "a": size}
    assert TI.checksum_json(doc) == JI.checksum_json(doc)


def test_unregistered_state_type_is_refused(tmp_path):
    from deequ_tpu_torch.analyzers.states import FrequencyTableState

    with pytest.raises(ValueError):
        TSP.FileSystemStateProvider(str(tmp_path)).persist(
            dq.Size(), FrequencyTableState.init(4, 8, "cpu"))
