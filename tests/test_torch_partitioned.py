"""Partition-aware incremental verification of the PyTorch/CUDA port
(deequ_tpu_torch.runners.incremental, repository.partition_store) against
the JAX reference: the reference's cases of ``tests/test_incremental.py``
run through both packages (``m`` is either package; the port on
``device="cpu"``), then the port's metrics are held against the
reference's on the same seeded data, and a store written by either package
is reused by the other.

Tolerances: counts, minima, maxima, HLL, frequencies and uniqueness equal
bit for bit; means, sums and standard deviations within 1e-12 relative of
the reference's (the reduction order differs between the packages), and
bit for bit against a full re-scan of the same package whose batches are
the partitions; KLL sketches equal at the same batch boundaries. The
reference runs at ``placement="device"`` (tests/conftest.py), the port's
partitions in one batch each (the default batch size).
"""

from __future__ import annotations

import glob
import os
from types import SimpleNamespace

import numpy as np
import pyarrow as pa
import pytest

import deequ_tpu.analyzers as J
import deequ_tpu.checks as JC
import deequ_tpu.exceptions as JE
import deequ_tpu.reliability as JRel
import deequ_tpu.repository.partition_store as JPS
import deequ_tpu.runners.incremental as JI
from deequ_tpu.data import Dataset as JDataset
from deequ_tpu.runners.engine import RunMonitor as JMonitor
from deequ_tpu.verification import VerificationSuite as JSuite
import deequ_tpu_torch as dq
import deequ_tpu_torch.analyzers as T
import deequ_tpu_torch.exceptions as TE
import deequ_tpu_torch.reliability as TRel
import deequ_tpu_torch.repository.partition_store as TPS
import deequ_tpu_torch.runners.incremental as TI

ROWS = 2048
MOMENTS = ("Mean", "Sum", "StandardDeviation")

REF = SimpleNamespace(
    name="jax", A=J, C=JC, Dataset=JDataset, ps=JPS, inc=JI, Suite=JSuite, Monitor=JMonitor,
    CorruptStateError=JE.CorruptStateError, FaultSpec=JRel.FaultSpec, inject=JRel.inject, kw={},
)
PORT = SimpleNamespace(
    name="torch", A=T, C=dq, Dataset=dq.Dataset, ps=TPS, inc=TI, Suite=dq.VerificationSuite,
    Monitor=dq.RunMonitor, CorruptStateError=TE.CorruptStateError, FaultSpec=TRel.FaultSpec,
    inject=TRel.inject, kw={"device": "cpu"},
)


@pytest.fixture(params=[REF, PORT], ids=["jax", "torch"])
def m(request):
    return request.param


def columns(seed: int, rows: int = ROWS) -> dict:
    rng = np.random.default_rng(seed)
    return {
        "id": np.arange(rows, dtype=np.int64) + seed * 1_000_000,
        "v": rng.normal(10.0, 2.0, rows),
        "cat": np.array(["a", "b", "c", "d"])[rng.integers(0, 4, rows)],
    }


def part(m, seed: int, rows: int = ROWS):
    return m.Dataset.from_dict(columns(seed, rows))


def concat(m, *seeds: int):
    return m.Dataset.from_arrow(pa.concat_tables([part(m, s).arrow for s in seeds]))


def battery(m) -> list:
    A = m.A
    return [A.Size(), A.Completeness("v"), A.Mean("v"), A.Sum("v"), A.Minimum("v"),
            A.Maximum("v"), A.StandardDeviation("v"), A.ApproxCountDistinct("cat"),
            A.Uniqueness(["id"]), A.KLLSketch("v")]


def checks(m) -> list:
    return [m.C.Check(m.C.CheckLevel.ERROR, "incremental battery")
            .has_size(lambda n: n > 0)
            .is_complete("v")
            .has_mean("v", lambda x: 5.0 < x < 15.0)
            .has_uniqueness(["id"], lambda u: u == 1.0)
            .has_approx_count_distinct("cat", lambda c: c >= 4)]


def run(m, store, dataset, parts, analyzers, **kw):
    return m.inc.run_incremental(store, dataset, parts, analyzers, **m.kw, **kw)


def verify(m, store, dataset, parts, **kw):
    return m.Suite.verify_partitioned(store, dataset, parts, checks(m), battery(m),
                                      batch_size=ROWS, **m.kw, **kw)


def full_run(m, data, analyzers):
    return m.Suite.do_verification_run(data, [], analyzers, batch_size=ROWS, **m.kw)


def value(metric):
    v = metric.value.get()
    return repr(v.buckets) if hasattr(v, "buckets") else v


def values(metrics: dict) -> dict:
    return {repr(a): value(mt) for a, mt in metrics.items()}


def flip_byte(path: str) -> None:
    raw = bytearray(open(path, "rb").read())
    raw[len(raw) // 2] ^= 0xFF
    open(path, "wb").write(bytes(raw))


def assert_close(got: dict, want: dict) -> None:
    """The port against the reference: moments within 1e-12 relative,
    everything else equal."""
    assert set(got) == set(want)
    for key, w in want.items():
        if key.split("(")[0] in MOMENTS:
            assert got[key] == pytest.approx(w, rel=1e-12), key
        else:
            assert got[key] == w, key


# -- the store --------------------------------------------------------------


def test_commit_get_roundtrip(m, tmp_path):
    store = m.ps.PartitionStateStore(str(tmp_path))
    store.commit("ds", "2026-01-03", fingerprint="fp", content_checksum="cc", num_rows=7,
                 analyzer_keys=["A", "B"], schema=[("x", "Integral")])
    got = store.get("ds", "2026-01-03")
    assert got.fingerprint == "fp" and got.content_checksum == "cc"
    assert got.num_rows == 7 and got.covers(["A"]) and got.covers(["A", "B"])
    assert not got.covers(["A", "C"])
    assert got.schema == (("x", "Integral"),)
    assert store.get("ds", "nope") is None


def test_time_partitioned_listing_and_window(m, tmp_path, monkeypatch):
    store = m.ps.PartitionStateStore(str(tmp_path))
    names = [f"2026-{mo:02d}-01" for mo in range(1, 7)] + ["adhoc-load"]
    for n in names:
        store.commit("ds", n, fingerprint="fp", content_checksum="c", num_rows=1,
                     analyzer_keys=[])
    assert store.list_partitions("ds") == sorted(names)
    assert store.list_partitions("ds", after="2026-03", before="2026-05") == [
        "2026-03-01", "2026-04-01", "2026-05-01"]
    assert m.ps.partition_bucket("2026-03-01") == "2026-03"
    assert os.path.isdir(os.path.join(str(tmp_path), "ds-ds", "2026-03"))
    assert m.ps.partition_bucket("adhoc-load").startswith("x")
    monkeypatch.setenv(m.ps.PARTITION_WINDOW_ENV, "2")
    assert store.list_partitions("ds") == ["2026-05-01", "2026-06-01", "adhoc-load"]
    monkeypatch.setenv(m.ps.PARTITION_WINDOW_ENV, "banana")
    assert len(store.list_partitions("ds")) == 7


def test_delete_invalidate_and_weird_names(m, tmp_path):
    store = m.ps.PartitionStateStore(str(tmp_path))
    store.commit("ds", "p1", fingerprint="f", content_checksum="c", num_rows=1,
                 analyzer_keys=[])
    store.invalidate("ds", "p1")
    assert store.get("ds", "p1") is None
    store.commit("ds", "p2", fingerprint="f", content_checksum="c", num_rows=1,
                 analyzer_keys=[])
    assert store.delete("ds", "p2") is True
    assert store.list_partitions("ds") == []
    names = ["UPPER/slash", "dots..", "ünïcode", "_underscore"]
    for n in names:
        store.commit("w", n, fingerprint="f", content_checksum="c", num_rows=1,
                     analyzer_keys=[])
    assert store.list_partitions("w") == sorted(names)


def test_corrupt_manifest_quarantines_typed(m, tmp_path):
    store = m.ps.PartitionStateStore(str(tmp_path))
    store.commit("ds", "p", fingerprint="f", content_checksum="c", num_rows=1,
                 analyzer_keys=[])
    [manifest] = glob.glob(str(tmp_path / "ds-ds" / "*" / "p-p" / "partition-manifest.json"))
    raw = open(manifest).read().replace('"numRows": 1', '"numRows": 2')
    open(manifest, "w").write(raw)
    before = m.ps.partition_quarantined_total()
    with pytest.raises(m.CorruptStateError):
        store.get("ds", "p")
    assert m.ps.partition_quarantined_total() == before + 1
    assert glob.glob(str(tmp_path) + ".quarantine/*")


def test_manifests_and_checksums_are_the_references():
    """The manifest JSON, the rollup manifest and the content checksum of
    the two packages agree byte for byte."""
    table = pa.table(columns(9, 4096))
    for window in ((0, 1024), (1024, 1024)):
        assert (TI.dataset_content_checksum(dq.Dataset.from_arrow(table.slice(*window)))
                == JI.dataset_content_checksum(JDataset.from_arrow(table.slice(*window))))
    a = TI.dataset_content_checksum(dq.Dataset.from_arrow(table.slice(0, 1024)))
    assert a != TI.dataset_content_checksum(dq.Dataset.from_arrow(table.slice(1024, 1024)))
    assert TI.contract_fingerprint(part(PORT, 1).schema) == JI.contract_fingerprint(
        part(REF, 1).schema)
    assert [TI.analyzer_key(a) for a in battery(PORT)] == [
        JI.analyzer_key(a) for a in battery(REF)]


def test_sliced_window_shift_invalidates(m, tmp_path):
    store = m.ps.PartitionStateStore(str(tmp_path))
    table = part(m, 10, rows=4096).arrow
    analyzers = [m.A.Size(), m.A.Mean("v")]
    run(m, store, "tbl", {"w": m.Dataset.from_arrow(table.slice(0, 2048))}, analyzers)
    _, rep = run(m, store, "tbl", {"w": m.Dataset.from_arrow(table.slice(2048, 2048))},
                 analyzers)
    assert rep.plan.reasons.get("w") == "content-changed"


def test_memory_uri_roundtrip(m):
    from fsspec.implementations.memory import MemoryFileSystem

    MemoryFileSystem.store.clear()
    try:
        store = m.ps.PartitionStateStore(f"memory://pstore-{m.name}")
        analyzers = [m.A.Size(), m.A.Mean("v")]
        parts = {"p1": part(m, 81), "p2": part(m, 82)}
        ctx, rep = run(m, store, "tbl", parts, analyzers, batch_size=ROWS)
        assert rep.plan.scan == ["p1", "p2"]
        assert store.list_partitions("tbl") == ["p1", "p2"]
        ctx2, rep2 = run(m, store, "tbl", parts, analyzers, batch_size=ROWS)
        assert rep2.plan.fully_reused
        assert ctx2.metric(m.A.Size()).value.get() == ctx.metric(m.A.Size()).value.get() == 2.0 * ROWS
        assert store.delete("tbl", "p1") is True
        assert store.list_partitions("tbl") == ["p2"]
    finally:
        MemoryFileSystem.store.clear()


# -- the delta planner ------------------------------------------------------


def test_lifecycle_new_reuse_changed_dropped(m, tmp_path):
    store = m.ps.PartitionStateStore(str(tmp_path))
    analyzers = [m.A.Size(), m.A.Mean("v")]
    mon = m.Monitor()
    ctx, rep = run(m, store, "ds", {"p1": part(m, 1), "p2": part(m, 2)}, analyzers,
                   monitor=mon)
    assert rep.plan.scan == ["p1", "p2"] and rep.plan.reuse == []
    assert mon.partitions_scanned == 2 and mon.partitions_reused == 0
    mon2 = m.Monitor()
    ctx2, rep2 = run(m, store, "ds", {"p1": part(m, 1), "p2": part(m, 2)}, analyzers,
                     monitor=mon2)
    assert rep2.plan.fully_reused and rep2.rows_scanned == 0
    assert rep2.rows_total == 2 * ROWS and mon2.partitions_reused == 2
    assert ctx.metric(m.A.Size()).value.get() == ctx2.metric(m.A.Size()).value.get()
    mon3 = m.Monitor()
    _, rep3 = run(m, store, "ds", {"p1": part(m, 1), "p2": part(m, 22)}, analyzers,
                  monitor=mon3)
    assert rep3.plan.scan == ["p2"] and rep3.plan.invalidated == ["p2"]
    assert rep3.plan.reasons["p2"] == "content-changed"
    assert mon3.partitions_invalidated == 1
    ctx4, rep4 = run(m, store, "ds", {"p1": part(m, 1)}, analyzers, delete_dropped=True)
    assert rep4.plan.dropped == ["p2"]
    assert ctx4.metric(m.A.Size()).value.get() == float(ROWS)
    assert store.list_partitions("ds") == ["p1"]


def test_zero_data_touched_on_reuse(m, tmp_path):
    store = m.ps.PartitionStateStore(str(tmp_path))
    analyzers = [m.A.Size(), m.A.Mean("v")]
    calls = []

    def loader():
        calls.append(1)
        return part(m, 3)

    run(m, store, "ds", {"p": m.inc.PartitionInput("p", loader, "v7")}, analyzers)
    assert calls
    calls.clear()
    ctx, rep = run(m, store, "ds", {"p": m.inc.PartitionInput("p", loader, "v7")}, analyzers)
    assert rep.plan.fully_reused and calls == []
    assert ctx.metric(m.A.Size()).value.get() == float(ROWS) and rep.rows_total == ROWS
    _, rep2 = run(m, store, "ds", {"p": m.inc.PartitionInput("p", loader, "v8")}, analyzers)
    assert calls and rep2.plan.reasons["p"] == "content-changed"


def test_fingerprint_battery_and_unversioned_rules(m, tmp_path):
    store = m.ps.PartitionStateStore(str(tmp_path))
    run(m, store, "ds", {"p": part(m, 1)}, [m.A.Size()])
    renamed = m.Dataset.from_dict({"w": np.arange(ROWS, dtype=np.int64)})
    _, rep = run(m, store, "ds", {"p": renamed}, [m.A.Size()])
    assert rep.plan.reasons["p"] == "stale-fingerprint" and rep.plan.invalidated == ["p"]
    run(m, store, "b", {"p": part(m, 1)}, [m.A.Size()])
    _, grew = run(m, store, "b", {"p": part(m, 1)}, [m.A.Size(), m.A.Mean("v")])
    assert grew.plan.reasons["p"] == "battery-grew"
    _, shrunk = run(m, store, "b", {"p": part(m, 1)}, [m.A.Size()])
    assert shrunk.plan.fully_reused
    lazy = {"p": m.inc.PartitionInput("p", lambda: part(m, 1))}
    run(m, store, "u", lazy, [m.A.Size()])
    _, unversioned = run(m, store, "u", {"p": m.inc.PartitionInput("p", lambda: part(m, 1))},
                         [m.A.Size()])
    assert unversioned.plan.reasons["p"] == "unversioned"


# -- grow, verify, and the merge's bits ---------------------------------------


def test_incremental_equals_full_scan_bit_exact(m, tmp_path):
    store = m.ps.PartitionStateStore(str(tmp_path))
    parts = {f"2026-07-{s:02d}": part(m, s) for s in (1, 2, 3)}
    assert verify(m, store, "tbl", parts).status == m.C.CheckStatus.SUCCESS
    for grown in ([1, 2, 3, 4], [1, 2, 3, 4, 5]):
        parts = {f"2026-07-{s:02d}": part(m, s) for s in grown}
        r = verify(m, store, "tbl", parts)
        assert r.incremental.plan.scan == [f"2026-07-{grown[-1]:02d}"]
        assert r.incremental.rows_scanned == ROWS
        assert r.incremental.rows_total == ROWS * len(grown)
        full = m.Suite.do_verification_run(concat(m, *grown), checks(m), battery(m),
                                           batch_size=ROWS, **m.kw)
        assert r.status == full.status == m.C.CheckStatus.SUCCESS
        assert values(r.metrics) == values(full.metrics)


def test_grouping_states_ride_the_store(m, tmp_path):
    store = m.ps.PartitionStateStore(str(tmp_path))
    A = m.A
    analyzers = [A.Size(), A.Uniqueness(["cat"]), A.Uniqueness(["id"])]
    parts = {"p1": part(m, 11), "p2": part(m, 12)}
    ctx, _ = run(m, store, "tbl", parts, analyzers)
    full = full_run(m, concat(m, 11, 12), analyzers)
    assert ctx.metric(A.Uniqueness(["id"])).value.get() == 1.0
    assert (ctx.metric(A.Uniqueness(["cat"])).value.get()
            == full.metrics[A.Uniqueness(["cat"])].value.get())
    ctx2, rep2 = run(m, store, "tbl", parts, analyzers)
    assert rep2.plan.fully_reused
    assert values(ctx2.metric_map) == values(ctx.metric_map)


def test_deletion_re_merge_consistency(m, tmp_path):
    store = m.ps.PartitionStateStore(str(tmp_path))
    analyzers = [m.A.Size(), m.A.Sum("v"), m.A.Mean("v")]
    parts = {f"p{s}": part(m, s) for s in (1, 2, 3)}
    run(m, store, "tbl", parts, analyzers, batch_size=ROWS)
    del parts["p2"]
    ctx, rep = run(m, store, "tbl", parts, analyzers, batch_size=ROWS)
    assert rep.plan.dropped == ["p2"] and rep.rows_scanned == 0
    assert values(ctx.metric_map) == values(full_run(m, concat(m, 1, 3), analyzers).metrics)


def test_growth_uses_the_rollup_prefix(m, tmp_path):
    store = m.ps.PartitionStateStore(str(tmp_path))
    A = m.A
    analyzers = [A.Size(), A.Mean("v"), A.Sum("v"), A.StandardDeviation("v")]
    parts = {"p1": part(m, 1), "p2": part(m, 2)}
    run(m, store, "tbl", parts, analyzers, batch_size=ROWS)
    assert store.rollup_get("tbl") is not None
    parts["p3"] = part(m, 3)
    mon = m.Monitor()
    ctx, _ = run(m, store, "tbl", parts, analyzers, batch_size=ROWS, monitor=mon)
    assert mon.partitions_rolled_up == 2
    assert values(ctx.metric_map) == values(full_run(m, concat(m, 1, 2, 3), analyzers).metrics)
    mon2 = m.Monitor()
    ctx2, _ = run(m, store, "tbl", parts, analyzers, batch_size=ROWS, monitor=mon2)
    assert mon2.partitions_rolled_up == 3
    assert values(ctx2.metric_map) == values(ctx.metric_map)
    # a changed prefix partition rebuilds the rollup
    parts["p1"] = part(m, 11)
    mon3 = m.Monitor()
    ctx3, rep3 = run(m, store, "tbl", parts, analyzers, batch_size=ROWS, monitor=mon3)
    assert rep3.plan.scan == ["p1"] and mon3.partitions_rolled_up == 0
    assert values(ctx3.metric_map) == values(full_run(m, concat(m, 11, 2, 3), analyzers).metrics)


def test_corrupt_rollup_blob_falls_back_to_partitions(m, tmp_path):
    store = m.ps.PartitionStateStore(str(tmp_path))
    analyzers = [m.A.Size(), m.A.Mean("v")]
    parts = {"p1": part(m, 1), "p2": part(m, 2)}
    ctx0, _ = run(m, store, "tbl", parts, analyzers, batch_size=ROWS)
    [blob] = glob.glob(str(tmp_path / "ds-tbl" / "rollup" / "Mean-*-state.npz"))
    flip_byte(blob)
    ctx, rep = run(m, store, "tbl", parts, analyzers, batch_size=ROWS)
    assert rep.plan.fully_reused
    assert values(ctx.metric_map) == values(ctx0.metric_map)


def test_corrupt_state_blob_quarantines_and_rescans_one(m, tmp_path):
    store = m.ps.PartitionStateStore(str(tmp_path))
    analyzers = [m.A.Size(), m.A.Mean("v"), m.A.Sum("v")]
    parts = {"p1": part(m, 1), "p2": part(m, 2), "p3": part(m, 3)}
    run(m, store, "tbl", parts, analyzers, batch_size=ROWS)
    store.rollup_invalidate("tbl")
    [blob] = glob.glob(str(tmp_path / "ds-tbl" / "*" / "p-p2" / "Mean-*-state.npz"))
    flip_byte(blob)
    mon = m.Monitor()
    ctx, rep = run(m, store, "tbl", parts, analyzers, batch_size=ROWS, monitor=mon)
    assert rep.plan.reasons.get("p2") == "corrupt-state"
    assert sorted(rep.plan.reuse) == ["p1", "p3"] and rep.rows_scanned == ROWS
    assert mon.corrupt_quarantined >= 1
    assert values(ctx.metric_map) == values(full_run(m, concat(m, 1, 2, 3), analyzers).metrics)
    # no payload to re-scan from: the typed error reaches the caller
    run(m, store, "one", {"p": part(m, 1)}, analyzers)
    store.rollup_invalidate("one")
    [blob] = glob.glob(str(tmp_path / "ds-one" / "*" / "p-p" / "Mean-*-state.npz"))
    flip_byte(blob)
    with pytest.raises((m.CorruptStateError, ValueError)):
        run(m, store, "one", {"p": m.inc.PartitionInput("p", None, None)}, analyzers)


def test_partition_store_load_fault_site(m, tmp_path):
    store = m.ps.PartitionStateStore(str(tmp_path))
    analyzers = [m.A.Size(), m.A.Mean("v")]
    parts = {"p1": part(m, 1), "p2": part(m, 2)}
    run(m, store, "tbl", parts, analyzers)
    with m.inject(m.FaultSpec("partition_store_load", "corrupt", match="tbl/p1",
                              count=1)) as inj:
        ctx, rep = run(m, store, "tbl", parts, analyzers)
    assert inj.fired
    assert "p1" in rep.plan.scan and "p2" in rep.plan.reuse
    assert "corrupt-manifest" in rep.plan.reasons["p1"]
    assert ctx.metric(m.A.Size()).value.get() == float(2 * ROWS)


def test_builder_entry_point(tmp_path):
    store = TPS.PartitionStateStore(str(tmp_path))
    result = (dq.VerificationSuite.on_partitions(store, "tbl", {"p": part(PORT, 41)},
                                                 device="cpu")
              .add_checks(checks(PORT)).with_batch_size(ROWS).run())
    assert result.status == dq.CheckStatus.SUCCESS
    assert result.incremental.plan.scan == ["p"]
    assert isinstance(result, dq.verification.IncrementalVerificationResult)


# -- the port against the reference -----------------------------------------


def test_grow_verify_equals_the_reference(tmp_path):
    """The same grow, re-verify, change, drop sequence in both packages:
    the same plans and check statuses, the metrics within the stated
    tolerances."""
    stores = {pk.name: pk.ps.PartitionStateStore(str(tmp_path / pk.name)) for pk in (REF, PORT)}
    steps = [
        ({1: "a", 2: "b"}, None),
        ({1: "a", 2: "b", 3: "c"}, None),
        ({1: "a", 2: "b2", 3: "c"}, {2: 22}),
        ({2: "b2", 3: "c"}, {2: 22}),
    ]
    for tokens, swaps in steps:
        seen = {}
        for pk in (REF, PORT):
            parts = {f"2026-07-{s:02d}": part(pk, (swaps or {}).get(s, s)) for s in tokens}
            sums = {f"2026-07-{s:02d}": t for s, t in tokens.items()}
            r = pk.Suite.verify_partitioned(stores[pk.name], "tbl", parts, checks(pk),
                                            battery(pk), checksums=sums, batch_size=ROWS,
                                            delete_dropped=True, **pk.kw)
            seen[pk.name] = r
        j, t = seen["jax"], seen["torch"]
        assert t.incremental.plan.as_dict() == j.incremental.plan.as_dict()
        assert t.status.value == j.status.value
        assert_close(values(t.metrics), values(j.metrics))
    assert stores["torch"].list_partitions("tbl") == stores["jax"].list_partitions("tbl")


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_a_store_written_by_either_package_is_reused_by_the_other(writer, tmp_path):
    """Partitions (and the rollup) one package scanned are planned as fully
    reused by the other: no payload touched, 0 rows scanned, the metrics
    the writer's within the tolerances; growth then scans only the new
    partition and folds from the writer's rollup."""
    first, second = (REF, PORT) if writer == "jax" else (PORT, REF)
    store_path = str(tmp_path / "shared")
    tokens = {"2026-07-01": "a", "2026-07-02": "b"}
    written = first.inc.run_incremental(
        first.ps.PartitionStateStore(store_path), "tbl",
        {n: part(first, i + 1) for i, n in enumerate(tokens)}, battery(first),
        checksums=tokens, batch_size=ROWS, **first.kw)[0]

    def boom():
        raise AssertionError("a reused partition's payload was read")

    store = second.ps.PartitionStateStore(store_path)
    mon = second.Monitor()
    ctx, rep = second.inc.run_incremental(store, "tbl", {n: boom for n in tokens},
                                          battery(second), checksums=tokens, monitor=mon,
                                          **second.kw)
    assert rep.plan.fully_reused and rep.rows_scanned == 0 and rep.rows_total == 2 * ROWS
    assert mon.partitions_rolled_up == 2
    assert_close(values(ctx.metric_map), values(written.metric_map))
    grown = dict(tokens, **{"2026-07-03": "c"})
    payloads = {n: boom for n in tokens}
    payloads["2026-07-03"] = part(second, 3)
    ctx2, rep2 = second.inc.run_incremental(store, "tbl", payloads, battery(second),
                                            checksums=grown, batch_size=ROWS, **second.kw)
    assert rep2.plan.scan == ["2026-07-03"] and rep2.rows_scanned == ROWS
    want = first.Suite.do_verification_run(concat(first, 1, 2, 3), [], battery(first),
                                           batch_size=ROWS, **first.kw)
    assert_close(values(ctx2.metric_map), values(want.metrics))


def test_profiles_and_suggestions_on_stored_states_equal_the_reference(tmp_path):
    """``profile_partitioned`` and ``suggest_partitioned``: the second call
    is fully reused with equal profiles and suggestions, in both packages;
    the port's profiles and suggestion JSON equal the reference's."""
    from deequ_tpu.suggestions import Rules as JRules
    from deequ_tpu_torch.suggestions import Rules as TRules

    got = {}
    for pk, rules in ((REF, JRules), (PORT, TRules)):
        store = pk.ps.PartitionStateStore(str(tmp_path / pk.name))
        parts = {"p1": part(pk, 51), "p2": part(pk, 52)}
        profiles, rep = pk.inc.profile_partitioned(store, "tbl", parts, batch_size=ROWS,
                                                   **pk.kw)
        assert set(rep.plan.scan) == {"p1", "p2"}
        again, rep2 = pk.inc.profile_partitioned(store, "tbl", parts, batch_size=ROWS,
                                                 **pk.kw)
        assert rep2.plan.fully_reused
        s1, srep1 = pk.inc.suggest_partitioned(store, "tbl", parts, rules.DEFAULT,
                                               batch_size=ROWS, **pk.kw)
        s2, srep2 = pk.inc.suggest_partitioned(store, "tbl", parts, rules.DEFAULT,
                                               batch_size=ROWS, **pk.kw)
        assert srep1.plan.fully_reused and srep2.plan.fully_reused
        assert s1.to_json() == s2.to_json()
        got[pk.name] = (profiles, again, s2)
    jp, jagain, js = got["jax"]
    tp, tagain, ts = got["torch"]
    for name in ("id", "v", "cat"):
        for prof in (tp, tagain):
            a, b = prof[name], jp[name]
            assert a.completeness == b.completeness
            assert a.approximate_num_distinct_values == b.approximate_num_distinct_values
            assert a.data_type == b.data_type
    assert tp["v"].mean == pytest.approx(jp["v"].mean, rel=1e-12)
    assert tagain["v"].mean == tp["v"].mean
    assert tp["cat"].histogram is not None
    assert ts.to_json() == js.to_json()


def test_the_device_defaults_to_the_card(tmp_path):
    import torch

    store = TPS.PartitionStateStore(str(tmp_path))
    if torch.cuda.is_available():
        assert dq.VerificationSuite.on_partitions(store, "tbl", {}).device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        dq.VerificationSuite.on_partitions(store, "tbl", {"p": part(PORT, 1)})
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TI.run_incremental(store, "tbl", {"p": part(PORT, 1)}, [T.Size()])
