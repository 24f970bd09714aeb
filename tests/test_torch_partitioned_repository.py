"""The time-partitioned metrics repository and the compaction lease of the
PyTorch/CUDA port (deequ_tpu_torch.repository.partitioned, .lease) against
the JAX reference: the reference's cases of
``tests/test_partitioned_repository.py`` and ``tests/test_cluster_lease.py``
run through both packages (``m`` is either package), and a history or a
lease written by either package is read, compacted or honoured by the
other.

Tolerances: the stored metrics are JSON, so every value read back equals
the value saved, bit for bit; the port's and the reference's analyzer
contexts are of the same 64 seeded rows (Size and Completeness equal, Mean
within 1e-12 relative).
"""

from __future__ import annotations

import json
import os
import time
from types import SimpleNamespace

import numpy as np
import pytest

import deequ_tpu.analyzers as J
import deequ_tpu.exceptions as JE
import deequ_tpu.interop as JInterop
import deequ_tpu.io as JIO
import deequ_tpu.reliability as JRel
import deequ_tpu.repository as JRepo
import deequ_tpu.repository.fs as JFS
import deequ_tpu.repository.lease as JL
from deequ_tpu.data import Dataset as JDataset
from deequ_tpu.runners import AnalysisRunner as JRunner
import deequ_tpu_torch as dq
import deequ_tpu_torch.analyzers as T
import deequ_tpu_torch.exceptions as TE
import deequ_tpu_torch.io as TIO
import deequ_tpu_torch.reliability as TRel
import deequ_tpu_torch.repository as TRepo
import deequ_tpu_torch.repository.fs as TFS
import deequ_tpu_torch.repository.lease as TL

DAY_MS = 86_400_000
BASE_MS = 1_735_689_600_000  # 2025-01-01T00:00Z

REF = SimpleNamespace(name="jax", A=J, Dataset=JDataset, Runner=JRunner, R=JRepo, fs=JFS,
                      lease=JL, io=JIO, CorruptStateError=JE.CorruptStateError,
                      FaultSpec=JRel.FaultSpec, inject=JRel.inject, kw={})
PORT = SimpleNamespace(name="torch", A=T, Dataset=dq.Dataset, Runner=dq.AnalysisRunner,
                       R=TRepo, fs=TFS, lease=TL, io=TIO, CorruptStateError=TE.CorruptStateError,
                       FaultSpec=TRel.FaultSpec, inject=TRel.inject, kw={"device": "cpu"})
_CONTEXTS = {}


@pytest.fixture(params=[REF, PORT], ids=["jax", "torch"])
def m(request):
    return request.param


def context(m, rows: int = 64, battery=None):
    """The analyzer context the histories hold: Size, Completeness and
    Mean over ``rows`` seeded values."""
    key = (m.name, rows, battery)
    if key not in _CONTEXTS:
        data = m.Dataset.from_dict({"x": np.random.default_rng(0).normal(10, 2, rows)})
        analyzers = ([m.A.Size(), m.A.Completeness("x"), m.A.Mean("x")] if battery is None
                     else [m.A.Size()])
        _CONTEXTS[key] = m.Runner.do_analysis_run(data, analyzers, **m.kw)
    return _CONTEXTS[key]


def populate(m, repo, days, tags=None, ctx=None):
    ctx = ctx if ctx is not None else context(m)
    for d in range(days):
        repo.save(m.R.ResultKey(BASE_MS + d * DAY_MS, tags or {}), ctx)


def repo_of(m, path, **kw):
    return m.R.PartitionedMetricsRepository(str(path), **kw)


def flip_mean(path) -> None:
    raw = path.read_text()
    i = raw.index("Mean") + 1
    path.write_text(raw[:i] + ("X" if raw[i] != "X" else "Y") + raw[i + 1:])


def size_of(m, result) -> float:
    return result.analyzer_context.metric_map[m.A.Size()].value.get()


# -- layout -----------------------------------------------------------------


def test_month_bucket(m):
    assert m.R.month_bucket(BASE_MS) == "2025-01"
    assert m.R.month_bucket(BASE_MS + 40 * DAY_MS) == "2025-02"
    assert m.R.month_bucket(0) == "1970-01"


def test_entries_land_in_month_buckets_and_windows_walk_only_theirs(m, tmp_path):
    repo = repo_of(m, tmp_path / "hist")
    populate(m, repo, 365)
    assert len(repo.buckets()) == 12
    assert len(repo.load().get()) == 365
    repo.entries_deserialized = 0
    repo.buckets_walked = 0
    got = repo.load().after(BASE_MS + 150 * DAY_MS).before(BASE_MS + 170 * DAY_MS).get()
    assert len(got) == 21
    assert repo.buckets_walked <= 2 and repo.entries_deserialized <= 62


def test_save_is_append_not_full_rewrite(m, tmp_path):
    repo = repo_of(m, tmp_path / "hist", compact_threshold=10_000)
    populate(m, repo, 60)
    jan = tmp_path / "hist" / "2025-01"
    before = sorted(os.listdir(jan))
    repo.save(m.R.ResultKey(BASE_MS + 45 * DAY_MS), context(m))
    assert sorted(os.listdir(jan)) == before


# -- compaction ---------------------------------------------------------------


def test_bucket_compacts_past_threshold_and_explicitly(m, tmp_path):
    repo = repo_of(m, tmp_path / "hist", compact_threshold=8)
    populate(m, repo, 20)
    files = os.listdir(tmp_path / "hist" / "2025-01")
    assert "compacted.json" in files
    assert len([f for f in files if f.startswith("e-")]) < 8
    assert len(repo.load().get()) == 20
    other = repo_of(m, tmp_path / "other", compact_threshold=10_000)
    populate(m, other, 5)
    assert other.compact("2025-01") == 5
    assert [f for f in os.listdir(tmp_path / "other" / "2025-01") if f.startswith("e-")] == []
    assert len(other.load().get()) == 5


@pytest.mark.parametrize("compact_first", [False, True])
def test_a_stale_entry_never_wins_after_a_failed_removal(m, tmp_path, monkeypatch, compact_first):
    repo = repo_of(m, tmp_path / "hist", compact_threshold=10_000)
    key = m.R.ResultKey(BASE_MS, {"env": "prod"})
    repo.save(key, context(m))

    def readonly(path):
        raise OSError("readonly")

    if compact_first:
        monkeypatch.setattr(m.io, "remove_file", readonly)
        repo.compact(m.R.month_bucket(BASE_MS))
        monkeypatch.undo()
    v2 = context(m, rows=2, battery="size")
    monkeypatch.setattr(m.io, "remove_file", readonly)
    repo.save(key, v2)
    monkeypatch.undo()
    for _ in range(2):
        got = repo.load().get()
        assert len(got) == 1 and size_of(m, got[0]) == 2.0
        repo.compact(m.R.month_bucket(BASE_MS))


def test_corrupt_entries_self_heal(m, tmp_path):
    repo = repo_of(m, tmp_path / "hist", compact_threshold=10_000)
    populate(m, repo, 3)
    entry = sorted(f for f in os.listdir(tmp_path / "hist" / "2025-01") if f.startswith("e-"))[-1]
    path = tmp_path / "hist" / "2025-01" / entry
    flip_mean(path)
    before = m.fs.quarantined_total()
    assert len(repo.load().get()) == 2
    assert m.fs.quarantined_total() - before == 1 and not path.exists()
    assert len(repo.load().get()) == 2
    assert m.fs.quarantined_total() - before == 1
    # compaction drops a corrupt compacted entry, once
    other = repo_of(m, tmp_path / "other", compact_threshold=10_000)
    populate(m, other, 4)
    other.compact("2025-01")
    flip_mean(tmp_path / "other" / "2025-01" / "compacted.json")
    before = m.fs.quarantined_total()
    assert other.compact("2025-01") == 3
    assert len(other.load().get()) == 3
    assert m.fs.quarantined_total() - before == 1


def test_replace_key_across_loose_and_compacted(m, tmp_path):
    repo = repo_of(m, tmp_path / "hist", compact_threshold=10_000)
    key = m.R.ResultKey(BASE_MS, {"env": "prod"})
    repo.save(key, context(m))
    repo.compact("2025-01")
    repo.save(key, context(m))
    repo.save(key, context(m))
    assert len(repo.load().get()) == 1 and repo.load_by_key(key) is not None
    repo.save(m.R.ResultKey(BASE_MS, {"env": "test"}), context(m))
    assert len(repo.load().get()) == 2


# -- quarantine ---------------------------------------------------------------


def test_flipped_byte_quarantines_one_entry(m, tmp_path):
    repo = repo_of(m, tmp_path / "hist", compact_threshold=4)
    populate(m, repo, 10)
    flip_mean(tmp_path / "hist" / "2025-01" / "compacted.json")
    before = m.fs.quarantined_total()
    assert len(repo.load().get()) == 9
    assert m.fs.quarantined_total() - before == 1
    assert list((tmp_path / "hist.quarantine").iterdir())


def test_torn_bucket_serves_rest_and_compaction_refuses(m, tmp_path):
    repo = repo_of(m, tmp_path / "hist", compact_threshold=2)
    populate(m, repo, 40)
    (tmp_path / "hist" / "2025-01" / "compacted.json").write_text('[{"torn"')
    assert len(repo.load().get()) == 10
    with pytest.raises(m.CorruptStateError):
        repo.compact("2025-01")
    repo.save(m.R.ResultKey(BASE_MS + 10 * DAY_MS, {"k": "new"}), context(m))
    assert any(r.result_key.tags_dict.get("k") == "new" for r in repo.load().get())


def test_injected_corrupt_fault_takes_the_quarantine_path(m, tmp_path):
    repo = repo_of(m, tmp_path / "hist", compact_threshold=2)
    populate(m, repo, 6)
    before = m.fs.quarantined_total()
    with m.inject(m.FaultSpec("repository_load", "corrupt", at=1)) as inj:
        got = repo.load().get()
    assert inj.fired and m.fs.quarantined_total() > before
    assert len(got) < 6 and len(repo.load().get()) == 6


# -- loader semantics ---------------------------------------------------------


def test_loader_filters_records_and_reopen(m, tmp_path):
    repo = repo_of(m, tmp_path / "hist")
    ctx = context(m)
    for d, env in enumerate(("prod", "test", "prod")):
        repo.save(m.R.ResultKey(BASE_MS + d * DAY_MS, {"env": env}), ctx)
    assert len(repo.load().get()) == 3
    assert len(repo.load().with_tag_values({"env": "prod"}).get()) == 2
    assert len(repo.load().after(BASE_MS + DAY_MS).get()) == 2
    assert len(repo.load().before(BASE_MS + DAY_MS).get()) == 2
    only = repo.load().for_analyzers([m.A.Size()]).get()
    assert all(set(r.analyzer_context.metric_map) == {m.A.Size()} for r in only)
    rows = repo.load().get_success_metrics_as_records(with_tags=["env"])
    assert rows and {r["env"] for r in rows} == {"prod", "test"}
    json.loads(repo.load().get_success_metrics_as_json())
    reopened = repo_of(m, tmp_path / "hist")
    assert reopened.load_by_key(m.R.ResultKey(BASE_MS, {"env": "prod"})).metric_map[
        m.A.Size()].value.get() == 64.0


def test_jvm_history_import_waits_for_the_interop_module(tmp_path):
    """The interop module is ported: a JVM history one package wrote
    imports into the port's partitioned layout with the writer's entries."""
    populate(REF, repo_of(REF, tmp_path / "ref"), 5, {"env": "prod"})
    payload = JInterop.write_jvm_metrics_history_json(repo_of(REF, tmp_path / "ref").load().get())
    repo = repo_of(PORT, tmp_path / "hist")
    assert repo.import_jvm_history(payload) == 5
    assert repo.import_jvm_history("[]") == 0
    got = sorted((r.result_key.data_set_date, r.analyzer_context.metric_map[PORT.A.Size()]
                  .value.get()) for r in repo.load().get())
    assert got == [(BASE_MS + d * DAY_MS, 64.0) for d in range(5)]


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_a_history_written_by_either_package_serves_the_other(writer, tmp_path):
    """Loose and compacted entries one package saved load in the other with
    the same keys and values; the reader's compaction keeps every entry and
    the writer reads the compacted file back."""
    first, second = (REF, PORT) if writer == "jax" else (PORT, REF)
    root = tmp_path / "hist"
    populate(first, repo_of(first, root, compact_threshold=8), 40, {"env": "prod"})
    reader = repo_of(second, root, compact_threshold=10_000)
    got = reader.load().get()
    assert len(got) == 40
    want = {r.result_key.data_set_date: r for r in repo_of(first, root).load().get()}
    for r in got:
        w = want[r.result_key.data_set_date]
        assert r.result_key.tags_dict == w.result_key.tags_dict == {"env": "prod"}
        for a, metric in r.analyzer_context.metric_map.items():
            twin = {repr(b): mt for b, mt in w.analyzer_context.metric_map.items()}[repr(a)]
            assert metric.value.get() == twin.value.get()
    for bucket in reader.buckets():
        assert reader.compact(bucket) >= 0
    assert len(repo_of(first, root).load().get()) == 40
    # the two packages' contexts of the same rows agree
    jm = {repr(a): mt.value.get() for a, mt in context(REF).metric_map.items()}
    tm = {repr(a): mt.value.get() for a, mt in context(PORT).metric_map.items()}
    assert set(jm) == set(tm)
    for key, value in jm.items():
        assert tm[key] == pytest.approx(value, rel=1e-12)


# -- the compaction lease -------------------------------------------------------


def test_concurrent_compactor_refused(m, tmp_path):
    root = str(tmp_path / "hist")
    a = repo_of(m, root, compact_threshold=10_000)
    b = repo_of(m, root, compact_threshold=10_000)
    b.lease.owner = "other-host:999"
    populate(m, a, 6)
    assert a.lease.acquire()
    try:
        assert b.compact("2025-01") == -1 and b.lease.refusals >= 1
        assert len(b.load().get()) == 6
    finally:
        a.lease.release()
    assert b.compact("2025-01") == 6
    assert len(b.load().get()) == 6


def test_stale_lease_takeover_after_ttl(m, tmp_path):
    path = str(tmp_path / "x.lease")
    dead = m.lease.FileLease(path, owner="dead:1", ttl_s=0.15)
    live = m.lease.FileLease(path, owner="live:2", ttl_s=30.0)
    assert dead.acquire()
    assert not live.acquire() and live.refusals == 1
    time.sleep(0.3)
    assert live.acquire() and live.takeovers == 1
    assert live.epoch == dead.epoch + 1
    assert not dead.held() and not dead.renew()


def test_lease_lost_mid_merge_leaves_loose_entries(m, tmp_path, monkeypatch):
    repo = repo_of(m, tmp_path / "hist", compact_threshold=10_000)
    populate(m, repo, 5)
    bucket_dir = tmp_path / "hist" / "2025-01"
    loose = sorted(f for f in os.listdir(bucket_dir) if f.startswith("e-"))
    monkeypatch.setattr(repo.lease, "renew", lambda: False)
    assert repo.compact("2025-01") == -1
    assert sorted(f for f in os.listdir(bucket_dir) if f.startswith("e-")) == loose
    assert not (bucket_dir / "compacted.json").exists()
    assert len(repo.load().get()) == 5


def test_crash_mid_compaction_recovers_by_takeover(m, tmp_path):
    repo = repo_of(m, tmp_path / "hist", compact_threshold=10_000)
    populate(m, repo, 4)
    crashed = m.lease.FileLease(repo.lease.path, owner="crashed:7", ttl_s=0.2)
    assert crashed.acquire()
    assert repo.compact("2025-01") == -1
    assert len(repo.load().get()) == 4
    time.sleep(0.4)
    assert repo.compact("2025-01") == 4 and repo.lease.takeovers == 1
    assert len(repo.load().get()) == 4


def test_lease_acquire_fault_site(tmp_path):
    lease = TL.FileLease(str(tmp_path / "x.lease"), owner="a:1")
    with TRel.inject(TRel.FaultSpec("lease_acquire", "corrupt", at=1)) as inj:
        with pytest.raises(TE.CorruptStateError):
            lease.acquire()
    assert inj.fired and lease.acquire()


def test_the_packages_share_one_lease_and_lose_no_entry(tmp_path):
    """The reference's two-writer interleaving with one writer of each
    package: while either holds the lease the other's compaction is
    refused, and alternating saves and compactions of one bucket lose no
    entry."""
    root = str(tmp_path / "hist")
    ref = repo_of(REF, root, compact_threshold=10_000)
    port = repo_of(PORT, root, compact_threshold=10_000)
    port.lease.owner = "port-host:2"
    populate(REF, ref, 2)
    assert ref.lease.acquire()
    try:
        assert port.compact("2025-01") == -1
    finally:
        ref.lease.release()
    for d in range(12):
        for repo, pkg, offset in ((ref, REF, 2), (port, PORT, 14)):
            repo.save(pkg.R.ResultKey(BASE_MS + (offset + d) * DAY_MS), context(pkg))
            assert repo.compact("2025-01") > 0
    stamps = sorted(r.result_key.data_set_date for r in repo_of(PORT, root).load().get())
    assert stamps == sorted(BASE_MS + d * DAY_MS for d in list(range(14)) + list(range(14, 26)))
    assert repo_of(REF, root).compact("2025-01") == 26
