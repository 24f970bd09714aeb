"""The device feature cache of the PyTorch/CUDA port
(``deequ_tpu_torch.runners.engine``: ``_DeviceFeatureCache``,
``device_feature_cache``, ``clear_device_feature_cache``) against the JAX
reference.

The reference's cases (``tests/test_advice_r5.py::TestDeviceFeatureCacheEviction``
and ``tests/test_service.py::...test_warm_run_bypasses_device_feature_cache``)
run through both packages (``m`` is either; the port on ``device="cpu"``,
where the cache holds host tensors) with the same outcomes. The port's own
cases: a warm run's batches all hit, build and copy nothing, and give the
cold run's metrics bit for bit and the reference's (counts, extrema,
HLL and KLL bit for bit, moments within 1e-12 relative: the reduction
order differs); at feed depths 0 and 2, over ``make_mesh(8)``, and in a
resumed checkpointed pass, whose batch numbering the cache keys keep.
"""

from __future__ import annotations

import logging
import threading
from types import SimpleNamespace

import numpy as np
import pytest

import deequ_tpu.analyzers as J
import deequ_tpu.reliability as JRel
import deequ_tpu.runners.engine as JEng
from deequ_tpu.analyzers.state_provider import InMemoryStateProvider as JMemory
from deequ_tpu.data import Dataset as JDataset
from deequ_tpu.runners import AnalysisRunner as JRunner
from deequ_tpu.service.placement import battery_signature as j_signature
from deequ_tpu.utils import BoundedLRU as JBoundedLRU
import deequ_tpu_torch as dq
import deequ_tpu_torch.analyzers as T
import deequ_tpu_torch.reliability as TRel
import deequ_tpu_torch.runners.engine as TEng
from deequ_tpu_torch.analyzers.state_provider import InMemoryStateProvider
from deequ_tpu_torch.parallel import make_mesh
from deequ_tpu_torch.utils import BoundedLRU

REF = SimpleNamespace(name="jax", A=J, eng=JEng, Dataset=JDataset, Runner=JRunner,
                      Monitor=JEng.RunMonitor, R=JRel, Memory=JMemory, LRU=JBoundedLRU,
                      logger="deequ_tpu.runners.engine", kw={},
                      warm=lambda analyzers, data: JEng.warm_fused_program(
                          j_signature(analyzers), data=data))
PORT = SimpleNamespace(name="torch", A=T, eng=TEng, Dataset=dq.Dataset, Runner=dq.AnalysisRunner,
                       Monitor=dq.RunMonitor, R=TRel, Memory=InMemoryStateProvider,
                       LRU=BoundedLRU, logger="deequ_tpu_torch.runners.engine",
                       kw={"device": "cpu"},
                       warm=lambda analyzers, data: TEng.warm_fused_program(
                           analyzers, data, device="cpu"))

MOMENTS = ("Mean", "Sum", "StandardDeviation", "Correlation")


@pytest.fixture(params=[REF, PORT], ids=["jax", "torch"])
def m(request):
    return request.param


@pytest.fixture(autouse=True)
def no_cache_left():
    """Every test starts and ends with both packages' caches gone."""
    JEng.clear_device_feature_cache()
    TEng.clear_device_feature_cache()
    yield
    JEng.clear_device_feature_cache()
    TEng.clear_device_feature_cache()


# ---------------------------------------------------------------------------
# the reference's cases, through both packages
# ---------------------------------------------------------------------------


def test_lru_group_eviction_drops_table_pin(m):
    cache = m.eng._DeviceFeatureCache(100)
    t1, t2, t3 = object(), object(), object()
    for i in range(2):
        assert cache.admit((id(t1), i), t1, {"f": i}, 20)
    assert cache.admit((id(t2), 0), t2, {"f": 0}, 40)
    assert cache.bytes == 80 and set(cache.tables) == {id(t1), id(t2)}
    # t1 is least recently used: its whole group goes, the pin with it
    assert cache.admit((id(t3), 0), t3, {"f": 0}, 60)
    assert id(t1) not in cache.tables
    assert cache.get((id(t1), 0)) is None and cache.get((id(t1), 1)) is None
    assert cache.get((id(t2), 0)) is not None
    assert cache.bytes == 100 and cache.evictions == 1


def test_get_refreshes_group_recency(m):
    cache = m.eng._DeviceFeatureCache(100)
    t1, t2, t3 = object(), object(), object()
    cache.admit((id(t1), 0), t1, {}, 40)
    cache.admit((id(t2), 0), t2, {}, 40)
    cache.get((id(t1), 0))
    cache.admit((id(t3), 0), t3, {}, 40)
    assert id(t1) in cache.tables and id(t2) not in cache.tables


def test_own_group_never_evicted_for_itself(m, caplog):
    cache = m.eng._DeviceFeatureCache(50)
    t1 = object()
    assert cache.admit((id(t1), 0), t1, {}, 40)
    with caplog.at_level(logging.WARNING, logger=m.logger):
        assert not cache.admit((id(t1), 1), t1, {}, 40)
    assert cache.get((id(t1), 0)) is not None
    assert any("stopped admitting" in rec.message for rec in caplog.records)
    with caplog.at_level(logging.WARNING, logger=m.logger):
        assert not cache.admit((id(t1), 2), t1, {}, 40)
    assert len([r for r in caplog.records if "stopped admitting" in r.message]) == 1


def test_oversize_entry_rejected_without_flushing_warm_groups(m):
    cache = m.eng._DeviceFeatureCache(100)
    t1, t2 = object(), object()
    assert cache.admit((id(t1), 0), t1, {"f": 0}, 60)
    assert not cache.admit((id(t2), 0), t2, {"f": 0}, 150)
    assert cache.get((id(t1), 0)) is not None
    assert cache.evictions == 0


def test_unfittable_entry_counts_own_group_before_evicting_others(m):
    cache = m.eng._DeviceFeatureCache(100)
    ta, tb = object(), object()
    assert cache.admit((id(ta), 0), ta, {"f": 0}, 80)
    assert cache.admit((id(tb), 0), tb, {"f": 0}, 15)
    assert not cache.admit((id(ta), 1), ta, {"f": 1}, 30)
    assert cache.get((id(tb), 0)) is not None
    assert cache.evictions == 0


def test_program_cache_is_bounded(m):
    assert isinstance(m.eng._PROGRAM_CACHE, m.LRU)
    assert m.eng._PROGRAM_CACHE.max_size >= 64


def test_duplicate_admit_is_idempotent(m):
    cache = m.eng._DeviceFeatureCache(100)
    t1, t2 = object(), object()
    assert cache.admit((id(t1), 0), t1, {"f": 0}, 40)
    assert cache.admit((id(t1), 0), t1, {"f": 0}, 40)
    assert cache.bytes == 40
    cache.admit((id(t2), 0), t2, {"f": 0}, 80)
    assert id(t1) not in cache.tables and cache.bytes == 80


def test_concurrent_admits_of_one_key_keep_it_once(m):
    cache = m.eng._DeviceFeatureCache(1000)
    t1 = object()
    barrier = threading.Barrier(8)
    results = []

    def admit():
        barrier.wait()
        results.append(cache.admit((id(t1), 0), t1, {"f": 0}, 40))

    threads = [threading.Thread(target=admit) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(30)
    assert results == [True] * 8
    assert cache.bytes == 40 and len(cache.store) == 1


def test_clear_resets_everything(m):
    cache = m.eng._DeviceFeatureCache(100)
    t1 = object()
    cache.admit((id(t1), 0), t1, {}, 60)
    cache.clear()
    assert cache.bytes == 0 and not cache.tables and not cache.store
    assert cache.admit((id(t1), 0), t1, {}, 60)


def test_engine_round_trip_with_tiny_budget(m, monkeypatch):
    """A second table evicts the first; a re-run over it hits. 12 kB holds
    one 1,024-row batch of ``Mean``'s features (about 10 kB), not two."""
    monkeypatch.setenv(m.eng.DEVICE_FEATURE_CACHE_ENV, "0.000012")
    d1 = m.Dataset.from_dict({"x": np.arange(1024, dtype=np.float64)})
    d2 = m.Dataset.from_dict({"x": np.arange(1024, 2048, dtype=np.float64)})
    run = lambda d: m.Runner.do_analysis_run(  # noqa: E731
        d, [m.A.Mean("x")], placement="device", batch_size=1024, **m.kw)
    run(d1)
    cache = m.eng.device_feature_cache()
    assert cache is not None and id(d1.arrow) in cache.tables
    run(d2)
    assert id(d1.arrow) not in cache.tables
    assert id(d2.arrow) in cache.tables
    assert cache.evictions == 1
    assert run(d2).metric(m.A.Mean("x")).value.get() == pytest.approx(1535.5)


def test_warm_run_bypasses_device_feature_cache(m, monkeypatch):
    monkeypatch.setenv(m.eng.DEVICE_FEATURE_CACHE_ENV, "1")
    data = m.Dataset.from_dict({"router_warmcache_col": np.arange(64, dtype=np.float64)})
    m.warm([m.A.Mean("router_warmcache_col")], data)
    cache = m.eng._DEVICE_FEATURE_CACHE
    assert cache is None or not cache.store


@pytest.mark.parametrize("raw", [None, "0", "-1", "lots"])
def test_the_cache_is_off_unless_given_a_budget(m, monkeypatch, raw):
    if raw is None:
        monkeypatch.delenv(m.eng.DEVICE_FEATURE_CACHE_ENV, raising=False)
    else:
        monkeypatch.setenv(m.eng.DEVICE_FEATURE_CACHE_ENV, raw)
    assert m.eng.device_feature_cache() is None


# ---------------------------------------------------------------------------
# the port's engine under the cache
# ---------------------------------------------------------------------------

ROWS = 20_000
BATCH = 4096


def table(m, seed: int = 5):
    rng = np.random.default_rng(seed)
    x = rng.normal(10.0, 3.0, ROWS)
    null = rng.random(ROWS) < 0.05
    return m.Dataset.from_dict({
        "x": [None if n else float(v) for n, v in zip(null, x)],
        "y": rng.gamma(2.0, 3.0, ROWS),
        "id": np.arange(ROWS, dtype=np.int64),
        "cat": [f"c{v}" for v in rng.zipf(1.5, ROWS) % 300],
        "name": [f"user_{v}@example.com" if v % 7 else f"n{v}" for v in
                 rng.integers(0, 1 << 20, ROWS)],
    })


def analyzers(m):
    A = m.A
    return [A.Size(), A.Completeness("x"), A.Mean("x"), A.Sum("y"), A.Minimum("x"),
            A.Maximum("y"), A.StandardDeviation("y"), A.Correlation("x", "y"),
            A.ApproxCountDistinct("id"), A.ApproxCountDistinct("name"),
            A.Compliance("big", "y > 5"), A.PatternMatch("name", r"@example\.com"),
            A.MaxLength("name"), A.KLLSketch("y"), A.Histogram("cat"), A.DataType("cat")]


def values(ctx) -> dict:
    out = {}
    for a, metric in ctx.metric_map.items():
        v = metric.value.get()
        if hasattr(v, "buckets"):
            v = repr(v.buckets)
        elif hasattr(v, "values") and not isinstance(v, (int, float)):
            v = repr(sorted((k, e.absolute) for k, e in v.values.items()))
        out[repr(a)] = v
    return out


def run(m, data, monitor=None, **kw):
    kw.setdefault("batch_size", BATCH)
    return m.Runner.do_analysis_run(data, analyzers(m), placement="device", monitor=monitor,
                                    **m.kw, **kw)


def assert_close(got: dict, want: dict) -> None:
    assert set(got) == set(want)
    for key, w in want.items():
        if key.split("(")[0] in MOMENTS:
            assert got[key] == pytest.approx(w, rel=1e-12), key
        else:
            assert got[key] == w, key


def cold_then_warm(data, **kw):
    cold, warm = dq.RunMonitor(), dq.RunMonitor()
    first = values(run(PORT, data, cold, **kw))
    second = values(run(PORT, data, warm, **kw))
    return first, second, cold, warm


@pytest.mark.parametrize("depth", ["0", "2"])
def test_a_warm_run_hits_every_batch_and_equals_the_cold_run(monkeypatch, depth):
    monkeypatch.setenv(TEng.DEVICE_FEATURE_CACHE_ENV, "1")
    monkeypatch.setenv("DEEQU_TPU_PREFETCH_DEPTH", depth)
    data = table(PORT)
    first, second, cold, warm = cold_then_warm(data)
    batches = -(-ROWS // BATCH)
    assert cold.feature_cache_hits == 0 and cold.phase_seconds["feature_build"] > 0
    assert cold.phase_seconds["host_to_device"] > 0
    assert warm.feature_cache_hits == batches == warm.batches
    assert "feature_build" not in warm.phase_seconds
    assert "host_to_device" not in warm.phase_seconds
    assert warm.device_updates == batches
    assert second == first
    cache = TEng.device_feature_cache()
    assert len(cache.store) == batches and list(cache.tables) == [id(data.arrow)]
    assert cache.bytes == sum(t.nbytes for f in cache.store.values() for t in f.values())


def test_cached_runs_equal_the_reference():
    """The port's cold and warm runs against the reference's uncached run
    at the same batch size (and the reference's own cached pair)."""
    import os

    os.environ[TEng.DEVICE_FEATURE_CACHE_ENV] = "1"
    try:
        first, second, _, _ = cold_then_warm(table(PORT))
        jdata = table(REF)
        ref_cold = values(run(REF, jdata))
        ref_warm = values(run(REF, jdata))
    finally:
        del os.environ[TEng.DEVICE_FEATURE_CACHE_ENV]
    assert ref_warm == ref_cold
    assert second == first
    assert_close(first, ref_cold)


def test_the_cache_keys_on_the_battery_and_the_batch_size(monkeypatch):
    monkeypatch.setenv(TEng.DEVICE_FEATURE_CACHE_ENV, "1")
    data = table(PORT)
    run(PORT, data)
    other = dq.RunMonitor()
    dq.AnalysisRunner.do_analysis_run(data, [T.Mean("x")], placement="device", batch_size=BATCH,
                                      monitor=other, device="cpu")
    assert other.feature_cache_hits == 0
    halved = dq.RunMonitor()
    run(PORT, data, halved, batch_size=BATCH // 2)
    assert halved.feature_cache_hits == 0
    again = dq.RunMonitor()
    run(PORT, data, again)
    assert again.feature_cache_hits == again.batches


def test_the_host_tier_never_reads_the_cache(monkeypatch):
    monkeypatch.setenv(TEng.DEVICE_FEATURE_CACHE_ENV, "1")
    data = table(PORT)
    host = [T.Size(), T.Mean("x"), T.Sum("y")]
    dq.AnalysisRunner.do_analysis_run(data, host, placement="host", batch_size=BATCH,
                                      device="cpu")
    assert TEng.device_feature_cache().store == {}


def test_a_mesh_pass_caches_the_unsplit_batches(monkeypatch):
    monkeypatch.setenv(TEng.DEVICE_FEATURE_CACHE_ENV, "1")
    data = table(PORT)
    plain = values(run(PORT, data))
    TEng.clear_device_feature_cache()
    mesh = make_mesh(8, device="cpu")
    cold, warm = dq.RunMonitor(), dq.RunMonitor()
    first = values(run(PORT, data, cold, sharding=mesh))
    second = values(run(PORT, data, warm, sharding=mesh))
    assert cold.feature_cache_hits == 0
    assert warm.feature_cache_hits == warm.batches == -(-ROWS // BATCH)
    assert "host_to_device" not in warm.phase_seconds
    assert second == first
    assert_close(first, plain)
    for features in TEng.device_feature_cache().store.values():
        assert {t.shape[0] for t in features.values()} == {BATCH}


def test_a_resumed_pass_keeps_the_batch_numbering(monkeypatch):
    """A pass interrupted at batch 11 cached batches 0-10; its resume from
    the checkpoint at batch 8 hits 8, 9 and 10 and builds the rest, and
    equals the uninterrupted run."""
    monkeypatch.setenv(TEng.DEVICE_FEATURE_CACHE_ENV, "1")
    rng = np.random.default_rng(7)
    data = dq.Dataset.from_dict({"x": rng.normal(0.0, 1.0, 16 * 1024)})
    battery = [T.Completeness("x"), T.Mean("x"), T.Minimum("x"), T.Maximum("x"),
               T.StandardDeviation("x"), T.KLLSketch("x")]
    go = lambda **kw: values(dq.AnalysisRunner.do_analysis_run(  # noqa: E731
        data, battery, batch_size=1024, device="cpu", **kw))
    want = go()
    TEng.clear_device_feature_cache()
    ckpt = TRel.IngestCheckpointer(InMemoryStateProvider(), every=4)
    with TRel.inject(TRel.FaultSpec("device_update", "interrupt", at=11)) as inj:
        with pytest.raises(KeyboardInterrupt):
            go(checkpointer=ckpt)
    assert inj.fired
    cache = TEng.device_feature_cache()
    assert sorted(key[-1] for key in cache.store) == list(range(11))
    mon = dq.RunMonitor()
    got = go(checkpointer=ckpt, monitor=mon)
    assert mon.resumed_at_batch == 8 and mon.batches == 8
    assert mon.feature_cache_hits == 3
    assert sorted(key[-1] for key in cache.store) == list(range(16))
    assert got == want
