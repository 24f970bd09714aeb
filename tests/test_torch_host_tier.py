"""The host ingest tier (``placement="host"``) of the PyTorch/CUDA port
against the JAX reference's host tier, and against the port's own device
tier.

Both packages run on the CPU with ``placement="host"`` over the same
pyarrow tables and batch sizes: the reference's partials come from its
native library and fold through its jitted ingest program; the port's come
from its copy of that library and fold through the plain versions of
``state_fold``'s carry entry and ``kll_compact``'s ingest entry.
Tolerances: counts, min, max, HLL registers, DataType counts, dictionary
counts and KLL sketches bit for bit; float64 sums and moments within 1e-12
relative (the reference's merges are XLA's, the port's PyTorch's); metrics
of those within 1e-12 too, inside BASELINE's +-1e-6. Against the port's
device tier, KLL quantiles hold within twice the sketch's rank error.
"""

from __future__ import annotations

import math

import jax
import numpy as np
import pyarrow as pa
import pyarrow.compute as pc
import pytest
import torch

import chip_smoke
import deequ_tpu
import deequ_tpu.analyzers as J
import deequ_tpu.data as JD
import deequ_tpu_torch as dq
import deequ_tpu_torch.analyzers as T
from deequ_tpu.analyzers.state_provider import (
    FileSystemStateProvider as JFileSystemStateProvider,
    InMemoryStateProvider as JInMemoryStateProvider,
)
from deequ_tpu.profiles import ColumnProfilerRunner as JaxProfilerRunner
from deequ_tpu.runners import AnalysisRunner as JaxRunner
from deequ_tpu_torch.analyzers.state_provider import FileSystemStateProvider, InMemoryStateProvider
from deequ_tpu_torch.convert import to_reference
from deequ_tpu_torch.runners import AnalysisRunner, RunMonitor
from deequ_tpu_torch.runners.engine import INGEST_CHUNK, resolve_scan_placement
from examples.example_utils import SAMPLE_ITEMS, items_as_dataset

CPU = torch.device("cpu")
RTOL = 1e-12
#: float leaves of these states are sums or Chan merges: 1e-12 relative
MOMENT_STATES = ("MeanState", "SumState", "StandardDeviationState", "CorrelationState")
MOMENT_METRICS = ("Mean", "Sum", "StandardDeviation", "Correlation")


def mixed_table(n: int = 20_000, seed: int = 3) -> pa.Table:
    """The reference's host-tier test table (tests/test_host_tier.py)."""
    rng = np.random.default_rng(seed)
    x = rng.normal(50, 10, n)
    xnull = rng.random(n) < 0.1
    y = rng.normal(-1, 2, n)
    cats = rng.integers(0, 500, n)
    strs = [None if rng.random() < 0.05 else f"v{int(i)}" for i in cats]
    return pa.table({"x": pa.array(x, mask=xnull), "y": pa.array(y), "cat": pa.array(cats),
                     "s": pa.array(strs)})


def battery(m):
    """The reference's host-tier battery (17 analyzers) and two sketches."""
    return [
        m.Size(), m.Size(where="x > 50"), m.Completeness("x"), m.Compliance("pos", "y > 0"),
        m.PatternMatch("s", r"v\d+"), m.Mean("x"), m.Sum("x"), m.Minimum("x"), m.Maximum("x"),
        m.StandardDeviation("x"), m.Correlation("x", "y"), m.MinLength("s"), m.MaxLength("s"),
        m.DataType("s"), m.ApproxCountDistinct("cat"), m.ApproxCountDistinct("s"),
        m.Mean("x", where="y > 0"), m.KLLSketch("x"), m.ApproxQuantile("y", 0.5),
    ]


def _value(metric):
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


def _assert_metrics(want, got, names) -> None:
    """``want``, ``got``: metric maps of the same analyzers, in order."""
    for name, w, g in zip(names, want, got):
        a, b = _value(w), _value(g)
        if isinstance(a, float) and math.isnan(a):
            assert isinstance(b, float) and math.isnan(b), name
        elif isinstance(a, float) and name in MOMENT_METRICS:
            assert abs(a - b) <= RTOL * max(1.0, abs(a)), (name, a, b)
        else:
            assert a == b, (name, a, b)


def _assert_state(torch_state, jax_state) -> None:
    name, tl = to_reference(torch_state)
    jl = [np.asarray(x) for x in jax.tree_util.tree_leaves(jax_state)]
    assert len(tl) == len(jl), name
    for i, (a, b) in enumerate(zip(jl, tl)):
        if name in MOMENT_STATES and a.dtype == np.float64:
            scale = float(np.nan_to_num(np.abs(a), posinf=0.0).max()) if a.size else 0.0
            ok = np.isclose(a, b, rtol=0, atol=RTOL * max(scale, 1.0), equal_nan=True)
            assert ok.all(), (name, i, a, b)
        else:
            same = a.tobytes() == np.asarray(b, dtype=a.dtype).tobytes()
            if not same and a.dtype.kind == "f":  # NaN payloads aside
                same = np.array_equal(a, b, equal_nan=True) and np.array_equal(
                    np.signbit(a), np.signbit(b))
            assert same, (name, i, a, b)


def _runs(table, batch_size, placement="host"):
    """One run in each package with save_states_with; returns the analyzer
    lists, the metric lists, the providers and the port's monitor."""
    jb, tb = battery(J), battery(T)
    jp, tp = JInMemoryStateProvider(), InMemoryStateProvider()
    jr = JaxRunner.do_analysis_run(JD.Dataset.from_arrow(table), jb, batch_size=batch_size,
                                   placement="host", save_states_with=jp)
    monitor = RunMonitor()
    tr = AnalysisRunner.do_analysis_run(dq.Dataset.from_arrow(table), tb, batch_size=batch_size,
                                        placement=placement, save_states_with=tp, device="cpu",
                                        monitor=monitor)
    return (jb, tb), ([jr.metric(a) for a in jb], [tr.metric(a) for a in tb]), (jp, tp), monitor


@pytest.mark.parametrize("batch_size", [4096, 2048, 512])
def test_battery_matches_the_reference_host_tier(batch_size):
    """The reference's battery in batches with a short tail: metrics and
    states, KLL items and HLL registers bit for bit."""
    table = mixed_table()
    (jb, tb), (jm, tm), (jp, tp), monitor = _runs(table, batch_size)
    _assert_metrics(jm, tm, [a.name for a in jb])
    for ja, ta in zip(jb, tb):
        _assert_state(tp.load(ta), jp.load(ja))
    batches = -(-table.num_rows // batch_size)
    assert monitor.placement == "host" and monitor.passes == 1 and monitor.batches == batches
    assert monitor.ingest_folds == -(-batches // INGEST_CHUNK)
    assert {"host_partials", "ingest_fold", "state_fetch"} <= set(monitor.phase_seconds)
    assert "feature_build" not in monitor.phase_seconds
    assert sum(monitor.pattern_routes.values()) >= 1


def test_host_tier_matches_the_device_tier():
    """The reference's test_metrics_match_device_path, in the port: the
    placement is a performance decision, never a semantic one."""
    table = mixed_table()
    tb = battery(T)
    data = dq.Dataset.from_arrow(table)
    host = AnalysisRunner.do_analysis_run(data, tb, batch_size=4096, placement="host",
                                          device="cpu")
    dev = AnalysisRunner.do_analysis_run(data, tb, batch_size=4096, placement="device",
                                         device="cpu")
    y = np.sort(table["y"].to_numpy().astype(np.float32))
    for a in tb:
        hv, dv = host.metric(a).value, dev.metric(a).value
        assert hv.is_success == dv.is_success, a
        if isinstance(a, T.ApproxQuantile):
            q = hv.get()
            lo, hi = np.searchsorted(y, q, "left") / len(y), np.searchsorted(y, q, "right") / len(y)
            err = max(0.0, lo - 0.5, 0.5 - hi)
            assert err <= 2 * a.relative_error, (q, err)
        elif isinstance(a, T.KLLSketch):
            assert hv.get().buckets[0].low_value == dv.get().buckets[0].low_value
        elif isinstance(hv.get(), float):
            assert hv.get() == pytest.approx(dv.get(), rel=1e-9, abs=1e-12), a
        else:
            assert _value(host.metric(a)) == _value(dev.metric(a)), a


def test_a_second_pass_gets_a_fresh_dictionary_memo():
    """The HLL seen-set of a dictionary column is keyed by the pass: a
    second pass over the same Dataset (host, then device, then host)
    counts every entry again."""
    table = mixed_table()
    data = dq.Dataset.from_arrow(table)
    assert data.dictionary_size("s") is not None
    a = T.ApproxCountDistinct("s")
    first = AnalysisRunner.do_analysis_run(data, [a], batch_size=2048, placement="host",
                                           device="cpu").metric(a).value.get()
    dev = AnalysisRunner.do_analysis_run(data, [a], batch_size=2048, placement="device",
                                         device="cpu").metric(a).value.get()
    again = AnalysisRunner.do_analysis_run(data, [a], batch_size=2048, placement="host",
                                           device="cpu").metric(a).value.get()
    assert first == dev == again > 400


def _dictionary_table(n: int, entries: int, seed: int) -> pa.Table:
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, entries, n)
    codes[:entries] = np.arange(entries)  # every entry, early
    rng.shuffle(codes[: n // 2])
    return pa.table({
        "d": pa.DictionaryArray.from_arrays(
            pa.array(codes.astype(np.int32), mask=rng.random(n) < 0.05),
            pa.array([f"e{i}" for i in range(entries)])),
        "v": pa.array(rng.normal(0, 1, n)),
    })


def test_dictionary_registers_are_published_after_their_view():
    """The pool's threads take partials of one dictionary column at once: a
    thread that finds the dictionary's registers in ``col.aux`` reads their
    register-sorted view next, so the registers are stored last."""
    from deequ_tpu_torch.analyzers.base import HostBatchContext

    class Recording(dict):
        order: list = []

        def __setitem__(self, key, value):
            self.order.append(key)
            super().__setitem__(key, value)

    batch = next(dq.Dataset.from_arrow(_dictionary_table(20_000, 300, 7))
                 .batches(20_000, pad_to_batch_size=False))
    col = batch.column("d")
    col.aux = Recording(col.aux)
    T.ApproxCountDistinct("d").host_partial(HostBatchContext(batch, 0, object()))
    order = col.aux.order
    view = [order.index(k) for k in ("hll_perm", "hll_pw_sorted", "hll_starts")]
    assert order.index("hll_regs_full") > max(view)


@pytest.mark.parametrize("entries,batch_size", [(300, 1024), ((1 << 16) + 500, 8192)])
def test_dictionary_memo_routes_match_the_reference(entries, batch_size):
    """ApproxCountDistinct over dictionary columns below and above 2^16
    entries (the presence count and the large-dictionary row lookup), with
    and without a where-filter: registers bit for bit."""
    table = _dictionary_table(3 * entries if entries > 1000 else 20_000, entries, entries)
    jb = [J.ApproxCountDistinct("d"), J.ApproxCountDistinct("d", where="v > 0"), J.DataType("d")]
    tb = [T.ApproxCountDistinct("d"), T.ApproxCountDistinct("d", where="v > 0"), T.DataType("d")]
    jp, tp = JInMemoryStateProvider(), InMemoryStateProvider()
    JaxRunner.do_analysis_run(JD.Dataset.from_arrow(table), jb, batch_size=batch_size,
                              placement="host", save_states_with=jp)
    AnalysisRunner.do_analysis_run(dq.Dataset.from_arrow(table), tb, batch_size=batch_size,
                                   placement="host", save_states_with=tp, device="cpu")
    for ja, ta in zip(jb, tb):
        _assert_state(tp.load(ta), jp.load(ja))


def test_config2_battery_matches_the_reference_and_the_oracle():
    """BASELINE config 2's checks (chip_smoke's table at a small size)
    through VerificationSuite.with_placement("host") in both packages."""
    rows = 6000
    table = chip_smoke.build_table(rows, seed=3)
    monitor = RunMonitor()
    got = (dq.VerificationSuite.on_data(dq.Dataset.from_arrow(table), device="cpu")
           .add_check(chip_smoke.build_check(dq, rows))
           .add_required_analyzer(T.CountDistinct("cat_large")).with_batch_size(256)
           .with_placement("host").with_monitor(monitor).run())
    want = (deequ_tpu.VerificationSuite.on_data(JD.Dataset.from_arrow(table))
            .add_check(chip_smoke.build_check(deequ_tpu, rows))
            .add_required_analyzer(J.CountDistinct("cat_large")).with_batch_size(256)
            .with_placement("host").run())
    values = chip_smoke.metric_values(got)
    assert chip_smoke.compare_metrics(values, chip_smoke.metric_values(want)) == []
    assert chip_smoke.compare_oracle(values, chip_smoke.oracle(table)) == []
    assert [r.status.value for r in got.check_results.values()] == [
        r.status.value for r in want.check_results.values()]
    assert monitor.placement == "host" and monitor.ingest_folds == 1
    assert monitor.batches == -(-rows // 256) and monitor.device_freq_sets == 0


def _basic_example(m, data, placement):
    return (m.VerificationSuite.on_data(data, **({"device": "cpu"} if m is dq else {}))
            .add_check(m.Check(m.CheckLevel.ERROR, "integrity checks")
                       .has_size(lambda size: size == 5).is_complete("id").is_unique("id")
                       .is_complete("productName").is_contained_in("priority", ["high", "low"])
                       .is_non_negative("numViews"))
            .add_check(m.Check(m.CheckLevel.WARNING, "distribution checks")
                       .contains_url("description", lambda ratio: ratio >= 0.5)
                       .has_approx_quantile("numViews", 0.5, lambda median: median <= 10))
            .with_placement(placement).run())


def _summary(result):
    return (result.status.value,
            [(c.description, r.status.value,
              [(str(x.constraint), x.status.value, x.message) for x in r.constraint_results])
             for c, r in result.check_results.items()],
            {(a.name, a.instance): _value(mt) for a, mt in result.metrics.items()})


def test_basic_example_matches_the_reference():
    table = items_as_dataset(*SAMPLE_ITEMS).arrow
    want = _basic_example(deequ_tpu, JD.Dataset.from_arrow(table), "host")
    got = _basic_example(dq, dq.Dataset.from_arrow(table), "host")
    assert _summary(got) == _summary(want)


def test_an_empty_dataset():
    empty = pa.table({"x": pa.array([], pa.float64()), "s": pa.array([], pa.string())})
    tb = [T.Size(), T.Mean("x"), T.Minimum("x"), T.KLLSketch("x"), T.ApproxCountDistinct("s")]
    jb = [J.Size(), J.Mean("x"), J.Minimum("x"), J.KLLSketch("x"), J.ApproxCountDistinct("s")]
    got = AnalysisRunner.do_analysis_run(dq.Dataset.from_arrow(empty), tb, placement="host",
                                         device="cpu")
    want = JaxRunner.do_analysis_run(JD.Dataset.from_arrow(empty), jb, placement="host")
    _assert_metrics([want.metric(a) for a in jb], [got.metric(a) for a in tb],
                    [a.name for a in jb])
    assert got.metric(tb[0]).value.get() == 0.0 and not got.metric(tb[1]).value.is_success


def test_profile_matches_the_reference_host_tier():
    table = chip_smoke.build_lineitem(20_000, comment_pool=8_000)
    want = (JaxProfilerRunner.on_data(JD.Dataset.from_arrow(table)).with_batch_size(4096)
            .with_placement("host").run())
    monitor = RunMonitor()
    got = (dq.ColumnProfilerRunner.on_data(dq.Dataset.from_arrow(table), device="cpu")
           .with_batch_size(4096).with_placement("host").with_monitor(monitor).run())
    assert monitor.placement == "host" and monitor.ingest_folds >= 2
    assert list(got.profiles) == list(want.profiles)
    for name, w in want.profiles.items():
        g = got.profiles[name]
        for field, wv in vars(w).items():
            gv = getattr(g, field)
            if field in ("mean", "sum", "std_dev") and wv is not None:
                assert abs(gv - wv) <= RTOL * max(1.0, abs(wv)), (name, field, gv, wv)
            elif field == "histogram":
                assert (gv is None) == (wv is None) and (wv is None or _value_dist(gv) == _value_dist(wv))
            elif field == "kll":
                assert (gv is None) == (wv is None)
                if wv is not None:
                    assert [(b.low_value, b.high_value, b.count) for b in gv.buckets] == [
                        (b.low_value, b.high_value, b.count) for b in wv.buckets]
                    assert gv.data == wv.data and gv.parameters == wv.parameters
            else:
                assert gv == wv, (name, field, gv, wv)


def _value_dist(d):
    return (d.number_of_bins, {k: (v.absolute, v.ratio) for k, v in d.values.items()})


def test_a_host_tier_partition_loads_in_the_reference_and_merges(tmp_path):
    """BASELINE config 4: a day partition scanned on the host tier, saved
    as the reference's v2 blobs, loads in the reference and merges with a
    device-tier partition's states in both packages."""
    rng = np.random.default_rng(42)
    rows = 8000
    table = pa.table({f"x{i}": pa.array(rng.normal(100 * i, 10, 2 * rows),
                                        mask=rng.random(2 * rows) < 0.05) for i in range(2)}
                     | {"cat": pa.array(rng.integers(0, 100_000, 2 * rows))})
    tb = [T.Size(), T.Completeness("x0"), T.Mean("x0"), T.Mean("x1"),
          T.ApproxCountDistinct("cat"), T.KLLSketch("x0")]
    jb = [J.Size(), J.Completeness("x0"), J.Mean("x0"), J.Mean("x1"),
          J.ApproxCountDistinct("cat"), J.KLLSketch("x0")]
    day0 = FileSystemStateProvider(str(tmp_path / "day0"))
    AnalysisRunner.do_analysis_run(dq.Dataset.from_arrow(table.slice(0, rows)), tb,
                                   batch_size=1024, placement="host", save_states_with=day0,
                                   device="cpu")
    day1 = InMemoryStateProvider()
    AnalysisRunner.do_analysis_run(dq.Dataset.from_arrow(table.slice(rows, rows)), tb,
                                   batch_size=1024, placement="device", save_states_with=day1,
                                   device="cpu")
    merged = AnalysisRunner.run_on_aggregated_states(
        dq.Dataset.from_arrow(table.slice(0, 1)).schema, tb, [day0, day1], device="cpu")
    # the reference loads the host tier's blobs and its own device-tier day
    jday0 = JFileSystemStateProvider(str(tmp_path / "day0"))
    jday1 = JInMemoryStateProvider()
    JaxRunner.do_analysis_run(JD.Dataset.from_arrow(table.slice(rows, rows)), jb,
                              batch_size=1024, placement="device", save_states_with=jday1)
    for ja, ta in zip(jb, tb):
        _assert_state(day0.load(ta), jday0.load(ja))
    jmerged = JaxRunner.run_on_aggregated_states(
        JD.Dataset.from_arrow(table.slice(0, 1)).schema, jb, [jday0, jday1])
    _assert_metrics([jmerged.metric(a) for a in jb], [merged.metric(a) for a in tb],
                    [a.name for a in jb])
    assert merged.metric(tb[0]).value.get() == 2 * rows


# ---------------------------------------------------------------------------
# placement
# ---------------------------------------------------------------------------


def test_an_analyzer_without_a_host_partial_forces_the_device():
    from deequ_tpu_torch.analyzers.grouping import DeviceFrequencyTableScan

    table_scan = DeviceFrequencyTableScan.__new__(DeviceFrequencyTableScan)
    assert not table_scan.supports_host_partial
    assert resolve_scan_placement([T.Size(), table_scan], "host", CPU) == "device"
    assert resolve_scan_placement([T.Size()], "host", CPU) == "host"
    assert resolve_scan_placement([], "host", CPU) == "device"


def test_auto_on_the_cpu_streams_to_the_device():
    monitor = RunMonitor()
    assert resolve_scan_placement([T.Size()], "auto", CPU, monitor) == "device"
    assert resolve_scan_placement([T.Size()], None, CPU) == "device"
    assert monitor.feed_bandwidth_mbps is None
    AnalysisRunner.do_analysis_run(dq.Dataset.from_arrow(mixed_table(500)), [T.Size()],
                                   device="cpu", monitor=monitor)
    assert monitor.placement == "device"
    with pytest.raises(ValueError):
        resolve_scan_placement([T.Size()], "nowhere", CPU)
    with pytest.raises(ValueError):
        AnalysisRunner.do_analysis_run(dq.Dataset.from_arrow(mixed_table(50)), [T.Size()],
                                       device="cpu", placement="nowhere")


def test_host_placement_takes_no_device_frequency_table():
    """A grouping set that would take the device frequency table on the
    device tier goes to the host group-by on the host tier, with the same
    metrics."""
    rng = np.random.default_rng(9)
    n = 30_000
    table = pa.table({"k": pa.array(rng.integers(0, 10_000, n)), "x": pa.array(rng.normal(size=n))})
    analyzers = [T.Uniqueness(["k"]), T.CountDistinct(["k"]), T.Mean("x")]
    metrics = {}
    for placement in ("device", "host"):
        monitor = RunMonitor()
        ctx = AnalysisRunner.do_analysis_run(dq.Dataset.from_arrow(table), analyzers,
                                             batch_size=4096, placement=placement,
                                             device="cpu", monitor=monitor)
        metrics[placement] = [ctx.metric(a).value.get() for a in analyzers]
        assert monitor.device_freq_sets == (1 if placement == "device" else 0)
        assert monitor.placement == placement
    assert metrics["host"][:2] == metrics["device"][:2]
    assert metrics["host"][2] == pytest.approx(metrics["device"][2], rel=1e-12)


def test_host_partials_of_sketches_sample_on_the_host():
    """A KLL analyzer's host partial is the native sampler's block sample,
    seeded by the batch index (the reference's _np_kll_sample semantics)."""
    from deequ_tpu_torch.analyzers.base import HostBatchContext
    from deequ_tpu_torch.native import plain

    table = mixed_table(5000)
    batch = next(dq.Dataset.from_arrow(table).batches(5000, pad_to_batch_size=False))
    items, m, h, nv, mn, mx = T.KLLSketch("x").host_partial(HostBatchContext(batch, 3))
    col = batch.column("x")
    want = plain.native_block_kll_sample_plain(col.values, col.mask, 2048, 3)
    assert items.tobytes() == want[0].tobytes() and (m, h, nv) == want[1:4]
    assert (mn, mx) == want[4:] and 0 < m <= 2 * 2048 and nv == int(np.count_nonzero(col.mask))


def test_verification_and_profile_builders_take_a_placement():
    data = dq.Dataset.from_arrow(mixed_table(3000))
    monitor = RunMonitor()
    result = (dq.VerificationSuite.on_data(data, device="cpu")
              .add_check(dq.Check(dq.CheckLevel.ERROR, "c").has_size(lambda v: v == 3000)
                         .is_complete("y"))
              .with_placement("host").with_monitor(monitor).run())
    assert result.status == dq.CheckStatus.SUCCESS and monitor.placement == "host"
    monitor = RunMonitor()
    ctx = (dq.AnalysisRunner.on_data(data, device="cpu").add_analyzer(T.Mean("y"))
           .with_placement("host").with_monitor(monitor).run())
    assert monitor.placement == "host" and ctx.metric(T.Mean("y")).value.is_success
    y = pc.mean(data.arrow["y"]).as_py()
    assert ctx.metric(T.Mean("y")).value.get() == pytest.approx(y, rel=1e-12)
