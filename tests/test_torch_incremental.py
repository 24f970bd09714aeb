"""Incremental runs of the PyTorch/CUDA port (deequ_tpu_torch) against the
JAX reference (deequ_tpu): BASELINE config 4 at a small size, state
aggregation and reuse, the metrics repository and anomaly detection.

Config 4 is two day partitions of the JAX bench's ``build_scan_data``
schema (x0-x3 normal with 5% nulls, ``cat`` int64 over 100,000 values,
seed 42; ``bench.py`` is not imported, the table is rebuilt here): each
partition runs the bench's battery with ``save_states_with`` and an
in-memory metrics repository keyed by day, the table's metrics refresh
from the merged states (``run_on_aggregated_states``), and anomaly checks
on Size and Mean pass on a steady day and fail on a quarter-size day.

Both packages fold the same data at the same batch size (the JAX package
at ``placement="device"``). Tolerances: metrics of counts, min, max, HLL,
frequencies, type counts and KLL sketches equal; means, sums, standard
deviations and correlations within 1e-9 of the reference's, and within
1e-12 relative of a one-pass run over the whole table; check statuses
equal.
"""

from __future__ import annotations

import math

import jax  # noqa: F401 - the reference package runs on JAX's CPU backend
import numpy as np
import pyarrow as pa
import pyarrow.compute as pc
import pytest

import deequ_tpu.analyzers as J
import deequ_tpu.anomalydetection as JA
import deequ_tpu.checks as JC
import deequ_tpu.exceptions as JE
import deequ_tpu.repository as JR
from deequ_tpu.analyzers.state_provider import (
    FileSystemStateProvider as JFileSystemStateProvider,
    InMemoryStateProvider as JInMemoryStateProvider,
)
from deequ_tpu.data import Dataset as JDataset
from deequ_tpu.runners import AnalysisRunner as JaxRunner
from deequ_tpu.runners.engine import RunMonitor as JRunMonitor
from deequ_tpu.verification import VerificationSuite as JSuite
import deequ_tpu_torch as dq
import deequ_tpu_torch.anomalydetection as TA
import deequ_tpu_torch.exceptions as TE
import deequ_tpu_torch.repository as TR
from deequ_tpu_torch.analyzers.state_provider import (
    FileSystemStateProvider,
    InMemoryStateProvider,
)

ROWS = 20_000
BATCH = 4096
MOMENTS = ("Mean", "Sum", "StandardDeviation", "Correlation")


def build_scan_data(rows: int) -> pa.Table:
    """``bench.py build_scan_data``: four normal columns with 5% nulls and
    an int64 category over 100,000 values, seed 42."""
    rng = np.random.default_rng(42)
    cols = {}
    for i in range(4):
        vals = rng.normal(100 * i, 10, rows)
        nulls = rng.random(rows) < 0.05
        cols[f"x{i}"] = pa.array(vals, mask=nulls)
    cols["cat"] = pa.array(rng.integers(0, 100_000, rows))
    return pa.table(cols)


def with_extra_columns(table: pa.Table) -> pa.Table:
    """The second battery's columns beside the bench's: a dictionary column
    of 100 categories derived from ``cat``, and x3 with NaN in it."""
    cat = table["cat"].to_numpy()
    grade = pa.array([f"g{v // 1000:02d}" for v in cat]).dictionary_encode()
    x3 = table["x3"].to_numpy(zero_copy_only=False).copy()
    x3[cat % 97 == 0] = np.nan
    return table.append_column("grade", grade).append_column(
        "x3n", pa.array(x3, mask=pc.is_null(table["x3"]).to_numpy(zero_copy_only=False)))


def battery(m):
    """The bench's config-4 battery (``bench.py run_incremental_stage``)."""
    return [m.Size(), m.Completeness("x0"), m.Mean("x0"), m.Mean("x1"),
            m.ApproxCountDistinct("cat"), m.KLLSketch("x0")]


def second_battery(m):
    """Every other persistable state type over the same partitions."""
    return [m.Correlation("x0", "x1"), m.StandardDeviation("x2"), m.Minimum("x3n"),
            m.Maximum("x3n"), m.Mean("x3n"), m.DataType("x2"), m.Histogram("grade"),
            m.Uniqueness(["cat"])]


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


def _assert_metrics(want: dict, got: dict, rtol: float) -> None:
    """``want`` and ``got``: analyzer repr -> metric."""
    assert set(want) == set(got)
    for key, w in want.items():
        a, b = _value(w), _value(got[key])
        if isinstance(a, float) and math.isnan(a):
            assert isinstance(b, float) and math.isnan(b), key
        elif isinstance(a, float) and key.split("(")[0] in MOMENTS:
            assert abs(a - b) <= rtol * max(1.0, abs(a)), (key, a, b)
        else:
            assert a == b, (key, a, b)


def _ident(analyzer) -> str:
    """The analyzer's repr without the reference Histogram's binning
    function, which the port's Histogram lacks."""
    return repr(analyzer).replace("binning_func=None, ", "")


def _by_repr(context) -> dict:
    return {_ident(a): m for a, m in context.metric_map.items()}


def _jax_partitions(table, analyzers, rows):
    providers, repo = [], JR.InMemoryMetricsRepository()
    for p in range(table.num_rows // rows):
        sp = JInMemoryStateProvider()
        JaxRunner.do_analysis_run(
            JDataset.from_arrow(table.slice(p * rows, rows)), analyzers, save_states_with=sp,
            metrics_repository=repo, save_or_append_results_with_key=JR.ResultKey(
                p, {"day": str(p)}), batch_size=BATCH, placement="device")
        providers.append(sp)
    return providers, repo


def _torch_partitions(table, analyzers, rows):
    providers, repo = [], TR.InMemoryMetricsRepository()
    for p in range(table.num_rows // rows):
        sp = InMemoryStateProvider()
        dq.AnalysisRunner.do_analysis_run(
            dq.Dataset.from_arrow(table.slice(p * rows, rows)), analyzers, save_states_with=sp,
            metrics_repository=repo, save_or_append_results_with_key=TR.ResultKey(
                p, {"day": str(p)}), batch_size=BATCH, device="cpu")
        providers.append(sp)
    return providers, repo


def _jax_day(table, repo, rows, key):
    return (JSuite.on_data(JDataset.from_arrow(table.slice(0, rows)))
            .with_batch_size(BATCH).with_placement("device")
            .use_repository(repo).save_or_append_result(JR.ResultKey(key, {"day": str(key)}))
            .add_anomaly_check(JA.RelativeRateOfChangeStrategy(
                max_rate_increase=1.5, max_rate_decrease=0.5), J.Size())
            .add_anomaly_check(JA.RelativeRateOfChangeStrategy(
                max_rate_increase=1.1, max_rate_decrease=0.9), J.Mean("x1"))
            .run())


def _torch_day(table, repo, rows, key):
    return (dq.VerificationSuite.on_data(dq.Dataset.from_arrow(table.slice(0, rows)),
                                         device="cpu")
            .with_batch_size(BATCH)
            .use_repository(repo).save_or_append_result(TR.ResultKey(key, {"day": str(key)}))
            .add_anomaly_check(TA.RelativeRateOfChangeStrategy(
                max_rate_increase=1.5, max_rate_decrease=0.5), dq.Size())
            .add_anomaly_check(TA.RelativeRateOfChangeStrategy(
                max_rate_increase=1.1, max_rate_decrease=0.9), dq.Mean("x1"))
            .run())


def _statuses(result):
    return [(c.description, r.status.value, [cr.status.value for cr in r.constraint_results])
            for c, r in result.check_results.items()]


def test_config4_matches_the_reference():
    table = build_scan_data(2 * ROWS)
    jp, jrepo = _jax_partitions(table, battery(J), ROWS)
    tp, trepo = _torch_partitions(table, battery(dq), ROWS)
    # each day's metrics in the repositories
    for day in range(2):
        key_j, key_t = JR.ResultKey(day, {"day": str(day)}), TR.ResultKey(day, {"day": str(day)})
        _assert_metrics(_by_repr(jrepo.load_by_key(key_j)), _by_repr(trepo.load_by_key(key_t)),
                        1e-9)
    # the table's metrics from the merged states, no rescan
    schema = dq.Dataset.from_arrow(table.slice(0, 1)).schema
    monitor = dq.RunMonitor()
    merged = dq.AnalysisRunner.run_on_aggregated_states(schema, battery(dq), tp, device="cpu",
                                                        monitor=monitor)
    jmerged = JaxRunner.run_on_aggregated_states(
        JDataset.from_arrow(table.slice(0, 1)).schema, battery(J), jp)
    _assert_metrics(_by_repr(jmerged), _by_repr(merged), 1e-9)
    assert merged.metric(dq.Size()).value.get() == 2 * ROWS
    assert monitor.passes == 0 and set(monitor.phase_seconds) == {
        "state_load", "state_merge", "metric_derivation"}
    # the merged exact metrics are a one-pass run's over the whole table
    full = dq.AnalysisRunner.do_analysis_run(dq.Dataset.from_arrow(table), battery(dq),
                                             batch_size=BATCH, device="cpu")
    exact = [a for a in battery(dq) if not isinstance(a, dq.KLLSketch)]
    _assert_metrics({repr(a): full.metric(a) for a in exact},
                    {repr(a): merged.metric(a) for a in exact}, 1e-12)
    # anomaly checks over the day history: a steady day passes, a
    # quarter-size day does not, in both packages
    j_steady, t_steady = _jax_day(table, jrepo, ROWS, 2), _torch_day(table, trepo, ROWS, 2)
    j_quarter = _jax_day(table, jrepo, ROWS // 4, 3)
    t_quarter = _torch_day(table, trepo, ROWS // 4, 3)
    assert t_steady.status == dq.CheckStatus.SUCCESS
    assert t_quarter.status != dq.CheckStatus.SUCCESS
    assert _statuses(t_steady) == _statuses(j_steady)
    assert _statuses(t_quarter) == _statuses(j_quarter)
    assert len(trepo.load().get()) == 4


def test_every_persistable_state_merges_to_a_full_table_run(tmp_path):
    table = with_extra_columns(build_scan_data(2 * ROWS))
    tp, _ = _torch_partitions(table, second_battery(dq), ROWS)
    jp, _ = _jax_partitions(table, second_battery(J), ROWS)
    schema = dq.Dataset.from_arrow(table).schema
    merged = dq.AnalysisRunner.run_on_aggregated_states(schema, second_battery(dq), tp,
                                                        device="cpu")
    full = dq.AnalysisRunner.do_analysis_run(dq.Dataset.from_arrow(table), second_battery(dq),
                                             batch_size=BATCH, device="cpu")
    _assert_metrics(_by_repr(full), _by_repr(merged), 1e-12)
    jmerged = JaxRunner.run_on_aggregated_states(JDataset.from_arrow(table).schema,
                                                 second_battery(J), jp)
    _assert_metrics(_by_repr(jmerged), _by_repr(merged), 1e-9)
    # persisted through files, loaded in fresh providers: the same metrics
    stores = []
    for p, sp in enumerate(tp):
        fs = FileSystemStateProvider(str(tmp_path / f"day{p}"))
        for a in second_battery(dq):
            fs.persist(a, sp.load(a))
        stores.append(FileSystemStateProvider(str(tmp_path / f"day{p}")))
    again = dq.AnalysisRunner.run_on_aggregated_states(schema, second_battery(dq), stores,
                                                       device="cpu")
    assert {k: repr(_value(m)) for k, m in _by_repr(again).items()} == {
        k: repr(_value(m)) for k, m in _by_repr(merged).items()}
    # and the reference reads the port's files
    jfiles = JaxRunner.run_on_aggregated_states(
        JDataset.from_arrow(table).schema, second_battery(J),
        [JFileSystemStateProvider(str(tmp_path / f"day{p}")) for p in range(2)])
    _assert_metrics(_by_repr(jfiles), _by_repr(merged), 1e-9)


def test_aggregate_with_merges_a_loaded_state_into_the_run():
    table = with_extra_columns(build_scan_data(2 * ROWS))
    first, second = table.slice(0, ROWS), table.slice(ROWS, ROWS)
    analyzers = battery(dq)[:5] + second_battery(dq)
    loaded = InMemoryStateProvider()
    dq.AnalysisRunner.do_analysis_run(dq.Dataset.from_arrow(first), analyzers,
                                      save_states_with=loaded, batch_size=BATCH, device="cpu")
    saved = InMemoryStateProvider()
    ctx = (dq.AnalysisRunner.on_data(dq.Dataset.from_arrow(second), device="cpu")
           .add_analyzers(analyzers).aggregate_with(loaded).save_states_with(saved)
           .with_batch_size(BATCH).run())
    full = dq.AnalysisRunner.do_analysis_run(dq.Dataset.from_arrow(table), analyzers,
                                             batch_size=BATCH, device="cpu")
    _assert_metrics(_by_repr(full), _by_repr(ctx), 1e-12)
    # the same through the reference
    janalyzers = battery(J)[:5] + second_battery(J)
    jloaded = JInMemoryStateProvider()
    JaxRunner.do_analysis_run(JDataset.from_arrow(first), janalyzers, save_states_with=jloaded,
                              batch_size=BATCH, placement="device")
    jctx = JaxRunner.do_analysis_run(JDataset.from_arrow(second), janalyzers,
                                     aggregate_with=jloaded, batch_size=BATCH,
                                     placement="device")
    _assert_metrics(_by_repr(jctx), _by_repr(ctx), 1e-9)
    # the saved states are the merged ones
    again = dq.AnalysisRunner.run_on_aggregated_states(dq.Dataset.from_arrow(table).schema,
                                                       analyzers, [saved], device="cpu")
    _assert_metrics(_by_repr(ctx), _by_repr(again), 0.0)
    # and through VerificationSuite
    check = (dq.Check(dq.CheckLevel.ERROR, "table")
             .has_size(lambda n: n == 2 * ROWS).has_correlation("x0", "x1", lambda c: abs(c) < 0.1)
             .is_complete("x2").has_uniqueness(["cat"], lambda u: u > 0.5))
    result = (dq.VerificationSuite.on_data(dq.Dataset.from_arrow(second), device="cpu")
              .add_check(check).aggregate_with(loaded).with_batch_size(BATCH).run())
    jcheck = (JC.Check(JC.CheckLevel.ERROR, "table")
              .has_size(lambda n: n == 2 * ROWS).has_correlation("x0", "x1", lambda c: abs(c) < 0.1)
              .is_complete("x2").has_uniqueness(["cat"], lambda u: u > 0.5))
    jresult = (JSuite.on_data(JDataset.from_arrow(second)).add_check(jcheck)
               .aggregate_with(jloaded).with_batch_size(BATCH).with_placement("device").run())
    assert _statuses(result) == _statuses(jresult)
    assert result.status == dq.CheckStatus.ERROR  # is_complete("x2") fails: 5% nulls


def test_grouping_states_take_the_host_group_by_when_saved():
    table = build_scan_data(2 * ROWS)
    data = dq.Dataset.from_arrow(table)
    plain, saving = dq.RunMonitor(), dq.RunMonitor()
    a = dq.Uniqueness(["cat"])
    ctx = dq.AnalysisRunner.do_analysis_run(data, [a], batch_size=BATCH, device="cpu",
                                            monitor=plain)
    store = InMemoryStateProvider()
    saved = dq.AnalysisRunner.do_analysis_run(data, [a], batch_size=BATCH, device="cpu",
                                              monitor=saving, save_states_with=store)
    assert plain.device_freq_sets == 1 and saving.device_freq_sets == 0
    assert "host_accumulators" in saving.phase_seconds
    assert type(store.load(a)).__name__ == "FrequenciesAndNumRows"
    assert ctx.metric(a).value.get() == saved.metric(a).value.get()
    jctx = JaxRunner.do_analysis_run(JDataset.from_arrow(table), [J.Uniqueness(["cat"])],
                                     save_states_with=JInMemoryStateProvider(),
                                     batch_size=BATCH, placement="device")
    assert jctx.metric(J.Uniqueness(["cat"])).value.get() == saved.metric(a).value.get()


def test_reuse_existing_results_for_key():
    table = build_scan_data(ROWS)
    analyzers = battery(dq)[:4]
    repo = TR.InMemoryMetricsRepository()
    key = TR.ResultKey(7, {"day": "7"})
    first = dq.AnalysisRunner.do_analysis_run(
        dq.Dataset.from_arrow(table), analyzers, metrics_repository=repo,
        save_or_append_results_with_key=key, batch_size=BATCH, device="cpu")
    monitor = dq.RunMonitor()
    other = dq.Dataset.from_arrow(table.slice(0, 100))
    reused = (dq.AnalysisRunner.on_data(other, device="cpu").add_analyzers(analyzers)
              .use_repository(repo).reuse_existing_results_for_key(key)
              .with_monitor(monitor).run())
    assert monitor.passes == 0
    assert {k: _value(m) for k, m in _by_repr(reused).items()} == {
        k: _value(m) for k, m in _by_repr(first).items()}
    # an analyzer without a stored result runs; with fail_if_results_missing it raises
    extra = dq.Mean("x2")
    mixed = dq.AnalysisRunner.do_analysis_run(
        other, analyzers + [extra], metrics_repository=repo,
        reuse_existing_results_for_key=key, device="cpu")
    assert mixed.metric(dq.Size()).value.get() == ROWS
    with pytest.raises(TE.MetricCalculationException):
        dq.AnalysisRunner.do_analysis_run(
            other, analyzers + [extra], metrics_repository=repo,
            reuse_existing_results_for_key=key, fail_if_results_missing=True, device="cpu")
    # the reference does the same
    jrepo = JR.InMemoryMetricsRepository()
    jkey = JR.ResultKey(7, {"day": "7"})
    JaxRunner.do_analysis_run(JDataset.from_arrow(table), battery(J)[:4],
                              metrics_repository=jrepo, save_or_append_results_with_key=jkey,
                              batch_size=BATCH, placement="device")
    jmon = JRunMonitor()
    jreused = JaxRunner.do_analysis_run(
        JDataset.from_arrow(table.slice(0, 100)), battery(J)[:4], metrics_repository=jrepo,
        reuse_existing_results_for_key=jkey, monitor=jmon)
    _assert_metrics(_by_repr(jreused), _by_repr(reused), 1e-9)
    with pytest.raises(JE.MetricCalculationException):
        JaxRunner.do_analysis_run(
            JDataset.from_arrow(table.slice(0, 100)), battery(J)[:4] + [J.Mean("x2")],
            metrics_repository=jrepo, reuse_existing_results_for_key=jkey,
            fail_if_results_missing=True)
    # and through VerificationSuite
    vrepo = TR.InMemoryMetricsRepository()
    check = dq.Check(dq.CheckLevel.ERROR, "size").has_size(lambda n: n == ROWS)
    first_v = (dq.VerificationSuite.on_data(dq.Dataset.from_arrow(table), device="cpu")
               .add_check(check).use_repository(vrepo).save_or_append_result(key).run())
    again_v = (dq.VerificationSuite.on_data(other, device="cpu").add_check(check)
               .use_repository(vrepo).reuse_existing_results_for_key(key).run())
    assert first_v.status == again_v.status == dq.CheckStatus.SUCCESS


def _history(m, repo_cls, path):
    repo = repo_cls(path)
    for day in range(4):
        data_cls = dq.Dataset if m is dq else JDataset
        table = build_scan_data(ROWS // 4 * (day + 1))
        analyzers = [m.Size(), m.Mean("x1"), m.Completeness("x0"), m.Histogram("grade")]
        table = with_extra_columns(table)
        key_cls = TR.ResultKey if m is dq else JR.ResultKey
        runner = dq.AnalysisRunner if m is dq else JaxRunner
        kwargs = {"device": "cpu"} if m is dq else {"placement": "device"}
        runner.do_analysis_run(
            data_cls.from_arrow(table), analyzers, metrics_repository=repo,
            save_or_append_results_with_key=key_cls(1000 + day, {
                "day": str(day), "parity": "even" if day % 2 == 0 else "odd"}),
            batch_size=BATCH, **kwargs)
    return repo


def _records(loader):
    return sorted((r["dataset_date"], r["name"], r["instance"], r["entity"], r.get("parity"),
                   r["value"]) for r in loader.get_success_metrics_as_records(["parity"]))


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_file_system_repository_reads_across_packages(writer, tmp_path):
    path = str(tmp_path / "metrics.json")
    if writer == "jax":
        _history(J, JR.FileSystemMetricsRepository, path)
    else:
        _history(dq, TR.FileSystemMetricsRepository, path)
    jrepo, trepo = JR.FileSystemMetricsRepository(path), TR.FileSystemMetricsRepository(path)
    assert _records(trepo.load()) == _records(jrepo.load())
    assert len(_records(trepo.load())) > 0
    # the loader's filters
    for jl, tl in [
        (jrepo.load().with_tag_values({"parity": "odd"}),
         trepo.load().with_tag_values({"parity": "odd"})),
        (jrepo.load().after(1001).before(1002), trepo.load().after(1001).before(1002)),
        (jrepo.load().for_analyzers([J.Size()]), trepo.load().for_analyzers([dq.Size()])),
    ]:
        assert _records(tl) == _records(jl)
        assert len(tl.get()) == len(jl.get())
    assert len(trepo.load().with_tag_values({"parity": "odd"}).get()) == 2
    assert [r.result_key.data_set_date for r in trepo.load().after(1001).before(1002).get()] \
        == [1001, 1002]
    key = TR.ResultKey(1002, {"day": "2", "parity": "even"})
    got = trepo.load_by_key(key)
    want = jrepo.load_by_key(JR.ResultKey(1002, {"day": "2", "parity": "even"}))
    _assert_metrics(_by_repr(want), _by_repr(got), 0.0)
    assert trepo.load().get_success_metrics_as_json() == jrepo.load().get_success_metrics_as_json()
    # a torn entry is quarantined by both, the rest keep serving
    text = open(path).read()
    open(path, "w").write(text.replace('"value": 5000.0', '"value": 5001.0', 1))
    assert len(TR.FileSystemMetricsRepository(path).load().get()) == 3
    assert len(JR.FileSystemMetricsRepository(path).load().get()) == 3


def _series(seed: int, n: int = 40):
    rng = np.random.default_rng(seed)
    s = rng.normal(100.0, 5.0, n)
    s[rng.integers(5, n, 3)] *= rng.choice([0.3, 1.8], 3)
    return s.tolist()


STRATEGIES = {
    "simple_threshold": lambda m: m.SimpleThresholdStrategy(lower_bound=90.0, upper_bound=110.0),
    "absolute_change": lambda m: m.AbsoluteChangeStrategy(-12.0, 12.0),
    "absolute_change_order2": lambda m: m.AbsoluteChangeStrategy(-20.0, 20.0, order=2),
    "rate_of_change": lambda m: m.RateOfChangeStrategy(max_rate_decrease=-15.0,
                                                       max_rate_increase=15.0),
    "relative_rate_of_change": lambda m: m.RelativeRateOfChangeStrategy(0.7, 1.3),
    "online_normal": lambda m: m.OnlineNormalStrategy(),
    "online_normal_no_exclusion": lambda m: m.OnlineNormalStrategy(
        lower_deviation_factor=2.0, upper_deviation_factor=2.0, ignore_anomalies=False),
    "batch_normal": lambda m: m.BatchNormalStrategy(),
}


@pytest.mark.parametrize("interval", [(0, 40), (10, 40), (25, 30)])
@pytest.mark.parametrize("case", sorted(STRATEGIES))
def test_anomaly_strategy_matches_the_reference_serial_detect(case, interval):
    if case == "batch_normal" and interval[0] == 0:
        interval = (1, 40)  # the batch strategy needs history before the interval
    for seed in range(3):
        series = _series(seed)
        want = STRATEGIES[case](JA).detect(series, interval)
        got = STRATEGIES[case](TA).detect(series, interval)
        assert [(i, a.value, a.confidence, a.detail) for i, a in got] == [
            (i, a.value, a.confidence, a.detail) for i, a in want], (case, seed)


def test_has_correlation_through_verification_suite():
    table = build_scan_data(ROWS)
    x0 = table["x0"].to_numpy(zero_copy_only=False)
    table = table.append_column("x0b", pa.array(2.0 * np.nan_to_num(x0, nan=1.0) + 1.0))
    check = (dq.Check(dq.CheckLevel.WARNING, "corr")
             .has_correlation("x0", "x0b", lambda c: c > 0.999)
             .has_correlation("x0", "x1", lambda c: abs(c) < 0.05)
             .has_correlation("x1", "x2", lambda c: c > 0.5).where("x3 > 300"))
    jcheck = (JC.Check(JC.CheckLevel.WARNING, "corr")
              .has_correlation("x0", "x0b", lambda c: c > 0.999)
              .has_correlation("x0", "x1", lambda c: abs(c) < 0.05)
              .has_correlation("x1", "x2", lambda c: c > 0.5).where("x3 > 300"))
    got = (dq.VerificationSuite.on_data(dq.Dataset.from_arrow(table), device="cpu")
           .add_check(check).with_batch_size(BATCH).run())
    want = (JSuite.on_data(JDataset.from_arrow(table)).add_check(jcheck)
            .with_batch_size(BATCH).with_placement("device").run())
    assert _statuses(got) == _statuses(want)
    assert got.status == dq.CheckStatus.WARNING
    _assert_metrics({_ident(a): m for a, m in want.metrics.items()},
                    {_ident(a): m for a, m in got.metrics.items()}, 1e-9)


def test_paths_not_in_this_slice_raise_by_name():
    with pytest.raises(NotImplementedError, match="PartitionedVerificationRunBuilder"):
        dq.VerificationSuite.on_partitions(None, "ds", {})
    with pytest.raises(NotImplementedError, match="HoltWinters"):
        TA.HoltWinters  # noqa: B018
