"""The port's host accumulators and result sinks against the JAX reference:
``Dataset.random_split``, the exact quantile mode, Histograms the device
frequency scan cannot take, ``MutualInformation``, a frequency table that
spills to disk under its budget, the two JSON sinks and
``cost_by_analyzer``, and states of these analyzers carried between the
packages.

The same pyarrow tables, made from a numpy seed, go through both
packages: JAX on the CPU (as ``tests/conftest.py`` sets it), the port on
``device="cpu"``. Tolerances (ROADMAP's parity bar): counts, histograms,
quantiles of the exact mode and every key are equal; Entropy and
MutualInformation agree within 1e-12 relative.
"""

from __future__ import annotations

import json
import math

import numpy as np
import pyarrow as pa
import pytest

import deequ_tpu
import deequ_tpu.analyzers as J
import deequ_tpu.analyzers.grouping as JG
import deequ_tpu.data as JD
import deequ_tpu_torch as dq
import deequ_tpu_torch.analyzers as T
import deequ_tpu_torch.analyzers.grouping as TG
import deequ_tpu_torch.data as TD
from deequ_tpu.analyzers.state_provider import FileSystemStateProvider as JaxFileStates
from deequ_tpu.analyzers.state_provider import InMemoryStateProvider as JaxMemoryStates
from deequ_tpu.runners import AnalysisRunner as JaxRunner
from deequ_tpu_torch.analyzers.state_provider import FileSystemStateProvider as FileStates
from deequ_tpu_torch.analyzers.state_provider import InMemoryStateProvider as MemoryStates
from deequ_tpu_torch.convert import from_reference, to_reference
from deequ_tpu_torch.runners import AnalysisRunner, RunMonitor

RTOL = 1e-12


def _table(n: int = 4000, seed: int = 21) -> pa.Table:
    """Columns of every kind the host paths key on: float64 with NaN,
    +-0.0 and nulls; int64 keys of about n / 2 values; a string column of
    about 290 values (``Dataset.from_arrow`` encodes it) and one of about
    900 (it stays plain), both with nulls; int8; booleans with nulls; and
    a 70,000-entry dictionary column, over the device scan's limit."""
    rng = np.random.default_rng(seed)
    f = rng.integers(-60, 60, n) / 4.0
    f[rng.random(n) < 0.03] = np.nan
    f[rng.random(n) < 0.03] = -0.0
    big = 70_000
    return pa.table({
        "f": pa.array(f, mask=rng.random(n) < 0.05),
        "k": pa.array(rng.integers(0, n // 2, n), mask=rng.random(n) < 0.02),
        "s": pa.array([None if v < 10 else f"s{v}" for v in rng.integers(0, 300, n)]),
        "t": pa.array([None if v < 20 else f"t{v}" for v in rng.integers(0, 920, n)]),
        "i8": pa.array(rng.integers(-20, 20, n).astype(np.int8)),
        "b": pa.array(rng.random(n) < 0.3, mask=rng.random(n) < 0.04),
        "y": pa.array(rng.normal(0.0, 1.0, n), mask=rng.random(n) < 0.1),
        "d": pa.DictionaryArray.from_arrays(
            pa.array(rng.integers(0, big, n).astype(np.int32), mask=rng.random(n) < 0.03),
            pa.array([f"w{i}" for i in range(big)])),
    })


def _value(metric):
    """A metric's value in comparable form (the failure's type when it
    failed)."""
    if metric.value.is_failure:
        return ("failure", type(metric.value.exception).__name__)
    v = metric.value.get()
    if hasattr(v, "buckets"):
        return ([(b.low_value, b.high_value, b.count) for b in v.buckets], list(v.parameters),
                v.data)
    if hasattr(v, "number_of_bins"):
        return v.number_of_bins, {k: (x.absolute, x.ratio) for k, x in v.values.items()}
    return v


def _assert_close(got, want, key=""):
    if isinstance(want, float) and isinstance(got, float):
        assert math.isclose(got, want, rel_tol=RTOL, abs_tol=0.0), (key, got, want)
    else:
        assert got == want, (key, got, want)


def _both(table, port_analyzers, ref_analyzers, **kwargs):
    """{repr: value} of each package's run over ``table``."""
    got = AnalysisRunner.do_analysis_run(TD.Dataset.from_arrow(table), port_analyzers,
                                         device="cpu", **kwargs)
    want = JaxRunner.do_analysis_run(JD.Dataset.from_arrow(table), ref_analyzers, **kwargs)
    return ({repr(a): _value(got.metric(a)) for a in port_analyzers},
            {repr(a): _value(want.metric(a)) for a in ref_analyzers})


# ---------------------------------------------------------------------------
# Dataset.random_split
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("fraction", [0.25, 0.75])
@pytest.mark.parametrize("seed", [0, 7])
def test_random_split_picks_the_reference_rows(fraction, seed):
    table = _table(3000)
    table = table.append_column("row", pa.array(np.arange(table.num_rows)))
    port = TD.Dataset.from_arrow(table).random_split(fraction, seed=seed)
    ref = JD.Dataset.from_arrow(table).random_split(fraction, seed=seed)
    for got, want in zip(port, ref):
        assert np.array_equal(got.arrow.column("row").to_numpy(),
                              want.arrow.column("row").to_numpy())
        # every column but the NaN-holding float one compares in Arrow
        assert got.arrow.drop(["f"]).equals(want.arrow.drop(["f"]))
        assert got.num_rows == want.num_rows
    assert port[0].num_rows + port[1].num_rows == table.num_rows


# ---------------------------------------------------------------------------
# the exact quantile mode
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("where", [None, "i8 > 0"])
@pytest.mark.parametrize("column", ["y", "f", "i8"])
def test_exact_quantiles_equal_the_reference_and_numpy(column, where):
    table = _table()
    qs = (0.0, 0.1, 0.5, 0.77, 1.0)
    port = [T.ApproxQuantile(column, 0.5, 0.0, where), T.ApproxQuantiles(column, qs, 0.0, where)]
    ref = [J.ApproxQuantile(column, 0.5, 0.0, where), J.ApproxQuantiles(column, qs, 0.0, where)]
    got, want = _both(table, port + [T.Size()], ref + [J.Size()], batch_size=333)
    assert list(got.values()) == list(want.values())
    x = table.column(column).to_numpy(zero_copy_only=False).astype(np.float64)
    keep = np.asarray(table.column(column).is_valid()) & ~np.isnan(x)
    if where is not None:
        keep &= table.column("i8").to_numpy() > 0
    assert got[repr(port[0])] == float(np.quantile(x[keep], 0.5))
    assert got[repr(port[1])] == {str(q): float(np.quantile(x[keep], q)) for q in qs}


def test_exact_quantile_states_merge_and_persist_as_the_reference_does(tmp_path):
    """Two partitions' exact states merged through ``aggregate_with`` equal
    the whole table's quantile in both packages; a file provider cannot
    persist one in either (the state is not registered), which fails that
    analyzer alone; and a state carried across with ``convert`` gives the
    same quantile."""
    table = _table()
    halves = table.slice(0, 1500), table.slice(1500)
    a_port, a_ref = T.ApproxQuantile("y", 0.3, 0.0), J.ApproxQuantile("y", 0.3, 0.0)
    port_states, ref_states = MemoryStates(), JaxMemoryStates()
    AnalysisRunner.do_analysis_run(TD.Dataset.from_arrow(halves[0]), [a_port], device="cpu",
                                   save_states_with=port_states)
    JaxRunner.do_analysis_run(JD.Dataset.from_arrow(halves[0]), [a_ref],
                              save_states_with=ref_states)
    got = AnalysisRunner.do_analysis_run(TD.Dataset.from_arrow(halves[1]), [a_port],
                                         device="cpu", aggregate_with=port_states)
    want = JaxRunner.do_analysis_run(JD.Dataset.from_arrow(halves[1]), [a_ref],
                                     aggregate_with=ref_states)
    whole = JaxRunner.do_analysis_run(JD.Dataset.from_arrow(table), [a_ref])
    assert got.metric(a_port).value.get() == want.metric(a_ref).value.get() \
        == whole.metric(a_ref).value.get()
    # carried across: the reference's state in the port's metric
    carried = from_reference("ExactQuantileState", list(ref_states.load(a_ref).chunks))
    assert a_port.compute_metric_from(carried).value.get() \
        == a_ref.compute_metric_from(ref_states.load(a_ref)).value.get()
    name, leaves = to_reference(port_states.load(a_port))
    assert name == type(ref_states.load(a_ref)).__name__
    # not persistable to files, in either package
    port_ctx = AnalysisRunner.do_analysis_run(
        TD.Dataset.from_arrow(table), [a_port, T.Size()], device="cpu",
        save_states_with=FileStates(str(tmp_path / "port")))
    ref_ctx = JaxRunner.do_analysis_run(
        JD.Dataset.from_arrow(table), [a_ref, J.Size()],
        save_states_with=JaxFileStates(str(tmp_path / "ref")))
    assert port_ctx.metric(a_port).value.is_failure and ref_ctx.metric(a_ref).value.is_failure
    assert "not registered" in str(port_ctx.metric(a_port).value.exception)
    assert port_ctx.metric(T.Size()).value.get() == ref_ctx.metric(J.Size()).value.get()


# ---------------------------------------------------------------------------
# Histograms on the host
# ---------------------------------------------------------------------------


def _bins(v):
    if v is None or v != v:
        return None
    return "low" if v < 0 else ("zero" if v == 0 else "high")


HISTOGRAMS = {
    "float": ("f", None, 1000),
    "int": ("k", None, 1000),
    "string": ("t", None, 1000),
    "bool": ("b", None, 1000),
    "int8 top 5": ("i8", None, 5),
    "binned float": ("f", _bins, 1000),
    "binned string": ("t", lambda v: v[:2], 1000),
    "dictionary over 2^16 entries": ("d", None, 1000),
    "binned dictionary": ("d", lambda v: v[:3], 1000),
}


@pytest.mark.parametrize("case", sorted(HISTOGRAMS))
def test_host_histograms_equal_the_reference(case):
    column, fn, bins = HISTOGRAMS[case]
    port, ref = T.Histogram(column, fn, bins), J.Histogram(column, fn, bins)
    # a dictionary column of any size is counted on the device (kernel
    # dict_code_counts), every other histogram on the host. The reference
    # counts a dictionary over 2^16 entries on the host, where the detail
    # bins it keeps among tied counts follow its batch boundaries (its
    # table keeps first-seen order): that case runs in one batch
    on_device = fn is None and column == "d"
    batch = 4000 if on_device else 700
    monitor = RunMonitor()
    got = AnalysisRunner.do_analysis_run(TD.Dataset.from_arrow(_table()), [port], device="cpu",
                                         batch_size=batch, monitor=monitor).metric(port)
    want = JaxRunner.do_analysis_run(JD.Dataset.from_arrow(_table()), [ref],
                                     batch_size=batch).metric(ref)
    assert _value(got) == _value(want)
    assert ("host_accumulators" in monitor.phase_seconds) != on_device


# ---------------------------------------------------------------------------
# MutualInformation
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("columns", [("i8", "s"), ("k", "i8"), ("s", "d")],
                         ids=lambda c: "-".join(c))
def test_mutual_information_equals_the_reference(columns):
    """Alone, and sharing its grouping set with Uniqueness and Entropy: the
    set takes the value-keyed host table (never the hashed device table),
    and every metric is the reference's."""
    table = _table()
    port = [T.MutualInformation(columns), T.Uniqueness(columns), T.Entropy(columns)]
    ref = [J.MutualInformation(columns), J.Uniqueness(columns), J.Entropy(columns)]
    for n in (1, 3):
        monitor = RunMonitor()
        got = AnalysisRunner.do_analysis_run(TD.Dataset.from_arrow(table), port[:n],
                                             device="cpu", placement="device", monitor=monitor)
        want = JaxRunner.do_analysis_run(JD.Dataset.from_arrow(table), ref[:n],
                                         placement="device")
        assert monitor.device_freq_sets == 0
        for a, b in zip(port[:n], ref[:n]):
            _assert_close(_value(got.metric(a)), _value(want.metric(b)), repr(a))


def _mi_numpy(table, columns) -> float:
    """Mutual information over the rows where both columns are present,
    NaN a key of its own, with N all rows (the reference's formula)."""
    n = table.num_rows
    x, y = (table.column(c) for c in columns)
    keep = np.asarray(x.is_valid()) & np.asarray(y.is_valid())
    xs = [("nan" if isinstance(v, float) and v != v else v)
          for v, k in zip(x.to_pylist(), keep) if k]
    ys = [("nan" if isinstance(v, float) and v != v else v)
          for v, k in zip(y.to_pylist(), keep) if k]
    from collections import Counter

    joint, cx, cy = Counter(zip(xs, ys)), Counter(xs), Counter(ys)
    return sum(c / n * math.log((c / n) / ((cx[a] / n) * (cy[b] / n)))
               for (a, b), c in joint.items())


@pytest.mark.parametrize("columns", [("i8", "b"), ("f", "s")], ids=lambda c: "-".join(c))
def test_mutual_information_of_boolean_and_nan_keys_equals_numpy(columns):
    """Where the reference's label lookups fail (a boolean key array
    indexes as a mask, a NaN key leaves its marginal), the port gives
    numpy's mutual information."""
    table = _table()
    a = T.MutualInformation(columns)
    got = AnalysisRunner.do_analysis_run(TD.Dataset.from_arrow(table), [a],
                                         device="cpu").metric(a).value.get()
    assert math.isclose(got, _mi_numpy(table, columns), rel_tol=1e-12)
    ref = J.MutualInformation(columns)
    assert JaxRunner.do_analysis_run(JD.Dataset.from_arrow(table), [ref]).metric(
        ref).value.is_failure


def test_mutual_information_states_load_in_either_package(tmp_path):
    """A MutualInformation state written by one package's file provider
    loads in the other's, and the metrics from it agree."""
    table = _table()
    port, ref = T.MutualInformation(("i8", "s")), J.MutualInformation(("i8", "s"))
    AnalysisRunner.do_analysis_run(TD.Dataset.from_arrow(table), [port], device="cpu",
                                   save_states_with=FileStates(str(tmp_path / "port")))
    JaxRunner.do_analysis_run(JD.Dataset.from_arrow(table), [ref],
                              save_states_with=JaxFileStates(str(tmp_path / "ref")))
    schema_port = TD.Dataset.from_arrow(table).schema
    schema_ref = JD.Dataset.from_arrow(table).schema
    got = dq.AnalysisRunner.run_on_aggregated_states(
        schema_port, [port], [FileStates(str(tmp_path / "ref"))], device="cpu").metric(port)
    want = JaxRunner.run_on_aggregated_states(
        schema_ref, [ref], [JaxFileStates(str(tmp_path / "port"))]).metric(ref)
    direct = JaxRunner.do_analysis_run(JD.Dataset.from_arrow(table), [ref]).metric(ref)
    _assert_close(got.value.get(), direct.value.get())
    _assert_close(want.value.get(), direct.value.get())


# ---------------------------------------------------------------------------
# the frequency budget and the spill to disk
# ---------------------------------------------------------------------------


def _grouping_battery(m):
    return [m.Uniqueness(["k"]), m.Distinctness(["k"]), m.CountDistinct(["k"]),
            m.Entropy(["k"]), m.UniqueValueRatio(["k"]), m.Histogram("t"),
            m.MutualInformation(["i8", "s"])]


def _spill_env(monkeypatch, budget: int, partitions: int, spill: bool = True):
    monkeypatch.setenv("DEEQU_TPU_MAX_FREQUENCY_ENTRIES", str(budget))
    monkeypatch.setenv("DEEQU_TPU_FREQUENCY_SPILL_PARTITIONS", str(partitions))
    monkeypatch.setenv("DEEQU_TPU_FREQUENCY_SPILL", "1" if spill else "0")
    # flush every few batches, so the table spills in several runs
    monkeypatch.setattr(TG, "MIN_FLUSH_ENTRIES", 256)
    monkeypatch.setattr(JG, "MIN_FLUSH_ENTRIES", 256)


@pytest.mark.parametrize("budget,partitions", [(40, 4), (700, 1)])
def test_spilled_tables_equal_the_unspilled_run_and_the_reference(monkeypatch, tmp_path,
                                                                  budget, partitions):
    table = _table()
    port, ref = _grouping_battery(T), _grouping_battery(J)
    kwargs = dict(batch_size=500, placement="host")
    unspilled = AnalysisRunner.do_analysis_run(TD.Dataset.from_arrow(table), port,
                                               device="cpu", **kwargs)
    _spill_env(monkeypatch, budget, partitions)
    monkeypatch.setattr("tempfile.tempdir", str(tmp_path))
    states = MemoryStates()
    spilled = AnalysisRunner.do_analysis_run(TD.Dataset.from_arrow(table), port,
                                             device="cpu", save_states_with=states, **kwargs)
    assert all(states.load(a).spilled for a in (port[0], port[5], port[6]))
    assert _spill_dirs(tmp_path)
    want = JaxRunner.do_analysis_run(JD.Dataset.from_arrow(table), ref, **kwargs)
    for a, b in zip(port, ref):
        got = _value(spilled.metric(a))
        _assert_close(got, _value(unspilled.metric(a)), repr(a))
        _assert_close(got, _value(want.metric(b)), repr(a))
    for a in port:
        states.load(a).close()
    assert not _spill_dirs(tmp_path)
    with pytest.raises(RuntimeError, match="spill store was closed"):
        list(states.load(port[0]).iter_merged_chunks())
    # a run that keeps no state removes its spill directories at once
    AnalysisRunner.do_analysis_run(TD.Dataset.from_arrow(table), port, device="cpu", **kwargs)
    assert not _spill_dirs(tmp_path)


def _spill_dirs(path) -> list:
    return [p for p in path.iterdir() if p.name.startswith("deequ-tpu-freq-spill-")]


def test_the_budget_fails_its_sets_when_spilling_is_off(monkeypatch):
    """With spilling off, a set over the budget fails its analyzers with
    the budget's error in both packages; the small sets and the scan
    analyzers of the same run are not touched."""
    table = _table()
    _spill_env(monkeypatch, 400, 4, spill=False)
    port = _grouping_battery(T) + [T.CountDistinct(["i8"]), T.Size()]
    ref = _grouping_battery(J) + [J.CountDistinct(["i8"]), J.Size()]
    got, want = _both(table, port, ref, batch_size=500, placement="host")
    assert list(got.values()) == list(want.values())
    failed = {k for k, v in got.items() if isinstance(v, tuple) and v[0] == "failure"}
    # k: about 2,000 groups, t about 900, (i8, s) about 3,500
    assert failed == {repr(a) for a in port[:7]}
    assert not failed & {repr(port[-2]), repr(port[-1])}
    ctx = AnalysisRunner.do_analysis_run(TD.Dataset.from_arrow(table), port[:1], device="cpu",
                                         batch_size=500, placement="host")
    assert "DEEQU_TPU_MAX_FREQUENCY_ENTRIES=400" in str(ctx.metric(port[0]).value.exception)


# ---------------------------------------------------------------------------
# the JSON sinks and the cost by analyzer
# ---------------------------------------------------------------------------


def _check(m):
    return (m.Check(m.CheckLevel.ERROR, "sinks")
            .has_size(lambda v: v == 4000).is_complete("i8").has_min("i8", lambda v: v >= -20)
            .has_completeness("f", lambda v: v > 0.99).is_contained_in("b", [True, False]))


def test_the_verification_sinks_write_the_reference_json(tmp_path):
    table = _table()
    paths = {name: (tmp_path / f"port-{name}.json", tmp_path / f"ref-{name}.json")
             for name in ("checks", "metrics")}
    port = (dq.VerificationSuite.on_data(TD.Dataset.from_arrow(table), device="cpu")
            .add_check(_check(dq))
            .save_check_results_json_to_path(str(paths["checks"][0]))
            .save_success_metrics_json_to_path(str(paths["metrics"][0])).run())
    ref = (deequ_tpu.VerificationSuite.on_data(JD.Dataset.from_arrow(table))
           .add_check(_check(deequ_tpu))
           .save_check_results_json_to_path(str(paths["checks"][1]))
           .save_success_metrics_json_to_path(str(paths["metrics"][1])).run())
    for got, want in paths.values():
        assert got.read_text() == want.read_text()
    assert paths["checks"][0].read_text() == port.check_results_as_json()
    assert json.loads(paths["metrics"][0].read_text()) == json.loads(ref.success_metrics_as_json())


def test_the_analysis_sink_keeps_an_existing_file_unless_told(tmp_path):
    table = _table()
    path = tmp_path / "metrics.json"
    path.write_text("kept")
    builder = (dq.AnalysisRunner.on_data(TD.Dataset.from_arrow(table), device="cpu")
               .add_analyzer(T.Size()).add_analyzer(T.Completeness("f")))
    builder.save_success_metrics_json_to_path(str(path)).run()
    assert path.read_text() == "kept"
    ctx = builder.save_success_metrics_json_to_path(str(path), overwrite=True).run()
    want = (deequ_tpu.runners.AnalysisRunner.on_data(JD.Dataset.from_arrow(table))
            .add_analyzer(J.Size()).add_analyzer(J.Completeness("f")).run())
    assert path.read_text() == ctx.success_metrics_as_json() == want.success_metrics_as_json()


@pytest.mark.parametrize("placement", ["device", "host"])
def test_cost_by_analyzer_names_the_reference_keys(placement):
    """Every analyzer of the pass's battery has a cost, keyed by its repr
    (the reference's keys); the JSON lists them most expensive first, and
    a check evaluated against a given context has none."""
    table = _table()
    port = (dq.VerificationSuite.on_data(TD.Dataset.from_arrow(table), device="cpu")
            .add_check(_check(dq)).with_batch_size(1000).with_placement(placement).run())
    ref = (deequ_tpu.VerificationSuite.on_data(JD.Dataset.from_arrow(table))
           .add_check(_check(deequ_tpu)).with_batch_size(1000).with_placement(placement).run())
    rows = json.loads(port.cost_by_analyzer_as_json())
    assert [r["analyzer"] for r in rows] == sorted(port.cost_by_analyzer,
                                                   key=lambda k: -port.cost_by_analyzer[k])
    assert set(port.cost_by_analyzer) == set(ref.cost_by_analyzer)
    assert all(r["seconds"] >= 0.0 for r in rows) and set(rows[0]) == {"analyzer", "seconds"}
    evaluated = dq.VerificationSuite.evaluate([_check(dq)], dq.AnalyzerContext.empty())
    assert evaluated.cost_by_analyzer == {} and evaluated.cost_by_analyzer_as_json() == "[]"


# ---------------------------------------------------------------------------
# the profiler's keys through an in-memory repository
# ---------------------------------------------------------------------------


def test_profiler_saves_and_reuses_through_an_in_memory_repository():
    """A profile saved under a key serves a second profile with no pass;
    the repository holds what the reference's holds."""
    from deequ_tpu.profiles import ColumnProfiler as JaxProfiler
    from deequ_tpu.repository import InMemoryMetricsRepository as JaxRepository
    from deequ_tpu.repository import ResultKey as JaxKey
    from deequ_tpu_torch.repository import InMemoryMetricsRepository, ResultKey

    table = _table(2000).drop(["d", "f"])
    repo, key = InMemoryMetricsRepository(), ResultKey(5, {"run": "a"})
    first = dq.ColumnProfiler.profile(TD.Dataset.from_arrow(table), device="cpu",
                                      metrics_repository=repo,
                                      save_in_metrics_repository_using_key=key)
    monitor = RunMonitor()
    again = dq.ColumnProfiler.profile(TD.Dataset.from_arrow(table), device="cpu",
                                      metrics_repository=repo,
                                      reuse_existing_results_using_key=key,
                                      fail_if_results_for_reusing_missing=True, monitor=monitor)
    assert monitor.passes == 0 and again.to_json() == first.to_json()
    jrepo, jkey = JaxRepository(), JaxKey(5, {"run": "a"})
    JaxProfiler.profile(JD.Dataset.from_arrow(table), metrics_repository=jrepo,
                        save_in_metrics_repository_using_key=jkey, placement="device")
    got = {repr(a): _value(m) for a, m in repo.load_by_key(key).metric_map.items()}
    want = {repr(a): _value(m) for a, m in jrepo.load_by_key(jkey).metric_map.items()}
    assert set(got) == set(want)
    for k, w in want.items():
        _assert_close(got[k], w, k)
    with pytest.raises(Exception, match="Could not find all necessary results"):
        dq.ColumnProfiler.profile(TD.Dataset.from_arrow(table), device="cpu",
                                  metrics_repository=repo,
                                  reuse_existing_results_using_key=ResultKey(6, {}),
                                  fail_if_results_for_reusing_missing=True)
