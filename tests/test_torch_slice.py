"""The PyTorch/CUDA port's slice as a whole against the JAX reference.

One battery of checks goes through ``deequ_tpu.VerificationSuite`` (JAX on
the CPU, device placement) and ``deequ_tpu_torch.VerificationSuite`` on
``device="cpu"`` (the kernels' plain versions) over the same pyarrow table,
in several batches. Tolerances: every metric other than Mean, Sum and
StandardDeviation is equal (counts, ratios of counts, min, max, HLL
estimates, frequency metrics, histograms); Mean, Sum and StandardDeviation
agree within 1e-12 relative (float64 sums added in another order) — well
inside BASELINE's ±1e-6. Check and constraint statuses are identical.

Also here: state carried across the two packages (``convert.py``), the
routing the port refuses, and the rule that entry points run on CUDA
unless the CPU is asked for.
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp
import numpy as np
import pyarrow as pa
import pyarrow.compute as pc
import pytest
import torch

import chip_smoke
import deequ_tpu
import deequ_tpu.analyzers as J
import deequ_tpu.analyzers.grouping as JG
import deequ_tpu.data as JD
import deequ_tpu.runners.features as JF
import deequ_tpu_torch
import deequ_tpu_torch.analyzers as T
import deequ_tpu_torch.analyzers.grouping as TG
import deequ_tpu_torch.data as TD
import deequ_tpu_torch.runners.features as TF
from deequ_tpu.runners import AnalysisRunner as JaxRunner
from deequ_tpu_torch.convert import from_reference, to_reference
from deequ_tpu_torch.runners import AnalysisRunner, RunMonitor
from deequ_tpu_torch.runners.engine import to_device

CPU = torch.device("cpu")
MOMENTS = ("Mean", "Sum", "StandardDeviation")
RTOL = 1e-12


def _key(analyzer):
    return (
        analyzer.name, analyzer.instance, getattr(analyzer, "where", None),
        getattr(analyzer, "max_detail_bins", None),
    )


def _value(metric):
    if metric.value.is_failure:
        return ("failure", type(metric.value.exception).__name__)
    v = metric.value.get()
    if hasattr(v, "values"):  # Distribution
        return (v.number_of_bins, {k: (d.absolute, d.ratio) for k, d in v.values.items()})
    return v


def _assert_metrics_match(jax_metrics, torch_metrics):
    jm = {_key(a): _value(m) for a, m in jax_metrics.items()}
    tm = {_key(a): _value(m) for a, m in torch_metrics.items()}
    assert set(jm) == set(tm)
    for key, want in jm.items():
        got = tm[key]
        if isinstance(want, float) and isinstance(got, float):
            if math.isnan(want):
                assert math.isnan(got), key
            elif key[0] in MOMENTS:
                assert abs(got - want) <= RTOL * max(abs(want), 1e-300), (key, got, want)
            else:
                assert got == want, (key, got, want)
        else:
            assert got == want, (key, got, want)


def _statuses(result):
    return [
        (check.description, r.status.value, [c.status.value for c in r.constraint_results])
        for check, r in result.check_results.items()
    ]


# ---------------------------------------------------------------------------
# datasets and checks, built the same way for both packages
# ---------------------------------------------------------------------------


def _encoded(table: pa.Table, columns) -> pa.Table:
    for name in columns:
        i = table.schema.get_field_index(name)
        table = table.set_column(i, name, pc.dictionary_encode(table[name]))
    return table


def _synthetic(n: int = 3000, seed: int = 1) -> pa.Table:
    rng = np.random.default_rng(seed)
    x = rng.normal(20.0, 4.0, n)
    x[rng.random(n) < 0.02] = np.nan
    y = rng.normal(0.0, 1.0, n)
    cats = [f"c{i}" for i in range(30)]
    return pa.table({
        "x": pa.array(x, mask=rng.random(n) < 0.1),
        "y": pa.array(y, mask=rng.random(n) < 0.05),
        "id": pa.array(np.arange(n, dtype=np.int64)),
        "cat": pa.DictionaryArray.from_arrays(
            pa.array(rng.integers(0, 30, n).astype(np.int32), mask=rng.random(n) < 0.07),
            pa.array(cats),
        ),
        "name": pa.array([None if i % 11 == 0 else f"n{i % 97}-{i % 7}" for i in range(n)]),
    })


def _checks_missing(m):
    """Checks over the df_missing fixture (att1/att2 dictionary-encoded)."""
    c = m.Check(m.CheckLevel.ERROR, "missing")
    return [
        c.has_size(lambda v: v == 12)
        .is_complete("item")
        .is_complete("att1")
        .has_completeness("att2", lambda v: v >= 0.75)
        .has_completeness("att1", lambda v: v > 0.5).where("att2 == 'f'")
        .has_uniqueness(["att1"], lambda v: v == 0.0)
        .has_distinctness(["att2"], lambda v: v > 0.1)
        .has_unique_value_ratio(["att1"], lambda v: v == 0.0)
        .has_entropy("att1", lambda v: v > 0.5)
        .has_number_of_distinct_values("att2", lambda v: v == 3)
        .has_histogram_values("att1", lambda h: h["a"].absolute == 4)
        .has_min_length("item", lambda v: v == 1.0)
        .has_max_length("att1", lambda v: v == 1.0)
        .has_pattern("att2", r"[df]", lambda v: v > 0.5)
        .has_approx_count_distinct("item", lambda v: v == 12.0)
        .has_approx_count_distinct("att2", lambda v: v == 2.0)
        .is_contained_in("att1", ["a", "b"])
        .satisfies("att1 == 'a'", "att1 is a", lambda v: v > 0.5).where("att2 is not None"),
        m.Check(m.CheckLevel.WARNING, "warn").has_size(lambda v: v > 100),
    ]


def _checks_synthetic(m):
    """Checks over the synthetic multi-batch table (NaN, nulls, where)."""
    c = m.Check(m.CheckLevel.ERROR, "numeric")
    return [
        c.has_size(lambda v: v == 3000)
        .has_completeness("x", lambda v: v > 0.8)
        .has_mean("x", lambda v: v > 0)
        .has_mean("y", lambda v: abs(v) < 0.2)
        .has_mean("x", lambda v: v > 0).where("y > 0")
        .has_sum("y", lambda v: v < 1e6)
        .has_sum("id", lambda v: v == 2999 * 3000 / 2)
        .has_min("x", lambda v: v < 10)
        .has_max("x", lambda v: v < 100)
        .has_max("y", lambda v: v < 10).where("x > 20")
        .has_min("id", lambda v: v == 0).where("cat == 'c3'")
        .has_standard_deviation("y", lambda v: 0.9 < v < 1.1)
        .has_standard_deviation("x", lambda v: v > 0).where("id < 1500")
        .is_non_negative("id")
        .is_less_than("y", "x")
        .has_approx_count_distinct("id", lambda v: v > 2800)
        .has_approx_count_distinct("cat", lambda v: v == 30)
        .has_uniqueness(["cat"], lambda v: v == 0.0)
        .has_entropy("cat", lambda v: v > 3.0)
        .has_histogram_values("cat", lambda h: True)
        .has_min_length("name", lambda v: v == 4)
        .has_max_length("name", lambda v: v <= 6).where("id > 5")
        .has_pattern("name", r"n1\d-", lambda v: v < 0.5)
        .is_contained_in("cat", ["c1", "c2", "c3"], assertion=lambda v: v < 0.5),
    ]


CASES = {
    "df_missing": (_checks_missing, 5),
    "synthetic": (_checks_synthetic, 512),
}


def _tables(case, df_missing):
    if case == "df_missing":
        return _encoded(df_missing.arrow, ["att1", "att2"])
    return _synthetic()


@pytest.mark.parametrize("case", sorted(CASES))
def test_verification_suite_matches_jax(case, df_missing):
    make_checks, batch_size = CASES[case]
    table = _tables(case, df_missing)
    jax_result = (
        deequ_tpu.VerificationSuite.on_data(JD.Dataset.from_arrow(table))
        .add_checks(make_checks(deequ_tpu)).with_batch_size(batch_size).run()
    )
    monitor = RunMonitor()
    torch_result = (
        deequ_tpu_torch.VerificationSuite.on_data(TD.Dataset.from_arrow(table), device="cpu")
        .add_checks(make_checks(deequ_tpu_torch)).with_batch_size(batch_size)
        .with_monitor(monitor).run()
    )
    _assert_metrics_match(jax_result.metrics, torch_result.metrics)
    assert _statuses(torch_result) == _statuses(jax_result)
    assert torch_result.status == deequ_tpu_torch.CheckStatus(jax_result.status.value)
    assert monitor.passes == 1
    assert monitor.batches == -(-table.num_rows // batch_size) > 1
    assert monitor.device == "cpu"
    assert {"feature_build", "host_to_device", "kernels", "state_fetch",
            "feature_build.rows"} <= set(monitor.phase_seconds)


def _edge_checks(m):
    yes = lambda _: True  # noqa: E731 - the values are compared, not asserted
    return [
        m.Check(m.CheckLevel.ERROR, "edges").has_size(lambda v: v == 0).is_complete("x")
        .has_mean("x", yes).has_min("b", yes).has_max("f", yes).has_sum("b", yes)
        .has_uniqueness(["d"], yes).has_histogram_values("d", yes).has_entropy("d", yes)
        .has_approx_count_distinct("x", yes).has_min_length("s", yes)
        .has_number_of_distinct_values("d", yes),
    ]


def _edge_table(case: str) -> pa.Table:
    n = 50
    if case == "empty":
        return pa.table({
            "x": pa.array([], pa.float64()), "b": pa.array([], pa.bool_()),
            "f": pa.array([], pa.float32()), "s": pa.array([], pa.string()),
            "d": pa.DictionaryArray.from_arrays(pa.array([], pa.int32()), pa.array([], pa.string())),
        })
    base = {
        "x": pa.array(np.arange(n, dtype=np.float64)),
        "f": pa.array(np.linspace(-1, 1, n).astype(np.float32)),
    }
    if case == "all_null_dictionary":
        return pa.table({
            **base,
            "b": pa.array([i % 3 == 0 for i in range(n)]),
            "s": pa.array([None] * n, pa.string()),
            "d": pa.DictionaryArray.from_arrays(pa.array([None] * n, pa.int32()), pa.array([], pa.string())),
        })
    return pa.table({  # int8 dictionary indices, nullable booleans
        **base,
        "b": pa.array([None if i % 5 == 0 else i % 3 == 0 for i in range(n)]),
        "s": pa.array(["ab" * (i % 4) for i in range(n)]),
        "d": pa.DictionaryArray.from_arrays(
            pa.array(np.arange(n) % 3, pa.int8()), pa.array(["p", "q", "r"])),
    })


@pytest.mark.parametrize("case", ["empty", "all_null_dictionary", "narrow_types"])
def test_edge_tables_match_jax(case):
    """Empty tables, an empty dictionary (no codes at all), boolean and
    float32 columns, int8 dictionary indices."""
    table = _edge_table(case)
    jax_result = (
        deequ_tpu.VerificationSuite.on_data(JD.Dataset.from_arrow(table))
        .add_checks(_edge_checks(deequ_tpu)).with_batch_size(16).run()
    )
    torch_result = (
        deequ_tpu_torch.VerificationSuite.on_data(TD.Dataset.from_arrow(table), device="cpu")
        .add_checks(_edge_checks(deequ_tpu_torch)).with_batch_size(16).run()
    )
    _assert_metrics_match(jax_result.metrics, torch_result.metrics)
    assert _statuses(torch_result) == _statuses(jax_result)


def _battery(m):
    return [
        m.Size(), m.Size(where="y > 0"), m.Completeness("x"), m.Completeness("nope"),
        m.Mean("name"), m.Mean("x", "y < 0"), m.Sum("id"), m.Minimum("y"),
        m.Maximum("x"), m.StandardDeviation("y"), m.MinLength("name"),
        m.MaxLength("name"), m.PatternMatch("name", r"-3$"),
        m.Compliance("bad", "x >>> 1"), m.ApproxCountDistinct("name"),
        m.CountDistinct("cat"), m.Distinctness("cat"), m.UniqueValueRatio("cat"),
        m.Histogram("cat", max_detail_bins=5), m.Histogram("cat", max_detail_bins=5000),
    ]


def test_analysis_runner_matches_jax_including_failure_metrics():
    table = _synthetic()
    jax_ctx = JaxRunner.do_analysis_run(JD.Dataset.from_arrow(table), _battery(J), batch_size=700)
    torch_ctx = AnalysisRunner.do_analysis_run(
        TD.Dataset.from_arrow(table), _battery(T), batch_size=700, device="cpu"
    )
    _assert_metrics_match(jax_ctx.metric_map, torch_ctx.metric_map)
    failed = {k[0] for k, v in ((_key(a), m) for a, m in torch_ctx.metric_map.items())
              if v.value.is_failure}
    # missing column, wrong type, malformed predicate, too many bins
    assert failed == {"Completeness", "Mean", "Compliance", "Histogram"}


def test_entry_points_raise_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    ds = TD.Dataset.from_arrow(_synthetic(50))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        deequ_tpu_torch.VerificationSuite.on_data(ds)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        AnalysisRunner.on_data(ds)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        AnalysisRunner.do_analysis_run(ds, [T.Size()])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        AnalysisRunner.do_analysis_run(ds, [T.Size()], device="cuda")
    ctx = AnalysisRunner.on_data(ds, device="cpu").add_analyzer(T.Size()).run()
    assert ctx.metric(T.Size()).value.get() == 50.0


@pytest.mark.parametrize("analyzer", [
    T.Histogram("y"),                     # plain (not dictionary-encoded) column
    J.MutualInformation(["cat", "id"]),   # an analyzer of the JAX package
    T.Histogram("id"),                    # plain column
    J.Correlation("x", "y"),              # an analyzer of the JAX package
    J.ApproxQuantile("x", 0.5),
])
def test_analyzers_outside_the_slice_raise(analyzer):
    """An analyzer of the JAX package raises in the port's runner. The
    port's Histograms over plain columns (which raised before the port had
    the host path) give the reference's metric."""
    table = _synthetic(100)
    ds = TD.Dataset.from_arrow(table)
    if isinstance(analyzer, T.Histogram):
        got = AnalysisRunner.do_analysis_run(ds, [T.Size(), analyzer],
                                             device="cpu").metric(analyzer).value.get()
        ref = J.Histogram(analyzer.column)
        want = JaxRunner.do_analysis_run(JD.Dataset.from_arrow(table),
                                         [J.Size(), ref]).metric(ref).value.get()
        assert got.number_of_bins == want.number_of_bins
        assert ({k: (v.absolute, v.ratio) for k, v in got.values.items()}
                == {k: (v.absolute, v.ratio) for k, v in want.values.items()})
        return
    with pytest.raises(NotImplementedError, match="not supported by deequ_tpu_torch"):
        AnalysisRunner.do_analysis_run(ds, [T.Size(), analyzer], device="cpu")


def test_dictionary_over_the_device_limit_raises():
    """A dictionary above the device frequency scan's 65536 entries no
    longer raises: its grouping set takes the device frequency table and
    its histogram counts every code (the name is kept from when it did)."""
    n = 70_000
    table = pa.table({"c": pa.DictionaryArray.from_arrays(
        pa.array(np.arange(n, dtype=np.int32)), pa.array([str(i) for i in range(n)]))})
    monitor = RunMonitor()
    ctx = AnalysisRunner.do_analysis_run(
        TD.Dataset.from_arrow(table), [T.CountDistinct("c")], device="cpu", monitor=monitor,
    )
    assert ctx.metric(T.CountDistinct("c")).value.get() == float(n)
    assert monitor.device_freq_sets == 1
    ctx = AnalysisRunner.do_analysis_run(
        TD.Dataset.from_arrow(table), [T.Histogram("c")], device="cpu",
    )
    assert ctx.metric(T.Histogram("c")).value.get().number_of_bins == n


# ---------------------------------------------------------------------------
# state carried across with convert.py
# ---------------------------------------------------------------------------

CARRY_CASES = {
    "size": lambda m: m.Size(where="y > 0"),
    "completeness": lambda m: m.Completeness("x"),
    "mean": lambda m: m.Mean("y", "x > 18"),
    "sum": lambda m: m.Sum("id"),
    "min": lambda m: m.Minimum("y"),
    "max": lambda m: m.Maximum("y", "x > 20"),
    "stddev": lambda m: m.StandardDeviation("y"),
    "min_length": lambda m: m.MinLength("name"),
    "hll": lambda m: m.ApproxCountDistinct("name"),
    # the runner-internal device frequency scan of a dictionary column
    "freq": lambda m: (JG if m is J else TG).DeviceFrequencyScan("cat", 30),
}


def _make(case, m):
    return CARRY_CASES[case](m)


@pytest.mark.parametrize("case", sorted(CARRY_CASES))
def test_state_carried_across_from_jax(case):
    """Fold batches 1..k in JAX, carry the state over, fold k+1..n in the
    port: equal to one JAX run over all n batches (float64 moments within
    1e-12 relative, everything else bit-exact)."""
    table = _synthetic()
    jax_a, torch_a = _make(case, J), _make(case, T)
    jb = list(JD.Dataset.from_arrow(table).batches(400))
    tb = list(TD.Dataset.from_arrow(table).batches(400))
    k = 3

    def jax_step(state, batch):
        built = JF.FeatureBuilder(jax_a.feature_specs()).build(batch)
        return jax_a.update(state, {key: jnp.asarray(v) for key, v in built.items()})

    full = jax_a.init_state()
    for batch in jb:
        full = jax_step(full, batch)
    head = jax_a.init_state()
    for batch in jb[:k]:
        head = jax_step(head, batch)
    state = from_reference(
        type(head).__name__, [np.asarray(x) for x in jax.tree_util.tree_leaves(head)], CPU
    )
    for batch in tb[k:]:
        state = torch_a.update(
            state, to_device(TF.FeatureBuilder(torch_a.feature_specs()).build(batch), CPU)
        )
    name, leaves = to_reference(state)
    assert name == type(full).__name__
    want = [np.asarray(x) for x in jax.tree_util.tree_leaves(full)]
    assert len(leaves) == len(want)
    float_leaves = {"mean": {0}, "sum": {0}, "stddev": {1, 2}}.get(case, set())
    for i, (got, exp) in enumerate(zip(leaves, want)):
        assert got.dtype == exp.dtype and got.shape == exp.shape
        if i in float_leaves:
            assert abs(float(got) - float(exp)) <= RTOL * max(abs(float(exp)), 1.0), (i, got, exp)
        else:
            assert np.array_equal(got, exp, equal_nan=np.issubdtype(exp.dtype, np.floating)), i
    # and back: the carried state is a valid reference state
    back = type(full)(*[jnp.asarray(x) for x in leaves])
    for got, exp in zip(jax.tree_util.tree_leaves(back), leaves):
        assert np.array_equal(np.asarray(got), exp, equal_nan=np.issubdtype(exp.dtype, np.floating))


def test_convert_rejects_mismatched_leaves():
    # an accumulator leaf of neither mode's type (float32 and int32 are
    # the 32-bit mode's, which a blob keeps), and HLL registers, int32 in
    # both modes
    with pytest.raises(TypeError):
        from_reference("MeanState", [np.float16(1.0), np.int64(2)])
    with pytest.raises(TypeError):
        from_reference("ApproxCountDistinctState", [np.zeros(512, dtype=np.int64)])
    with pytest.raises(ValueError):
        from_reference("MinState", [np.float64(1.0)])
    with pytest.raises(ValueError):
        from_reference("KLLSketchState", [])
    # the exact-quantile state converts: its leaves are its value chunks
    # (it did not before the port had the exact mode)
    chunks = [np.array([3.0, -1.5]), np.array([], dtype=np.float64), np.array([7.25])]
    state = from_reference("ExactQuantileState", chunks)
    assert np.array_equal(state.values(), np.concatenate(chunks)) and state.count == 3
    name, back = to_reference(state)
    assert name == "ExactQuantileState"
    assert all(np.array_equal(a, b) for a, b in zip(back, chunks)) and len(back) == 3
    with pytest.raises(TypeError):
        from_reference("ExactQuantileState", [np.array([1, 2], dtype=np.int64)])


# ---------------------------------------------------------------------------
# chip_smoke's data, checks and oracle at a small size
# ---------------------------------------------------------------------------


def test_chip_smoke_battery_matches_oracle_and_jax_on_cpu():
    rows = 6000
    table = chip_smoke.build_table(rows, seed=3)
    torch_result = (
        deequ_tpu_torch.VerificationSuite.on_data(TD.Dataset.from_arrow(table), device="cpu")
        .add_check(chip_smoke.build_check(deequ_tpu_torch, rows))
        .add_required_analyzer(T.CountDistinct("cat_large")).with_batch_size(2048).run()
    )
    got = chip_smoke.metric_values(torch_result)
    assert chip_smoke.compare_oracle(got, chip_smoke.oracle(table)) == []
    jax_result = (
        deequ_tpu.VerificationSuite.on_data(JD.Dataset.from_arrow(table))
        .add_check(chip_smoke.build_check(deequ_tpu, rows))
        .add_required_analyzer(J.CountDistinct("cat_large")).with_batch_size(2048).run()
    )
    assert chip_smoke.compare_metrics(got, chip_smoke.metric_values(jax_result)) == []
    assert _statuses(torch_result) == _statuses(jax_result)
    assert len(got) >= 20
