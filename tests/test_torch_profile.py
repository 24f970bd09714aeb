"""The port's column profiler, DataType and quantile analyzers against the
JAX reference.

``ColumnProfilerRunner`` runs in both packages over the same pyarrow table
at the same batch size: JAX on the CPU at ``placement="device"`` (so its
sketches fold through ``kll_update``, as the port's do), the port on
``device="cpu"`` (the kernels' plain versions). Tolerances: inferred types,
completeness, distinct estimates, type counts, histograms, KLL buckets,
sketch data and percentiles are equal; means, sums and standard deviations
agree within 1e-12 relative (float64 sums added in another order).
"""

from __future__ import annotations

import copy
import json

import jax
import jax.numpy as jnp
import numpy as np
import pyarrow as pa
import pytest
import torch

import chip_smoke
import deequ_tpu
import deequ_tpu.analyzers as J
import deequ_tpu.data as JD
import deequ_tpu.runners.features as JF
import deequ_tpu_torch as dq
import deequ_tpu_torch.analyzers as T
import deequ_tpu_torch.data as TD
from deequ_tpu.profiles import ColumnProfilerRunner as JaxProfilerRunner
from deequ_tpu.runners import AnalysisRunner as JaxRunner
from deequ_tpu_torch.convert import from_reference, to_reference
from deequ_tpu_torch.runners import AnalysisRunner, RunMonitor

RTOL = 1e-12
MOMENT_FIELDS = ("mean", "sum", "std_dev")


def _close(got, want) -> bool:
    if got is None or want is None:
        return got is want
    return abs(got - want) <= RTOL * max(abs(want), 1e-300)


def _dist(d):
    return None if d is None else (
        d.number_of_bins, {k: (v.absolute, v.ratio) for k, v in d.values.items()}
    )


def _kll(d):
    return None if d is None else (
        [(b.low_value, b.high_value, b.count) for b in d.buckets], d.parameters, d.data
    )


def _assert_profiles_match(jax_profiles, torch_profiles) -> None:
    assert list(torch_profiles.profiles) == list(jax_profiles.profiles)
    assert torch_profiles.num_records == jax_profiles.num_records
    for name, want in jax_profiles.profiles.items():
        got = torch_profiles.profiles[name]
        assert type(got).__name__ == type(want).__name__, name
        for field, w in vars(want).items():
            g = getattr(got, field)
            if field == "histogram":
                assert _dist(g) == _dist(w), (name, field)
            elif field == "kll":
                assert _kll(g) == _kll(w), (name, field)
            elif field in MOMENT_FIELDS:
                assert _close(g, w), (name, field, g, w)
            else:
                assert g == w, (name, field, g, w)
    jj, tj = json.loads(jax_profiles.to_json()), json.loads(torch_profiles.to_json())
    for jc, tc in zip(jj["columns"], tj["columns"]):
        for key in ("mean", "sum", "stdDev"):
            if key in jc:
                assert _close(tc.pop(key), jc.pop(key)), (jc["column"], key)
        assert tc == jc


def _numeric_strings(n: int = 20_000, seed: int = 3) -> pa.Table:
    """String columns that pass 2 casts (integral, fractional, one
    low-cardinality column that also gets a histogram of its original
    strings), a mixed column that stays a string, booleans and nullable
    numerics."""
    rng = np.random.default_rng(seed)

    def nulls(values, p):
        return [None if rng.random() < p else v for v in values]

    return pa.table({
        "int_str": pa.array(nulls([str(v) for v in rng.integers(-500, 5000, n)], 0.05)),
        "frac_str": pa.array(nulls([f"{v:.3f}" for v in rng.normal(10, 3, n)], 0.1)),
        "small_str": pa.array(nulls([str(v) for v in rng.integers(0, 9, n)], 0.02)),
        "mixed": pa.array(nulls([("true" if v % 3 == 0 else f"x{v % 50}") for v in range(n)], 0.1)),
        "flag": pa.array(nulls([bool(v) for v in rng.integers(0, 2, n)], 0.03)),
        "value": pa.array(rng.normal(-3, 9, n), mask=rng.random(n) < 0.2),
        "count": pa.array(rng.integers(0, 40, n)),
    })


PROFILE_CASES = {
    "lineitem": (lambda: chip_smoke.build_lineitem(48_000, comment_pool=20_000), 16_384),
    "numeric_strings": (_numeric_strings, 6_000),
}


@pytest.mark.parametrize("case", sorted(PROFILE_CASES))
def test_profile_matches_jax(case):
    make_table, batch_size = PROFILE_CASES[case]
    table = make_table()
    jax_profiles = (
        JaxProfilerRunner.on_data(JD.Dataset.from_arrow(table))
        .with_batch_size(batch_size).with_placement("device").run()
    )
    monitor = RunMonitor()
    torch_profiles = (
        dq.ColumnProfilerRunner.on_data(TD.Dataset.from_arrow(table), device="cpu")
        .with_batch_size(batch_size).with_monitor(monitor).run()
    )
    _assert_profiles_match(jax_profiles, torch_profiles)
    assert monitor.device == "cpu"
    assert monitor.passes in (2, 3)
    numeric = [p for p in torch_profiles.profiles.values() if getattr(p, "kll", None)]
    assert numeric and all(len(p.approx_percentiles) == 100 for p in numeric)
    if case == "numeric_strings":
        assert torch_profiles["int_str"].data_type == "Integral"
        assert torch_profiles["frac_str"].data_type == "Fractional"
        assert torch_profiles["mixed"].data_type == "String"
        assert torch_profiles["small_str"].histogram is not None


def test_profile_writes_its_json(tmp_path):
    table = _numeric_strings(2_000)
    path = tmp_path / "profiles.json"
    profiles = (
        dq.ColumnProfilerRunner.on_data(TD.Dataset.from_arrow(table), device="cpu")
        .restrict_to_columns(["int_str", "value"])
        .save_column_profiles_json_to_path(str(path)).run()
    )
    assert path.read_text() == profiles.to_json()
    assert sorted(profiles.profiles) == ["int_str", "value"]


def _typed_strings(n: int = 9_000, seed: int = 11) -> pa.Table:
    rng = np.random.default_rng(seed)
    pool = np.array(["12", "-3.5", "true", "false", "abc", "+ 7", "", ".", "1e5", " 4", "- 1.5"])
    picks = pool[rng.integers(0, len(pool), n)]
    values = [None if rng.random() < 0.08 else str(v) for v in picks]
    return pa.table({
        "plain": pa.array(values),
        "dict": pa.array(values).dictionary_encode(),
        "wide": pa.array([f"{v}{i}" if v else v for i, v in enumerate(values)]),
        "k": pa.array(rng.integers(0, 10, n)),
    })


@pytest.mark.parametrize("column", ["plain", "dict", "wide"])
def test_data_type_counts_match_jax(column):
    """DataType's five class counts, with and without a where-filter, on a
    dictionary column, a plain low-cardinality one (the dataset encodes
    it) and a plain one of distinct values."""
    table = _typed_strings()
    batch_size = 2_048

    def analyzers(m):
        return [m.DataType(column), m.DataType(column, where="k > 3"), m.DataType("k")]

    jax_ctx = JaxRunner.do_analysis_run(
        JD.Dataset.from_arrow(table), analyzers(J), batch_size=batch_size, placement="device"
    )
    torch_ctx = AnalysisRunner.do_analysis_run(
        TD.Dataset.from_arrow(table), analyzers(T), batch_size=batch_size, device="cpu"
    )
    for ja, ta in zip(analyzers(J), analyzers(T)):
        want, got = jax_ctx.metric(ja), torch_ctx.metric(ta)
        assert _dist(got.value.get()) == _dist(want.value.get()), ta
    counts = {k: v.absolute for k, v in torch_ctx.metric(T.DataType(column)).value.get().values.items()}
    assert sum(counts.values()) == table.num_rows
    if column != "wide":
        assert all(counts[k] > 0 for k in ("Unknown", "Fractional", "Integral", "Boolean", "String"))


def test_type_feature_matches_jax():
    table = _typed_strings(3_000)
    jb = next(JD.Dataset.from_arrow(table).batches(4_096))
    tb = next(TD.Dataset.from_arrow(table).batches(4_096))
    from deequ_tpu_torch.runners.features import FeatureBuilder

    for column in ("plain", "dict", "wide", "k"):
        spec_j, spec_t = J.base.typeclass_feature(column), T.base.typeclass_feature(column)
        want = JF.FeatureBuilder([spec_j]).build(jb)[spec_j.key]
        got = FeatureBuilder([spec_t]).build(tb)[spec_t.key]
        np.testing.assert_array_equal(got, want)


def _quantile_checks(m):
    yes = lambda _: True  # noqa: E731 - the values are compared, not asserted
    a = J if m is deequ_tpu else T
    types = (deequ_tpu.constraints if m is deequ_tpu else dq).ConstrainableDataTypes
    return [
        m.Check(m.CheckLevel.ERROR, "quantiles")
        .has_approx_quantile("x", 0.5, lambda v: 15 < v < 25)
        .has_approx_quantile("x", 0.9, yes, relative_error=0.05).where("y > 0")
        .has_approx_quantile("id", 0.25, lambda v: 700 < v < 800)
        .kll_sketch_satisfies("y", lambda d: len(d.buckets) == 100)
        .kll_sketch_satisfies("x", yes, a.KLLParameters(64, 0.64, 10))
        .has_data_type("name", types.STRING)
        .has_data_type("num", types.NUMERIC, lambda v: v > 0.5)
        .has_data_type("num", types.NULL, yes).where("x > 20"),
    ]


def _quantile_table(n: int = 3_000, seed: int = 2) -> pa.Table:
    rng = np.random.default_rng(seed)
    x = rng.normal(20.0, 4.0, n)
    x[rng.random(n) < 0.02] = np.nan
    x[:5] = [0.0, -0.0, -0.0, 0.0, 1e300]
    return pa.table({
        "x": pa.array(x, mask=rng.random(n) < 0.1),
        "y": pa.array(rng.normal(0.0, 1.0, n), mask=rng.random(n) < 0.05),
        "id": pa.array(np.arange(n, dtype=np.int64)),
        "name": pa.array([None if i % 11 == 0 else f"n{i % 97}" for i in range(n)]),
        "num": pa.array([None if i % 13 == 0 else (str(i % 40) if i % 4 else "t") for i in range(n)]),
    })


def _metric_value(metric):
    if metric.value.is_failure:
        return ("failure", type(metric.value.exception).__name__)
    v = metric.value.get()
    if hasattr(v, "buckets"):
        return _kll(v)
    if hasattr(v, "number_of_bins"):
        return _dist(v)
    return v


def test_quantile_analyzers_in_a_verification_suite_match_jax():
    table = _quantile_table()
    batch_size = 512

    def required(a):
        return [a.ApproxQuantiles("y", (0.1, 0.5, 0.99)), a.ApproxQuantile("x", 0.75, 0.02),
                a.KLLSketch("id", where="x > 18")]

    jax_result = (
        deequ_tpu.VerificationSuite.on_data(JD.Dataset.from_arrow(table))
        .add_checks(_quantile_checks(deequ_tpu)).add_required_analyzers(required(J))
        .with_batch_size(batch_size).with_placement("device").run()
    )
    torch_result = (
        dq.VerificationSuite.on_data(TD.Dataset.from_arrow(table), device="cpu")
        .add_checks(_quantile_checks(dq)).add_required_analyzers(required(T))
        .with_batch_size(batch_size).run()
    )

    def by_key(metrics):
        return {(a.name, a.instance, getattr(a, "where", None), repr(a)): _metric_value(m)
                for a, m in metrics.items()}

    assert by_key(torch_result.metrics) == by_key(jax_result.metrics)
    statuses = lambda r: [  # noqa: E731
        [c.status.value for c in cr.constraint_results] for cr in r.check_results.values()
    ]
    assert statuses(torch_result) == statuses(jax_result)
    assert torch_result.status.value == jax_result.status.value == "Success"


@pytest.mark.parametrize("case", ["data_type", "kll"])
def test_states_carried_across_from_jax(case):
    """Fold the first batches in JAX, carry the state over with
    ``convert.py``, fold the rest in the port: equal to one JAX run."""
    table = _quantile_table()
    make = {"data_type": lambda m: m.DataType("num", where="id > 100"),
            "kll": lambda m: m.KLLSketch("x", m.KLLParameters(32))}[case]
    jax_a, torch_a = make(J), make(T)
    jb = list(JD.Dataset.from_arrow(table).batches(500))
    tb = list(TD.Dataset.from_arrow(table).batches(500))
    builder = JF.FeatureBuilder(jax_a.feature_specs())
    step = jax.jit(jax_a.update)

    def jax_fold(state, batches):
        for batch in batches:
            state = step(state, {k: jnp.asarray(v) for k, v in builder.build(batch).items()})
        return state

    full = jax_fold(jax_a.init_state(), jb)
    head = jax_fold(jax_a.init_state(), jb[:3])
    state = from_reference(type(head).__name__,
                           [np.asarray(x) for x in jax.tree_util.tree_leaves(head)])
    from deequ_tpu_torch.runners.engine import to_device
    from deequ_tpu_torch.runners.features import FeatureBuilder

    torch_builder = FeatureBuilder(torch_a.feature_specs())
    for batch in tb[3:]:
        state = torch_a.update(state, to_device(torch_builder.build(batch), torch.device("cpu")))
    name, leaves = to_reference(state)
    assert name == type(full).__name__
    for got, want in zip(leaves, jax.tree_util.tree_leaves(full)):
        assert got.tobytes() == np.asarray(want).tobytes()


def _dataset():
    return TD.Dataset.from_arrow(_quantile_table(200))


#: the profiler's repository keys: the day a profile is saved under
PROFILE_KEY = {"day": "2024-01-02"}


def _repository_values(repository_module, path, key) -> dict:
    """{repr(analyzer): value} of the context a repository file holds
    under ``key``, read through ``repository_module``'s own classes."""
    repo = repository_module.FileSystemMetricsRepository(str(path))
    context = repo.load_by_key(repository_module.ResultKey(1, PROFILE_KEY))
    return {} if context is None else {
        repr(a): _metric_value(m) for a, m in context.metric_map.items()}


def _assert_repository_values_match(got: dict, want: dict) -> None:
    assert set(got) == set(want)
    for key, w in want.items():
        g = got[key]
        if isinstance(w, float) and key.split("(")[0] in ("Mean", "Sum", "StandardDeviation"):
            assert _close(g, w), (key, g, w)
        else:
            assert g == w, (key, g, w)


def _repository_profiles(tmp_path, option: str, run_port, run_reference) -> None:
    """One repository key through both packages (``option`` names it): a
    repository alone stays empty, a save key leaves equal contexts in
    both packages' files, and a reuse key serves the port's whole profile
    from a file the reference saved (no pass runs), equal to the
    reference's profile."""
    import deequ_tpu.repository as JR
    import deequ_tpu_torch.repository as TR

    jpath, tpath = tmp_path / "reference.json", tmp_path / "port.json"
    jkey, tkey = JR.ResultKey(1, PROFILE_KEY), TR.ResultKey(1, PROFILE_KEY)
    if option == "reuse":
        want = run_reference(JR.FileSystemMetricsRepository(str(jpath)), None, jkey)
        monitor = RunMonitor()
        got = run_port(TR.FileSystemMetricsRepository(str(jpath)), tkey, None, monitor)
        assert monitor.passes == 0
    else:
        save = option == "save"
        want = run_reference(JR.FileSystemMetricsRepository(str(jpath)), None,
                             jkey if save else None)
        got = run_port(TR.FileSystemMetricsRepository(str(tpath)), None,
                       tkey if save else None, None)
        want_values = _repository_values(JR, jpath, jkey)
        for module in (JR, TR):  # each file read by either package
            _assert_repository_values_match(_repository_values(module, tpath, tkey),
                                            want_values)
        assert bool(want_values) == save
    _assert_profiles_match(want, got)


def _reference_profile(table):
    def run(repository, reuse_key, save_key):
        from deequ_tpu.profiles import ColumnProfiler as JaxProfiler

        return JaxProfiler.profile(
            JD.Dataset.from_arrow(table), metrics_repository=repository,
            reuse_existing_results_using_key=reuse_key,
            fail_if_results_for_reusing_missing=reuse_key is not None,
            save_in_metrics_repository_using_key=save_key, batch_size=256,
            placement="device")

    return run


@pytest.mark.parametrize("option", ["metrics_repository", "reuse_existing_results_using_key",
                                    "save_in_metrics_repository_using_key"])
def test_profiler_options_outside_the_slice_raise(option, tmp_path):
    """``ColumnProfiler.profile``'s repository keys (they raised before
    the port had them; the name is kept) give the reference's profile and
    repository contents."""
    table = _numeric_strings(900)

    def run_port(repository, reuse_key, save_key, monitor):
        return dq.ColumnProfiler.profile(
            TD.Dataset.from_arrow(table), device="cpu", metrics_repository=repository,
            reuse_existing_results_using_key=reuse_key,
            fail_if_results_for_reusing_missing=reuse_key is not None,
            save_in_metrics_repository_using_key=save_key, batch_size=256, monitor=monitor)

    scenario = {"metrics_repository": "alone", "reuse_existing_results_using_key": "reuse",
                "save_in_metrics_repository_using_key": "save"}[option]
    _repository_profiles(tmp_path, scenario, run_port, _reference_profile(table))


@pytest.mark.parametrize("method", ["use_repository", "reuse_existing_results_for_key",
                                    "save_or_append_result"])
def test_profiler_builder_options_outside_the_slice_raise(method, tmp_path):
    """The builder's ``use_repository``, ``reuse_existing_results_for_key``
    and ``save_or_append_result`` (they raised before; the name is kept),
    through the same scenarios as ``ColumnProfiler.profile``'s keys."""
    table = _numeric_strings(900)

    def run_port(repository, reuse_key, save_key, monitor):
        builder = (dq.ColumnProfilerRunner.on_data(TD.Dataset.from_arrow(table), device="cpu")
                   .use_repository(repository).with_batch_size(256))
        if reuse_key is not None:
            builder = builder.reuse_existing_results_for_key(reuse_key, True)
        if save_key is not None:
            builder = builder.save_or_append_result(save_key)
        if monitor is not None:
            builder = builder.with_monitor(monitor)
        return builder.run()

    scenario = {"use_repository": "alone", "reuse_existing_results_for_key": "reuse",
                "save_or_append_result": "save"}[method]
    _repository_profiles(tmp_path, scenario, run_port, _reference_profile(table))


@pytest.mark.parametrize("analyzer", [T.ApproxQuantile("x", 0.5, 0.0),
                                      T.ApproxQuantiles("x", (0.1, 0.5, 0.9), 0.0)])
def test_exact_quantile_mode_raises(analyzer):
    """The exact mode (``relative_error=0.0``; it raised before the port
    had it, the name is kept) equals the reference's exact metric and
    numpy's quantile of the column's present, non-NaN values, at batch
    sizes that cut the column differently in the two packages."""
    table = _quantile_table(200)
    got = AnalysisRunner.do_analysis_run(
        TD.Dataset.from_arrow(table), [T.Size(), analyzer], device="cpu", batch_size=37
    ).metric(analyzer)
    ref = (J.ApproxQuantile("x", 0.5, 0.0) if isinstance(analyzer, T.ApproxQuantile)
           else J.ApproxQuantiles("x", (0.1, 0.5, 0.9), 0.0))
    want = JaxRunner.do_analysis_run(JD.Dataset.from_arrow(table), [J.Size(), ref],
                                     batch_size=64).metric(ref)
    assert got.value.get() == want.value.get()
    x = table.column("x").to_numpy(zero_copy_only=False).astype(np.float64)
    present = np.asarray(table.column("x").is_valid()) & ~np.isnan(x)
    exact = {q: float(np.quantile(x[present], q)) for q in (0.1, 0.5, 0.9)}
    if isinstance(analyzer, T.ApproxQuantile):
        assert got.value.get() == exact[0.5]
    else:
        assert got.value.get() == {str(q): v for q, v in exact.items()}


def test_host_partials_of_sketches_raise():
    """A sketch's host partial raises without a batch context, as the
    reference's does; with one it is the reference's host sample of the
    batch, bit for bit."""
    from deequ_tpu.analyzers.base import HostBatchContext as JaxContext
    from deequ_tpu_torch.analyzers.base import HostBatchContext

    with pytest.raises(AttributeError):
        T.KLLSketch("x").host_partial(None)
    with pytest.raises(AttributeError):
        J.KLLSketch("x").host_partial(None)
    table = _quantile_table(3_000)
    batch = next(TD.Dataset.from_arrow(table).batches(3_000, pad_to_batch_size=False))
    ref = next(JD.Dataset.from_arrow(table).batches(3_000, pad_to_batch_size=False))
    got = T.KLLSketch("x").host_partial(HostBatchContext(batch, 5))
    want = J.KLLSketch("x").host_partial(JaxContext(ref, 5))
    assert np.asarray(got[0]).tobytes() == np.asarray(want[0]).tobytes()
    assert [float(v) for v in got[1:]] == [float(v) for v in want[1:]]


def test_profiler_runs_on_cuda_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        dq.ColumnProfilerRunner.on_data(_dataset()).run()


def test_profile_of_an_empty_table():
    table = pa.table({"x": pa.array([], pa.float64()), "s": pa.array([], pa.string())})

    def run(profiles):
        return {n: (p.data_type, p.completeness, p.approximate_num_distinct_values,
                    getattr(p, "kll", None)) for n, p in profiles.profiles.items()}

    jp = JaxProfilerRunner.on_data(JD.Dataset.from_arrow(table)).with_placement("device").run()
    tp = dq.ColumnProfilerRunner.on_data(TD.Dataset.from_arrow(table), device="cpu").run()
    assert run(tp) == run(jp)


def test_chip_smoke_profile_checks_on_cpu():
    """``chip_smoke.py``'s profile comparison and numpy oracle, on a small
    lineitem profile: they pass on a right profile and catch a wrong one."""
    table = chip_smoke.build_lineitem(30_000, comment_pool=3_000)
    profiles = dq.ColumnProfilerRunner.on_data(TD.Dataset.from_arrow(table), device="cpu") \
        .with_batch_size(8_192).run()
    got = chip_smoke.profile_values(profiles)
    assert chip_smoke.compare_profiles(got, chip_smoke.profile_values(profiles)) == []
    problems, worst = chip_smoke.compare_profile_oracle(got, table)
    assert problems == [] and 0 < worst <= 2 * chip_smoke.KLL_RELATIVE_ERROR
    wrong = copy.deepcopy(got)
    wrong["l_tax"]["maximum"] += 0.01
    wrong["l_shipmode"]["type_counts"]["String"] -= 1
    wrong["l_discount"]["approx_percentiles"] = [0.0] * 100
    problems, _ = chip_smoke.compare_profile_oracle(wrong, table)
    assert len(problems) == 3
    assert len(chip_smoke.compare_profiles(wrong, got)) == 3
