"""The port's constraint suggestion (``deequ_tpu_torch.suggestions``)
against the JAX reference's, and ``chip_smoke.py``'s phase 10 helpers at a
small size.

A small wide table in BASELINE config 5's shape (``chip_smoke.build_wide``:
numeric, string and categorical columns, seed 7) goes through both
packages' ``ConstraintSuggestionRunner``: JAX on the CPU (as
``tests/conftest.py`` sets it), the port on ``device="cpu"``. The
suggestions' JSON, the evaluation JSON and every status on the test split
are equal byte for byte.
"""

from __future__ import annotations

import json

import numpy as np
import pyarrow as pa
import pytest
import torch

import chip_smoke
import deequ_tpu.data as JD
import deequ_tpu.suggestions as JS
import deequ_tpu.suggestions.rules as JR
import deequ_tpu_torch as dq
import deequ_tpu_torch.data as TD
import deequ_tpu_torch.suggestions as TS
import deequ_tpu_torch.suggestions.rules as TR
from deequ_tpu_torch.runners import RunMonitor

ROWS = 3000


def _wide(rows: int = ROWS) -> pa.Table:
    """Config 5's shape at a small width and size, plus a boolean column
    with nulls (its histogram takes the host path) and a column of numbers
    written as strings (the profile casts it)."""
    table = chip_smoke.build_wide(rows, n_numeric=4, n_string=2, n_cat=3)
    rng = np.random.default_rng(11)
    flags = pa.array(rng.random(rows) < 0.2, mask=rng.random(rows) < 0.05)
    numbers = pa.array([None if v < 3 else str(v) for v in rng.integers(0, 60, rows)])
    return table.append_column("flag", flags).append_column("num_str", numbers)


def _rules(package, unique: bool):
    rules = list(package.Rules.DEFAULT)
    if unique:
        rules.append(package.UniqueIfApproximatelyUniqueRule())
    return rules


def _statuses(result) -> list:
    if result.verification_result is None:
        return []
    return [c.status.value for r in result.verification_result.check_results.values()
            for c in r.constraint_results]


def _run_both(table, tmp_path, unique: bool, split: bool, **options):
    """(port result, reference result, {sink: (port text, reference text)})."""
    out = {}
    results = []
    for name, package, data in (
        ("port", TS, TD.Dataset.from_arrow(table)),
        ("reference", JS, JD.Dataset.from_arrow(table)),
    ):
        kwargs = {"device": "cpu"} if package is TS else {}
        builder = package.ConstraintSuggestionRunner.on_data(data, **kwargs)
        builder = builder.add_constraint_rules(_rules(package, unique))
        if split:
            builder = builder.use_train_test_split_with_testset_ratio(
                0.25, testset_split_random_seed=3)
        paths = {sink: tmp_path / f"{name}-{sink}.json" for sink in ("suggestions", "evaluation")}
        builder = (builder.save_constraint_suggestions_json_to_path(str(paths["suggestions"]))
                   .save_evaluation_results_json_to_path(str(paths["evaluation"])))
        for method, value in options.items():
            builder = getattr(builder, method)(value)
        results.append(builder.run())
        for sink, path in paths.items():
            out.setdefault(sink, []).append(path.read_text() if path.exists() else None)
    return results[0], results[1], out


@pytest.mark.parametrize("split", [False, True], ids=["no split", "test split"])
@pytest.mark.parametrize("unique", [False, True], ids=["default rules", "with uniqueness"])
def test_suggestions_equal_the_reference_byte_for_byte(tmp_path, unique, split):
    port, ref, sinks = _run_both(_wide(), tmp_path, unique, split)
    assert port.to_json() == ref.to_json()
    assert sinks["suggestions"][0] == sinks["suggestions"][1] == port.to_json()
    assert sinks["evaluation"][0] == sinks["evaluation"][1]
    assert _statuses(port) == _statuses(ref)
    assert port.num_records == ref.num_records
    assert list(port.constraint_suggestions) == list(ref.constraint_suggestions)
    codes = {s.code_for_constraint.split("(")[0] for s in port.all_suggestions}
    assert {".is_complete", ".is_contained_in", ".is_non_negative"} <= codes
    assert (".is_unique" in codes) == unique
    if split:
        assert port.verification_result is not None and len(_statuses(port)) == len(
            port.all_suggestions)
        assert json.loads(sinks["evaluation"][0])["constraint_suggestions"][0][
            "constraint_result_on_test_set"] == _statuses(port)[0]
    else:
        assert port.verification_result is None and sinks["evaluation"][0] is None


OPTIONS = {
    "restricted columns": {"restrict_to_columns": ["n0", "s1", "c2", "flag"]},
    "low threshold": {"with_low_cardinality_histogram_threshold": 30},
    "predefined types": {"set_predefined_types": {"num_str": "String", "n1": "Integral"}},
    "batches of 512": {"with_batch_size": 512},
}


@pytest.mark.parametrize("case", sorted(OPTIONS))
def test_builder_options_equal_the_reference(tmp_path, case):
    port, ref, sinks = _run_both(_wide(), tmp_path, False, True, **OPTIONS[case])
    assert port.to_json() == ref.to_json()
    assert sinks["evaluation"][0] == sinks["evaluation"][1]
    assert list(port.column_profiles) == list(ref.column_profiles)


def test_each_rule_suggests_what_the_reference_rule_does():
    """Rule by rule over the port's profiles of the wide table: each
    rule's applicability and candidate equal the reference rule's on the
    reference's profiles."""
    from deequ_tpu.profiles import ColumnProfiler as JaxProfiler

    table = _wide()
    port = dq.ColumnProfiler.profile(TD.Dataset.from_arrow(table), device="cpu")
    ref = JaxProfiler.profile(JD.Dataset.from_arrow(table))
    names = ["CompleteIfCompleteRule", "RetainCompletenessRule", "RetainTypeRule",
             "CategoricalRangeRule", "FractionalCategoricalRangeRule", "NonNegativeNumbersRule",
             "UniqueIfApproximatelyUniqueRule"]
    fired = 0
    for name in names:
        prule, rrule = getattr(TR, name)(), getattr(JR, name)()
        assert prule.rule_description == rrule.rule_description
        for column in table.column_names:
            pp, rp = port.profiles[column], ref.profiles[column]
            applies = prule.should_be_applied(pp, port.num_records)
            assert applies == rrule.should_be_applied(rp, ref.num_records), (name, column)
            if applies:
                fired += 1
                got = prule.candidate(pp, port.num_records)
                want = rrule.candidate(rp, ref.num_records)
                assert (str(got.constraint), got.current_value, got.description,
                        got.code_for_constraint) == (str(want.constraint), want.current_value,
                                                     want.description, want.code_for_constraint)
    assert fired >= len(table.column_names)
    assert len(TR.DEFAULT_RULES) == len(JR.DEFAULT_RULES) == 6


def test_apply_rules_and_the_profiles_sink(tmp_path):
    """``apply_rules`` over a profile gives the runner's result, and the
    profiles sink writes the profile's JSON."""
    table = _wide()
    path = tmp_path / "profiles.json"
    result = (TS.ConstraintSuggestionRunner.on_data(TD.Dataset.from_arrow(table), device="cpu")
              .add_constraint_rules(TS.Rules.DEFAULT)
              .save_column_profiles_json_to_path(str(path)).run())
    profiles = dq.ColumnProfiler.profile(TD.Dataset.from_arrow(table), device="cpu")
    assert TS.apply_rules(profiles, TS.Rules.DEFAULT).to_json() == result.to_json()
    assert path.read_text() == profiles.to_json()


def test_the_repository_keys_reach_the_profile(tmp_path):
    """The runner's repository, save and reuse keys are the profile's: a
    run saved under a key serves a second run with no profile pass."""
    from deequ_tpu_torch.repository import InMemoryMetricsRepository, ResultKey

    table = _wide()
    repo, key = InMemoryMetricsRepository(), ResultKey(9, {"split": "train"})
    first = (TS.ConstraintSuggestionRunner.on_data(TD.Dataset.from_arrow(table), device="cpu")
             .add_constraint_rules(TS.Rules.DEFAULT).use_repository(repo)
             .save_or_append_result(key).run())
    assert repo.load_by_key(key) is not None
    monitor = RunMonitor()
    again = (TS.ConstraintSuggestionRunner.on_data(TD.Dataset.from_arrow(table), device="cpu")
             .add_constraint_rules(TS.Rules.DEFAULT).use_repository(repo)
             .reuse_existing_results_for_key(key, True).with_monitor(monitor).run())
    assert monitor.passes == 0 and again.to_json() == first.to_json()


def test_the_runner_needs_a_card_unless_told_otherwise(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    data = TD.Dataset.from_arrow(_wide(200))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TS.ConstraintSuggestionRunner.on_data(data)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TS.ConstraintSuggestionRunner.run(data, TS.Rules.DEFAULT)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TS.ConstraintSuggestionRunner.run(data, TS.Rules.DEFAULT, device="cuda")
    result = TS.ConstraintSuggestionRunner.run(data, TS.Rules.DEFAULT, device="cpu")
    assert result.num_records == 200


@pytest.mark.parametrize("ratio", [0.0, 1.0, -0.5])
def test_the_testset_ratio_is_checked_as_in_the_reference(ratio):
    data = TD.Dataset.from_arrow(_wide(100))
    with pytest.raises(ValueError, match="Testset ratio"):
        TS.ConstraintSuggestionRunner.run(data, TS.Rules.DEFAULT, testset_ratio=ratio,
                                          device="cpu")
    with pytest.raises(ValueError, match="Testset ratio"):
        JS.ConstraintSuggestionRunner.run(JD.Dataset.from_arrow(_wide(100)),
                                          JS.Rules.DEFAULT, testset_ratio=ratio)


# ---------------------------------------------------------------------------
# chip_smoke's phase 10 at a small size
# ---------------------------------------------------------------------------


def test_chip_smoke_builds_the_bench_wide_table():
    """``build_wide`` is the JAX bench's ``build_wide_data``, value for
    value, at config 5's widths."""
    import bench

    got = chip_smoke.build_wide(2000)
    want = bench.build_wide_data(2000, n_numeric=30, n_string=10, n_cat=10)
    assert got.equals(want)
    assert got.num_columns == 50


@pytest.mark.parametrize("unique", [False, True], ids=["default rules", "with uniqueness"])
def test_chip_smoke_oracle_holds_the_run_and_catches_faults(unique):
    """Phase 10's oracle holds the port's run on the CPU (profiles of the
    training split, every status on the test split), and each kind of
    fault it is meant to catch makes it report."""
    table = chip_smoke.build_wide(4000, n_numeric=6, n_string=2, n_cat=4)
    data = TD.Dataset.from_arrow(table)
    rules = tuple(TS.Rules.DEFAULT) + ((TS.UniqueIfApproximatelyUniqueRule(),) if unique else ())
    result = chip_smoke._suggestion_run(dq, data, "cpu", rules)
    got = chip_smoke.suggestion_values(result)
    train, test = chip_smoke.split_rows(table)
    assert chip_smoke.suggestion_oracle(result, got[1], train, test) == []
    want = JS.ConstraintSuggestionRunner.on_data(JD.Dataset.from_arrow(table)) \
        .add_constraint_rules(_rules(JS, unique)) \
        .use_train_test_split_with_testset_ratio(0.25, testset_split_random_seed=0).run()
    assert got == (want.to_json(), _statuses(want))
    # faults: a flipped status, a wrong completeness, a wrong histogram count
    flipped = ["Failure" if s == "Success" else "Success" for s in got[1][:1]] + got[1][1:]
    assert len(chip_smoke.suggestion_oracle(result, flipped, train, test)) == 1
    profile = result.column_profiles["n0"]
    object.__setattr__(profile, "completeness", profile.completeness - 1e-9)
    cat = result.column_profiles["c0"]
    first = next(iter(cat.histogram.values))
    cat.histogram.values[first] = type(cat.histogram.values[first])(
        cat.histogram.values[first].absolute + 1, cat.histogram.values[first].ratio)
    assert len(chip_smoke.suggestion_oracle(result, got[1], train, test)) == 2
