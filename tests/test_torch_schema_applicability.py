"""Row-level schemas, applicability and profile distances of the
PyTorch/CUDA port (deequ_tpu_torch.schema, .applicability,
.analyzers.distance) against the JAX reference: the cases of
``tests/test_schema_applicability.py`` and ``tests/test_distance.py`` run
through both packages (``m`` is either package; the port's applicability
runs on ``device="cpu"``), then both packages generate the same random rows
for a schema, find the same constraints applicable, and measure the same
distances between the same sketches.

Tolerances: bit for bit (the random rows, the verdicts, the distances;
the sketches come from the same batches in both packages).
"""

import numpy as np
import pytest

from torch_pairs import pair, reference_isolated  # noqa: F401 (autouse)

NAMES = {
    'AnalysisRunner': 'runners:AnalysisRunner',
    'Applicability': 'applicability:Applicability',
    'Check': 'checks:Check',
    'CheckLevel': 'checks:CheckLevel',
    'ColumnKind': 'data:ColumnKind',
    'ColumnSchema': 'data:ColumnSchema',
    'Completeness': 'analyzers:Completeness',
    'Dataset': 'data:Dataset',
    'Distance': 'analyzers:Distance',
    'HostKLL': 'ops.kll_host:HostKLL',
    'InMemoryStateProvider': 'analyzers.state_provider:InMemoryStateProvider',
    'KLLSketch': 'analyzers:KLLSketch',
    'Mean': 'analyzers:Mean',
    'RowLevelSchema': 'schema:RowLevelSchema',
    'RowLevelSchemaValidator': 'schema:RowLevelSchemaValidator',
    'Schema': 'data:Schema',
    'generate_random_data': 'applicability:generate_random_data',
}
REF, PORT = pair(NAMES)


@pytest.fixture(params=[REF, PORT], ids=["jax", "torch"])
def m(request):
    return request.param


class TestRowLevelSchemaValidator:
    def test_int_validation_and_cast(self, m):
        data = m.Dataset.from_dict(
            {"id": ["1", "2", "not-a-number", "4", None], "name": list("abcde")}
        )
        schema = m.RowLevelSchema().with_int_column("id", is_nullable=False)
        result = m.RowLevelSchemaValidator.validate(data, schema)
        assert result.num_valid_rows == 3
        assert result.num_invalid_rows == 2
        valid = result.valid_rows.to_pandas()
        assert list(valid["id"]) == [1, 2, 4]
        assert result.valid_rows.schema["id"].kind == m.ColumnKind.INTEGRAL
        invalid = result.invalid_rows.to_pandas()
        assert set(invalid["name"]) == {"c", "e"}

    def test_int_bounds(self, m):
        data = m.Dataset.from_dict({"v": ["5", "15", "25"]})
        schema = m.RowLevelSchema().with_int_column("v", min_value=10, max_value=20)
        result = m.RowLevelSchemaValidator.validate(data, schema)
        assert result.num_valid_rows == 1
        assert list(result.valid_rows.to_pandas()["v"]) == [15]

    def test_string_constraints(self, m):
        data = m.Dataset.from_dict({"code": ["AB", "ABC", "ABCD", "xy", None]})
        schema = m.RowLevelSchema().with_string_column(
            "code", min_length=2, max_length=3, matches="^[A-Z]+$"
        )
        result = m.RowLevelSchemaValidator.validate(data, schema)
        # AB, ABC pass; ABCD too long; xy lowercase; null allowed (nullable)
        assert result.num_valid_rows == 3

    def test_decimal(self, m):
        data = m.Dataset.from_dict({"d": ["12.34", "123456.7", "abc"]})
        schema = m.RowLevelSchema().with_decimal_column("d", precision=6, scale=2)
        result = m.RowLevelSchemaValidator.validate(data, schema)
        assert result.num_valid_rows == 1
        assert list(result.valid_rows.to_pandas()["d"]) == [12.34]

    def test_timestamp(self, m):
        data = m.Dataset.from_dict(
            {"ts": ["2024-01-31 10:30:00", "not a date", "2024-13-99 99:99:99"]}
        )
        schema = m.RowLevelSchema().with_timestamp_column("ts", mask="yyyy-MM-dd HH:mm:ss")
        result = m.RowLevelSchemaValidator.validate(data, schema)
        assert result.num_valid_rows == 1
        assert result.valid_rows.schema["ts"].kind == m.ColumnKind.TIMESTAMP

    def test_non_nullable(self, m):
        data = m.Dataset.from_dict({"x": ["a", None, "b"]})
        schema = m.RowLevelSchema().with_string_column("x", is_nullable=False)
        result = m.RowLevelSchemaValidator.validate(data, schema)
        assert result.num_valid_rows == 2

    def test_multi_column_cnf(self, m):
        data = m.Dataset.from_dict(
            {
                "id": ["1", "2", "x"],
                "name": ["alice", "bob", "carol"],
            }
        )
        schema = (
            m.RowLevelSchema()
            .with_int_column("id", is_nullable=False)
            .with_string_column("name", max_length=5)
        )
        result = m.RowLevelSchemaValidator.validate(data, schema)
        assert result.num_valid_rows == 2


class TestApplicability:
    def _schema(self, m):
        return m.Schema(
            [
                m.ColumnSchema("num", m.ColumnKind.FRACTIONAL),
                m.ColumnSchema("count", m.ColumnKind.INTEGRAL),
                m.ColumnSchema("name", m.ColumnKind.STRING),
                m.ColumnSchema("flag", m.ColumnKind.BOOLEAN),
            ]
        )

    def test_generate_random_data(self, m):
        data = m.generate_random_data(self._schema(m), 500)
        assert data.num_rows == 500
        assert data.schema["num"].kind == m.ColumnKind.FRACTIONAL
        assert data.schema["name"].kind == m.ColumnKind.STRING

    def test_applicable_check(self, m):
        check = (
            m.Check(m.CheckLevel.ERROR, "ok")
            .has_size(lambda v: True)
            .has_mean("num", lambda v: True)
            .is_complete("name")
        )
        result = m.Applicability.is_applicable_check(check, self._schema(m), **m.dev)
        assert result.is_applicable
        assert all(result.constraint_applicabilities.values())

    def test_inapplicable_check(self, m):
        check = (
            m.Check(m.CheckLevel.ERROR, "bad")
            .has_mean("name", lambda v: True)  # mean over a string column
            .has_mean("missing_col", lambda v: True)
        )
        result = m.Applicability.is_applicable_check(check, self._schema(m), **m.dev)
        assert not result.is_applicable
        assert len(result.failures) == 2
        inapplicable = [
            c for c, ok in result.constraint_applicabilities.items() if not ok
        ]
        assert len(inapplicable) == 2

    def test_analyzers_applicability(self, m):

        result = m.Applicability.is_applicable_analyzers(
            [m.Mean("num"), m.Completeness("name")], self._schema(m), **m.dev
        )
        assert result.is_applicable
        bad = m.Applicability.is_applicable_analyzers([m.Mean("name")], self._schema(m), **m.dev)
        assert not bad.is_applicable


# ---------------------------------------------------------------------------
# profile distances (the cases of tests/test_distance.py)
# ---------------------------------------------------------------------------


def _kll(m, buffers):
    return m.HostKLL.from_buffers(buffers, sketch_size=2048, shrinking_factor=0.64)


class TestNumericalDistance:
    def test_hand_computed_cdf_distance(self, m):
        # s1 holds {1,2,3}, s2 holds {2,3,4}, all weight 1. CDFs evaluated
        # at union {1,2,3,4}: s1 -> 1/3, 2/3, 1, 1 ; s2 -> 0, 1/3, 2/3, 1.
        # L-inf = 1/3.
        s1 = _kll(m, [[1.0, 2.0, 3.0]])
        s2 = _kll(m, [[2.0, 3.0, 4.0]])
        d = m.Distance.numerical_distance(s1, s2, correct_for_low_number_of_samples=True)
        assert d == pytest.approx(1 / 3)

    def test_weighted_levels(self, m):
        # s1: items 1 (w1) and 2 (w2) -> total 3; cdf(1)=1/3, cdf(2)=1
        # s2: item 2 (w1)             -> total 1; cdf(1)=0,   cdf(2)=1
        s1 = _kll(m, [[1.0], [2.0]])
        s2 = _kll(m, [[2.0]])
        d = m.Distance.numerical_distance(s1, s2, correct_for_low_number_of_samples=True)
        assert d == pytest.approx(1 / 3)

    def test_identical_sketches_distance_zero(self, m):
        s = _kll(m, [[1.0, 5.0, 9.0]])
        assert m.Distance.numerical_distance(s, s, True) == 0.0

    def test_small_sample_correction_floors_at_zero(self, m):
        # linf 1/3 with n=m=3: correction 1.8*sqrt(6/9) ~ 1.47 > 1/3 -> 0
        s1 = _kll(m, [[1.0, 2.0, 3.0]])
        s2 = _kll(m, [[2.0, 3.0, 4.0]])
        assert m.Distance.numerical_distance(s1, s2) == 0.0

    def test_from_analyzer_states(self, m):
        rng = np.random.default_rng(0)
        a = m.KLLSketch("x")
        same1 = m.Dataset.from_dict({"x": rng.normal(size=20_000)})
        same2 = m.Dataset.from_dict({"x": rng.normal(size=20_000)})
        shifted = m.Dataset.from_dict({"x": rng.normal(loc=3.0, size=20_000)})
        states = {}
        for name, data in (("a", same1), ("b", same2), ("c", shifted)):

            sp = m.InMemoryStateProvider()
            m.AnalysisRunner.do_analysis_run(data, [a], save_states_with=sp, **m.dev)
            states[name] = sp.load(a)
        near = m.Distance.numerical_distance(states["a"], states["b"], True)
        far = m.Distance.numerical_distance(states["a"], states["c"], True)
        assert near < 0.05
        assert far > 0.5  # N(0,1) vs N(3,1): L-inf CDF distance ~ 0.87

    def test_robust_variant_keeps_large_distances(self, m):
        rng = np.random.default_rng(1)
        s1 = _kll(m, [sorted(rng.normal(size=1000))])
        s2 = _kll(m, [sorted(rng.normal(loc=3.0, size=1000))])
        d = m.Distance.numerical_distance(s1, s2)
        assert d > 0.7


class TestCategoricalDistance:
    def test_hand_computed(self, m):
        s1 = {"a": 5, "b": 5}
        s2 = {"a": 2, "b": 8}
        # per-key mass: |0.5-0.2| = 0.3, |0.5-0.8| = 0.3 -> 0.3
        d = m.Distance.categorical_distance(s1, s2, correct_for_low_number_of_samples=True)
        assert d == pytest.approx(0.3)

    def test_disjoint_keys(self, m):
        d = m.Distance.categorical_distance(
            {"a": 10}, {"b": 10}, correct_for_low_number_of_samples=True
        )
        assert d == pytest.approx(1.0)

    def test_small_sample_correction(self, m):
        s1 = {"a": 5, "b": 5}
        s2 = {"a": 2, "b": 8}
        # 0.3 - 1.8*sqrt(20/100) < 0 -> floored at 0
        assert m.Distance.categorical_distance(s1, s2) == 0.0

    def test_large_sample_correction_small(self, m):
        s1 = {"a": 50_000, "b": 50_000}
        s2 = {"a": 20_000, "b": 80_000}
        d = m.Distance.categorical_distance(s1, s2)
        assert d == pytest.approx(0.3 - 1.8 * np.sqrt(2e5 / 1e10), rel=1e-9)

    def test_pandas_series_counts(self, m):
        import pandas as pd

        s1 = pd.Series({"a": 5, "b": 5})
        s2 = pd.Series({"a": 2, "b": 8})
        d = m.Distance.categorical_distance(s1, s2, correct_for_low_number_of_samples=True)
        assert d == pytest.approx(0.3)


class TestEmptySamples:
    def test_empty_categorical_sample_robust_is_zero(self, m):
        assert m.Distance.categorical_distance({}, {"a": 1}) == 0.0
        assert m.Distance.categorical_distance({"a": 1}, {}) == 0.0

    def test_empty_sketch_robust_is_zero(self, m):
        empty = _kll(m, [[]])
        full = _kll(m, [[1.0, 2.0]])
        assert m.Distance.numerical_distance(empty, full) == 0.0



# ---------------------------------------------------------------------------
# the two packages side by side
# ---------------------------------------------------------------------------


def _wide_schema(m):
    kinds = m.ColumnKind
    return m.Schema([
        m.ColumnSchema("num", kinds.FRACTIONAL, nullable=True),
        m.ColumnSchema("count", kinds.INTEGRAL, nullable=True),
        m.ColumnSchema("name", kinds.STRING, nullable=True),
        m.ColumnSchema("flag", kinds.BOOLEAN, nullable=False),
        m.ColumnSchema("ts", kinds.TIMESTAMP, nullable=True),
    ])


def test_both_packages_generate_the_same_rows():
    got = {m.name: m.generate_random_data(_wide_schema(m), 400, seed=7).arrow for m in (REF, PORT)}
    assert got["torch"].equals(got["jax"])
    assert got["torch"].num_rows == 400


def _verdicts(m, check_of):
    result = m.Applicability.is_applicable_check(check_of(m), _wide_schema(m), **m.dev)
    return (result.is_applicable, sorted(result.failures),
            sorted((str(c), ok) for c, ok in result.constraint_applicabilities.items()))


@pytest.mark.parametrize("case", ["applicable", "missing_column", "wrong_type"])
def test_both_packages_find_the_same_constraints_applicable(case):
    def check_of(m):
        check = m.Check(m.CheckLevel.ERROR, case).has_size(lambda n: n > 0)
        if case == "applicable":
            return check.has_mean("num", lambda v: True).is_complete("name") \
                .has_max("count", lambda v: True)
        if case == "missing_column":
            return check.is_complete("nope").has_mean("num", lambda v: True)
        return check.has_mean("name", lambda v: True).has_min("flag", lambda v: True)

    want = _verdicts(REF, check_of)
    assert _verdicts(PORT, check_of) == want
    assert want[0] is (case == "applicable")


def test_both_packages_measure_the_same_distances():
    """KLL sketches of the same batches are the same items in both
    packages, so their numerical distances are equal bit for bit; the
    categorical distance is host arithmetic on the same counts."""
    rng = np.random.default_rng(21)
    columns = {name: rng.normal(loc=shift, size=30_000) for name, shift in
               (("a", 0.0), ("b", 0.1), ("c", 2.0))}
    got = {}
    for m in (REF, PORT):
        states = {}
        for name, values in columns.items():
            sp = m.InMemoryStateProvider()
            analyzer = m.KLLSketch("x")
            m.AnalysisRunner.do_analysis_run(m.Dataset.from_dict({"x": values}), [analyzer],
                                             save_states_with=sp, batch_size=8192, **m.dev)
            states[name] = sp.load(analyzer)
        got[m.name] = [m.Distance.numerical_distance(states["a"], states[o], flag)
                       for o in ("b", "c") for flag in (True, False)]
    assert got["torch"] == got["jax"]
    assert got["torch"][2] > 0.5
    counts = ({"x": 30, "y": 50, "z": 20}, {"x": 10, "y": 70, "w": 5})
    assert (PORT.Distance.categorical_distance(*counts, True)
            == REF.Distance.categorical_distance(*counts, True))
