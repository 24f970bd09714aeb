"""Constraints: assertions over computed metrics.

A constraint pairs an analyzer with an assertion (and an optional value
picker narrowing the metric value first). Evaluation looks the metric up in
the analysis results, applies the picker, then the assertion, and converts
every error into a structured failure message instead of raising
(reference `constraints/Constraint.scala:36-682`,
`constraints/AnalysisBasedConstraint.scala:42-122`).
"""

from __future__ import annotations

import abc
import enum
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Sequence

from .analyzers import (
    Analyzer,
    ApproxCountDistinct,
    ApproxQuantile,
    Completeness,
    Compliance,
    Correlation,
    DataType,
    Distinctness,
    Entropy,
    Histogram,
    KLLSketch,
    Maximum,
    MaxLength,
    Mean,
    Minimum,
    MinLength,
    PatternMatch,
    Size,
    StandardDeviation,
    Sum,
    Uniqueness,
    UniqueValueRatio,
)
from .metrics import Distribution, Metric


class ConstraintStatus(enum.Enum):
    SUCCESS = "Success"
    FAILURE = "Failure"


class ConstrainableDataTypes(enum.Enum):
    """(reference `constraints/ConstrainableDataTypes.scala`)."""

    NULL = "Null"
    FRACTIONAL = "Fractional"
    INTEGRAL = "Integral"
    BOOLEAN = "Boolean"
    STRING = "String"
    NUMERIC = "Numeric"


class Constraint(abc.ABC):
    """Evaluable on a map of analyzer -> metric."""

    @abc.abstractmethod
    def evaluate(self, analysis_results: Dict[Analyzer, Metric]) -> "ConstraintResult":
        ...


@dataclass(frozen=True)
class ConstraintResult:
    constraint: Constraint
    status: ConstraintStatus
    message: Optional[str] = None
    metric: Optional[Metric] = None


class ConstraintDecorator(Constraint):
    """(reference `constraints/Constraint.scala:41-57`)."""

    def __init__(self, inner: Constraint):
        self._inner = inner

    @property
    def inner(self) -> Constraint:
        if isinstance(self._inner, ConstraintDecorator):
            return self._inner.inner
        return self._inner

    def evaluate(self, analysis_results: Dict[Analyzer, Metric]) -> ConstraintResult:
        result = self._inner.evaluate(analysis_results)
        return ConstraintResult(self, result.status, result.message, result.metric)


class NamedConstraint(ConstraintDecorator):
    """Readable name wrapper (reference `constraints/Constraint.scala:59-69`)."""

    def __init__(self, constraint: Constraint, name: str):
        super().__init__(constraint)
        self._name = name

    def __str__(self) -> str:
        return self._name

    def __repr__(self) -> str:
        return self._name


# messages (reference `constraints/AnalysisBasedConstraint.scala:46-52`)
MISSING_ANALYSIS_MESSAGE = "Missing Analysis, can't run the constraint!"
PROBLEMATIC_METRIC_PICKER = "Can't retrieve the value to assert on"
ASSERTION_EXCEPTION = "Can't execute the assertion"


class AnalysisBasedConstraint(Constraint):
    """Constraint evaluated against a metric computed by an analyzer
    (reference `constraints/AnalysisBasedConstraint.scala:42-122`)."""

    def __init__(
        self,
        analyzer: Analyzer,
        assertion: Callable[[Any], bool],
        value_picker: Optional[Callable[[Any], Any]] = None,
        hint: Optional[str] = None,
    ):
        self.analyzer = analyzer
        self.assertion = assertion
        self.value_picker = value_picker
        self.hint = hint

    def evaluate(self, analysis_results: Dict[Analyzer, Metric]) -> ConstraintResult:
        metric = analysis_results.get(self.analyzer)
        if metric is None:
            return ConstraintResult(self, ConstraintStatus.FAILURE, MISSING_ANALYSIS_MESSAGE)
        return self._pick_value_and_assert(metric)

    def _pick_value_and_assert(self, metric: Metric) -> ConstraintResult:
        if metric.value.is_failure:
            return ConstraintResult(
                self,
                ConstraintStatus.FAILURE,
                f"metric computation failed: {metric.value.exception}",
                metric,
            )
        try:
            raw = metric.value.get()
            if self.value_picker is not None:
                try:
                    assert_on = self.value_picker(raw)
                except Exception as exc:  # noqa: BLE001
                    return ConstraintResult(
                        self,
                        ConstraintStatus.FAILURE,
                        f"{PROBLEMATIC_METRIC_PICKER}: {exc}",
                        metric,
                    )
            else:
                assert_on = raw
            try:
                holds = self.assertion(assert_on)
            except Exception as exc:  # noqa: BLE001
                return ConstraintResult(
                    self, ConstraintStatus.FAILURE, f"{ASSERTION_EXCEPTION}: {exc}", metric
                )
            if holds:
                return ConstraintResult(self, ConstraintStatus.SUCCESS, metric=metric)
            hint = f" {self.hint}" if self.hint else ""
            return ConstraintResult(
                self,
                ConstraintStatus.FAILURE,
                f"Value: {assert_on} does not meet the constraint requirement!{hint}",
                metric,
            )
        except Exception as exc:  # noqa: BLE001
            return ConstraintResult(self, ConstraintStatus.FAILURE, str(exc), metric)

    def __str__(self) -> str:
        return f"AnalysisBasedConstraint({self.analyzer})"

    __repr__ = __str__


# ---------------------------------------------------------------------------
# Constraint factories (reference `constraints/Constraint.scala:83-682`)
# ---------------------------------------------------------------------------


def size_constraint(assertion, where=None, hint=None) -> Constraint:
    inner = AnalysisBasedConstraint(Size(where=where), assertion, hint=hint)
    return NamedConstraint(inner, f"SizeConstraint({Size(where=where)})")


def completeness_constraint(column, assertion, where=None, hint=None) -> Constraint:
    analyzer = Completeness(column, where)
    inner = AnalysisBasedConstraint(analyzer, assertion, hint=hint)
    return NamedConstraint(inner, f"CompletenessConstraint({analyzer})")


def uniqueness_constraint(columns: Sequence[str], assertion, hint=None) -> Constraint:
    analyzer = Uniqueness(tuple(columns))
    inner = AnalysisBasedConstraint(analyzer, assertion, hint=hint)
    return NamedConstraint(inner, f"UniquenessConstraint({analyzer})")


def distinctness_constraint(columns: Sequence[str], assertion, hint=None) -> Constraint:
    analyzer = Distinctness(tuple(columns))
    inner = AnalysisBasedConstraint(analyzer, assertion, hint=hint)
    return NamedConstraint(inner, f"DistinctnessConstraint({analyzer})")


def unique_value_ratio_constraint(columns: Sequence[str], assertion, hint=None) -> Constraint:
    analyzer = UniqueValueRatio(tuple(columns))
    inner = AnalysisBasedConstraint(analyzer, assertion, hint=hint)
    return NamedConstraint(inner, f"UniqueValueRatioConstraint({analyzer})")


def compliance_constraint(name, predicate, assertion, where=None, hint=None) -> Constraint:
    analyzer = Compliance(name, predicate, where)
    inner = AnalysisBasedConstraint(analyzer, assertion, hint=hint)
    return NamedConstraint(inner, f"ComplianceConstraint({analyzer})")


def pattern_match_constraint(
    column, pattern, assertion, where=None, name=None, hint=None
) -> Constraint:
    analyzer = PatternMatch(column, pattern, where)
    inner = AnalysisBasedConstraint(analyzer, assertion, hint=hint)
    display = name or f"PatternMatchConstraint({column}, {pattern})"
    return NamedConstraint(inner, display)


def entropy_constraint(column, assertion, hint=None) -> Constraint:
    analyzer = Entropy(column)
    inner = AnalysisBasedConstraint(analyzer, assertion, hint=hint)
    return NamedConstraint(inner, f"EntropyConstraint({analyzer})")


def histogram_constraint(column, assertion, max_bins=None, hint=None) -> Constraint:
    kwargs = {} if max_bins is None else {"max_detail_bins": max_bins}
    analyzer = Histogram(column, **kwargs)
    inner = AnalysisBasedConstraint(analyzer, assertion, hint=hint)
    return NamedConstraint(inner, f"HistogramConstraint({analyzer})")


def histogram_bin_constraint(column, assertion, max_bins=None, hint=None) -> Constraint:
    """Assertion over the number of distinct bins
    (reference `histogramBinConstraint`)."""
    kwargs = {} if max_bins is None else {"max_detail_bins": max_bins}
    analyzer = Histogram(column, **kwargs)
    inner = AnalysisBasedConstraint(
        analyzer, assertion, value_picker=lambda d: float(d.number_of_bins), hint=hint
    )
    return NamedConstraint(inner, f"HistogramBinConstraint({analyzer})")


def min_length_constraint(column, assertion, where=None, hint=None) -> Constraint:
    analyzer = MinLength(column, where)
    inner = AnalysisBasedConstraint(analyzer, assertion, hint=hint)
    return NamedConstraint(inner, f"MinLengthConstraint({analyzer})")


def max_length_constraint(column, assertion, where=None, hint=None) -> Constraint:
    analyzer = MaxLength(column, where)
    inner = AnalysisBasedConstraint(analyzer, assertion, hint=hint)
    return NamedConstraint(inner, f"MaxLengthConstraint({analyzer})")


def min_constraint(column, assertion, where=None, hint=None) -> Constraint:
    analyzer = Minimum(column, where)
    inner = AnalysisBasedConstraint(analyzer, assertion, hint=hint)
    return NamedConstraint(inner, f"MinimumConstraint({analyzer})")


def max_constraint(column, assertion, where=None, hint=None) -> Constraint:
    analyzer = Maximum(column, where)
    inner = AnalysisBasedConstraint(analyzer, assertion, hint=hint)
    return NamedConstraint(inner, f"MaximumConstraint({analyzer})")


def mean_constraint(column, assertion, where=None, hint=None) -> Constraint:
    analyzer = Mean(column, where)
    inner = AnalysisBasedConstraint(analyzer, assertion, hint=hint)
    return NamedConstraint(inner, f"MeanConstraint({analyzer})")


def sum_constraint(column, assertion, where=None, hint=None) -> Constraint:
    analyzer = Sum(column, where)
    inner = AnalysisBasedConstraint(analyzer, assertion, hint=hint)
    return NamedConstraint(inner, f"SumConstraint({analyzer})")


def standard_deviation_constraint(column, assertion, where=None, hint=None) -> Constraint:
    analyzer = StandardDeviation(column, where)
    inner = AnalysisBasedConstraint(analyzer, assertion, hint=hint)
    return NamedConstraint(inner, f"StandardDeviationConstraint({analyzer})")


def correlation_constraint(column_a, column_b, assertion, where=None, hint=None) -> Constraint:
    analyzer = Correlation(column_a, column_b, where)
    inner = AnalysisBasedConstraint(analyzer, assertion, hint=hint)
    return NamedConstraint(inner, f"CorrelationConstraint({analyzer})")


def anomaly_constraint(
    analyzer: Analyzer, assertion: Callable[[float], bool], hint=None
) -> Constraint:
    """Constraint whose assertion encapsulates an anomaly-detection decision
    over the repository history (reference `anomalyConstraint`)."""
    inner = AnalysisBasedConstraint(analyzer, assertion, hint=hint)
    return NamedConstraint(inner, f"AnomalyConstraint({analyzer})")


def approx_count_distinct_constraint(column, assertion, where=None, hint=None) -> Constraint:
    analyzer = ApproxCountDistinct(column, where)
    inner = AnalysisBasedConstraint(analyzer, assertion, hint=hint)
    return NamedConstraint(inner, f"ApproxCountDistinctConstraint({analyzer})")


def kll_constraint(column, assertion, kll_parameters=None, hint=None) -> Constraint:
    analyzer = KLLSketch(column, kll_parameters)
    inner = AnalysisBasedConstraint(analyzer, assertion, hint=hint)
    return NamedConstraint(inner, f"kllSketchConstraint({analyzer})")


def approx_quantile_constraint(
    column, quantile, assertion, relative_error=0.01, where=None, hint=None
) -> Constraint:
    analyzer = ApproxQuantile(column, quantile, relative_error, where)
    inner = AnalysisBasedConstraint(analyzer, assertion, hint=hint)
    return NamedConstraint(inner, f"ApproxQuantileConstraint({analyzer})")


def data_type_constraint(column, data_type, assertion, where=None, hint=None) -> Constraint:
    """Assertion over the ratio of values inferred as ``data_type``
    (reference `dataTypeConstraint`, `constraints/Constraint.scala:592-624`)."""

    def ratio_types(ignore_unknown: bool, key: str, distribution: Distribution) -> float:
        absolute = (
            distribution.values[key].absolute if key in distribution.values else 0
        )
        if ignore_unknown:
            if absolute == 0:
                return 0.0
            total = sum(v.absolute for v in distribution.values.values())
            unknown = (
                distribution.values["Unknown"].absolute
                if "Unknown" in distribution.values
                else 0
            )
            denom = total - unknown
            return absolute / denom if denom > 0 else 0.0
        total = sum(v.absolute for v in distribution.values.values())
        return absolute / total if total > 0 else 0.0

    def picker(distribution: Distribution) -> float:
        if data_type == ConstrainableDataTypes.NULL:
            return ratio_types(False, "Unknown", distribution)
        if data_type == ConstrainableDataTypes.NUMERIC:
            return ratio_types(True, "Fractional", distribution) + ratio_types(
                True, "Integral", distribution
            )
        return ratio_types(True, data_type.value, distribution)

    analyzer = DataType(column, where)
    inner = AnalysisBasedConstraint(analyzer, assertion, value_picker=picker, hint=hint)
    return NamedConstraint(inner, f"DataTypeConstraint({analyzer})")
