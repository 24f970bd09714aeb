"""Check DSL: a named, immutable group of constraints with ~40 fluent
factories (reference `checks/Check.scala:60-974`). Each factory returns a NEW
Check (or a CheckWithLastConstraintFilterable allowing ``.where(...)`` to
rebuild the last constraint with a row filter, reference
`checks/CheckWithLastConstraintFilterable.scala:22-54`).
"""

from __future__ import annotations

import enum
from typing import Callable, Optional, Sequence, Set, Tuple

from . import constraints as C
from .analyzers import Analyzer, Patterns
from .constraints import (
    AnalysisBasedConstraint,
    ConstrainableDataTypes,
    Constraint,
    ConstraintDecorator,
    ConstraintStatus,
)


class CheckLevel(enum.Enum):
    ERROR = "Error"
    WARNING = "Warning"


class CheckStatus(enum.Enum):
    SUCCESS = "Success"
    WARNING = "Warning"
    ERROR = "Error"

    @property
    def severity(self) -> int:
        return {"Success": 0, "Warning": 1, "Error": 2}[self.value]


class CheckResult:
    def __init__(self, check: "Check", status: CheckStatus, constraint_results):
        self.check = check
        self.status = status
        self.constraint_results = list(constraint_results)


def is_one(value: float) -> bool:
    """The default assertion (reference `Check.IsOne`)."""
    return value == 1.0


def contained_in_predicate(column: str, allowed_values) -> str:
    """Null-tolerant membership predicate shared by ``is_contained_in`` and
    the categorical suggestion rules. Numeric literals stay numeric so
    numeric columns can match their allowed set."""
    literals = ", ".join(
        repr(v) if isinstance(v, str) else repr(float(v))
        if isinstance(v, float) else str(v)
        for v in allowed_values
    )
    return f"({column} is None) or ({column} in [{literals}])"


class Check:
    """(reference `checks/Check.scala:60-94`)."""

    def __init__(
        self,
        level: CheckLevel = CheckLevel.ERROR,
        description: str = "",
        constraints: Sequence[Constraint] = (),
    ):
        self.level = level
        self.description = description
        self.constraints: Tuple[Constraint, ...] = tuple(constraints)

    # -- plumbing -----------------------------------------------------------

    def add_constraint(self, constraint: Constraint) -> "Check":
        return Check(self.level, self.description, self.constraints + (constraint,))

    def _add_filterable(
        self, creation_func: Callable[[Optional[str]], Constraint]
    ) -> "CheckWithLastConstraintFilterable":
        return CheckWithLastConstraintFilterable(
            self.level,
            self.description,
            self.constraints + (creation_func(None),),
            creation_func,
        )

    def evaluate(self, context) -> CheckResult:
        """(reference `checks/Check.scala:950-962`)."""
        results = [c.evaluate(context.metric_map) for c in self.constraints]
        any_failures = any(r.status == ConstraintStatus.FAILURE for r in results)
        if any_failures:
            status = (
                CheckStatus.ERROR if self.level == CheckLevel.ERROR else CheckStatus.WARNING
            )
        else:
            status = CheckStatus.SUCCESS
        return CheckResult(self, status, results)

    def required_analyzers(self) -> Set[Analyzer]:
        """(reference `checks/Check.scala:964-973`)."""
        out: Set[Analyzer] = set()
        for c in self.constraints:
            inner = c.inner if isinstance(c, ConstraintDecorator) else c
            if isinstance(inner, AnalysisBasedConstraint):
                out.add(inner.analyzer)
        return out

    # -- factories ----------------------------------------------------------

    def has_size(self, assertion, hint=None) -> "CheckWithLastConstraintFilterable":
        return self._add_filterable(
            lambda where: C.size_constraint(assertion, where, hint)
        )

    def is_complete(self, column, hint=None) -> "CheckWithLastConstraintFilterable":
        return self._add_filterable(
            lambda where: C.completeness_constraint(column, is_one, where, hint)
        )

    def has_completeness(self, column, assertion, hint=None) -> "CheckWithLastConstraintFilterable":
        return self._add_filterable(
            lambda where: C.completeness_constraint(column, assertion, where, hint)
        )

    def is_unique(self, column, hint=None) -> "Check":
        return self.add_constraint(C.uniqueness_constraint([column], is_one, hint))

    def is_primary_key(self, column, *columns, hint=None) -> "Check":
        return self.add_constraint(
            C.uniqueness_constraint([column, *columns], is_one, hint)
        )

    def has_uniqueness(self, columns, assertion, hint=None) -> "Check":
        if isinstance(columns, str):
            columns = [columns]
        return self.add_constraint(C.uniqueness_constraint(columns, assertion, hint))

    def has_distinctness(self, columns, assertion, hint=None) -> "Check":
        if isinstance(columns, str):
            columns = [columns]
        return self.add_constraint(C.distinctness_constraint(columns, assertion, hint))

    def has_unique_value_ratio(self, columns, assertion, hint=None) -> "Check":
        if isinstance(columns, str):
            columns = [columns]
        return self.add_constraint(C.unique_value_ratio_constraint(columns, assertion, hint))

    def has_number_of_distinct_values(self, column, assertion, max_bins=None, hint=None) -> "Check":
        return self.add_constraint(
            C.histogram_bin_constraint(column, assertion, max_bins, hint=hint)
        )

    def has_histogram_values(self, column, assertion, max_bins=None, hint=None) -> "Check":
        return self.add_constraint(
            C.histogram_constraint(column, assertion, max_bins, hint=hint)
        )

    def kll_sketch_satisfies(self, column, assertion, kll_parameters=None, hint=None) -> "Check":
        return self.add_constraint(C.kll_constraint(column, assertion, kll_parameters, hint))

    def has_approx_quantile(
        self, column, quantile, assertion, relative_error=0.01, hint=None
    ) -> "CheckWithLastConstraintFilterable":
        return self._add_filterable(
            lambda where: C.approx_quantile_constraint(
                column, quantile, assertion, relative_error, where, hint
            )
        )

    def has_data_type(self, column, data_type: ConstrainableDataTypes, assertion=is_one, hint=None):
        return self._add_filterable(
            lambda where: C.data_type_constraint(column, data_type, assertion, where, hint)
        )

    def has_entropy(self, column, assertion, hint=None) -> "Check":
        return self.add_constraint(C.entropy_constraint(column, assertion, hint))

    def has_min_length(self, column, assertion, hint=None) -> "CheckWithLastConstraintFilterable":
        return self._add_filterable(
            lambda where: C.min_length_constraint(column, assertion, where, hint)
        )

    def has_max_length(self, column, assertion, hint=None) -> "CheckWithLastConstraintFilterable":
        return self._add_filterable(
            lambda where: C.max_length_constraint(column, assertion, where, hint)
        )

    def has_min(self, column, assertion, hint=None) -> "CheckWithLastConstraintFilterable":
        return self._add_filterable(
            lambda where: C.min_constraint(column, assertion, where, hint)
        )

    def has_max(self, column, assertion, hint=None) -> "CheckWithLastConstraintFilterable":
        return self._add_filterable(
            lambda where: C.max_constraint(column, assertion, where, hint)
        )

    def has_mean(self, column, assertion, hint=None) -> "CheckWithLastConstraintFilterable":
        return self._add_filterable(
            lambda where: C.mean_constraint(column, assertion, where, hint)
        )

    def has_sum(self, column, assertion, hint=None) -> "CheckWithLastConstraintFilterable":
        return self._add_filterable(
            lambda where: C.sum_constraint(column, assertion, where, hint)
        )

    def has_standard_deviation(
        self, column, assertion, hint=None
    ) -> "CheckWithLastConstraintFilterable":
        return self._add_filterable(
            lambda where: C.standard_deviation_constraint(column, assertion, where, hint)
        )

    def has_approx_count_distinct(
        self, column, assertion, hint=None
    ) -> "CheckWithLastConstraintFilterable":
        return self._add_filterable(
            lambda where: C.approx_count_distinct_constraint(column, assertion, where, hint)
        )

    def has_correlation(
        self, column_a, column_b, assertion, hint=None
    ) -> "CheckWithLastConstraintFilterable":
        return self._add_filterable(
            lambda where: C.correlation_constraint(column_a, column_b, assertion, where, hint)
        )

    def satisfies(
        self, column_condition, constraint_name, assertion=is_one, hint=None
    ) -> "CheckWithLastConstraintFilterable":
        return self._add_filterable(
            lambda where: C.compliance_constraint(
                constraint_name, column_condition, assertion, where, hint
            )
        )

    def has_pattern(
        self, column, pattern, assertion=is_one, name=None, hint=None
    ) -> "CheckWithLastConstraintFilterable":
        return self._add_filterable(
            lambda where: C.pattern_match_constraint(
                column, pattern, assertion, where, name, hint
            )
        )

    def contains_credit_card_number(self, column, assertion=is_one, hint=None):
        return self.has_pattern(
            column, Patterns.CREDITCARD, assertion,
            name=f"containsCreditCardNumber({column})", hint=hint,
        )

    def contains_email(self, column, assertion=is_one, hint=None):
        return self.has_pattern(
            column, Patterns.EMAIL, assertion, name=f"containsEmail({column})", hint=hint
        )

    def contains_url(self, column, assertion=is_one, hint=None):
        return self.has_pattern(
            column, Patterns.URL, assertion, name=f"containsURL({column})", hint=hint
        )

    def contains_social_security_number(self, column, assertion=is_one, hint=None):
        return self.has_pattern(
            column,
            Patterns.SOCIAL_SECURITY_NUMBER_US,
            assertion,
            name=f"containsSocialSecurityNumber({column})",
            hint=hint,
        )

    def is_non_negative(self, column, assertion=is_one, hint=None):
        # nulls are compliant (reference coalesces nulls to 0.0,
        # `checks/Check.scala:787-799`)
        return self.satisfies(
            f"({column} is None) or ({column} >= 0)",
            f"{column} is non-negative",
            assertion,
            hint,
        )

    def is_positive(self, column, assertion=is_one, hint=None):
        return self.satisfies(
            f"({column} is None) or ({column} > 0)",
            f"{column} is positive",
            assertion,
            hint,
        )

    def is_less_than(self, column_a, column_b, assertion=is_one, hint=None):
        return self.satisfies(
            f"{column_a} < {column_b}", f"{column_a} is less than {column_b}", assertion, hint
        )

    def is_less_than_or_equal_to(self, column_a, column_b, assertion=is_one, hint=None):
        return self.satisfies(
            f"{column_a} <= {column_b}",
            f"{column_a} is less than or equal to {column_b}",
            assertion,
            hint,
        )

    def is_greater_than(self, column_a, column_b, assertion=is_one, hint=None):
        return self.satisfies(
            f"{column_a} > {column_b}",
            f"{column_a} is greater than {column_b}",
            assertion,
            hint,
        )

    def is_greater_than_or_equal_to(self, column_a, column_b, assertion=is_one, hint=None):
        return self.satisfies(
            f"{column_a} >= {column_b}",
            f"{column_a} is greater than or equal to {column_b}",
            assertion,
            hint,
        )

    def is_contained_in(
        self,
        column,
        allowed_values=None,
        lower_bound=None,
        upper_bound=None,
        include_lower_bound=True,
        include_upper_bound=True,
        assertion=is_one,
        hint=None,
    ):
        """Values version (allowed_values) or numeric-interval version
        (lower_bound/upper_bound); non-null values must comply
        (reference `checks/Check.scala:844-943`)."""
        if allowed_values is not None:
            predicate = contained_in_predicate(column, allowed_values)
            return self.satisfies(
                predicate,
                f"{column} contained in {','.join(str(v) for v in allowed_values)}",
                assertion,
                hint,
            )
        if lower_bound is None or upper_bound is None:
            raise ValueError(
                "is_contained_in needs either allowed_values or lower_bound+upper_bound"
            )
        left = ">=" if include_lower_bound else ">"
        right = "<=" if include_upper_bound else "<"
        predicate = (
            f"({column} is None) or "
            f"({column} {left} {lower_bound} and {column} {right} {upper_bound})"
        )
        return self.satisfies(
            predicate, f"{column} between {lower_bound} and {upper_bound}", assertion, hint
        )

    def is_newest_point_non_anomalous(
        self,
        metrics_repository,
        anomaly_detection_strategy,
        analyzer: Analyzer,
        with_tag_values=None,
        after_date=None,
        before_date=None,
        hint=None,
    ) -> "Check":
        """Anomaly check on the newest metric point given repository history
        (reference `checks/Check.scala:345-365,998-1055`)."""
        from .anomalydetection.wiring import is_newest_point_non_anomalous

        def assertion(value: float) -> bool:
            return is_newest_point_non_anomalous(
                metrics_repository,
                anomaly_detection_strategy,
                analyzer,
                with_tag_values or {},
                after_date,
                before_date,
                value,
            )

        return self.add_constraint(C.anomaly_constraint(analyzer, assertion, hint))


class CheckWithLastConstraintFilterable(Check):
    """Allows filtering the data for the last added constraint with
    ``.where(...)`` (reference `checks/CheckWithLastConstraintFilterable.scala`)."""

    def __init__(self, level, description, constraints, create_replacement):
        super().__init__(level, description, constraints)
        self._create_replacement = create_replacement

    def where(self, filter_: str) -> Check:
        adjusted = self.constraints[:-1] + (self._create_replacement(filter_),)
        return Check(self.level, self.description, adjusted)
