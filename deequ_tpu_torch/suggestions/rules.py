"""Constraint suggestion rules (reference `suggestions/rules/*.scala`),
copied from the JAX package's ``deequ_tpu/suggestions/rules.py``.

Each rule decides applicability from a column profile and emits a
constraint + the fluent-API code string that would create it."""

from __future__ import annotations

import abc
import math
from dataclasses import dataclass
from typing import Dict, List, Tuple

from ..analyzers.grouping import NULL_FIELD_REPLACEMENT
from ..checks import contained_in_predicate, is_one
from ..constraints import (
    ConstrainableDataTypes,
    Constraint,
    completeness_constraint,
    compliance_constraint,
    data_type_constraint,
    uniqueness_constraint,
)
from ..metrics import DistributionValue
from ..profiles import ColumnProfile, NumericColumnProfile


@dataclass
class ConstraintSuggestion:
    """(reference `suggestions/ConstraintSuggestion.scala:25-35`)."""

    constraint: Constraint
    column_name: str
    current_value: str
    description: str
    suggesting_rule: "ConstraintRule"
    code_for_constraint: str


class ConstraintRule(abc.ABC):
    """(reference `suggestions/rules/ConstraintRule.scala:23-44`)."""

    rule_description: str = ""

    @abc.abstractmethod
    def should_be_applied(self, profile: ColumnProfile, num_records: int) -> bool:
        ...

    @abc.abstractmethod
    def candidate(self, profile: ColumnProfile, num_records: int) -> ConstraintSuggestion:
        ...


def _round_down_2(x: float) -> float:
    """BigDecimal setScale(2, DOWN) analog."""
    return math.floor(x * 100) / 100


class CompleteIfCompleteRule(ConstraintRule):
    """(reference `rules/CompleteIfCompleteRule.scala`)."""

    rule_description = (
        "If a column is complete in the sample, we suggest a NOT NULL constraint"
    )

    def should_be_applied(self, profile, num_records):
        return profile.completeness == 1.0

    def candidate(self, profile, num_records):
        return ConstraintSuggestion(
            completeness_constraint(profile.column, is_one),
            profile.column,
            f"Completeness: {profile.completeness}",
            f"'{profile.column}' is not null",
            self,
            f'.is_complete("{profile.column}")',
        )


class RetainCompletenessRule(ConstraintRule):
    """Models completeness as a binomial variable and suggests the 95%
    lower confidence bound (reference `rules/RetainCompletenessRule.scala`)."""

    rule_description = (
        "If a column is incomplete in the sample, we model its completeness "
        "as a binomial variable, estimate a confidence interval and use this "
        "to define a lower bound for the completeness"
    )

    def should_be_applied(self, profile, num_records):
        return 0.2 < profile.completeness < 1.0

    def candidate(self, profile, num_records):
        p = profile.completeness
        n = max(num_records, 1)
        z = 1.96
        target = _round_down_2(p - z * math.sqrt(p * (1 - p) / n))
        bound_percent = round((1.0 - target) * 100)
        return ConstraintSuggestion(
            completeness_constraint(profile.column, lambda v, t=target: v >= t),
            profile.column,
            f"Completeness: {profile.completeness}",
            f"'{profile.column}' has less than {bound_percent}% missing values",
            self,
            f'.has_completeness("{profile.column}", lambda v: v >= {target}, '
            f'"It should be above {target}!")',
        )


class RetainTypeRule(ConstraintRule):
    """(reference `rules/RetainTypeRule.scala`)."""

    rule_description = "If we detect a non-string type, we suggest a type constraint"

    def should_be_applied(self, profile, num_records):
        return profile.is_data_type_inferred and profile.data_type in (
            "Integral", "Fractional", "Boolean",
        )

    def candidate(self, profile, num_records):
        dt = {
            "Fractional": ConstrainableDataTypes.FRACTIONAL,
            "Integral": ConstrainableDataTypes.INTEGRAL,
            "Boolean": ConstrainableDataTypes.BOOLEAN,
        }[profile.data_type]
        return ConstraintSuggestion(
            data_type_constraint(profile.column, dt, is_one),
            profile.column,
            f"DataType: {profile.data_type}",
            f"'{profile.column}' has type {profile.data_type}",
            self,
            f'.has_data_type("{profile.column}", ConstrainableDataTypes.'
            f"{profile.data_type.upper()})",
        )


def _unique_value_ratio(entries: Dict[str, DistributionValue]) -> float:
    num_unique = sum(1 for v in entries.values() if v.absolute == 1)
    return num_unique / len(entries) if entries else 1.0


def _sql_category_list(keys: List[str]) -> str:
    return ", ".join("'" + k.replace("'", "''") + "'" for k in keys)


def _code_category_list(keys: List[str]) -> str:
    escaped = [k.replace("\\", "\\\\").replace('"', '\\"') for k in keys]
    return ", ".join(f'"{k}"' for k in escaped)


class CategoricalRangeRule(ConstraintRule):
    """(reference `rules/CategoricalRangeRule.scala:26-77`)."""

    rule_description = (
        "If we see a categorical range for a column, we suggest an "
        "IS IN (...) constraint"
    )

    def should_be_applied(self, profile, num_records):
        if profile.histogram is None or profile.data_type != "String":
            return False
        return _unique_value_ratio(profile.histogram.values) <= 0.1

    def candidate(self, profile, num_records):
        by_popularity = sorted(
            (
                (k, v)
                for k, v in profile.histogram.values.items()
                if k != NULL_FIELD_REPLACEMENT
            ),
            key=lambda kv: kv[1].absolute,
            reverse=True,
        )
        keys = [k for k, _ in by_popularity]
        categories_sql = _sql_category_list(keys)
        description = f"'{profile.column}' has value range {categories_sql}"
        predicate = _membership_predicate(profile.column, keys)
        return ConstraintSuggestion(
            compliance_constraint(description, predicate, is_one),
            profile.column,
            "Compliance: 1",
            description,
            self,
            f'.is_contained_in("{profile.column}", [{_code_category_list(keys)}])',
        )


class FractionalCategoricalRangeRule(ConstraintRule):
    """Top categories covering >= 90% of the data
    (reference `rules/FractionalCategoricalRangeRule.scala`)."""

    rule_description = (
        "If we see a categorical range for most values in a column, we "
        "suggest an IS IN (...) constraint that should hold for most values"
    )

    def __init__(self, target_data_coverage_fraction: float = 0.9):
        self.target_data_coverage_fraction = target_data_coverage_fraction

    def _top_categories(self, profile) -> Dict[str, DistributionValue]:
        sorted_values = sorted(
            profile.histogram.values.items(), key=lambda kv: kv[1].ratio, reverse=True
        )
        coverage = 0.0
        out: Dict[str, DistributionValue] = {}
        for key, value in sorted_values:
            if coverage < self.target_data_coverage_fraction:
                out[key] = value
                coverage += value.ratio
        return out

    def should_be_applied(self, profile, num_records):
        if profile.histogram is None or profile.data_type != "String":
            return False
        ratio = _unique_value_ratio(profile.histogram.values)
        top = self._top_categories(profile)
        ratio_sum = sum(v.ratio for v in top.values())
        return ratio <= 0.4 and ratio_sum < 1

    def candidate(self, profile, num_records):
        top = self._top_categories(profile)
        ratio_sums = sum(v.ratio for v in top.values())
        by_popularity = sorted(
            ((k, v) for k, v in top.items() if k != NULL_FIELD_REPLACEMENT),
            key=lambda kv: kv[1].absolute,
            reverse=True,
        )
        keys = [k for k, _ in by_popularity]
        categories_sql = _sql_category_list(keys)
        p = ratio_sums
        n = max(num_records, 1)
        z = 1.96
        target = _round_down_2(p - z * math.sqrt(p * (1 - p) / n))
        description = (
            f"'{profile.column}' has value range {categories_sql} for at "
            f"least {target * 100}% of values"
        )
        hint = f"It should be above {target}!"
        predicate = _membership_predicate(profile.column, keys)
        return ConstraintSuggestion(
            compliance_constraint(
                description, predicate, lambda v, t=target: v >= t, hint=hint
            ),
            profile.column,
            f"Compliance: {ratio_sums}",
            description,
            self,
            f'.is_contained_in("{profile.column}", [{_code_category_list(keys)}], '
            f"lambda v: v >= {target}, \"{hint}\")",
        )


class NonNegativeNumbersRule(ConstraintRule):
    """(reference `rules/NonNegativeNumbersRule.scala`)."""

    rule_description = (
        "If we see only non-negative numbers in a column, we suggest a "
        "corresponding constraint"
    )

    def should_be_applied(self, profile, num_records):
        return (
            isinstance(profile, NumericColumnProfile)
            and profile.minimum is not None
            and profile.minimum >= 0.0
        )

    def candidate(self, profile, num_records):
        description = f"'{profile.column}' has no negative values"
        minimum = (
            str(profile.minimum)
            if isinstance(profile, NumericColumnProfile) and profile.minimum is not None
            else "Error while calculating minimum!"
        )
        return ConstraintSuggestion(
            compliance_constraint(description, f"{profile.column} >= 0", is_one),
            profile.column,
            f"Minimum: {minimum}",
            description,
            self,
            f'.is_non_negative("{profile.column}")',
        )


class UniqueIfApproximatelyUniqueRule(ConstraintRule):
    """(reference `rules/UniqueIfApproximatelyUniqueRule.scala`; not part of
    the DEFAULT set there either)."""

    rule_description = (
        "If the ratio of approximate num distinct values in a column is "
        "close to the number of records (within the error of the HLL "
        "sketch), we suggest a UNIQUE constraint"
    )

    def should_be_applied(self, profile, num_records):
        if num_records == 0:
            return False
        approx_distinctness = profile.approximate_num_distinct_values / num_records
        return profile.completeness == 1.0 and abs(1.0 - approx_distinctness) <= 0.08

    def candidate(self, profile, num_records):
        approx_distinctness = profile.approximate_num_distinct_values / max(num_records, 1)
        return ConstraintSuggestion(
            uniqueness_constraint([profile.column], is_one),
            profile.column,
            f"ApproxDistinctness: {approx_distinctness}",
            f"'{profile.column}' is unique",
            self,
            f'.is_unique("{profile.column}")',
        )


def _membership_predicate(column: str, keys: List[str]) -> str:
    return contained_in_predicate(column, keys)


DEFAULT_RULES: Tuple[ConstraintRule, ...] = (
    CompleteIfCompleteRule(),
    RetainCompletenessRule(),
    RetainTypeRule(),
    CategoricalRangeRule(),
    FractionalCategoricalRangeRule(),
    NonNegativeNumbersRule(),
)
