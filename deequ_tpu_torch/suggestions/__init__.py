"""Constraint suggestion: profile the data, apply heuristic rules per
column, optionally evaluate the suggested constraints on a held-out split
(reference `suggestions/ConstraintSuggestionRunner.scala:41-200+`,
`suggestions/rules/*.scala`), ported from the JAX package's
``deequ_tpu/suggestions``.

The profile of the training split and the held-out verification of the
suggested check both run on ``device`` (``cuda`` unless the caller names
another); the rules themselves are host code.
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

from ..config import DeviceLike, resolve_device
from ..profiles import ColumnProfile
from .rules import (  # noqa: F401
    DEFAULT_RULES,
    CategoricalRangeRule,
    CompleteIfCompleteRule,
    ConstraintRule,
    ConstraintSuggestion,
    FractionalCategoricalRangeRule,
    NonNegativeNumbersRule,
    RetainCompletenessRule,
    RetainTypeRule,
    UniqueIfApproximatelyUniqueRule,
)


class Rules:
    """(reference `ConstraintSuggestionRunner.scala:30-36`)."""

    DEFAULT = DEFAULT_RULES


@dataclass
class ConstraintSuggestionResult:
    """(reference `suggestions/ConstraintSuggestionResult.scala:32-59`)."""

    column_profiles: Dict[str, ColumnProfile]
    num_records: int
    constraint_suggestions: Dict[str, List[ConstraintSuggestion]]
    verification_result: Optional[object] = None

    @property
    def all_suggestions(self) -> List[ConstraintSuggestion]:
        return [s for group in self.constraint_suggestions.values() for s in group]

    def to_json(self) -> str:
        return json.dumps(
            {
                "constraint_suggestions": [
                    {
                        "constraint_name": str(s.constraint),
                        "column_name": s.column_name,
                        "current_value": s.current_value,
                        "description": s.description,
                        "suggesting_rule": type(s.suggesting_rule).__name__,
                        "rule_description": s.suggesting_rule.rule_description,
                        "code_for_constraint": s.code_for_constraint,
                    }
                    for s in self.all_suggestions
                ]
            },
            indent=2,
        )


def apply_rules(profiles, constraint_rules) -> ConstraintSuggestionResult:
    """Rule application alone: profiles in, suggestions out, each
    profile's suggestions together and in rule order."""
    suggestions: List[ConstraintSuggestion] = []
    for profile in profiles.profiles.values():
        for rule in constraint_rules:
            if rule.should_be_applied(profile, profiles.num_records):
                suggestions.append(rule.candidate(profile, profiles.num_records))
    by_column: Dict[str, List[ConstraintSuggestion]] = {}
    for s in suggestions:
        by_column.setdefault(s.column_name, []).append(s)
    return ConstraintSuggestionResult(profiles.profiles, profiles.num_records, by_column)


class ConstraintSuggestionRunner:
    @staticmethod
    def on_data(data, device: DeviceLike = None) -> "ConstraintSuggestionRunBuilder":
        return ConstraintSuggestionRunBuilder(data, device=device)

    @staticmethod
    def run(
        data,
        constraint_rules: Sequence[ConstraintRule],
        restrict_to_columns: Optional[Sequence[str]] = None,
        low_cardinality_histogram_threshold: int = 120,
        print_status_updates: bool = False,
        testset_ratio: Optional[float] = None,
        testset_split_random_seed: Optional[int] = None,
        metrics_repository=None,
        reuse_existing_results_key=None,
        fail_if_results_for_reusing_missing: bool = False,
        save_or_append_results_key=None,
        kll_parameters=None,
        predefined_types: Optional[Dict[str, str]] = None,
        suggestions_path: Optional[str] = None,
        evaluation_path: Optional[str] = None,
        profiles_path: Optional[str] = None,
        batch_size: Optional[int] = None,
        device: DeviceLike = None,
        monitor=None,
    ) -> ConstraintSuggestionResult:
        """Profile the training split on ``device``, apply the rules, and
        run the suggested check on the test split there too (reference
        `ConstraintSuggestionRunner.scala:41-200+`). ``monitor`` (a
        ``RunMonitor``) records every pass of both."""
        from .. import io as dio
        from ..profiles import ColumnProfiler

        dev = resolve_device(device)
        if testset_ratio is not None and not 0.0 < testset_ratio < 1.0:
            raise ValueError("Testset ratio must be in ]0, 1[")

        # train/test split (reference `splitTrainTestSets`)
        if testset_ratio is not None:
            seed = 0 if testset_split_random_seed is None else testset_split_random_seed
            training, test = data.random_split(1.0 - testset_ratio, seed=seed)
        else:
            training, test = data, None

        profiles = ColumnProfiler.profile(
            training,
            restrict_to_columns=restrict_to_columns,
            print_status_updates=print_status_updates,
            low_cardinality_histogram_threshold=low_cardinality_histogram_threshold,
            metrics_repository=metrics_repository,
            reuse_existing_results_using_key=reuse_existing_results_key,
            fail_if_results_for_reusing_missing=fail_if_results_for_reusing_missing,
            save_in_metrics_repository_using_key=save_or_append_results_key,
            kll_parameters=kll_parameters,
            predefined_types=predefined_types,
            batch_size=batch_size,
            monitor=monitor,
            device=dev,
        )

        # the flat list's order is all_suggestions' grouped order: each
        # profile's suggestions are contiguous
        result = apply_rules(profiles, constraint_rules)
        suggestions = result.all_suggestions

        if profiles_path is not None:
            dio.write_text_atomic(profiles_path, profiles.to_json())
        if suggestions_path is not None:
            dio.write_text_atomic(suggestions_path, result.to_json())

        # evaluate the suggested constraints on the test split
        # (reference `evaluateConstraintsIfNecessary`)
        if test is not None and suggestions:
            from ..checks import Check, CheckLevel
            from ..verification import VerificationSuite

            check = Check(CheckLevel.WARNING, "generated constraints")
            for s in suggestions:
                check = check.add_constraint(s.constraint)
            builder = VerificationSuite.on_data(test, device=dev).add_check(check)
            if monitor is not None:
                builder = builder.with_monitor(monitor)
            verification = builder.run()
            result.verification_result = verification
            if evaluation_path is not None:
                statuses = [
                    cr.status.value
                    for r in verification.check_results.values()
                    for cr in r.constraint_results
                ]
                payload = {
                    "constraint_suggestions": [
                        {
                            "constraint_name": str(s.constraint),
                            "column_name": s.column_name,
                            "code_for_constraint": s.code_for_constraint,
                            "constraint_result_on_test_set": status,
                        }
                        for s, status in zip(suggestions, statuses)
                    ]
                }
                dio.write_text_atomic(evaluation_path, json.dumps(payload, indent=2))
        return result


class ConstraintSuggestionRunBuilder:
    """(reference `suggestions/ConstraintSuggestionRunBuilder.scala`)."""

    def __init__(self, data, device: DeviceLike = None):
        self.data = data
        self.device = resolve_device(device)
        self._rules: List[ConstraintRule] = []
        self._columns: Optional[Sequence[str]] = None
        self._threshold = 120
        self._print_status = False
        self._testset_ratio: Optional[float] = None
        self._testset_seed: Optional[int] = None
        self._repository = None
        self._reuse_key = None
        self._fail_if_missing = False
        self._save_key = None
        self._kll_parameters = None
        self._predefined_types: Optional[Dict[str, str]] = None
        self._suggestions_path: Optional[str] = None
        self._evaluation_path: Optional[str] = None
        self._profiles_path: Optional[str] = None
        self._batch_size: Optional[int] = None
        self._monitor = None

    def add_constraint_rule(self, rule: ConstraintRule):
        self._rules.append(rule)
        return self

    def add_constraint_rules(self, rules: Sequence[ConstraintRule]):
        self._rules.extend(rules)
        return self

    def restrict_to_columns(self, columns: Sequence[str]):
        self._columns = columns
        return self

    def with_low_cardinality_histogram_threshold(self, threshold: int):
        self._threshold = threshold
        return self

    def print_status_updates(self):
        self._print_status = True
        return self

    def use_train_test_split_with_testset_ratio(
        self, testset_ratio: float, testset_split_random_seed: Optional[int] = None
    ):
        self._testset_ratio = testset_ratio
        self._testset_seed = testset_split_random_seed
        return self

    def use_repository(self, repository):
        self._repository = repository
        return self

    def reuse_existing_results_for_key(self, key, fail_if_results_missing: bool = False):
        self._reuse_key = key
        self._fail_if_missing = fail_if_results_missing
        return self

    def save_or_append_result(self, key):
        self._save_key = key
        return self

    def set_kll_parameters(self, parameters):
        self._kll_parameters = parameters
        return self

    def set_predefined_types(self, types: Dict[str, str]):
        self._predefined_types = types
        return self

    def save_constraint_suggestions_json_to_path(self, path: str):
        self._suggestions_path = path
        return self

    def save_evaluation_results_json_to_path(self, path: str):
        self._evaluation_path = path
        return self

    def save_column_profiles_json_to_path(self, path: str):
        self._profiles_path = path
        return self

    def with_batch_size(self, batch_size: int):
        self._batch_size = batch_size
        return self

    def with_monitor(self, monitor):
        """Record every pass of the profile and the held-out verification
        in ``monitor`` (a ``RunMonitor``)."""
        self._monitor = monitor
        return self

    def run(self) -> ConstraintSuggestionResult:
        return ConstraintSuggestionRunner.run(
            self.data,
            self._rules,
            restrict_to_columns=self._columns,
            low_cardinality_histogram_threshold=self._threshold,
            print_status_updates=self._print_status,
            testset_ratio=self._testset_ratio,
            testset_split_random_seed=self._testset_seed,
            metrics_repository=self._repository,
            reuse_existing_results_key=self._reuse_key,
            fail_if_results_for_reusing_missing=self._fail_if_missing,
            save_or_append_results_key=self._save_key,
            kll_parameters=self._kll_parameters,
            predefined_types=self._predefined_types,
            suggestions_path=self._suggestions_path,
            evaluation_path=self._evaluation_path,
            profiles_path=self._profiles_path,
            batch_size=self._batch_size,
            device=self.device,
            monitor=self._monitor,
        )
