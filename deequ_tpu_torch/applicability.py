"""Applicability checking: verify that a check / set of analyzers is
compatible with a schema BEFORE running on production data, by generating
random records matching the schema and executing against them
(reference `analyzers/applicability/Applicability.scala:162-273`).

The JAX package's module with the runs on ``device=``: the random rows are
the reference's (the same ``random.Random(seed)`` and ``default_rng(seed)``
draws in the same order), and the check or the analyzers run through the
port's verification suite or analysis runner on the device the caller
names (``cuda`` unless it passes another; without a card that raises).
"""

from __future__ import annotations

import random
import string
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

import numpy as np

from .analyzers import Analyzer
from .checks import Check
from .config import DeviceLike, resolve_device
from .constraints import Constraint
from .data import ColumnKind, ColumnSchema, Dataset, Schema

NUM_RECORDS = 1000  # reference `Applicability.scala:240`


def generate_random_data(schema: Schema, num_records: int = NUM_RECORDS, seed: int = 42) -> Dataset:
    """Random rows matching a schema; nullable columns get ~1% nulls
    (reference `Applicability.generateRandomData`, `:240-272`)."""
    rng = random.Random(seed)
    nprng = np.random.default_rng(seed)
    columns: Dict[str, list] = {}
    for cs in schema.columns:
        values: List = []
        for _ in range(num_records):
            if cs.nullable and rng.random() < 0.01:
                values.append(None)
            elif cs.kind == ColumnKind.INTEGRAL:
                values.append(int(nprng.integers(-(2**31), 2**31 - 1)))
            elif cs.kind == ColumnKind.FRACTIONAL:
                values.append(float(nprng.normal()))
            elif cs.kind == ColumnKind.BOOLEAN:
                values.append(bool(rng.random() < 0.5))
            elif cs.kind == ColumnKind.TIMESTAMP:
                values.append(np.datetime64("2020-01-01") + np.timedelta64(rng.randrange(10**6), "s"))
            else:
                values.append("".join(rng.choices(string.ascii_letters, k=rng.randrange(1, 20))))
        columns[cs.name] = values
    return Dataset.from_dict(columns)


@dataclass
class CheckApplicability:
    """(reference `Applicability.scala:44-56`)."""

    is_applicable: bool
    failures: Dict[str, Optional[BaseException]]
    constraint_applicabilities: Dict[Constraint, bool] = field(default_factory=dict)


@dataclass
class AnalyzersApplicability:
    is_applicable: bool
    failures: Dict[str, Optional[BaseException]]


class Applicability:
    @staticmethod
    def is_applicable_check(
        check: Check, schema: Schema, *, device: DeviceLike = None
    ) -> CheckApplicability:
        """Run the check against random data; a constraint is applicable if
        its metric computation did not fail (reference `Applicability.
        isApplicable(check, schema)`, `:162-199`)."""
        from .verification import VerificationSuite

        dev = resolve_device(device)
        data = generate_random_data(schema)
        result = VerificationSuite.do_verification_run(data, [check], device=dev)
        constraint_applicabilities: Dict[Constraint, bool] = {}
        failures: Dict[str, Optional[BaseException]] = {}
        for check_result in result.check_results.values():
            for cr in check_result.constraint_results:
                metric_failed = cr.metric is not None and cr.metric.value.is_failure
                missing = cr.metric is None
                applicable = not (metric_failed or missing)
                constraint_applicabilities[cr.constraint] = applicable
                if not applicable:
                    exc = (
                        cr.metric.value.exception
                        if cr.metric is not None and cr.metric.value.is_failure
                        else RuntimeError(cr.message or "missing metric")
                    )
                    # keyed by the CONSTRAINT's string, as the reference does
                    # (`Applicability.scala:176-177` maps
                    # `constraint.toString -> constraint`), so two failing
                    # constraints sharing one analyzer keep distinct entries;
                    # the reference returns a Seq and tolerates duplicate
                    # names — a dict needs a disambiguating suffix instead
                    name = str(cr.constraint)
                    if name in failures:
                        i = 2
                        while f"{name} #{i}" in failures:
                            i += 1
                        name = f"{name} #{i}"
                    failures[name] = exc
        return CheckApplicability(
            not failures, failures, constraint_applicabilities
        )

    @staticmethod
    def is_applicable_analyzers(
        analyzers: Sequence[Analyzer], schema: Schema, *, device: DeviceLike = None
    ) -> AnalyzersApplicability:
        """(reference `Applicability.isApplicable(analyzers, schema)`,
        `:201-238`)."""
        from .runners.analysis_runner import AnalysisRunner

        dev = resolve_device(device)
        data = generate_random_data(schema)
        context = AnalysisRunner.do_analysis_run(data, analyzers, device=dev)
        failures: Dict[str, Optional[BaseException]] = {}
        for analyzer, metric in context.metric_map.items():
            if metric.value.is_failure:
                failures[str(analyzer)] = metric.value.exception
        return AnalyzersApplicability(not failures, failures)
