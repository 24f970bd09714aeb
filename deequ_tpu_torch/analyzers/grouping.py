"""Frequency/grouping analyzers over dictionary-encoded columns.

The reference computes one `GROUP BY` per distinct grouping-column set and
shares the resulting frequency table between all analyzers on that set
(reference `analyzers/GroupingAnalyzers.scala:29-157`, scheduler sharing at
`analyzers/runners/AnalysisRunner.scala:259-287`). Here a single
dictionary-encoded grouping column is counted ON DEVICE in the same pass as
every other analyzer: the ``dict_code_counts`` kernel counts the batch's
codes (:class:`DeviceFrequencyScan`), and the counts become the shared
:class:`FrequenciesAndNumRows` table every grouping metric reads.

State semantics (verified against the reference):
- frequencies exclude rows where the grouping column is null;
- ``num_rows`` counts ALL rows (`FrequencyBasedAnalyzer.computeFrequencies`,
  `GroupingAnalyzers.scala:53-80`: numRows = data.count());
- merge = outer join adding counts (`GroupingAnalyzers.scala:128-148`).
"""

from __future__ import annotations

import abc
import math
from dataclasses import dataclass, field
from typing import Callable, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import pandas as pd

from ..data import Schema
from ..exceptions import EmptyStateException, IllegalAnalyzerParameterException, wrap_if_necessary
from ..kernels.dict_code_counts import dict_code_counts
from ..metrics import (
    Distribution,
    DistributionValue,
    DoubleMetric,
    Entity,
    Failure,
    HistogramMetric,
    Success,
    metric_from_empty,
    metric_from_failure,
    metric_from_value,
)
from .base import (
    Analyzer,
    Preconditions,
    ScanShareableAnalyzer,
    codes_feature,
    mask_feature,
    rows_feature,
)
from .states import FrequencyCountsState


class FrequenciesAndNumRows:
    """Host state: group -> count plus total row count
    (reference `GroupingAnalyzers.scala:128-157`), the metric side of the
    reference's accumulator: built once per run from the device counts."""

    def __init__(self, frequencies: pd.Series, num_rows: int, group_columns: Sequence[str]):
        self.frequencies = frequencies  # index = group keys
        self.num_rows = int(num_rows)
        self.group_columns = list(group_columns)
        self._summary: Optional[Tuple[int, int, int, float]] = None

    def iter_merged_chunks(self) -> Iterator[pd.Series]:
        """Yield the count table (one chunk; the protocol of the
        reference's spilling accumulator)."""
        if len(self.frequencies):
            yield self.frequencies

    def num_distinct(self) -> int:
        return len(self.frequencies)

    def stream_summary(self) -> Tuple[int, int, int, float]:
        """(num_distinct, singleton_count, sum(count), sum(count*ln(count))),
        cached — every scalar frequency reduction (Uniqueness,
        Distinctness, UniqueValueRatio, CountDistinct, Entropy) reads these."""
        if self._summary is None:
            c = self.frequencies.to_numpy(dtype=np.int64)
            self._summary = (
                len(c), int((c == 1).sum()), int(c.sum()), _sum_c_ln_c(c)
            )
        return self._summary

    def is_empty(self) -> bool:
        return len(self.frequencies) == 0

    def sum(self, other: "FrequenciesAndNumRows") -> "FrequenciesAndNumRows":
        merged = _add_series(self.frequencies, other.frequencies)
        return FrequenciesAndNumRows(merged, self.num_rows + other.num_rows, self.group_columns)

    @staticmethod
    def empty(group_columns: Sequence[str]) -> "FrequenciesAndNumRows":
        return FrequenciesAndNumRows(pd.Series([], dtype=np.int64), 0, group_columns)


def _with_null_bin(counts: pd.Series, num_null: int) -> pd.Series:
    """Add the NullValue bin (reference `analyzers/Histogram.scala:108`:
    nulls count under the "NullValue" key)."""
    if not num_null:
        return counts
    return counts.add(
        pd.Series({NULL_FIELD_REPLACEMENT: num_null}), fill_value=0
    ).astype(np.int64)


def _sum_c_ln_c(counts: np.ndarray) -> float:
    """sum(count * ln(count)) over a count multiset in CANONICAL order: the
    count-of-counts histogram reduced in ascending count value, a pure
    function of the multiset (the reference package's Entropy reduces the
    same way, so the two agree bit for bit)."""
    counts = np.asarray(counts, dtype=np.int64)
    uc, mult = np.unique(counts[counts > 0], return_counts=True)
    pos = uc.astype(np.float64)
    return float((mult.astype(np.float64) * (pos * np.log(pos))).sum())


def _add_series(a: pd.Series, b: pd.Series) -> pd.Series:
    """Outer-join add of two count series; tolerates empty operands."""
    if len(a) == 0:
        return b.astype(np.int64)
    if len(b) == 0:
        return a.astype(np.int64)
    return a.add(b, fill_value=0).astype(np.int64)


@dataclass(frozen=True)
class DeviceFrequencyScan(ScanShareableAnalyzer):
    """Frequency table of one dictionary-encoded column computed ON DEVICE:
    the ``dict_code_counts`` kernel counts each batch's codes in the fused
    pass (the reference instead runs a Spark groupBy shuffle per set,
    `GroupingAnalyzers.scala:53-80`).

    Runner-internal: `AnalysisRunner` instantiates it for dictionary-encoded
    grouping columns and converts the state back into FrequenciesAndNumRows,
    so every grouping analyzer's metric code sees one state type."""

    column: str = ""
    num_categories: int = 0
    name: str = field(default="DeviceFrequencyScan", init=False)

    @property
    def instance(self) -> str:
        return self.column

    def feature_specs(self):
        return [rows_feature(), mask_feature(self.column), codes_feature(self.column)]

    def init_state(self, device) -> FrequencyCountsState:
        return FrequencyCountsState.init(self.num_categories, device)

    def update(self, state: FrequencyCountsState, features) -> FrequencyCountsState:
        # masked rows and the null/padding code K are dropped by the kernel;
        # num_rows counts every valid row
        counts, num_rows = dict_code_counts(
            features[codes_feature(self.column).key],
            features["rows"],
            features[mask_feature(self.column).key],
            self.num_categories,
        )
        return FrequencyCountsState(state.counts + counts, state.num_rows + num_rows)

    def merge(self, a, b):
        return a.merge(b)

    def to_frequencies(self, state, dictionary: np.ndarray) -> FrequenciesAndNumRows:
        counts = state.counts.cpu().numpy()
        nz = counts > 0
        series = pd.Series(
            counts[nz].astype(np.int64), index=pd.Index(np.asarray(dictionary)[nz])
        )
        return FrequenciesAndNumRows(series, int(state.num_rows), [self.column])

    def compute_metric_from(self, state):  # pragma: no cover - runner-internal
        raise NotImplementedError(
            "DeviceFrequencyScan states convert via to_frequencies; the "
            "grouping analyzers sharing the set own the metrics"
        )


class GroupingAnalyzer(Analyzer[FrequenciesAndNumRows, DoubleMetric]):
    """Analyzer computed from a shared frequency table."""

    columns: Sequence[str]

    def grouping_columns(self) -> List[str]:
        return list(self.columns)

    @property
    def instance(self) -> str:
        return ",".join(self.grouping_columns())

    @property
    def entity(self) -> Entity:
        return Entity.COLUMN if len(self.grouping_columns()) == 1 else Entity.MULTICOLUMN

    def preconditions(self) -> List[Callable[[Schema], None]]:
        cols = self.grouping_columns()
        out: List[Callable[[Schema], None]] = [Preconditions.at_least_one(cols)]
        for c in cols:
            out.append(Preconditions.has_column(c))
            out.append(Preconditions.is_not_nested(c))
        return out

    def merge(self, a: FrequenciesAndNumRows, b: FrequenciesAndNumRows) -> FrequenciesAndNumRows:
        return a.sum(b)


class ScanShareableFrequencyBasedAnalyzer(GroupingAnalyzer):
    """Base for analyzers that reduce the frequency table to a double
    (reference `GroupingAnalyzers.scala:85-123`)."""

    #: an EMPTY frequency table (e.g. every grouping value null) yields an
    #: empty metric: the reference's SUM aggregation over an empty relation
    #: returns null -> EmptyStateException (`NullHandlingTests.scala`).
    #: CountDistinct overrides this — COUNT over an empty relation is 0.
    empty_frequencies_are_empty_metric: bool = True

    def compute_metric_from(self, state: Optional[FrequenciesAndNumRows]) -> DoubleMetric:
        if state is None:
            return metric_from_empty(self.name, self.instance, self.entity)
        if self.empty_frequencies_are_empty_metric and state.is_empty():
            return metric_from_empty(self.name, self.instance, self.entity)
        try:
            value = self.metric_from_frequencies(state)
        except Exception as exc:  # noqa: BLE001
            return metric_from_failure(wrap_if_necessary(exc), self.name, self.instance, self.entity)
        if value is None or (isinstance(value, float) and math.isnan(value)):
            return metric_from_empty(self.name, self.instance, self.entity)
        return metric_from_value(float(value), self.name, self.instance, self.entity)

    @abc.abstractmethod
    def metric_from_frequencies(self, state: FrequenciesAndNumRows) -> float:
        ...


@dataclass(frozen=True)
class Uniqueness(ScanShareableFrequencyBasedAnalyzer):
    """Fraction of rows whose group occurs exactly once: sum(count==1)/numRows
    (reference `analyzers/Uniqueness.scala:26-38`)."""

    columns: Tuple[str, ...] = ()
    name: str = field(default="Uniqueness", init=False)

    def __init__(self, columns):
        object.__setattr__(self, "columns", _as_tuple(columns))

    def metric_from_frequencies(self, state: FrequenciesAndNumRows) -> float:
        if state.num_rows == 0:
            return float("nan")
        return float(state.stream_summary()[1]) / state.num_rows


@dataclass(frozen=True)
class Distinctness(ScanShareableFrequencyBasedAnalyzer):
    """Fraction of distinct groups over rows: sum(count>=1)/numRows
    (reference `analyzers/Distinctness.scala:29-41`)."""

    columns: Tuple[str, ...] = ()
    name: str = field(default="Distinctness", init=False)

    def __init__(self, columns):
        object.__setattr__(self, "columns", _as_tuple(columns))

    def metric_from_frequencies(self, state: FrequenciesAndNumRows) -> float:
        if state.num_rows == 0:
            return float("nan")
        return float(state.num_distinct()) / state.num_rows


@dataclass(frozen=True)
class UniqueValueRatio(ScanShareableFrequencyBasedAnalyzer):
    """sum(count==1) / number of distinct groups
    (reference `analyzers/UniqueValueRatio.scala:25-44`)."""

    columns: Tuple[str, ...] = ()
    name: str = field(default="UniqueValueRatio", init=False)

    def __init__(self, columns):
        object.__setattr__(self, "columns", _as_tuple(columns))

    def metric_from_frequencies(self, state: FrequenciesAndNumRows) -> float:
        num_groups, singletons, _, _ = state.stream_summary()
        if num_groups == 0:
            return float("nan")
        return float(singletons) / num_groups


@dataclass(frozen=True)
class CountDistinct(ScanShareableFrequencyBasedAnalyzer):
    """Number of distinct groups (reference `analyzers/CountDistinct.scala:24-40`)."""

    columns: Tuple[str, ...] = ()
    name: str = field(default="CountDistinct", init=False)
    empty_frequencies_are_empty_metric = False  # COUNT of no groups is 0.0

    def __init__(self, columns):
        object.__setattr__(self, "columns", _as_tuple(columns))

    def metric_from_frequencies(self, state: FrequenciesAndNumRows) -> float:
        return float(state.num_distinct())


@dataclass(frozen=True)
class Entropy(ScanShareableFrequencyBasedAnalyzer):
    """Shannon entropy over the value distribution, with N = total row count:
    -sum (c/N) ln(c/N) (reference `analyzers/Entropy.scala:28-42`)."""

    columns: Tuple[str, ...] = ()
    name: str = field(default="Entropy", init=False)

    def __init__(self, column):
        object.__setattr__(self, "columns", _as_tuple(column))

    def metric_from_frequencies(self, state: FrequenciesAndNumRows) -> float:
        n = state.num_rows
        if n == 0:
            return float("nan")
        # -sum (c/n) ln(c/n) = ln(n) * sum(c)/n - sum(c ln c)/n
        _, _, total, c_ln_c = state.stream_summary()
        return float(math.log(n) * total / n - c_ln_c / n)


def _as_tuple(columns) -> Tuple[str, ...]:
    if isinstance(columns, str):
        return (columns,)
    return tuple(columns)


def _java_double_to_string(x: float) -> str:
    """Java ``Double.toString`` semantics: shortest round-trip digits,
    plain decimal for 1e-3 <= |x| < 1e7, otherwise computerized scientific
    notation ``d.dddEn`` (no '+', no leading exponent zeros). Spark's
    cast-to-string on DoubleType delegates to this, so Histogram bin keys
    must match it exactly (e.g. 1e7 keys as '1.0E7', not '10000000.0')."""
    if math.isnan(x):
        return "NaN"
    if math.isinf(x):
        return "Infinity" if x > 0 else "-Infinity"
    if x == 0.0:
        return "-0.0" if math.copysign(1.0, x) < 0 else "0.0"
    sign = "-" if x < 0 else ""
    a = abs(x)
    if 1e-3 <= a < 1e7:
        # Python repr is also shortest-round-trip and stays in plain
        # decimal over exactly this range
        return sign + repr(a)
    # normalize shortest-round-trip digits to d.ddd * 10^dec_exp
    r = repr(a)
    if "e" in r:
        mant, _, exp_s = r.partition("e")
        digits = mant.replace(".", "")
        dec_exp = int(exp_s)
    else:
        int_part, _, frac = r.partition(".")
        if int_part != "0":
            digits = (int_part + frac).lstrip("0")
            dec_exp = len(int_part) - 1
        else:
            stripped = frac.lstrip("0")
            digits = stripped
            dec_exp = -(len(frac) - len(stripped) + 1)
    digits = digits.rstrip("0") or "0"
    mantissa = digits[0] + "." + (digits[1:] or "0")
    return f"{sign}{mantissa}E{dec_exp}"


def _spark_string_cast(value) -> str:
    """Format a value the way Spark's cast-to-string would (booleans
    lowercase, doubles via Java ``Double.toString``)."""
    if isinstance(value, (bool, np.bool_)):
        return "true" if value else "false"
    if isinstance(value, (float, np.floating)):
        return _java_double_to_string(float(value))
    if isinstance(value, (int, np.integer)):
        return str(int(value))
    return str(value)


def device_counts_to_histogram_frequencies(
    scan: DeviceFrequencyScan, state: FrequencyCountsState, dictionary: np.ndarray
) -> FrequenciesAndNumRows:
    """Device frequency counts -> the Histogram state shape: keys become
    their Spark string casts and null rows land in the NullValue bin."""
    counts = state.counts.cpu().numpy()
    nz = np.flatnonzero(counts)
    keys = [_spark_string_cast(v) for v in np.asarray(dictionary)[nz]]
    series = pd.Series(counts[nz].astype(np.int64), index=keys)
    if series.index.has_duplicates:
        series = series.groupby(level=0, sort=False).sum()
    num_rows = int(state.num_rows)
    series = _with_null_bin(series, num_rows - int(counts.sum()))
    return FrequenciesAndNumRows(series.astype(np.int64), num_rows, [scan.column])


NULL_FIELD_REPLACEMENT = "NullValue"  # reference `analyzers/Histogram.scala:108`
MAXIMUM_ALLOWED_DETAIL_BINS = 1000  # reference `analyzers/Histogram.scala:109`


@dataclass(frozen=True)
class Histogram(Analyzer[FrequenciesAndNumRows, HistogramMetric]):
    """Exact value histogram of one dictionary-encoded column: values cast
    to string, nulls replaced by "NullValue", top-K detail bins by count
    (reference `analyzers/Histogram.scala:41-116`, without its binning
    function). Its counts come from the device frequency scan."""

    column: str = ""
    max_detail_bins: int = MAXIMUM_ALLOWED_DETAIL_BINS
    name: str = field(default="Histogram", init=False)

    @property
    def instance(self) -> str:
        return self.column

    @property
    def entity(self) -> Entity:
        return Entity.COLUMN

    def preconditions(self) -> List[Callable[[Schema], None]]:
        def param_check(schema: Schema) -> None:
            if self.max_detail_bins > MAXIMUM_ALLOWED_DETAIL_BINS:
                raise IllegalAnalyzerParameterException(
                    f"Cannot return histogram values for more than "
                    f"{MAXIMUM_ALLOWED_DETAIL_BINS} values"
                )

        return [param_check, Preconditions.has_column(self.column)]

    def merge(self, a: FrequenciesAndNumRows, b: FrequenciesAndNumRows) -> FrequenciesAndNumRows:
        return a.sum(b)

    def compute_metric_from(self, state: Optional[FrequenciesAndNumRows]) -> HistogramMetric:
        if state is None:
            return HistogramMetric(
                self.entity,
                self.name,
                self.instance,
                Failure(EmptyStateException(f"Empty state for analyzer {self}")),
                self.column,
            )
        try:
            top = state.frequencies.nlargest(self.max_detail_bins)
            values = {
                str(k): DistributionValue(int(v), int(v) / state.num_rows)
                for k, v in top.items()
            }
            dist = Distribution(values, number_of_bins=state.num_distinct())
            return HistogramMetric(self.entity, self.name, self.instance, Success(dist), self.column)
        except Exception as exc:  # noqa: BLE001
            return HistogramMetric(
                self.entity, self.name, self.instance, Failure(wrap_if_necessary(exc)), self.column
            )
