"""Scan-shareable single-pass reduction analyzers.

Each mirrors an analyzer of the JAX reference (deequ_tpu/analyzers/
simple.py, with the reference deequ's file:line cited per class). Every
update here is a scalar reduction (DataType's is five counts): the analyzer
names its reduction as a
``scan_reduce`` slot (``scan_slot``) and folds the slot's batch partials
into its state (``fold_slot``), so the engine serves a whole battery with
one kernel launch per batch — the analog of deequ's fused ``data.agg(...)``
scan (reference `analyzers/runners/AnalysisRunner.scala:303-318`).

On the host ingest tier each analyzer's ``host_partial`` computes the
batch's partial state on the host from the native library's shared block
passes (``HostBatchContext``), as the reference's do (simple.py:122-740).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, List, Optional

import numpy as np
import torch

from ..data import Schema
from ..expr import Predicate
from ..kernels.scan_reduce import (
    KIND_CLASSES,
    KIND_COMOMENTS,
    KIND_COUNTS,
    KIND_MOMENTS,
    Partials,
    comoments,
)
from ..metrics import (
    Distribution,
    DistributionValue,
    Entity,
    HistogramMetric,
    Success,
    metric_from_empty,
)
from .base import (
    FeatureSpec,
    HostBatchContext,
    Preconditions,
    ScanShareableAnalyzer,
    SlotSpec,
    StandardScanShareableAnalyzer,
    host_acc,
    host_count,
    length_feature,
    mask_feature,
    numeric_feature,
    predicate_feature,
    regex_feature,
    rows_feature,
    typeclass_feature,
)
from .states import (
    CorrelationState,
    DataTypeHistogram,
    MaxState,
    MeanState,
    MinState,
    NumMatches,
    NumMatchesAndCount,
    StandardDeviationState,
    SumState,
    max_nan,
    min_nan_largest,
)


def _with_where(specs: List[FeatureSpec], where: Optional[Predicate]) -> List[FeatureSpec]:
    if where is not None:
        specs.append(predicate_feature(where))
    return specs


@dataclass(frozen=True)
class Size(StandardScanShareableAnalyzer[NumMatches]):
    """Row count (reference `analyzers/Size.scala:23-48`)."""

    where: Optional[Predicate] = None
    name: str = field(default="Size", init=False)

    def feature_specs(self) -> List[FeatureSpec]:
        return _with_where([rows_feature()], self.where)

    def init_state(self, device) -> NumMatches:
        return NumMatches.init(device)

    def scan_slot(self) -> SlotSpec:
        return (KIND_COUNTS, self._where_key(), None, None)

    def fold_slot(self, state: NumMatches, p: Partials) -> NumMatches:
        return NumMatches(state.num_matches + p.count)

    supports_host_partial = True

    def host_partial(self, ctx: HostBatchContext) -> NumMatches:
        return NumMatches(host_count(np.count_nonzero(ctx.row_mask(self))))

    def merge(self, a: NumMatches, b: NumMatches) -> NumMatches:
        return a.merge(b)

    def metric_value(self, state: NumMatches) -> float:
        return state.metric_value()


@dataclass(frozen=True)
class _RatioAnalyzer(StandardScanShareableAnalyzer[NumMatchesAndCount]):
    """Shared logic for matches/count analyzers: the slot selects the
    matching rows among the (where-filtered) counted rows."""

    def init_state(self, device) -> NumMatchesAndCount:
        return NumMatchesAndCount.init(device)

    def _match_key(self) -> str:
        raise NotImplementedError

    def scan_slot(self) -> SlotSpec:
        return (KIND_COUNTS, self._where_key(), self._match_key(), None)

    def fold_slot(self, state: NumMatchesAndCount, p: Partials) -> NumMatchesAndCount:
        return NumMatchesAndCount(state.num_matches + p.matches, state.count + p.count)

    supports_host_partial = True

    def host_partial(self, ctx: HostBatchContext) -> NumMatchesAndCount:
        rows = ctx.row_mask(self)
        return NumMatchesAndCount(
            host_count(np.count_nonzero(rows & self._host_matches(ctx))),
            host_count(np.count_nonzero(rows)),
        )

    def _host_matches(self, ctx: HostBatchContext) -> np.ndarray:
        raise NotImplementedError

    def merge(self, a: NumMatchesAndCount, b: NumMatchesAndCount) -> NumMatchesAndCount:
        return a.merge(b)

    def metric_value(self, state: NumMatchesAndCount) -> float:
        return state.metric_value()

    def is_empty(self, state: NumMatchesAndCount) -> bool:
        return int(state.count) == 0


@dataclass(frozen=True)
class Completeness(_RatioAnalyzer):
    """Fraction of non-null values (reference `analyzers/Completeness.scala:26-46`)."""

    column: str = ""
    where: Optional[Predicate] = None
    name: str = field(default="Completeness", init=False)

    @property
    def instance(self) -> str:
        return self.column

    @property
    def entity(self) -> Entity:
        return Entity.COLUMN

    def preconditions(self) -> List[Callable[[Schema], None]]:
        return [Preconditions.has_column(self.column), Preconditions.is_not_nested(self.column)]

    def feature_specs(self) -> List[FeatureSpec]:
        return _with_where([rows_feature(), mask_feature(self.column)], self.where)

    def _match_key(self) -> str:
        return mask_feature(self.column).key

    def _host_matches(self, ctx: HostBatchContext) -> np.ndarray:
        return ctx.batch.column(self.column).mask


@dataclass(frozen=True)
class Compliance(_RatioAnalyzer):
    """Fraction of rows satisfying a predicate
    (reference `analyzers/Compliance.scala:37-53`). Null predicate results
    count as non-compliant but stay in the denominator (SQL semantics)."""

    instance_name: str = ""
    predicate: Predicate = "True"
    where: Optional[Predicate] = None
    name: str = field(default="Compliance", init=False)

    @property
    def instance(self) -> str:
        return self.instance_name

    @property
    def entity(self) -> Entity:
        return Entity.COLUMN

    def feature_specs(self) -> List[FeatureSpec]:
        return _with_where([rows_feature(), predicate_feature(self.predicate)], self.where)

    def _match_key(self) -> str:
        return predicate_feature(self.predicate).key

    def _host_matches(self, ctx: HostBatchContext) -> np.ndarray:
        return ctx.pred_mask(self.predicate)


class Patterns:
    """Built-in regexes (reference `analyzers/PatternMatch.scala:58-72`)."""

    EMAIL = (
        r"""(?:[a-z0-9!#$%&'*+/=?^_`{|}~-]+(?:\.[a-z0-9!#$%&'*+/=?^_`{|}~-]+)*"""
        r"""|"(?:[\x01-\x08\x0b\x0c\x0e-\x1f\x21\x23-\x5b\x5d-\x7f]|\\[\x01-\x09\x0b\x0c\x0e-\x7f])*")"""
        r"""@(?:(?:[a-z0-9](?:[a-z0-9-]*[a-z0-9])?\.)+[a-z0-9](?:[a-z0-9-]*[a-z0-9])?"""
        r"""|\[(?:(?:25[0-5]|2[0-4][0-9]|[01]?[0-9][0-9]?)\.){3}"""
        r"""(?:25[0-5]|2[0-4][0-9]|[01]?[0-9][0-9]?|[a-z0-9-]*[a-z0-9]:"""
        r"""(?:[\x01-\x08\x0b\x0c\x0e-\x1f\x21-\x5a\x53-\x7f]|\\[\x01-\x09\x0b\x0c\x0e-\x7f])+)\])"""
    )
    URL = r"""(https?|ftp)://[^\s/$.?#].[^\s]*"""
    SOCIAL_SECURITY_NUMBER_US = (
        r"""((?!219-09-9999|078-05-1120)(?!666|000|9\d{2})\d{3}-(?!00)\d{2}-(?!0{4})\d{4})"""
        r"""|((?!219 09 9999|078 05 1120)(?!666|000|9\d{2})\d{3} (?!00)\d{2} (?!0{4})\d{4})"""
        r"""|((?!219099999|078051120)(?!666|000|9\d{2})\d{3}(?!00)\d{2}(?!0{4})\d{4})"""
    )
    CREDITCARD = (
        r"""\b(?:3[47]\d{2}([\ \-]?)\d{6}\1\d|(?:(?:4\d|5[1-5]|65)\d{2}|6011)([\ \-]?)\d{4}\2\d{4}\2)\d{4}\b"""
    )


@dataclass(frozen=True)
class PatternMatch(_RatioAnalyzer):
    """Fraction of values matching a regex, unanchored search; nulls stay in
    the denominator (reference `analyzers/PatternMatch.scala:37-55`)."""

    column: str = ""
    pattern: str = ""
    where: Optional[Predicate] = None
    name: str = field(default="PatternMatch", init=False)

    @property
    def instance(self) -> str:
        return self.column

    @property
    def entity(self) -> Entity:
        return Entity.COLUMN

    def preconditions(self) -> List[Callable[[Schema], None]]:
        return [Preconditions.has_column(self.column), Preconditions.is_string(self.column)]

    def feature_specs(self) -> List[FeatureSpec]:
        return _with_where(
            [rows_feature(), regex_feature(self.column, self.pattern)], self.where
        )

    def _match_key(self) -> str:
        return regex_feature(self.column, self.pattern).key

    def _host_matches(self, ctx: HostBatchContext) -> np.ndarray:
        from ..runners.features import column_regex_matches

        return column_regex_matches(ctx.batch.column(self.column), self.pattern)


@dataclass(frozen=True)
class _ValueAnalyzer(StandardScanShareableAnalyzer):
    """Shared plumbing of reductions over one column's present values: the
    slot selects present rows among the (where-filtered) counted rows and
    reduces their values."""

    column: str = ""
    where: Optional[Predicate] = None

    @property
    def instance(self) -> str:
        return self.column

    @property
    def entity(self) -> Entity:
        return Entity.COLUMN

    def _value_feature(self) -> FeatureSpec:
        raise NotImplementedError

    def feature_specs(self) -> List[FeatureSpec]:
        return _with_where(
            [rows_feature(), self._value_feature(), mask_feature(self.column)], self.where
        )

    def scan_slot(self) -> SlotSpec:
        return (
            KIND_MOMENTS, self._where_key(), mask_feature(self.column).key,
            self._value_feature().key,
        )

    def merge(self, a, b):
        return a.merge(b)

    def metric_value(self, state) -> float:
        return state.metric_value()

    def is_empty(self, state) -> bool:
        return int(state.count) == 0


@dataclass(frozen=True)
class _NumericColumnAnalyzer(_ValueAnalyzer):
    """Single numeric-column reductions."""

    def preconditions(self) -> List[Callable[[Schema], None]]:
        return [Preconditions.has_column(self.column), Preconditions.is_numeric(self.column)]

    def _value_feature(self) -> FeatureSpec:
        return numeric_feature(self.column)


@dataclass(frozen=True)
class Mean(_NumericColumnAnalyzer):
    """(reference `analyzers/Mean.scala:25-54`)."""

    name: str = field(default="Mean", init=False)

    def init_state(self, device) -> MeanState:
        return MeanState.init(device)

    def fold_slot(self, state: MeanState, p: Partials) -> MeanState:
        return MeanState(state.total + p.total, state.count + p.matches)

    supports_host_partial = True

    def host_partial(self, ctx: HostBatchContext) -> MeanState:
        count, total = ctx.block_stats(self, self.column)[:2]
        return MeanState(host_acc(total), host_count(count))


@dataclass(frozen=True)
class Sum(_NumericColumnAnalyzer):
    """(reference `analyzers/Sum.scala:25-52`)."""

    name: str = field(default="Sum", init=False)

    def init_state(self, device) -> SumState:
        return SumState.init(device)

    def fold_slot(self, state: SumState, p: Partials) -> SumState:
        return SumState(state.total + p.total, state.count + p.matches)

    supports_host_partial = True

    def host_partial(self, ctx: HostBatchContext) -> SumState:
        count, total = ctx.block_stats(self, self.column)[:2]
        return SumState(host_acc(total), host_count(count))


@dataclass(frozen=True)
class Minimum(_NumericColumnAnalyzer):
    """NaN-largest order: NaN values never win, and a min over only NaNs is
    NaN (reference `analyzers/Minimum.scala:25-53`)."""

    name: str = field(default="Minimum", init=False)

    def init_state(self, device) -> MinState:
        return MinState.init(device)

    def fold_slot(self, state: MinState, p: Partials) -> MinState:
        return MinState(min_nan_largest(state.min_value, p.min), state.count + p.matches)

    supports_host_partial = True

    def host_partial(self, ctx: HostBatchContext) -> MinState:
        stats = ctx.block_stats(self, self.column)
        # the native min is NaN when the block holds no non-NaN value: the
        # identity of MinState
        return MinState(host_acc(stats[2]), host_count(stats[0]))


@dataclass(frozen=True)
class Maximum(_NumericColumnAnalyzer):
    """Any valid NaN wins the max (reference `analyzers/Maximum.scala:25-53`)."""

    name: str = field(default="Maximum", init=False)

    def init_state(self, device) -> MaxState:
        return MaxState.init(device)

    def fold_slot(self, state: MaxState, p: Partials) -> MaxState:
        return MaxState(max_nan(state.max_value, p.max), state.count + p.matches)

    supports_host_partial = True

    def host_partial(self, ctx: HostBatchContext) -> MaxState:
        stats = ctx.block_stats(self, self.column)
        count = stats[0]
        return MaxState(host_acc(stats[3] if count > 0 else -np.inf), host_count(count))


@dataclass(frozen=True)
class _LengthAnalyzer(_ValueAnalyzer):
    def preconditions(self) -> List[Callable[[Schema], None]]:
        return [Preconditions.has_column(self.column), Preconditions.is_string(self.column)]

    def _value_feature(self) -> FeatureSpec:
        return length_feature(self.column)


@dataclass(frozen=True)
class MinLength(_LengthAnalyzer):
    """Min string length, nulls ignored (reference `analyzers/MinLength.scala:25-41`)."""

    name: str = field(default="MinLength", init=False)

    def init_state(self, device) -> MinState:
        return MinState.init(device)

    def fold_slot(self, state: MinState, p: Partials) -> MinState:
        return MinState(min_nan_largest(state.min_value, p.min), state.count + p.matches)

    supports_host_partial = True

    def host_partial(self, ctx: HostBatchContext) -> MinState:
        lengths = ctx.string_lengths(self.column)
        mask = ctx.column_mask(self, self.column)
        n = int(np.count_nonzero(mask))
        mn = float(lengths[mask].min()) if n else np.nan  # NaN: MinState's identity
        return MinState(host_acc(mn), host_count(n))


@dataclass(frozen=True)
class MaxLength(_LengthAnalyzer):
    """(reference `analyzers/MaxLength.scala:25-41`)."""

    name: str = field(default="MaxLength", init=False)

    def init_state(self, device) -> MaxState:
        return MaxState.init(device)

    def fold_slot(self, state: MaxState, p: Partials) -> MaxState:
        return MaxState(max_nan(state.max_value, p.max), state.count + p.matches)

    supports_host_partial = True

    def host_partial(self, ctx: HostBatchContext) -> MaxState:
        lengths = ctx.string_lengths(self.column)
        mask = ctx.column_mask(self, self.column)
        n = int(np.count_nonzero(mask))
        mx = float(lengths[mask].max()) if n else -np.inf
        return MaxState(host_acc(mx), host_count(n))


@dataclass(frozen=True)
class StandardDeviation(_NumericColumnAnalyzer):
    """Population stddev via Welford/Chan merges
    (reference `analyzers/StandardDeviation.scala:25-73`)."""

    name: str = field(default="StandardDeviation", init=False)

    def init_state(self, device) -> StandardDeviationState:
        return StandardDeviationState.init(device)

    def fold_slot(self, state: StandardDeviationState, p: Partials) -> StandardDeviationState:
        batch = StandardDeviationState(p.matches.to(state.n.dtype), p.mean, p.m2)
        return state.merge(batch)

    supports_host_partial = True

    def host_partial(self, ctx: HostBatchContext) -> StandardDeviationState:
        stats = ctx.block_stats(self, self.column)
        count, total, m2 = stats[0], stats[1], stats[4]
        avg = total / count if count > 0 else 0.0
        return StandardDeviationState(
            host_acc(count), host_acc(avg), host_acc(m2 if count > 0 else 0.0)
        )

    def is_empty(self, state) -> bool:
        return float(state.n) == 0


@dataclass(frozen=True)
class Correlation(StandardScanShareableAnalyzer[CorrelationState]):
    """Pearson correlation of two columns via mergeable co-moments
    (reference `analyzers/Correlation.scala:26-105`). Its batch update is a
    co-moment slot of ``scan_reduce`` over the rows where both columns are
    present."""

    first_column: str = ""
    second_column: str = ""
    where: Optional[Predicate] = None
    name: str = field(default="Correlation", init=False)

    @property
    def instance(self) -> str:
        return f"{self.first_column},{self.second_column}"

    @property
    def entity(self) -> Entity:
        return Entity.MULTICOLUMN

    def preconditions(self) -> List[Callable[[Schema], None]]:
        return [
            Preconditions.has_column(self.first_column),
            Preconditions.is_numeric(self.first_column),
            Preconditions.has_column(self.second_column),
            Preconditions.is_numeric(self.second_column),
        ]

    def feature_specs(self) -> List[FeatureSpec]:
        return _with_where([
            rows_feature(),
            numeric_feature(self.first_column),
            mask_feature(self.first_column),
            numeric_feature(self.second_column),
            mask_feature(self.second_column),
        ], self.where)

    def init_state(self, device) -> CorrelationState:
        return CorrelationState.init(device)

    def scan_slot(self) -> SlotSpec:
        return (
            KIND_COMOMENTS, self._where_key(), mask_feature(self.first_column).key,
            numeric_feature(self.first_column).key, numeric_feature(self.second_column).key,
            mask_feature(self.second_column).key,
        )

    def fold_slot(self, state: CorrelationState, p: Partials) -> CorrelationState:
        return state.merge(CorrelationState(*comoments(p)))

    supports_host_partial = True

    def host_partial(self, ctx: HostBatchContext) -> CorrelationState:
        from ..native import native_block_comoments

        cx = ctx.batch.column(self.first_column)
        cy = ctx.batch.column(self.second_column)
        mask = ctx.row_mask(self) & cx.mask & cy.mask
        vx = cx.values if np.issubdtype(cx.values.dtype, np.number) else cx.numeric_f64()
        vy = cy.values if np.issubdtype(cy.values.dtype, np.number) else cy.numeric_f64()
        n, xs, ys, ck, xmk, ymk = native_block_comoments(vx, vy, mask)
        xa = xs / n if n > 0 else 0.0
        ya = ys / n if n > 0 else 0.0
        return CorrelationState(*(host_acc(v) for v in (n, xa, ya, ck, xmk, ymk)))

    def merge(self, a, b):
        return a.merge(b)

    def metric_value(self, state) -> float:
        return state.metric_value()

    def is_empty(self, state) -> bool:
        return float(state.n) == 0


#: order of DataTypeHistogram buckets (reference `analyzers/DataType.scala:32-52`)
DATA_TYPE_INSTANCES = ("Unknown", "Fractional", "Integral", "Boolean", "String")


@dataclass(frozen=True)
class DataType(ScanShareableAnalyzer[DataTypeHistogram, HistogramMetric]):
    """Histogram of inferred value types. Classification per value follows the
    reference decision order null -> fractional -> integral -> boolean ->
    string with the reference regexes (reference
    `analyzers/catalyst/StatefulDataType.scala:36-38`, `analyzers/DataType.scala:32-183`).
    The host classifies (``runners/features.py``); the five class counts
    are a class-count slot of ``scan_reduce``."""

    column: str = ""
    where: Optional[Predicate] = None
    name: str = field(default="DataType", init=False)

    @property
    def instance(self) -> str:
        return self.column

    @property
    def entity(self) -> Entity:
        return Entity.COLUMN

    def preconditions(self) -> List[Callable[[Schema], None]]:
        return [Preconditions.has_column(self.column), Preconditions.is_not_nested(self.column)]

    def feature_specs(self) -> List[FeatureSpec]:
        return _with_where([rows_feature(), typeclass_feature(self.column)], self.where)

    def init_state(self, device) -> DataTypeHistogram:
        return DataTypeHistogram.init(device)

    def scan_slot(self) -> SlotSpec:
        return (KIND_CLASSES, self._where_key(), None, typeclass_feature(self.column).key)

    def fold_slot(self, state: DataTypeHistogram, p: Partials) -> DataTypeHistogram:
        return DataTypeHistogram(state.counts + p.classes)

    supports_host_partial = True

    def host_partial(self, ctx: HostBatchContext) -> DataTypeHistogram:
        from ..runners.features import TYPE_NULL, _is_string_dict, dict_entry_type_codes

        col = ctx.batch.column(self.column)
        if _is_string_dict(col) and self.where is None and ctx.row_mask_all():
            # a dictionary whose distinct values all classify alike (the
            # common shape of real string columns): the histogram is the
            # valid and null counts
            uniform = col.aux.get("tc_uniform")
            if uniform is None:
                tc = dict_entry_type_codes(col)
                uniform = int(tc[0]) if len(tc) and (tc == tc[0]).all() else -1
                col.aux["tc_uniform"] = uniform
            if uniform > TYPE_NULL:
                n = len(col.mask)
                n_valid = int(np.count_nonzero(col.mask))
                counts = np.zeros(5, dtype=np.int64)
                counts[uniform] = n_valid
                counts[TYPE_NULL] = n - n_valid
                return DataTypeHistogram(torch.from_numpy(counts))
            # the shared per-code counts through each entry's class: no
            # per-row classes at all; the last slot (null values) is
            # TYPE_NULL
            by_code = ctx.dict_code_counts(self.column)
            tc = dict_entry_type_codes(col)
            counts = np.bincount(
                tc, weights=by_code[: col.num_categories], minlength=5
            )[:5].astype(np.int64)
            counts[TYPE_NULL] += by_code[col.num_categories]
            return DataTypeHistogram(torch.from_numpy(counts))
        codes = ctx.type_codes(self.column)
        mask = ctx.row_mask(self)
        masked = codes if mask.all() else codes[mask]
        return DataTypeHistogram(torch.from_numpy(np.bincount(masked, minlength=5)[:5].astype(np.int64)))

    def merge(self, a, b):
        return a.merge(b)

    def compute_metric_from(self, state: Optional[DataTypeHistogram]) -> HistogramMetric:
        if state is None:
            empty = metric_from_empty(self.name, self.instance, self.entity)
            return HistogramMetric(self.entity, self.name, self.instance, empty.value, self.column)
        counts = np.asarray(state.counts.cpu())
        total = int(counts.sum())
        values = {
            DATA_TYPE_INSTANCES[i]: DistributionValue(
                int(counts[i]), (int(counts[i]) / total) if total > 0 else 0.0
            )
            for i in range(5)
        }
        dist = Distribution(values, number_of_bins=5)
        return HistogramMetric(self.entity, self.name, self.instance, Success(dist), self.column)
