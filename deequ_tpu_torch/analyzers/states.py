"""Analyzer states: dataclasses of tensors with a semigroup merge.

Each mirrors a state of the JAX reference (deequ_tpu/analyzers/states.py)
with the SAME class name and field order, so the reference's flattened
state leaves map one to one onto these fields (see ``convert.py``). Leaves
are 0-d or 1-d tensors on the run's device; ``merge`` is plain tensor
arithmetic on that device, and the metric helpers read host values.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass, field
from typing import List, Sequence

import numpy as np
import torch

from ..config import ACC_DTYPE, COUNT_DTYPE
from ..ops.kll import KLLSketchState  # noqa: F401 - the KLL analyzers' state
from ..ops.order import max_nan, min_nan_largest


def _f(x: float, device) -> torch.Tensor:
    return torch.tensor(x, dtype=ACC_DTYPE, device=device)


def _i(x: int, device) -> torch.Tensor:
    return torch.tensor(x, dtype=COUNT_DTYPE, device=device)


def tensor_fields(state) -> List[dataclasses.Field]:
    """The state's tensor fields in order. A field marked
    ``metadata={"static": True}`` (a sketch size, a constant) is
    configuration, not a leaf, as a non-pytree field is in the reference."""
    return [f for f in dataclasses.fields(state) if not f.metadata.get("static")]


def leaves(state) -> List[torch.Tensor]:
    """The state's tensors in field order (the reference's leaf order)."""
    return [getattr(state, f.name) for f in tensor_fields(state)]


def with_leaves(state, tensors: Sequence[torch.Tensor]):
    """A state of the same class and static fields with these tensors."""
    return dataclasses.replace(
        state, **{f.name: t for f, t in zip(tensor_fields(state), tensors)}
    )


@dataclass
class FrequencyCountsState:
    """Dense per-category counts for the device frequency path (dictionary-
    encoded grouping columns): counts[i] = rows whose code is i, plus the
    total row count the frequency semantics require (reference
    `GroupingAnalyzers.scala:53-80`: numRows counts ALL rows)."""

    counts: torch.Tensor    # int64[num_categories]
    num_rows: torch.Tensor  # int64

    @staticmethod
    def init(num_categories: int, device) -> "FrequencyCountsState":
        return FrequencyCountsState(
            torch.zeros(num_categories, dtype=COUNT_DTYPE, device=device), _i(0, device)
        )

    def merge(self, other: "FrequencyCountsState") -> "FrequencyCountsState":
        return FrequencyCountsState(
            self.counts + other.counts, self.num_rows + other.num_rows
        )


@dataclass
class NumMatches:
    """Row-count state (reference `analyzers/Size.scala:23-29`)."""

    num_matches: torch.Tensor

    @staticmethod
    def init(device) -> "NumMatches":
        return NumMatches(_i(0, device))

    def merge(self, other: "NumMatches") -> "NumMatches":
        return NumMatches(self.num_matches + other.num_matches)

    def metric_value(self) -> float:
        return float(self.num_matches)


@dataclass
class NumMatchesAndCount:
    """Ratio state (reference `analyzers/Analyzer.scala:438-449`)."""

    num_matches: torch.Tensor
    count: torch.Tensor

    @staticmethod
    def init(device) -> "NumMatchesAndCount":
        return NumMatchesAndCount(_i(0, device), _i(0, device))

    def merge(self, other: "NumMatchesAndCount") -> "NumMatchesAndCount":
        return NumMatchesAndCount(
            self.num_matches + other.num_matches, self.count + other.count
        )

    def metric_value(self) -> float:
        count = float(self.count)
        if count == 0:
            return float("nan")
        return float(self.num_matches) / count


@dataclass
class MeanState:
    """(sum, count) (reference `analyzers/Mean.scala:25-35`)."""

    total: torch.Tensor
    count: torch.Tensor

    @staticmethod
    def init(device) -> "MeanState":
        return MeanState(_f(0.0, device), _i(0, device))

    def merge(self, other: "MeanState") -> "MeanState":
        return MeanState(self.total + other.total, self.count + other.count)

    def metric_value(self) -> float:
        count = float(self.count)
        if count == 0:
            return float("nan")
        return float(self.total) / count


@dataclass
class SumState:
    """(sum) plus a count used only for emptiness detection
    (reference `analyzers/Sum.scala:25-33`)."""

    total: torch.Tensor
    count: torch.Tensor

    @staticmethod
    def init(device) -> "SumState":
        return SumState(_f(0.0, device), _i(0, device))

    def merge(self, other: "SumState") -> "SumState":
        return SumState(self.total + other.total, self.count + other.count)

    def metric_value(self) -> float:
        return float(self.total)


@dataclass
class MinState:
    """(reference `analyzers/Minimum.scala:25-33`)."""

    min_value: torch.Tensor
    count: torch.Tensor

    @staticmethod
    def init(device) -> "MinState":
        # NaN is the identity (top) element of the NaN-largest min order
        return MinState(_f(math.nan, device), _i(0, device))

    def merge(self, other: "MinState") -> "MinState":
        return MinState(
            min_nan_largest(self.min_value, other.min_value),
            self.count + other.count,
        )

    def metric_value(self) -> float:
        return float(self.min_value)


@dataclass
class MaxState:
    """(reference `analyzers/Maximum.scala:25-33`)."""

    max_value: torch.Tensor
    count: torch.Tensor

    @staticmethod
    def init(device) -> "MaxState":
        return MaxState(_f(-math.inf, device), _i(0, device))

    def merge(self, other: "MaxState") -> "MaxState":
        return MaxState(max_nan(self.max_value, other.max_value), self.count + other.count)

    def metric_value(self) -> float:
        return float(self.max_value)


@dataclass
class StandardDeviationState:
    """Welford/Chan parallel-merge moments (n, avg, m2)
    (reference `analyzers/StandardDeviation.scala:25-50`)."""

    n: torch.Tensor
    avg: torch.Tensor
    m2: torch.Tensor

    @staticmethod
    def init(device) -> "StandardDeviationState":
        return StandardDeviationState(_f(0.0, device), _f(0.0, device), _f(0.0, device))

    def merge(self, other: "StandardDeviationState") -> "StandardDeviationState":
        n = self.n + other.n
        safe_n = torch.where(n == 0, torch.ones_like(n), n)
        delta = other.avg - self.avg
        zero = torch.zeros_like(n)
        avg = torch.where(n == 0, zero, (self.avg * self.n + other.avg * other.n) / safe_n)
        m2 = self.m2 + other.m2 + delta * delta * self.n * other.n / safe_n
        return StandardDeviationState(n, avg, torch.where(n == 0, zero, m2))

    def metric_value(self) -> float:
        n = float(self.n)
        if n == 0:
            return float("nan")
        return float(np.sqrt(float(self.m2) / n))


@dataclass
class DataTypeHistogram:
    """Counts of inferred value types [null, fractional, integral, boolean,
    string] (reference `analyzers/DataType.scala:32-96`)."""

    counts: torch.Tensor  # int64[5]

    NULL_POS: int = field(default=0, metadata={"static": True})

    @staticmethod
    def init(device) -> "DataTypeHistogram":
        return DataTypeHistogram(torch.zeros(5, dtype=COUNT_DTYPE, device=device))

    def merge(self, other: "DataTypeHistogram") -> "DataTypeHistogram":
        return DataTypeHistogram(self.counts + other.counts)


@dataclass
class ApproxCountDistinctState:
    """HLL++ registers, unpacked int32[512] (reference packs them into 52
    longs, `analyzers/ApproxCountDistinct.scala:26-40`; see ``ops/hll.py``
    for the packed-format converters)."""

    registers: torch.Tensor  # int32[512]

    @staticmethod
    def init(device) -> "ApproxCountDistinctState":
        from ..ops.hll import M

        return ApproxCountDistinctState(torch.zeros(M, dtype=torch.int32, device=device))

    def merge(self, other: "ApproxCountDistinctState") -> "ApproxCountDistinctState":
        return ApproxCountDistinctState(torch.maximum(self.registers, other.registers))

    def metric_value(self) -> float:
        from ..ops.hll import estimate_cardinality

        return estimate_cardinality(self.registers.cpu().numpy())
