"""Metric datamodel.

Mirrors the reference datamodel (deequ `metrics/Metric.scala:21-68`,
`metrics/HistogramMetric.scala:21-61`, `metrics/KLLMetric.scala:24-40`):
a metric is (entity, name, instance, value) where value is a Try-like
Success/Failure wrapper so that analyzer errors become *data*, not aborts
(`analyzers/Analyzer.scala:94-103`).
"""

from __future__ import annotations

import enum
from dataclasses import dataclass
from typing import Any, Callable, Dict, Generic, List, Sequence, TypeVar

T = TypeVar("T")
U = TypeVar("U")


class Entity(enum.Enum):
    """What a metric is about (reference `metrics/Metric.scala:21-26`)."""

    DATASET = "Dataset"
    COLUMN = "Column"
    MULTICOLUMN = "Multicolumn"


class Try(Generic[T]):
    """Success-or-Failure result wrapper (Scala Try analog)."""

    __slots__ = ()

    @property
    def is_success(self) -> bool:
        return isinstance(self, Success)

    @property
    def is_failure(self) -> bool:
        return not self.is_success

    def get(self) -> T:
        raise NotImplementedError

    def get_or_else(self, default: U) -> T | U:
        return self.get() if self.is_success else default

    def map(self, fn: Callable[[T], U]) -> "Try[U]":
        if self.is_success:
            try:
                return Success(fn(self.get()))
            except Exception as exc:  # noqa: BLE001 - mirror Try semantics
                return Failure(exc)
        return self  # type: ignore[return-value]


@dataclass(frozen=True)
class Success(Try[T]):
    value: T

    def get(self) -> T:
        return self.value

    def __repr__(self) -> str:
        return f"Success({self.value!r})"


@dataclass(frozen=True)
class Failure(Try[Any]):
    exception: BaseException

    def get(self) -> Any:
        raise self.exception

    def __repr__(self) -> str:
        return f"Failure({self.exception!r})"


@dataclass(frozen=True)
class Metric(Generic[T]):
    """Base metric record (reference `metrics/Metric.scala:28-44`)."""

    entity: Entity
    name: str
    instance: str
    value: Try[T]

    def flatten(self) -> Sequence["DoubleMetric"]:
        raise NotImplementedError


@dataclass(frozen=True)
class DoubleMetric(Metric[float]):
    def flatten(self) -> Sequence["DoubleMetric"]:
        return (self,)


@dataclass(frozen=True)
class KeyedDoubleMetric(Metric[Dict[str, float]]):
    """Many named doubles under one metric, e.g. ApproxQuantiles
    (reference `metrics/Metric.scala:54-68`)."""

    def flatten(self) -> Sequence[DoubleMetric]:
        if self.value.is_success:
            return tuple(
                DoubleMetric(self.entity, f"{self.name}-{k}", self.instance, Success(v))
                for k, v in self.value.get().items()
            )
        return (DoubleMetric(self.entity, self.name, self.instance, self.value),)


@dataclass(frozen=True)
class DistributionValue:
    absolute: int
    ratio: float


@dataclass(frozen=True)
class Distribution:
    """Categorical distribution: label -> (absolute count, ratio); the metric
    payload of Histogram/DataType (reference `metrics/HistogramMetric.scala:21-40`)."""

    values: Dict[str, DistributionValue]
    number_of_bins: int

    def __getitem__(self, key: str) -> DistributionValue:
        return self.values[key]

    def argmax(self) -> str:
        return max(self.values, key=lambda k: self.values[k].absolute)


@dataclass(frozen=True)
class HistogramMetric(Metric[Distribution]):
    column: str = ""

    def flatten(self) -> Sequence[DoubleMetric]:
        """Flatten to bins + per-bin abs/ratio metrics
        (reference `metrics/HistogramMetric.scala:31-61`)."""
        if self.value.is_failure:
            return (
                DoubleMetric(self.entity, f"{self.name}.bins", self.instance, self.value),
            )
        dist = self.value.get()
        out: List[DoubleMetric] = [
            DoubleMetric(
                self.entity, f"{self.name}.bins", self.instance, Success(float(dist.number_of_bins))
            )
        ]
        for key, dv in dist.values.items():
            out.append(
                DoubleMetric(
                    self.entity,
                    f"{self.name}.abs.{key}",
                    self.instance,
                    Success(float(dv.absolute)),
                )
            )
            out.append(
                DoubleMetric(
                    self.entity, f"{self.name}.ratio.{key}", self.instance, Success(dv.ratio)
                )
            )
        return tuple(out)


@dataclass(frozen=True)
class BucketValue:
    low_value: float
    high_value: float
    count: int


@dataclass(frozen=True)
class BucketDistribution:
    """Equi-width bucketed view of a KLL sketch plus the raw sketch parameters
    and data, so percentiles can be re-derived later
    (reference `metrics/KLLMetric.scala` / `analyzers/KLLSketch.scala:125-160`)."""

    buckets: List[BucketValue]
    parameters: List[float]  # [shrinking_factor, sketch_size]
    data: List[List[float]]  # per-level compactor buffers (weights 2^level)

    def compute_percentiles(self) -> List[float]:
        """Re-materialize the sketch from raw buffers and query 1..100th
        percentiles (reference `metrics/KLLMetric.scala:24-40`)."""
        from ..ops.kll_host import HostKLL

        sketch = HostKLL.from_buffers(self.data, int(self.parameters[1]), self.parameters[0])
        return [sketch.quantile(p / 100.0) for p in range(1, 101)]

    def argmax(self) -> int:
        return max(range(len(self.buckets)), key=lambda i: self.buckets[i].count)


@dataclass(frozen=True)
class KLLMetric(Metric[BucketDistribution]):
    def flatten(self) -> Sequence[DoubleMetric]:
        if self.value.is_failure:
            return (
                DoubleMetric(self.entity, f"{self.name}.buckets", self.instance, self.value),
            )
        dist = self.value.get()
        out: List[DoubleMetric] = [
            DoubleMetric(
                self.entity,
                f"{self.name}.buckets",
                self.instance,
                Success(float(len(dist.buckets))),
            )
        ]
        for i, b in enumerate(dist.buckets):
            out.append(
                DoubleMetric(
                    self.entity, f"{self.name}.bucket.{i}.count", self.instance, Success(float(b.count))
                )
            )
        return tuple(out)


def metric_from_value(value: float, name: str, instance: str, entity: Entity) -> DoubleMetric:
    if value is None:
        return metric_from_failure(
            ValueError(f"metric {name} on {instance} produced no value"), name, instance, entity
        )
    # NaN is a legitimate successful value (Spark: max/sum/avg over data
    # containing NaN, corr at zero variance); emptiness/failure is decided
    # by the caller, never inferred from the value here
    return DoubleMetric(entity, name, instance, Success(float(value)))


def metric_from_failure(
    exception: BaseException, name: str, instance: str, entity: Entity
) -> DoubleMetric:
    return DoubleMetric(entity, name, instance, Failure(exception))


def metric_from_empty(name: str, instance: str, entity: Entity) -> DoubleMetric:
    from ..exceptions import EmptyStateException

    return metric_from_failure(
        EmptyStateException(f"Empty state for analyzer {name} on {instance}, all input values were NULL."),
        name,
        instance,
        entity,
    )
