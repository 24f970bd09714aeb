"""Anomaly detection over metric time series
(reference `anomalydetection/*.scala`).

An :class:`AnomalyDetectionStrategy` finds anomalies in a value series within
a search interval; :class:`AnomalyDetector` handles the
sort/filter/new-point protocol. Series here are metric histories (length
<< 1e5), so everything is plain numpy on host — same as the reference, where
this is breeze code on the host.

A copy of the JAX package's module (it imports no JAX). The seasonal
Holt-Winters strategy is not part of this port yet.
"""

from __future__ import annotations

import abc
from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Tuple

import numpy as np


@dataclass(frozen=True)
class Anomaly:
    """(reference `anomalydetection/DetectionResult.scala`)."""

    value: Optional[float]
    confidence: float
    detail: Optional[str] = None

    def __eq__(self, other):
        if not isinstance(other, Anomaly):
            return NotImplemented
        return self.value == other.value and self.confidence == other.confidence


@dataclass(frozen=True)
class DetectionResult:
    anomalies: Tuple[Tuple[int, Anomaly], ...] = ()


@dataclass(frozen=True)
class DataPoint:
    """(reference `anomalydetection/AnomalyDetector.scala:19`)."""

    time: int
    metric_value: Optional[float]


class AnomalyDetectionStrategy(abc.ABC):
    @abc.abstractmethod
    def detect(
        self, data_series: Sequence[float], search_interval: Tuple[int, int]
    ) -> List[Tuple[int, Anomaly]]:
        """Find anomalies at indices within [start, end) of the series."""

    def detect_batch(self, series_list, search_interval):
        """Score N series at once; returns one ``[(index, Anomaly), ...]``
        list per series. ``search_interval``: one shared ``(start, end)``
        tuple, or a sequence of N per-series tuples (the fleet-watch
        shape). This default simply loops :meth:`detect` — every strategy
        is batchable by contract; the vectorizable strategies override it
        with array-shaped cores that are element-for-element identical
        to serial (parity-pinned by tests/test_anomaly_reference.py)."""
        from .strategies import normalize_intervals

        if not len(series_list):
            return []
        starts, ends = normalize_intervals(
            len(series_list), search_interval,
            "The start of the interval can't be larger than the end.",
        )
        return [
            self.detect(series, (int(starts[i]), int(ends[i])))
            for i, series in enumerate(series_list)
        ]


@dataclass(frozen=True)
class AnomalyDetector:
    """(reference `anomalydetection/AnomalyDetector.scala:21-90`)."""

    strategy: AnomalyDetectionStrategy

    def is_new_point_anomalous(
        self, historical_data_points: Sequence[DataPoint], new_point: DataPoint
    ) -> DetectionResult:
        if not historical_data_points:
            raise ValueError("historicalDataPoints must not be empty!")
        sorted_points = sorted(historical_data_points, key=lambda p: p.time)
        last_time = sorted_points[-1].time
        if last_time >= new_point.time:
            raise ValueError(
                "Can't decide which range to use for anomaly detection. New data point with "
                f"time {new_point.time} is in history range "
                f"({sorted_points[0].time} - {last_time})!"
            )
        all_points = list(sorted_points) + [new_point]
        result = self.detect_anomalies_in_history(
            all_points, (new_point.time, np.iinfo(np.int64).max)
        )
        return DetectionResult(result.anomalies)

    def detect_anomalies_in_history(
        self,
        data_series: Sequence[DataPoint],
        search_interval: Tuple[int, int] = (np.iinfo(np.int64).min, np.iinfo(np.int64).max),
    ) -> DetectionResult:
        search_start, search_end = search_interval
        if search_start > search_end:
            raise ValueError("The first interval element has to be smaller or equal to the last.")
        present = [p for p in data_series if p.metric_value is not None]
        sorted_series = sorted(present, key=lambda p: p.time)
        timestamps = [p.time for p in sorted_series]
        lower = int(np.searchsorted(timestamps, search_start, side="left"))
        upper = int(np.searchsorted(timestamps, search_end, side="left"))
        values = [p.metric_value for p in sorted_series]
        anomalies = self.strategy.detect(values, (lower, upper))
        return DetectionResult(
            tuple((timestamps[idx], anomaly) for idx, anomaly in anomalies)
        )


from .strategies import (  # noqa: E402
    AbsoluteChangeStrategy,
    BatchNormalStrategy,
    OnlineNormalStrategy,
    RateOfChangeStrategy,
    RelativeRateOfChangeStrategy,
    SimpleThresholdStrategy,
)

__all__ = [
    "AbsoluteChangeStrategy",
    "Anomaly",
    "AnomalyDetectionStrategy",
    "AnomalyDetector",
    "BatchNormalStrategy",
    "DataPoint",
    "DetectionResult",
    "OnlineNormalStrategy",
    "RateOfChangeStrategy",
    "RelativeRateOfChangeStrategy",
    "SimpleThresholdStrategy",
]


#: the seasonal strategy's names, which this port does not carry yet
_NOT_PORTED = ("HoltWinters", "MetricInterval", "SeriesSeasonality")


def __getattr__(name: str):
    if name in _NOT_PORTED:
        raise NotImplementedError(
            f"{name} (seasonal Holt-Winters anomaly detection) is not supported by "
            "deequ_tpu_torch yet"
        )
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
