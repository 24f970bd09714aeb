"""Anomaly detection strategies (reference `anomalydetection/*.scala`)."""

from __future__ import annotations

import math
import sys
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np

from . import Anomaly, AnomalyDetectionStrategy

# finite sentinels (the reference uses Double.MinValue/MaxValue): a factor
# of MAX times stdDev 0 must stay 0, never NaN as inf*0 would be
_NEG_INF = -sys.float_info.max
_POS_INF = sys.float_info.max


def normalize_intervals(n_series: int, search_interval, message: str):
    """Per-series (starts, ends) int64 arrays from either ONE shared
    ``(start, end)`` tuple or a sequence of N per-series tuples — the
    fleet-watch shape, where every tenant's "newest point" sits at its own
    ragged index. Validates each interval with the caller's exact serial
    error ``message`` so batched and serial paths fail identically."""
    seq = list(search_interval)
    if len(seq) == 2 and not hasattr(seq[0], "__len__"):
        starts = np.full(n_series, int(seq[0]), dtype=np.int64)
        ends = np.full(n_series, int(seq[1]), dtype=np.int64)
    else:
        if len(seq) != n_series:
            raise ValueError(
                f"need one search interval or one per series "
                f"({n_series}), got {len(seq)}"
            )
        starts = np.array([int(s) for s, _ in seq], dtype=np.int64)
        ends = np.array([int(e) for _, e in seq], dtype=np.int64)
    if np.any(starts > ends):
        raise ValueError(message)
    return starts, ends


def pad_series_matrix(series_list):
    """Right-pad N ragged series into a float64 ``[N, T]`` matrix plus the
    per-series lengths (the mask). Padding is zeros; every batched core
    masks it out via the lengths."""
    arrays = [np.asarray(s, dtype=np.float64) for s in series_list]
    lengths = np.array([len(a) for a in arrays], dtype=np.int64)
    t = int(lengths.max()) if len(arrays) else 0
    m = np.zeros((len(arrays), t))
    for i, a in enumerate(arrays):
        m[i, : len(a)] = a
    return m, lengths


@dataclass(frozen=True)
class SimpleThresholdStrategy(AnomalyDetectionStrategy):
    """Flags values outside [lower_bound, upper_bound]
    (reference `anomalydetection/SimpleThresholdStrategy.scala`)."""

    upper_bound: float
    lower_bound: float = _NEG_INF

    def __post_init__(self):
        if self.lower_bound > self.upper_bound:
            raise ValueError("The lower bound must be smaller or equal to the upper bound.")

    def detect(self, data_series, search_interval):
        start, end = search_interval
        if start > end:
            raise ValueError("The start of the interval can't be larger than the end.")
        out = []
        for index in range(start, min(end, len(data_series))):
            value = data_series[index]
            if value < self.lower_bound or value > self.upper_bound:
                out.append(
                    (
                        index,
                        Anomaly(
                            value,
                            1.0,
                            f"[SimpleThresholdStrategy]: Value {value} is not in bounds "
                            f"[{self.lower_bound}, {self.upper_bound}]",
                        ),
                    )
                )
        return out

    def detect_batch(self, series_list, search_interval):
        """Batched :meth:`detect`: N ragged series flag through ONE
        vectorized bounds compare (``search_interval``: one shared tuple
        or one per series) — element-for-element identical to serial."""
        if not len(series_list):
            return []
        starts, ends = normalize_intervals(
            len(series_list), search_interval,
            "The start of the interval can't be larger than the end.",
        )
        m, lengths = pad_series_matrix(series_list)
        idx = np.arange(m.shape[1], dtype=np.int64)
        in_window = (
            (idx[None, :] >= starts[:, None])
            & (idx[None, :] < np.minimum(ends, lengths)[:, None])
        )
        flags = in_window & ((m < self.lower_bound) | (m > self.upper_bound))
        out = []
        for i, series in enumerate(series_list):
            rows = []
            for index in np.nonzero(flags[i])[0]:
                value = series[int(index)]
                rows.append(
                    (
                        int(index),
                        Anomaly(
                            value,
                            1.0,
                            f"[SimpleThresholdStrategy]: Value {value} is not in bounds "
                            f"[{self.lower_bound}, {self.upper_bound}]",
                        ),
                    )
                )
            out.append(rows)
        return out


@dataclass(frozen=True)
class _BaseChangeStrategy(AnomalyDetectionStrategy):
    """Nth-order discrete change detection
    (reference `anomalydetection/BaseChangeStrategy.scala:30-95`)."""

    max_rate_decrease: Optional[float] = None
    max_rate_increase: Optional[float] = None
    order: int = 1

    def __post_init__(self):
        if self.max_rate_decrease is None and self.max_rate_increase is None:
            raise ValueError(
                "At least one of the two limits (max_rate_decrease or max_rate_increase) "
                "has to be specified."
            )
        lo = self.max_rate_decrease if self.max_rate_decrease is not None else _NEG_INF
        hi = self.max_rate_increase if self.max_rate_increase is not None else _POS_INF
        if lo > hi:
            raise ValueError(
                "The maximal rate of increase has to be bigger than the maximal rate of decrease."
            )
        if self.order < 0:
            raise ValueError("Order of derivative cannot be negative.")

    def diff(self, series: np.ndarray, order: int) -> np.ndarray:
        if order == 0 or len(series) == 0:
            return series
        return self.diff(series[1:] - series[:-1], order - 1)

    def diff_matrix(self, m: np.ndarray, order: int) -> np.ndarray:
        """The series-axis twin of :meth:`diff` over an ``[N, T]`` matrix
        (same recursive pairwise subtraction, columns instead of scalars).
        Each output column j holds the order-``order`` change ending at
        input column ``j + order`` — window-start independent, which is
        what lets ONE matrix diff serve every per-series interval."""
        if order == 0 or m.shape[1] == 0:
            return m
        return self.diff_matrix(m[:, 1:] - m[:, :-1], order - 1)

    def detect_batch(self, series_list, search_interval):
        """Batched :meth:`detect`: N ragged series' nth-order changes
        compute in ONE matrix diff (``search_interval``: one shared tuple
        or one per series) — element-for-element identical to serial,
        because ``diff`` of a window equals the full-series diff
        restricted to the window's columns."""
        if not len(series_list):
            return []
        starts, ends = normalize_intervals(
            len(series_list), search_interval,
            "The start of the interval cannot be larger than the end.",
        )
        m, lengths = pad_series_matrix(series_list)
        lo = self.max_rate_decrease if self.max_rate_decrease is not None else _NEG_INF
        hi = self.max_rate_increase if self.max_rate_increase is not None else _POS_INF
        changes = self.diff_matrix(m, self.order)
        # diff column j = change ending at index j + order; the serial
        # window [max(start-order,0) : min(end,len)] maps to diff columns
        # [max(start-order,0), min(end,len)-order)
        j = np.arange(changes.shape[1], dtype=np.int64)
        start_points = np.maximum(starts - self.order, 0)
        stop = np.minimum(ends, lengths) - self.order
        in_window = (
            (j[None, :] >= start_points[:, None])
            & (j[None, :] < stop[:, None])
        )
        flags = in_window & ((changes < lo) | (changes > hi))
        out = []
        for i, series in enumerate(series_list):
            rows = []
            for col in np.nonzero(flags[i])[0]:
                index = int(col) + self.order
                change = changes[i, int(col)]
                rows.append(
                    (
                        index,
                        Anomaly(
                            series[index],
                            1.0,
                            f"[AbsoluteChangeStrategy]: Change of {change} is not in bounds "
                            f"[{lo}, {hi}]. Order={self.order}",
                        ),
                    )
                )
            out.append(rows)
        return out

    def detect(self, data_series, search_interval):
        start, end = search_interval
        if start > end:
            raise ValueError("The start of the interval cannot be larger than the end.")
        start_point = max(start - self.order, 0)
        window = np.asarray(data_series[start_point:end], dtype=np.float64)
        data = self.diff(window, self.order)
        lo = self.max_rate_decrease if self.max_rate_decrease is not None else _NEG_INF
        hi = self.max_rate_increase if self.max_rate_increase is not None else _POS_INF
        out = []
        for i, change in enumerate(data):
            if change < lo or change > hi:
                index = i + start_point + self.order
                out.append(
                    (
                        index,
                        Anomaly(
                            data_series[index],
                            1.0,
                            f"[AbsoluteChangeStrategy]: Change of {change} is not in bounds "
                            f"[{lo}, {hi}]. Order={self.order}",
                        ),
                    )
                )
        return out


@dataclass(frozen=True)
class AbsoluteChangeStrategy(_BaseChangeStrategy):
    """(reference `anomalydetection/AbsoluteChangeStrategy.scala`)."""


@dataclass(frozen=True)
class RateOfChangeStrategy(_BaseChangeStrategy):
    """Deprecated alias of AbsoluteChangeStrategy
    (reference `anomalydetection/RateOfChangeStrategy.scala`)."""


@dataclass(frozen=True)
class RelativeRateOfChangeStrategy(_BaseChangeStrategy):
    """Ratio (current / order-steps-back) change detection
    (reference `anomalydetection/RelativeRateOfChangeStrategy.scala`)."""

    def diff(self, series: np.ndarray, order: int) -> np.ndarray:
        if order <= 0:
            raise ValueError("Order of diff cannot be zero or negative")
        if len(series) == 0:
            return series
        with np.errstate(divide="ignore", invalid="ignore"):
            return series[order:] / series[:-order]

    def diff_matrix(self, m: np.ndarray, order: int) -> np.ndarray:
        if order <= 0:
            raise ValueError("Order of diff cannot be zero or negative")
        if m.shape[1] == 0:
            return m
        with np.errstate(divide="ignore", invalid="ignore"):
            return m[:, order:] / m[:, :-order]


@dataclass(frozen=True)
class OnlineNormalStrategy(AnomalyDetectionStrategy):
    """Incremental mean/variance bounds with optional anomaly exclusion
    (reference `anomalydetection/OnlineNormalStrategy.scala:39-45`)."""

    lower_deviation_factor: Optional[float] = 3.0
    upper_deviation_factor: Optional[float] = 3.0
    ignore_start_percentage: float = 0.1
    ignore_anomalies: bool = True

    def __post_init__(self):
        if self.lower_deviation_factor is None and self.upper_deviation_factor is None:
            raise ValueError("At least one factor has to be specified.")
        if (self.lower_deviation_factor or 1.0) < 0 or (self.upper_deviation_factor or 1.0) < 0:
            raise ValueError("Factors cannot be smaller than zero.")
        if not 0.0 <= self.ignore_start_percentage <= 1.0:
            raise ValueError("Percentage of start values to ignore must be in interval [0, 1].")

    def compute_stats_and_anomalies(self, data_series, search_interval=(0, 2**63 - 1)):
        results = []
        current_mean = 0.0
        current_variance = 0.0
        sn = 0.0
        num_skip = len(data_series) * self.ignore_start_percentage
        search_start, search_end = search_interval
        upper_factor = (
            self.upper_deviation_factor if self.upper_deviation_factor is not None else _POS_INF
        )
        lower_factor = (
            self.lower_deviation_factor if self.lower_deviation_factor is not None else _POS_INF
        )
        for index, value in enumerate(data_series):
            last_mean, last_variance, last_sn = current_mean, current_variance, sn
            if index == 0:
                current_mean = value
            else:
                current_mean = last_mean + (value - last_mean) / (index + 1)
            sn += (value - last_mean) * (value - current_mean)
            current_variance = sn / (index + 1)
            std_dev = math.sqrt(current_variance)
            upper = current_mean + upper_factor * std_dev
            lower = current_mean - lower_factor * std_dev
            if (
                index < num_skip
                or index < search_start
                or index >= search_end
                or lower <= value <= upper
            ):
                results.append((current_mean, std_dev, False))
            else:
                if self.ignore_anomalies:
                    current_mean, current_variance, sn = last_mean, last_variance, last_sn
                results.append((current_mean, std_dev, True))
        return results

    def detect(self, data_series, search_interval):
        start, end = search_interval
        if start > end:
            raise ValueError("The start of the interval can't be larger than the end.")
        stats = self.compute_stats_and_anomalies(data_series, search_interval)
        upper_factor = (
            self.upper_deviation_factor if self.upper_deviation_factor is not None else _POS_INF
        )
        lower_factor = (
            self.lower_deviation_factor if self.lower_deviation_factor is not None else _POS_INF
        )
        out = []
        for index in range(start, min(end, len(data_series))):
            mean, std_dev, is_anomaly = stats[index]
            if not is_anomaly:
                continue
            lower = mean - lower_factor * std_dev
            upper = mean + upper_factor * std_dev
            out.append(
                (
                    index,
                    Anomaly(
                        data_series[index],
                        1.0,
                        f"[OnlineNormalStrategy]: Value {data_series[index]} is not in "
                        f"bounds [{lower}, {upper}].",
                    ),
                )
            )
        return out

    # -- batched scoring core (fleet watch: ROADMAP item 5) ------------------

    def compute_stats_batch(
        self, series_matrix, lengths=None, search_interval=(0, 2**63 - 1)
    ):
        """The scoring core vectorized over a SERIES axis: one array-shaped
        call scores N metric series at once — the per-timestep recurrences
        (incremental mean, Welford ``sn``, the anomaly-exclusion rollback)
        run as elementwise numpy ops over all N series, so a fleet of
        thousands of tenants' metric histories scores in O(T) vector steps
        instead of N python loops. Per-element arithmetic is IDENTICAL to
        the one-series :meth:`compute_stats_and_anomalies` (same formula,
        same order, same IEEE ops), pinned by parity tests.

        ``series_matrix``: float64 ``[N, T]``, ragged series padded on the
        right (padding is ignored via ``lengths``). ``search_interval``:
        one shared ``(start, end)`` tuple, or a sequence of N per-series
        tuples (the fleet-watch shape — each tenant's newest point sits at
        its own ragged index). Returns ``(means, std_devs, is_anomaly)``
        each ``[N, T]``; entries past a series' length are zeros/False."""
        m = np.asarray(series_matrix, dtype=np.float64)
        if m.ndim != 2:
            raise ValueError("series_matrix must be [n_series, n_points]")
        n, t = m.shape
        lengths = (
            np.full(n, t, dtype=np.int64) if lengths is None
            else np.asarray(lengths, dtype=np.int64)
        )
        upper_factor = (
            self.upper_deviation_factor
            if self.upper_deviation_factor is not None else _POS_INF
        )
        lower_factor = (
            self.lower_deviation_factor
            if self.lower_deviation_factor is not None else _POS_INF
        )
        seq = list(search_interval)
        if len(seq) == 2 and not hasattr(seq[0], "__len__"):
            search_start, search_end = int(seq[0]), int(seq[1])
        else:
            # per-series intervals: the comparisons below are elementwise,
            # so arrays slot straight in (no validation here — the scalar
            # compute_stats_and_anomalies performs none either)
            search_start = np.array([int(s) for s, _ in seq], dtype=np.int64)
            search_end = np.array([int(e) for _, e in seq], dtype=np.int64)
        num_skip = lengths * self.ignore_start_percentage
        means = np.zeros((n, t))
        std_devs = np.zeros((n, t))
        flags = np.zeros((n, t), dtype=bool)
        current_mean = np.zeros(n)
        sn = np.zeros(n)
        for index in range(t):
            active = index < lengths
            value = np.where(active, m[:, index], 0.0)
            last_mean = current_mean
            last_sn = sn
            if index == 0:
                current_mean = value.copy()
            else:
                current_mean = last_mean + (value - last_mean) / (index + 1)
            sn = last_sn + (value - last_mean) * (value - current_mean)
            std_dev = np.sqrt(sn / (index + 1))
            upper = current_mean + upper_factor * std_dev
            lower = current_mean - lower_factor * std_dev
            # points outside the search interval are never FLAGGED — and,
            # exactly like the scalar path, never rolled back either
            anomaly = active & ~(
                (index < num_skip)
                | (index < search_start)
                | (index >= search_end)
                | ((lower <= value) & (value <= upper))
            )
            if self.ignore_anomalies:
                # the scalar path RESTORES the running stats for anomalous
                # points (and records the restored mean with the
                # pre-restore std) — replicated elementwise
                current_mean = np.where(anomaly, last_mean, current_mean)
                sn = np.where(anomaly, last_sn, sn)
            inactive = ~active
            current_mean = np.where(inactive, last_mean, current_mean)
            sn = np.where(inactive, last_sn, sn)
            means[:, index] = np.where(active, current_mean, 0.0)
            std_devs[:, index] = np.where(active, std_dev, 0.0)
            flags[:, index] = anomaly
        return means, std_devs, flags

    def detect_batch(self, series_list, search_interval):
        """Batched :meth:`detect`: N series score through ONE
        ``compute_stats_batch`` call (``search_interval``: one shared
        tuple or one per series); returns a list over series of the same
        ``[(index, Anomaly), ...]`` the one-series path produces (bounds,
        messages and indices identical — parity-pinned)."""
        if not len(series_list):
            return []
        starts, ends = normalize_intervals(
            len(series_list), search_interval,
            "The start of the interval can't be larger than the end.",
        )
        series_list = [np.asarray(s, dtype=np.float64) for s in series_list]
        m, lengths = pad_series_matrix(series_list)
        means, std_devs, flags = self.compute_stats_batch(
            m, lengths, list(zip(starts.tolist(), ends.tolist()))
        )
        upper_factor = (
            self.upper_deviation_factor
            if self.upper_deviation_factor is not None else _POS_INF
        )
        lower_factor = (
            self.lower_deviation_factor
            if self.lower_deviation_factor is not None else _POS_INF
        )
        out = []
        for i, series in enumerate(series_list):
            rows = []
            for index in range(int(starts[i]), min(int(ends[i]), len(series))):
                if not flags[i, index]:
                    continue
                mean = means[i, index]
                std_dev = std_devs[i, index]
                lower = mean - lower_factor * std_dev
                upper = mean + upper_factor * std_dev
                value = series[index]
                rows.append(
                    (
                        index,
                        Anomaly(
                            value,
                            1.0,
                            f"[OnlineNormalStrategy]: Value {value} is not "
                            f"in bounds [{lower}, {upper}].",
                        ),
                    )
                )
            out.append(rows)
        return out


@dataclass(frozen=True)
class BatchNormalStrategy(AnomalyDetectionStrategy):
    """Mean/stdDev bounds estimated from values outside the search interval
    (reference `anomalydetection/BatchNormalStrategy.scala:33-36`)."""

    lower_deviation_factor: Optional[float] = 3.0
    upper_deviation_factor: Optional[float] = 3.0
    include_interval: bool = False

    def __post_init__(self):
        if self.lower_deviation_factor is None and self.upper_deviation_factor is None:
            raise ValueError("At least one factor has to be specified.")
        if (self.lower_deviation_factor or 1.0) < 0 or (self.upper_deviation_factor or 1.0) < 0:
            raise ValueError("Factors cannot be smaller than zero.")

    def detect(self, data_series, search_interval):
        start, end = search_interval
        if start > end:
            raise ValueError("The start of the interval can't be larger than the end.")
        if len(data_series) == 0:
            raise ValueError("Data series is empty. Can't calculate mean/ stdDev.")
        series = np.asarray(data_series, dtype=np.float64)
        end_capped = min(end, len(series))
        if self.include_interval:
            basis = series
        else:
            basis = np.concatenate([series[:start], series[end_capped:]])
            if len(basis) == 0:
                raise ValueError(
                    "Excluding values in searchInterval from calculation but not enough values "
                    "remain to calculate mean and stdDev."
                )
        mean = float(np.mean(basis))
        # sample stddev like breeze meanAndVariance (ddof=1)
        std_dev = float(np.std(basis, ddof=1)) if len(basis) > 1 else 0.0
        upper_factor = (
            self.upper_deviation_factor if self.upper_deviation_factor is not None else _POS_INF
        )
        lower_factor = (
            self.lower_deviation_factor if self.lower_deviation_factor is not None else _POS_INF
        )
        upper = mean + upper_factor * std_dev
        lower = mean - lower_factor * std_dev
        out = []
        for index in range(start, end_capped):
            value = series[index]
            if value > upper or value < lower:
                out.append(
                    (
                        index,
                        Anomaly(
                            float(value),
                            1.0,
                            f"[BatchNormalStrategy]: Value {value} is not in "
                            f"bounds [{lower}, {upper}].",
                        ),
                    )
                )
        return out

    def detect_batch(self, series_list, search_interval):
        """Batched :meth:`detect` over N ragged series (``search_interval``:
        one shared tuple or one per series). The per-series mean/stdDev
        reductions run on each row's exact basis slice (identical
        reduction order — a masked full-width sum would round differently
        under numpy's pairwise summation); the bounds compare is one
        vectorized pass."""
        if not len(series_list):
            return []
        starts, ends = normalize_intervals(
            len(series_list), search_interval,
            "The start of the interval can't be larger than the end.",
        )
        upper_factor = (
            self.upper_deviation_factor if self.upper_deviation_factor is not None else _POS_INF
        )
        lower_factor = (
            self.lower_deviation_factor if self.lower_deviation_factor is not None else _POS_INF
        )
        m, lengths = pad_series_matrix(series_list)
        n = len(series_list)
        uppers = np.zeros(n)
        lowers = np.zeros(n)
        for i in range(n):
            if lengths[i] == 0:
                raise ValueError("Data series is empty. Can't calculate mean/ stdDev.")
            series = m[i, : lengths[i]]
            end_capped = min(int(ends[i]), int(lengths[i]))
            if self.include_interval:
                basis = series
            else:
                basis = np.concatenate(
                    [series[: int(starts[i])], series[end_capped:]]
                )
                if len(basis) == 0:
                    raise ValueError(
                        "Excluding values in searchInterval from calculation but not enough values "
                        "remain to calculate mean and stdDev."
                    )
            mean = float(np.mean(basis))
            std_dev = float(np.std(basis, ddof=1)) if len(basis) > 1 else 0.0
            uppers[i] = mean + upper_factor * std_dev
            lowers[i] = mean - lower_factor * std_dev
        idx = np.arange(m.shape[1], dtype=np.int64)
        in_window = (
            (idx[None, :] >= starts[:, None])
            & (idx[None, :] < np.minimum(ends, lengths)[:, None])
        )
        flags = in_window & ((m > uppers[:, None]) | (m < lowers[:, None]))
        out = []
        for i in range(n):
            rows = []
            for index in np.nonzero(flags[i])[0]:
                value = m[i, int(index)]
                rows.append(
                    (
                        int(index),
                        Anomaly(
                            float(value),
                            1.0,
                            f"[BatchNormalStrategy]: Value {value} is not in "
                            f"bounds [{lowers[i]}, {uppers[i]}].",
                        ),
                    )
                )
            out.append(rows)
        return out
