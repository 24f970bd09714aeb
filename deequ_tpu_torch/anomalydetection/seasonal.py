"""Additive Holt-Winters seasonal anomaly detection with L-BFGS-B parameter
fitting (reference `anomalydetection/seasonal/HoltWinters.scala:63-249`,
which uses breeze's LBFGSB; here scipy's).

A copy of the JAX package's module (numpy and scipy only), with one
change: the batched recurrence takes each series' two initial period sums
with Python's ``sum`` over the same values the serial path sums, so
:meth:`HoltWinters.detect_batch` equals :meth:`HoltWinters.detect` bit for
bit. Python's ``sum`` of ``float`` objects is compensated (Neumaier) since
CPython 3.12, while a sum of numpy scalars is a plain left fold; a vector
left fold matches only the second."""

from __future__ import annotations

import enum
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np

from . import Anomaly, AnomalyDetectionStrategy


class SeriesSeasonality(enum.Enum):
    WEEKLY = "Weekly"
    YEARLY = "Yearly"


class MetricInterval(enum.Enum):
    DAILY = "Daily"
    MONTHLY = "Monthly"


@dataclass(frozen=True)
class ModelResults:
    forecasts: List[float]
    level: List[float]
    trend: List[float]
    seasonality: List[float]
    residuals: List[float]


def additive_holt_winters(
    series: Sequence[float],
    periodicity: int,
    number_of_points_to_forecast: int,
    alpha: float,
    beta: float,
    gamma: float,
) -> ModelResults:
    """(reference `HoltWinters.scala:76-124` — same recurrences)."""
    series = list(series)
    m = periodicity
    first_period_sum = sum(series[:m])
    second_period_sum = sum(series[m : 2 * m])
    level = [first_period_sum / m]
    trend = [(second_period_sum - first_period_sum) / (m * m)]
    seasonality = [x - level[0] for x in series[:m]]
    y = [level[0] + trend[0] + seasonality[0]]
    big_y = list(series)
    for t in range(len(series) + number_of_points_to_forecast):
        if t >= len(series):
            big_y.append(level[-1] + trend[-1] + seasonality[len(seasonality) - m])
        level.append(alpha * (big_y[t] - seasonality[t]) + (1 - alpha) * (level[t] + trend[t]))
        trend.append(beta * (level[t + 1] - level[t]) + (1 - beta) * trend[t])
        seasonality.append(
            gamma * (big_y[t] - level[t] - trend[t]) + (1 - gamma) * seasonality[t]
        )
        y.append(level[t + 1] + trend[t + 1] + seasonality[t + 1])
    residuals = [series_value - forecast for forecast, series_value in zip(y, series)]
    forecasted = big_y[len(series) :]
    return ModelResults(forecasted, level, trend, seasonality, residuals)


@dataclass(frozen=True)
class BatchModelResults:
    """Per-series forecasts/residuals of one batched Holt-Winters pass.
    ``forecasts[i, :n_forecasts[i]]`` and ``residuals[i, :train_lengths[i]]``
    are meaningful; the padding is zeros."""

    forecasts: np.ndarray  # [N, max(n_forecasts)]
    residuals: np.ndarray  # [N, max(train_lengths)]
    train_lengths: np.ndarray
    n_forecasts: np.ndarray


def additive_holt_winters_batch(
    matrix: np.ndarray,
    train_lengths: np.ndarray,
    periodicity: int,
    n_forecasts: np.ndarray,
    alphas: np.ndarray,
    betas: np.ndarray,
    gammas: np.ndarray,
    period_sums: Optional[Sequence[Tuple[float, float]]] = None,
) -> BatchModelResults:
    """The series-axis twin of :func:`additive_holt_winters`: N training
    series (right-padded rows of ``matrix``, per-series ``train_lengths``)
    run the level/trend/seasonality recurrences as ONE elementwise vector
    pass over timesteps — a fleet of tenants' seasonal models evaluates in
    O(T) array steps instead of N python loops. Per-element arithmetic is
    IDENTICAL to the scalar recurrence (same formula, same op order, same
    IEEE doubles).

    The initial level and trend come from each series' first and second
    period sums, taken with Python's ``sum`` exactly as the scalar path
    takes them: ``period_sums[i]`` when given (the caller summed the
    series' own elements, as :meth:`HoltWinters.detect_batch` does), else
    ``sum`` over the row's elements of ``matrix`` (numpy scalars of a float
    array: a left fold, what the scalar path does on such elements).

    Requires every ``train_lengths[i] >= periodicity`` (the scalar path's
    seasonal-list layout only aligns with the shared buffer then — callers
    route shorter histories through the scalar code)."""
    m = int(periodicity)
    mat = np.asarray(matrix, dtype=np.float64)
    tl = np.asarray(train_lengths, dtype=np.int64)
    nf = np.asarray(n_forecasts, dtype=np.int64)
    alphas = np.asarray(alphas, dtype=np.float64)
    betas = np.asarray(betas, dtype=np.float64)
    gammas = np.asarray(gammas, dtype=np.float64)
    if np.any(tl < m):
        raise ValueError(
            "additive_holt_winters_batch requires at least one full cycle "
            "of training per series (route shorter series through the "
            "scalar path)"
        )
    n, width = mat.shape
    total = tl + nf
    steps = int(total.max()) if n else 0
    zeros = np.zeros(n)

    def col(j: int) -> np.ndarray:
        return mat[:, j] if j < width else zeros

    # initial level/trend: one python `sum` per series and period, over the
    # values the scalar path sums (m is 7 or 12)
    if period_sums is None:
        period_sums = [
            (sum(mat[i, :m]), sum(mat[i, m:min(2 * m, int(tl[i]))]))
            for i in range(n)
        ]
    first = np.array([float(a) for a, _ in period_sums], dtype=np.float64)
    second = np.array([float(b) for _, b in period_sums], dtype=np.float64)
    level = first / m
    trend = (second - first) / (m * m)
    # seasonality buffer: index j<m holds the init entries, index m+t the
    # entry appended at step t — the same layout as the scalar list, so
    # every scalar list read seasonality[k] is exactly S[:, k]
    seas = np.zeros((n, m + steps + 1))
    for j in range(m):
        seas[:, j] = col(j) - level
    residuals = np.zeros((n, int(tl.max()) if n else 0))
    forecasts = np.zeros((n, int(nf.max()) if n else 0))
    if residuals.shape[1] > 0:
        residuals[:, 0] = np.where(
            0 < tl, col(0) - (level + trend + seas[:, 0]), 0.0
        )
    rows = np.arange(n)
    for t in range(steps):
        active = t < total
        in_train = t < tl
        observed = col(t)
        # big_y[t]: the observed training value, or (in the forecast
        # phase) level[-1] + trend[-1] + seasonality[len - m] == S[:, t]
        big_y = np.where(in_train, observed, level + trend + seas[:, t])
        fc_mask = active & ~in_train
        if fc_mask.any():
            forecasts[rows[fc_mask], (t - tl)[fc_mask]] = big_y[fc_mask]
        level_next = alphas * (big_y - seas[:, t]) + (1 - alphas) * (level + trend)
        trend_next = betas * (level_next - level) + (1 - betas) * trend
        seas[:, m + t] = gammas * (big_y - level - trend) + (1 - gammas) * seas[:, t]
        # y[t+1] = level[t+1] + trend[t+1] + seasonality[t+1] (list index
        # t+1 — an INIT entry while t+1 < m, the step-(t+1-m) append after)
        y_next = level_next + trend_next + seas[:, t + 1]
        r_mask = active & (t + 1 < tl)
        if r_mask.any():
            residuals[r_mask, t + 1] = (col(t + 1) - y_next)[r_mask]
        # freeze finished lanes so a short series' state cannot drift (its
        # outputs are already recorded; this only guards against overflow
        # in dead lanes)
        level = np.where(active, level_next, level)
        trend = np.where(active, trend_next, trend)
    return BatchModelResults(forecasts, residuals, tl, nf)


class HoltWinters(AnomalyDetectionStrategy):
    """(reference `HoltWinters.scala:63-249`; periodicity table `:70-73`)."""

    def __init__(self, metrics_interval: MetricInterval, seasonality: SeriesSeasonality):
        table = {
            (SeriesSeasonality.WEEKLY, MetricInterval.DAILY): 7,
            (SeriesSeasonality.YEARLY, MetricInterval.MONTHLY): 12,
        }
        key = (seasonality, metrics_interval)
        if key not in table:
            raise ValueError(
                "Only (Weekly seasonality, Daily interval) and (Yearly, Monthly) are supported"
            )
        self.series_periodicity = table[key]

    def _fit(self, series: Sequence[float], num_forecast: int) -> Tuple[float, float, float]:
        from scipy.optimize import minimize

        m = self.series_periodicity

        def objective(x: np.ndarray) -> float:
            results = additive_holt_winters(series, m, num_forecast, x[0], x[1], x[2])
            return float(sum(r * r for r in results.residuals))

        res = minimize(
            objective,
            x0=np.array([0.3, 0.1, 0.1]),
            method="L-BFGS-B",
            bounds=[(0.0, 1.0)] * 3,
        )
        return float(res.x[0]), float(res.x[1]), float(res.x[2])

    def _validate(self, data_series, start: int, end: int) -> int:
        """The scalar path's validations, shared with the batched twin so
        both fail identically; returns the forecast count."""
        if len(data_series) == 0:
            raise ValueError("Provided data series is empty")
        if start >= end:
            raise ValueError("Start must be before end")
        if start < 0 or end < 0:
            raise ValueError("The search interval needs to be strictly positive")
        if start < self.series_periodicity * 2:
            raise ValueError("Need at least two full cycles of data to estimate model")
        if start >= len(data_series):
            return 1
        return min(end, len(data_series)) - start

    @staticmethod
    def _flag(data_series, start, forecasts, residuals):
        """Residual-threshold flagging shared by scalar and batched paths
        (same 1.96-sigma rule, same message)."""
        abs_residuals = np.abs(np.asarray(residuals))
        residual_sd = float(np.std(abs_residuals, ddof=1)) if len(abs_residuals) > 1 else 0.0
        out = []
        test_series = data_series[start:]
        for detection_index, (observed, forecast) in enumerate(
            zip(test_series, forecasts)
        ):
            if abs(observed - forecast) > 1.96 * residual_sd:
                out.append(
                    (
                        detection_index + start,
                        Anomaly(
                            observed,
                            1.0,
                            f"Forecasted {forecast} for observed value {observed}",
                        ),
                    )
                )
        return out

    def detect(self, data_series, search_interval=(0, 2**31 - 1)):
        start, end = search_interval
        num_forecast = self._validate(data_series, start, end)
        training = list(data_series[:start])
        alpha, beta, gamma = self._fit(training, num_forecast)
        results = additive_holt_winters(
            training, self.series_periodicity, num_forecast, alpha, beta, gamma
        )
        return self._flag(data_series, start, results.forecasts, results.residuals)

    # -- batched scoring (the fleet watch's) ---------------------------------

    def fit_batch(self, series_list, search_interval=(0, 2**31 - 1)):
        """Per-series L-BFGS-B parameter fits for a fleet, via the SAME
        scalar objective ``detect`` uses (parameters are therefore
        bit-identical to serial — the optimizer is inherently per-series;
        it is the model-evaluation recurrences that batch). Returns a list
        of (alpha, beta, gamma). Callers scoring the same histories every
        harvest can cache these and pass them to :meth:`detect_batch`."""
        from .strategies import normalize_intervals

        if not len(series_list):
            return []
        starts, ends = normalize_intervals(
            len(series_list), search_interval, "Start must be before end"
        )
        out = []
        for i, series in enumerate(series_list):
            nf = self._validate(series, int(starts[i]), int(ends[i]))
            out.append(self._fit(list(series[: int(starts[i])]), nf))
        return out

    def detect_batch(self, series_list, search_interval=(0, 2**31 - 1), params=None):
        """Batched :meth:`detect`: every series' seasonal model evaluates
        in ONE :func:`additive_holt_winters_batch` vector pass (parameters
        from ``params`` — e.g. a cached :meth:`fit_batch` — or fitted
        per series exactly like serial), element-for-element identical to
        the scalar path. ``search_interval``: one shared tuple or one per
        series. Series whose training span is shorter than one full cycle
        (possible only when the series itself is shorter than the
        validated ``2 * periodicity`` start) route through the scalar
        recurrence — the shared seasonal buffer only aligns with the
        scalar list layout from one cycle up."""
        from .strategies import normalize_intervals

        if not len(series_list):
            return []
        starts, ends = normalize_intervals(
            len(series_list), search_interval, "Start must be before end"
        )
        m = self.series_periodicity
        n = len(series_list)
        n_forecasts = np.zeros(n, dtype=np.int64)
        train_lengths = np.zeros(n, dtype=np.int64)
        for i, series in enumerate(series_list):
            n_forecasts[i] = self._validate(series, int(starts[i]), int(ends[i]))
            train_lengths[i] = min(int(starts[i]), len(series))
        if params is None:
            params = [
                self._fit(list(series[: int(starts[i])]), int(n_forecasts[i]))
                for i, series in enumerate(series_list)
            ]
        out: List = [None] * n
        batched = [i for i in range(n) if train_lengths[i] >= m]
        batched_set = set(batched)
        for i in range(n):
            if i in batched_set:
                continue
            results = additive_holt_winters(
                list(series_list[i][: int(starts[i])]), m,
                int(n_forecasts[i]), *params[i]
            )
            out[i] = self._flag(
                series_list[i], int(starts[i]),
                results.forecasts, results.residuals,
            )
        if batched:
            width = int(train_lengths[batched].max())
            mat = np.zeros((len(batched), width))
            for row, i in enumerate(batched):
                tl = int(train_lengths[i])
                mat[row, :tl] = np.asarray(
                    series_list[i][:tl], dtype=np.float64
                )
            # the serial path's own period sums: python `sum` over the
            # training list's elements, whatever their type
            sums = []
            for i in batched:
                training = list(series_list[i][: int(starts[i])])
                sums.append((sum(training[:m]), sum(training[m:2 * m])))
            res = additive_holt_winters_batch(
                mat, train_lengths[batched], m, n_forecasts[batched],
                np.array([params[i][0] for i in batched]),
                np.array([params[i][1] for i in batched]),
                np.array([params[i][2] for i in batched]),
                period_sums=sums,
            )
            for row, i in enumerate(batched):
                tl = int(train_lengths[i])
                nf = int(n_forecasts[i])
                out[i] = self._flag(
                    series_list[i], int(starts[i]),
                    res.forecasts[row, :nf], res.residuals[row, :tl],
                )
        return out
