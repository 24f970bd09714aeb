"""Host-side KLL sketch queries (rank / quantile / CDF).

Operates on the materialized per-level compactor buffers, either straight
from a fetched :class:`~deequ_tpu_torch.ops.kll.KLLSketchState` or re-materialized
from a persisted ``BucketDistribution.data`` payload (the reference's
`reconstruct` path, `analyzers/QuantileNonSample.scala:46-60`, used by
`metrics/KLLMetric.scala:24-40`).
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np


class HostKLL:
    """Weighted-sample view of a KLL sketch: items ``x_i`` with weights
    ``2^level``, answering rank and quantile queries
    (reference `analyzers/QuantileNonSample.scala:126-278`)."""

    def __init__(self, values: np.ndarray, weights: np.ndarray, sketch_size: int,
                 shrinking_factor: float):
        order = np.argsort(values, kind="stable")
        self.values = np.asarray(values, dtype=np.float64)[order]
        self.weights = np.asarray(weights, dtype=np.int64)[order]
        self.cum_weights = np.cumsum(self.weights)
        self.total_weight = int(self.cum_weights[-1]) if len(self.cum_weights) else 0
        self.sketch_size = sketch_size
        self.shrinking_factor = shrinking_factor

    # -- constructors -------------------------------------------------------

    @staticmethod
    def from_buffers(
        buffers: Sequence[Sequence[float]], sketch_size: int, shrinking_factor: float
    ) -> "HostKLL":
        values: List[float] = []
        weights: List[int] = []
        for level, buf in enumerate(buffers):
            w = 1 << level
            for x in buf:
                values.append(float(x))
                weights.append(w)
        return HostKLL(
            np.asarray(values, dtype=np.float64),
            np.asarray(weights, dtype=np.int64),
            sketch_size,
            shrinking_factor,
        )

    @staticmethod
    def from_state(state) -> "HostKLL":
        """From a KLLSketchState on the host (no copy of the padding)."""
        items = state.items.cpu().numpy()
        sizes = state.sizes.cpu().numpy()
        values: List[np.ndarray] = []
        weights: List[np.ndarray] = []
        for lvl in range(items.shape[0]):
            n = int(sizes[lvl])
            if n == 0:
                continue
            values.append(items[lvl][:n])
            weights.append(np.full(n, 1 << lvl, dtype=np.int64))
        if not values:
            return HostKLL(
                np.empty(0, dtype=np.float64), np.empty(0, dtype=np.int64),
                state.sketch_size, 0.0,
            )
        return HostKLL(
            np.concatenate(values), np.concatenate(weights), state.sketch_size, 0.0
        )

    # -- queries ------------------------------------------------------------

    @property
    def is_empty(self) -> bool:
        return self.total_weight == 0

    def rank(self, x: float) -> int:
        """Weighted count of items <= x (reference `getRank`)."""
        idx = np.searchsorted(self.values, x, side="right")
        return int(self.cum_weights[idx - 1]) if idx > 0 else 0

    def rank_exclusive(self, x: float) -> int:
        """Weighted count of items < x (reference `getRankExclusive`)."""
        idx = np.searchsorted(self.values, x, side="left")
        return int(self.cum_weights[idx - 1]) if idx > 0 else 0

    def quantile(self, q: float) -> float:
        """Smallest item whose cumulative weight reaches q * totalWeight."""
        if self.is_empty:
            return float("nan")
        q = min(max(q, 0.0), 1.0)
        target = q * self.total_weight
        idx = np.searchsorted(self.cum_weights, target, side="left")
        idx = min(idx, len(self.values) - 1)
        return float(self.values[idx])

    def quantiles(self, qs: Sequence[float]) -> List[float]:
        return [self.quantile(q) for q in qs]

    def cdf(self, xs: Sequence[float]) -> np.ndarray:
        """P[X <= x] estimates for each x."""
        if self.is_empty:
            return np.full(len(xs), np.nan)
        idx = np.searchsorted(self.values, np.asarray(xs, dtype=np.float64), side="right")
        cw = np.concatenate([[0], self.cum_weights])
        return cw[idx] / self.total_weight
