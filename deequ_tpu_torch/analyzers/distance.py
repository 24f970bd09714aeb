"""Profile-vs-profile distances: L-infinity distance between two KLL
quantile sketches or two categorical count maps, with the two-sample
Kolmogorov-Smirnov small-sample correction
(reference `analyzers/Distance.scala:19-88`).

A copy of the JAX package's module; a device sketch state is read to the
host (:meth:`HostKLL.from_state`) before its CDF is evaluated."""

from __future__ import annotations

from typing import Mapping, Union

import numpy as np

from ..ops.kll import KLLSketchState
from ..ops.kll_host import HostKLL


class Distance:
    """Namespace mirroring the reference's `Distance` object."""

    @staticmethod
    def numerical_distance(
        sample1: Union[HostKLL, KLLSketchState],
        sample2: Union[HostKLL, KLLSketchState],
        correct_for_low_number_of_samples: bool = False,
    ) -> float:
        """L-inf distance between the CDFs of two KLL sketches, evaluated at
        the union of both sketches' item values (reference
        `Distance.numericalDistance`, `Distance.scala:22-41`: rank-map keys
        are the sketch items, ranks normalize by each sketch's total
        weight)."""
        s1 = sample1 if isinstance(sample1, HostKLL) else HostKLL.from_state(sample1)
        s2 = sample2 if isinstance(sample2, HostKLL) else HostKLL.from_state(sample2)
        keys = np.union1d(s1.values, s2.values)
        n = float(s1.total_weight)
        m = float(s2.total_weight)
        cdf1 = s1.cdf(keys)
        cdf2 = s2.cdf(keys)
        linf_simple = float(np.max(np.abs(cdf1 - cdf2))) if len(keys) else 0.0
        return _select_metrics(linf_simple, n, m, correct_for_low_number_of_samples)

    @staticmethod
    def categorical_distance(
        sample1: Mapping[str, int],
        sample2: Mapping[str, int],
        correct_for_low_number_of_samples: bool = False,
    ) -> float:
        """L-inf distance between two categorical count maps (reference
        `Distance.categoricalDistance`, `Distance.scala:44-68`; per the
        reference, the comparison is per-key probability mass, not a
        cumulative distribution). Accepts any mapping, including the
        pandas Series inside FrequenciesAndNumRows."""
        d1 = dict(sample1)  # normalizes Mapping and pandas Series alike
        d2 = dict(sample2)
        n = float(sum(d1.values()))
        m = float(sum(d2.values()))
        keys = set(d1) | set(d2)
        linf_simple = 0.0
        for key in keys:
            p1 = d1.get(key, 0) / n if n else 0.0
            p2 = d2.get(key, 0) / m if m else 0.0
            linf_simple = max(linf_simple, abs(p1 - p2))
        return _select_metrics(linf_simple, n, m, correct_for_low_number_of_samples)


def _select_metrics(
    linf_simple: float, n: float, m: float, correct_for_low_number_of_samples: bool
) -> float:
    """Reference `Distance.selectMetrics` (`Distance.scala:72-88`). NOTE the
    reference's naming is inverted relative to intuition and is reproduced
    exactly: with the flag TRUE the raw L-inf is returned; with the default
    FALSE the two-sample Kolmogorov-Smirnov robustness term is subtracted
    (distances indistinguishable from sampling noise floor at 0)."""
    if correct_for_low_number_of_samples:
        return linf_simple
    if n <= 0 or m <= 0:
        # an empty sample: the KS noise floor is infinite (the reference's
        # Scala double division yields Infinity), so the robust distance is 0
        return 0.0
    return max(0.0, linf_simple - 1.8 * np.sqrt((n + m) / (n * m)))
