"""Holt-Winters of the PyTorch/CUDA port (deequ_tpu_torch.anomalydetection.
seasonal) against the JAX reference's serial path: the Holt-Winters cases of
``tests/test_anomaly_reference.py`` and ``tests/test_holtwinters_parity.py``
run through both packages (``m`` is either package), the port's ``detect``
equals the reference's ``detect`` bit for bit, and the port's batched
scoring equals its own serial ``detect`` element for element — messages
included — on the reference's ragged fleet.

The reference's batched path is not the oracle: it takes its initial period
sums as a left fold, while its serial path calls Python's ``sum``, which is
compensated (Neumaier) for floats since Python 3.12, so the two differ in
the last digit for some series. The port's batched path takes the serial
path's own sums.

Tolerance: none — indices, values and messages are compared exactly
(``abs=0.0`` where pytest.approx is used).
"""

import sys

import numpy as np
import pytest

from torch_pairs import pair, reference_isolated  # noqa: F401 (autouse)

NAMES = {
    "HoltWinters": "anomalydetection:HoltWinters",
    "MetricInterval": "anomalydetection:MetricInterval",
    "SeriesSeasonality": "anomalydetection:SeriesSeasonality",
    "seasonal": "anomalydetection.seasonal",
}
REF, PORT = pair(NAMES)


@pytest.fixture(params=[REF, PORT], ids=["jax", "torch"])
def m(request):
    return request.param


def weekly_series(weeks=6, seed=3, noise=0.2):
    rng = np.random.default_rng(seed)
    pattern = [10.0, 12.0, 14.0, 13.0, 11.0, 5.0, 4.0]
    return [v + float(rng.normal(0, noise)) for _ in range(weeks) for v in pattern]


def weekly(m):
    return m.HoltWinters(m.MetricInterval.DAILY, m.SeriesSeasonality.WEEKLY)


def flags(rows):
    return [(i, float(a.value), a.detail) for i, a in rows]


def ragged_hw_fleet():
    """The reference's ``test_batched_parity_ragged_fleet`` fleet."""
    rng = np.random.default_rng(6)
    fleet = []
    for k in range(8):
        weeks = int(rng.integers(4, 7))
        s = weekly_series(weeks=weeks, seed=100 + k)
        if k % 2 == 0:
            s[-1] += 25.0
        fleet.append(s)
    return fleet, [(len(s) - 7, len(s)) for s in fleet]


# a 3-week daily series with weekly shape + mild upward trend, and the
# forecasts an independent transliteration of the reference recurrences
# gives (tests/test_holtwinters_parity.py)
SERIES = [
    52.0, 48.0, 55.0, 60.0, 51.0, 49.0, 58.0,
    54.0, 50.0, 57.0, 63.0, 53.0, 51.0, 60.0,
    56.0, 52.0, 59.0, 65.0, 55.0, 53.0, 62.0,
]
GOLDEN_FORECASTS = [
    57.395022792, 53.4093265079, 60.4767359217, 65.949207499,
    56.6337166725, 54.8356517695, 64.0594997361,
]
GOLDEN_SSE = 10.57629367


class TestHoltWintersCases:
    """The reference's Holt-Winters scenarios, in both packages."""

    def test_detects_break_in_weekly_pattern(self, m):
        series = weekly_series()
        series[-2] += 30.0
        found = [i for i, _ in weekly(m).detect(series, (35, 42))]
        assert len(series) - 2 in found

    def test_break_flags_only_with_the_break(self, m):
        clean = weekly_series(seed=4)
        broken = list(clean)
        broken[-2] += 30.0
        day = len(clean) - 2
        assert day in [i for i, _ in weekly(m).detect(broken, (35, 42))]
        assert day not in [i for i, _ in weekly(m).detect(clean, (35, 42))]

    def test_yearly_monthly_periodicity(self, m):
        rng = np.random.default_rng(5)
        series = [50.0 + 10 * np.sin(2 * np.pi * (i % 12) / 12) + float(rng.normal(0, 0.3))
                  for i in range(48)]
        series[-1] += 60.0
        hw = m.HoltWinters(m.MetricInterval.MONTHLY, m.SeriesSeasonality.YEARLY)
        assert [i for i, _ in hw.detect(series, (47, 48))] == [47]

    def test_unsupported_period_combo_raises(self, m):
        with pytest.raises(ValueError):
            m.HoltWinters(m.MetricInterval.MONTHLY, m.SeriesSeasonality.WEEKLY)

    def test_validations(self, m):
        hw = weekly(m)
        for series, interval in (([], (0, 10)), ([1.0] * 30, (20, 10)),
                                 ([1.0] * 30, (-1, 10)), ([1.0] * 30, (7, 20))):
            with pytest.raises(ValueError):
                hw.detect(series, interval)
            with pytest.raises(ValueError):
                hw.detect_batch([series], [interval])

    def test_batched_accepts_cached_params(self, m):
        hw = weekly(m)
        fleet = [weekly_series(seed=7), weekly_series(seed=8)]
        fleet[0][-1] += 30.0
        intervals = [(len(s) - 7, len(s)) for s in fleet]
        params = hw.fit_batch(fleet, intervals)
        got = hw.detect_batch(fleet, intervals, params=params)
        want = hw.detect_batch(fleet, intervals)
        assert [flags(r) for r in got] == [flags(r) for r in want]
        assert (len(fleet[0]) - 1) in [i for i, _ in got[0]]

    def test_batch_core_matches_scalar_recurrence(self, m):
        """The reference's core case: numpy-scalar trainings in a float
        matrix, where Python's ``sum`` is a left fold on both paths."""
        rng = np.random.default_rng(9)
        trainings = [list(rng.normal(20, 3, int(rng.integers(14, 42)))) for _ in range(10)]
        params = [tuple(float(x) for x in p) for p in rng.uniform(0.01, 0.99, (10, 3))]
        nfs = [int(rng.integers(1, 8)) for _ in range(10)]
        tl = np.array([len(t) for t in trainings])
        mat = np.zeros((10, int(tl.max())))
        for i, t in enumerate(trainings):
            mat[i, :len(t)] = t
        res = m.seasonal.additive_holt_winters_batch(
            mat, tl, 7, np.array(nfs), *(np.array([p[j] for p in params]) for j in range(3)))
        for i, training in enumerate(trainings):
            want = m.seasonal.additive_holt_winters(training, 7, nfs[i], *params[i])
            assert res.forecasts[i, :nfs[i]].tolist() == pytest.approx(want.forecasts, abs=0.0)
            assert res.residuals[i, :len(training)].tolist() == pytest.approx(
                want.residuals, abs=0.0)

    def test_forecasts_match_pinned_goldens(self, m):
        result = m.seasonal.additive_holt_winters(SERIES, 7, 7, 0.3, 0.1, 0.2)
        assert result.forecasts == pytest.approx(GOLDEN_FORECASTS, abs=1e-9)
        sse = sum(r * r for r in result.residuals[:len(SERIES)])
        assert sse == pytest.approx(GOLDEN_SSE, abs=1e-8)

    def test_end_to_end_on_a_numpy_series(self, m):
        rng = np.random.default_rng(3)
        series = [50 + 5 * np.sin(2 * np.pi * (i % 7) / 7) + rng.normal(0, 0.3) for i in range(42)]
        series[-1] += 25
        anomalies = weekly(m).detect(np.asarray(series), (35, 42))
        assert any(idx == 41 for idx, _ in anomalies)


def _reference_cases():
    cases = []
    for seed in range(6):
        for weeks in (3, 4, 6):
            s = weekly_series(weeks=weeks, seed=40 + seed, noise=0.5)
            if seed % 2:
                s[-1] += 20.0
            cases.append((f"weekly-{seed}-{weeks}", s, (len(s) - 7, len(s))))
    rng = np.random.default_rng(5)
    yearly = [50.0 + 10 * np.sin(2 * np.pi * (i % 12) / 12) + float(rng.normal(0, 0.3))
              for i in range(48)]
    cases.append(("yearly", yearly, (36, 48)))
    cases.append(("golden", list(SERIES), (14, 21)))
    cases.append(("numpy", np.asarray(weekly_series(seed=9)), (35, 42)))
    cases.append(("past-the-end", weekly_series(seed=10, weeks=3), (21, 30)))
    return cases


@pytest.mark.parametrize("name,series,interval", _reference_cases(),
                         ids=[c[0] for c in _reference_cases()])
def test_port_detect_equals_the_reference_bit_for_bit(name, series, interval):
    yearly = name == "yearly"
    def strategy(m):
        if yearly:
            return m.HoltWinters(m.MetricInterval.MONTHLY, m.SeriesSeasonality.YEARLY)
        return weekly(m)
    want = flags(strategy(REF).detect(series, interval))
    got = flags(strategy(PORT).detect(series, interval))
    assert got == want
    assert strategy(PORT).fit_batch([series], [interval]) == strategy(REF).fit_batch(
        [series], [interval])


def test_port_batched_parity_ragged_fleet():
    """The reference's ``test_batched_parity_ragged_fleet`` on the port:
    one batched call equals per-series serial calls, element for element."""
    fleet, intervals = ragged_hw_fleet()
    hw = weekly(PORT)
    batched = hw.detect_batch(fleet, intervals)
    assert len(batched) == len(fleet)
    for series, interval, got in zip(fleet, intervals, batched):
        assert flags(got) == flags(hw.detect(series, interval))
    assert any(got for got in batched)


def test_port_batched_scoring_equals_the_reference_serial_path():
    fleet, intervals = ragged_hw_fleet()
    batched = weekly(PORT).detect_batch(fleet, intervals)
    for series, interval, got in zip(fleet, intervals, batched):
        assert flags(got) == flags(weekly(REF).detect(series, interval))


def test_the_port_takes_the_serial_paths_period_sums():
    """Python 3.12's ``sum`` of floats is compensated, a left fold is not;
    the port's batched core, given a series' own sums, equals the scalar
    recurrence on Python floats, where a left fold would be an ulp off."""
    assert sys.version_info >= (3, 12)
    assert sum([0.1] * 10) == 1.0
    left = 0.0
    for x in [0.1] * 10:
        left += x
    assert left != 1.0
    S = PORT.seasonal
    fleet, intervals = ragged_hw_fleet()
    params = weekly(PORT).fit_batch(fleet, intervals)
    for series, (start, end), p in zip(fleet, intervals, params):
        training = series[:start]
        nf = end - start
        want = S.additive_holt_winters(training, 7, nf, *p)
        res = S.additive_holt_winters_batch(
            np.asarray([training]), np.array([start]), 7, np.array([nf]),
            *(np.array([x]) for x in p),
            period_sums=[(sum(training[:7]), sum(training[7:14]))])
        assert res.forecasts[0].tolist() == want.forecasts
        assert res.residuals[0].tolist() == want.residuals


def test_the_reference_batched_path_is_an_ulp_off_its_serial_path():
    """The reference's fault this port does not copy: on the ragged fleet
    its batched core differs from its scalar recurrence in the last digit
    for some series (its left-fold period sums), the port's for none."""
    fleet, intervals = ragged_hw_fleet()
    params = weekly(REF).fit_batch(fleet, intervals)
    differs = {"jax": 0, "torch": 0}
    for m in (REF, PORT):
        S = m.seasonal
        for series, (start, end), p in zip(fleet, intervals, params):
            training = series[:start]
            want = S.additive_holt_winters(training, 7, end - start, *p)
            res = S.additive_holt_winters_batch(
                np.asarray([training]), np.array([start]), 7, np.array([end - start]),
                *(np.array([x]) for x in p),
                **({"period_sums": [(sum(training[:7]), sum(training[7:14]))]}
                   if m is PORT else {}))
            differs[m.name] += res.forecasts[0].tolist() != want.forecasts
    assert differs["torch"] == 0
    assert differs["jax"] > 0
