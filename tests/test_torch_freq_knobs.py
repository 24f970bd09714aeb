"""The frequency engine's knobs and switches in the PyTorch/CUDA port, held
against the JAX reference: both packages resolve the six frequency-engine
constants through their knob registries (env override > tuned > static)
and honour ``DEEQU_TPU_DEVICE_FREQ`` and ``DEEQU_TPU_FREQ_HOST_ROUTE``, so
the same Dataset takes the same grouping routes in both.

The table has 70,000 rows, above the probe's 65,536-row slices: low-
cardinality sets that the static 2^21-row floor keeps on the device table
move to the host group-by once ``DEEQU_TPU_FREQ_HOST_ROUTE_MIN_ROWS=0``.
Each case asserts ``RunMonitor.device_freq_sets`` (sets on the device
table) and every metric equal between the packages (Entropy within 1e-12
relative, the rest exact), and the count each route gives.
"""

from __future__ import annotations

import math

import numpy as np
import pyarrow as pa
import pytest

import deequ_tpu.analyzers as J
import deequ_tpu.data as JD
import deequ_tpu_torch.analyzers as T
import deequ_tpu_torch.data as TD
from deequ_tpu.runners import AnalysisRunner as JaxRunner
from deequ_tpu.runners.engine import RunMonitor as JaxMonitor
from deequ_tpu.tuning import knobs as JK
from deequ_tpu_torch.runners import AnalysisRunner, RunMonitor
from deequ_tpu_torch.tuning import knobs as TK

ROWS = 70_000
BATCH = 1 << 14
FREQ_ENVS = ("DEEQU_TPU_DEVICE_FREQ", "DEEQU_TPU_FREQ_HOST_ROUTE", "DEEQU_TPU_AUTOTUNE",
             *(k.env for k in TK.REGISTRY.values() if k.env))


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    for env in FREQ_ENVS:
        monkeypatch.delenv(env, raising=False)
    JK.clear_tuned()
    TK.clear_tuned()
    yield
    JK.clear_tuned()
    TK.clear_tuned()


def _table() -> pa.Table:
    rng = np.random.default_rng(31)
    words = pa.array([f"w{i}" for i in range(300)])
    return pa.table({
        "k": rng.integers(0, 50, ROWS),
        "m": rng.integers(0, 100, ROWS),
        # distinct above rows/8: stays a plain string column
        "s": pa.array([f"s{v}" for v in rng.integers(0, 20_000, ROWS)]),
        "d": pa.DictionaryArray.from_arrays(
            pa.array(rng.integers(0, 300, ROWS).astype(np.int32)), words),
        "v": rng.standard_normal(ROWS),
    })


def _battery(m):
    return [m.Uniqueness(["k"]), m.CountDistinct(["k", "m"]), m.Entropy("m"),
            m.Distinctness(["s"]), m.Uniqueness(["d"]), m.Size(), m.Mean("v")]


def _values(ctx, battery) -> dict:
    return {repr(a): ctx.metric(a).value.get() for a in battery}


def _tune_max_distinct():
    for knobs in (TK, JK):
        knobs.set_tuned("freq_host_route_max_distinct", 64, source="test")


#: case -> (env, tuned-layer setter, device-table sets of the four non-
#: dictionary sets; the dictionary column always takes the dictionary scan)
CASES = {
    "static": ({}, None, 4),
    "host route floor 0": ({"DEEQU_TPU_FREQ_HOST_ROUTE_MIN_ROWS": "0"}, None, 0),
    "device freq off": ({"DEEQU_TPU_DEVICE_FREQ": "0"}, None, 0),
    "probe off": ({"DEEQU_TPU_FREQ_HOST_ROUTE": "0",
                   "DEEQU_TPU_FREQ_HOST_ROUTE_MIN_ROWS": "0"}, None, 4),
    # 64 distinct: k (50) goes to the host, (k, m), m and s stay on the table
    "tuned max distinct": ({"DEEQU_TPU_FREQ_HOST_ROUTE_MIN_ROWS": "0"}, _tune_max_distinct, 3),
    "tuned max distinct, autotune off": (
        {"DEEQU_TPU_FREQ_HOST_ROUTE_MIN_ROWS": "0", "DEEQU_TPU_AUTOTUNE": "0"},
        _tune_max_distinct, 0),
}


@pytest.mark.parametrize("case", list(CASES))
def test_routes_and_metrics_match_reference(case, monkeypatch):
    env, tune, sets = CASES[case]
    for key, value in env.items():
        monkeypatch.setenv(key, value)
    if tune is not None:
        tune()
    table = _table()
    jbat, tbat = _battery(J), _battery(T)
    jm, tm = JaxMonitor(), RunMonitor()
    want = _values(JaxRunner.do_analysis_run(JD.Dataset.from_arrow(table), jbat,
                                             batch_size=BATCH, placement="device", monitor=jm),
                   jbat)
    got = _values(AnalysisRunner.do_analysis_run(TD.Dataset.from_arrow(table), tbat,
                                                 batch_size=BATCH, device="cpu",
                                                 placement="device", monitor=tm), tbat)
    assert tm.device_freq_sets == jm.device_freq_sets == sets
    assert tm.passes == jm.passes == 1
    assert set(got) == set(want)
    for key, w in want.items():
        if key.startswith(("Entropy", "Mean")):
            assert math.isclose(got[key], w, rel_tol=1e-12, abs_tol=0.0), (key, got[key], w)
        else:
            assert got[key] == w, (key, got[key], w)


def test_explicit_arguments_outrank_the_knobs(monkeypatch):
    """``device_freq`` and the table sizes given to ``do_analysis_run``
    win over the switch and the registry."""
    monkeypatch.setenv("DEEQU_TPU_DEVICE_FREQ", "0")
    monkeypatch.setenv("DEEQU_TPU_FREQ_TABLE_SLOTS", "1024")
    TK.set_tuned("freq_buffer_entries", 1 << 16, source="test")
    tbat = _battery(T)
    data = TD.Dataset.from_arrow(_table())
    tm = RunMonitor()
    AnalysisRunner.do_analysis_run(data, tbat, batch_size=BATCH, device="cpu", monitor=tm,
                                   device_freq=True)
    assert tm.device_freq_sets == 4
    # the knobs size the tables when no argument is given: a 2^16-entry
    # buffer holds the 81,920 padded rows only as a compaction table,
    # and 1,024 slots overflow for (k, m)'s 5,000 groups and the 20,000
    # strings (both re-run in one more pass)
    assert tm.freq_overflow_fallbacks == 2 and tm.passes == 2
    tm = RunMonitor()
    AnalysisRunner.do_analysis_run(data, tbat, batch_size=BATCH, device="cpu", monitor=tm,
                                   device_freq=True, freq_table_slots=1 << 15,
                                   freq_buffer_entries=1 << 17)
    assert tm.device_freq_sets == 4 and tm.freq_overflow_fallbacks == 0 and tm.passes == 1


def test_invalid_switches_warn_once_and_stay_on(monkeypatch, caplog):
    from deequ_tpu_torch.analyzers import grouping

    monkeypatch.setattr(grouping, "_ENV_WARNED", set())
    monkeypatch.setenv("DEEQU_TPU_DEVICE_FREQ", "yes")
    monkeypatch.setenv("DEEQU_TPU_FREQ_HOST_ROUTE", "maybe")
    monkeypatch.setenv("DEEQU_TPU_FREQ_HOST_ROUTE_MIN_ROWS", "0")
    with caplog.at_level("WARNING", logger=grouping.__name__):
        for _ in range(3):
            assert grouping.device_freq_enabled()
            assert grouping.probably_low_cardinality(TD.Dataset.from_arrow(_table()), ["k"])
    warned = [r.message for r in caplog.records]
    assert sum("DEEQU_TPU_DEVICE_FREQ=" in w for w in warned) == 1
    assert sum("DEEQU_TPU_FREQ_HOST_ROUTE=" in w for w in warned) == 1
