"""Grouping sets on a mesh: the PyTorch/CUDA port against the JAX
reference on its 8 virtual CPU devices (tests/conftest.py).

The reference keeps no frequency table per shard: ``sharded_update``
runs the fused update with replicated states and row-sharded features, so
a grouping set's ``FrequencyTableState`` on a mesh is one global table.
The port keeps one table per set too, fed the whole batch on the mesh's
first device. Both give the same Size, Uniqueness, CountDistinct and
Entropy over high-cardinality int64 keys, strings and a two-column set,
unsharded and on ``make_mesh(8)``, with a resident plan and a
non-resident one (a small ``freq_buffer_entries``), each set on a device
table (``device_freq_sets == 1`` a set). Counts exactly, Entropy within
1e-12 relative.

One planning difference remains and is pinned below: a sharded resident
plan gets the full ``slots`` table in the reference and the minimal 8-slot
table in the port. No path of either package reads that table: a
resident scan's drain reads its buffer alone, and the reference's
collective merge, which would compact into it, never receives a device
table scan (such a scan has no host partial). So the answers agree.
"""

from __future__ import annotations

import math

import numpy as np
import pyarrow as pa
import pytest

import deequ_tpu.analyzers as J
import deequ_tpu.data as JD
import deequ_tpu.parallel as JP
import deequ_tpu_torch.analyzers as T
import deequ_tpu_torch.data as TD
import deequ_tpu_torch.parallel as TP
from deequ_tpu.analyzers.grouping import plan_table_scan as ref_plan_table_scan
from deequ_tpu.runners import AnalysisRunner as JaxRunner
from deequ_tpu.runners.engine import RunMonitor as JaxMonitor
from deequ_tpu_torch.analyzers.grouping import plan_table_scan
from deequ_tpu_torch.runners import AnalysisRunner, RunMonitor

pytestmark = [pytest.mark.mesh, pytest.mark.grouping]

ROWS = 40_000
BATCH = 8192
RTOL = 1e-12
#: the grouping sets: int64 keys, strings, and the two together
SETS = (("k",), ("s",), ("k", "s"))
ROUTES = {
    "resident": {},
    "non-resident": {"DEEQU_TPU_FREQ_BUFFER_ENTRIES": "8192"},
}


def _table() -> pa.Table:
    rng = np.random.default_rng(20)
    return pa.table({
        "k": rng.integers(0, 30_000, ROWS),
        "s": pa.array([f"v{v}" for v in rng.integers(0, 25_000, ROWS)]),
    })


def _battery(m, cols):
    battery = [m.Size(), m.Uniqueness(list(cols)), m.CountDistinct(list(cols))]
    if len(cols) == 1:
        battery.append(m.Entropy(cols[0]))
    return battery


def _values(ctx, battery) -> dict:
    return {repr(a): ctx.metric(a).value.get() for a in battery}


@pytest.fixture(autouse=True)
def _static_knobs(monkeypatch):
    monkeypatch.setenv("DEEQU_TPU_AUTOTUNE", "0")


@pytest.mark.parametrize("route", sorted(ROUTES))
@pytest.mark.parametrize("meshed", [False, True], ids=["unsharded", "mesh8"])
@pytest.mark.parametrize("cols", SETS, ids=lambda c: "-".join(c))
def test_grouping_sets_match_the_reference(cols, meshed, route, monkeypatch):
    for key, value in ROUTES[route].items():
        monkeypatch.setenv(key, value)
    table = _table()
    jbat, tbat = _battery(J, cols), _battery(T, cols)
    jm, tm = JaxMonitor(), RunMonitor()
    want = _values(JaxRunner.do_analysis_run(
        JD.Dataset.from_arrow(table), jbat, batch_size=BATCH, placement="device",
        sharding=JP.make_mesh(8) if meshed else None, monitor=jm), jbat)
    got = _values(AnalysisRunner.do_analysis_run(
        TD.Dataset.from_arrow(table), tbat, batch_size=BATCH, placement="device", device="cpu",
        sharding=TP.make_mesh(8, device="cpu") if meshed else None, monitor=tm), tbat)
    assert set(got) == set(want)
    for key, w in want.items():
        if key.startswith("Entropy"):
            assert math.isclose(got[key], w, rel_tol=RTOL, abs_tol=0.0), (key, got[key], w)
        else:
            assert got[key] == w, (key, got[key], w)
    assert got[repr(tbat[0])] == float(ROWS)
    assert tm.device_freq_sets == jm.device_freq_sets == 1
    assert tm.freq_overflow_fallbacks == jm.freq_overflow_fallbacks == 0
    assert tm.passes == 1
    from deequ_tpu_torch.tuning import knobs

    schema = TD.Dataset.from_arrow(table).schema
    plans = (ref_plan_table_scan(JD.Dataset.from_arrow(table).schema, list(cols), ROWS, BATCH,
                                 sharded=meshed),
             plan_table_scan(schema, list(cols), ROWS, BATCH,
                             freq_buffer_entries=knobs.value("freq_buffer_entries"),
                             sharded=meshed))
    assert [p.resident for p in plans] == [route == "resident"] * 2


@pytest.mark.parametrize("cols", SETS, ids=lambda c: "-".join(c))
def test_the_sharded_resident_plan(cols):
    """The port's sharded resident plan keeps the minimal 8-slot table;
    the reference's keeps ``slots``, the configured capacity capped at
    the row count (rounded up to a power of two). Both are resident with
    the same buffer, and both drains read the buffer alone, so the table
    of a sharded resident plan is never read and the metrics agree
    (test_grouping_sets_match_the_reference)."""
    table = _table()
    ref = ref_plan_table_scan(JD.Dataset.from_arrow(table).schema, list(cols), ROWS, BATCH,
                              sharded=True)
    port = plan_table_scan(TD.Dataset.from_arrow(table).schema, list(cols), ROWS, BATCH,
                           sharded=True)
    unsharded = plan_table_scan(TD.Dataset.from_arrow(table).schema, list(cols), ROWS, BATCH)
    assert ref.resident and port.resident
    assert ref.slots == 1 << 16  # 40,000 rows below the 2^22 default, rounded up
    assert port.slots == unsharded.slots == 8
    assert port.buffer_entries == ref.buffer_entries == unsharded.buffer_entries
    assert port.buffer_entries >= -(-ROWS // BATCH) * BATCH
