"""The PyTorch/CUDA port's grouping engine against the JAX reference.

The same seeded numpy inputs go through ``deequ_tpu`` (JAX on the CPU) and
``deequ_tpu_torch`` on ``device="cpu"``, where the kernels ``freq_keys``
and ``freq_compact`` run their plain PyTorch versions. Tolerances: hashes,
keys, counts, state leaves and every grouping metric but Entropy are
bit-exact; Entropy is within 1e-12 relative (it is a float reduction; both
packages reduce the count multiset in the same canonical order, so it is
bit-exact in practice).

Covered: the key hashes, ``freq_compact``, ``FrequencyTableState`` (append,
compaction, merge, and carried across with ``convert.py``), the planner and
the cardinality probe, the host group-by, and whole runs on the three
device-table routes (resident, compaction, overflow) and the host route.
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pyarrow as pa
import pytest
import torch

import chip_smoke
import deequ_tpu.analyzers as J
import deequ_tpu.analyzers.grouping as JG
import deequ_tpu.data as JD
import deequ_tpu.ops as JO
import deequ_tpu.ops.hashing as JH
import deequ_tpu.runners.features as JF
import deequ_tpu_torch.analyzers as T
import deequ_tpu_torch.analyzers.grouping as TG
import deequ_tpu_torch.data as TD
import deequ_tpu_torch.ops.hashing as TH
import deequ_tpu_torch.runners.features as TF
from deequ_tpu.analyzers.states import FrequencyTableState as JaxTableState
from deequ_tpu.runners import AnalysisRunner as JaxRunner
from deequ_tpu.runners.engine import RunMonitor as JaxMonitor
from deequ_tpu_torch.convert import from_reference, to_reference
from deequ_tpu_torch.kernels.freq_compact import freq_compact, freq_compact_plain
from deequ_tpu_torch.runners import AnalysisRunner, RunMonitor
from deequ_tpu_torch.runners.engine import to_device

CPU = torch.device("cpu")
RTOL = 1e-12
SENT = np.uint64(JH.FREQ_KEY_SENTINEL)


def _u64(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint64)


# ---------------------------------------------------------------------------
# hashes
# ---------------------------------------------------------------------------

EDGE_INT64 = np.array([0, 1, -1, -(2**63), 2**63 - 1, 2**53, 2**53 + 1], dtype=np.int64)


def _hash_inputs() -> np.ndarray:
    rng = np.random.default_rng(11)
    return np.concatenate([EDGE_INT64, rng.integers(-(2**63), 2**63 - 1, 5000, dtype=np.int64)])


def test_splitmix64_matches_reference_and_numpy():
    v = _hash_inputs()
    u = v.view(np.uint64)
    got = _u64(TH.splitmix64_torch(torch.from_numpy(v)))
    assert np.array_equal(got, np.asarray(JH.splitmix64_jnp(jnp.asarray(u))))
    assert np.array_equal(got, JH.splitmix64(u))
    assert np.array_equal(got, TH.splitmix64(u))


@pytest.mark.parametrize("seed", ["scalar", "chained"])
def test_xxhash64_u64_matches_reference_and_numpy(seed):
    """One column hashed with the default seed, and a second column chained
    on the first one's keys (per-row seeds), as multi-column keys chain."""
    v = _hash_inputs()
    u = v.view(np.uint64)
    if seed == "scalar":
        t_seed, j_seed, n_seed = JH.DEFAULT_SEED, np.uint64(JH.DEFAULT_SEED), JH.DEFAULT_SEED
    else:
        first = TH.splitmix64_torch(torch.from_numpy(v[::-1].copy()))
        t_seed, j_seed, n_seed = first, jnp.asarray(_u64(first)), _u64(first)
    got = _u64(TH.xxhash64_u64_torch(torch.from_numpy(v), t_seed))
    assert np.array_equal(got, np.asarray(JH.xxhash64_u64_jnp(jnp.asarray(u), j_seed)))
    assert np.array_equal(got, JH.xxhash64_u64(u, n_seed))
    assert np.array_equal(got, TH.xxhash64_u64(u, n_seed))


# ---------------------------------------------------------------------------
# freq_compact
# ---------------------------------------------------------------------------


def _pairs(n: int, distinct: int, seed: int):
    """Keys drawn from ``distinct`` values, many with the top bit set, a
    tenth of them the sentinel with count 0, the others with counts >= 1."""
    rng = np.random.default_rng(seed)
    pool = rng.integers(0, 2**64 - 1, distinct, dtype=np.uint64)
    pool[: distinct // 3] |= np.uint64(1 << 63)
    keys = pool[rng.integers(0, distinct, n)]
    keys[rng.random(n) < 0.1] = SENT
    counts = np.where(keys == SENT, 0, rng.integers(1, 5, n)).astype(np.int64)
    return keys, counts


def _compact_reference(keys: np.ndarray, counts: np.ndarray, out_size: int):
    out = JO.freq_compact(jnp.asarray(keys), jnp.asarray(counts), out_size, jnp.uint64(SENT))
    return [np.asarray(x) for x in out]


def _assert_compacted(got, want):
    keys, counts, n_unique, kept, total = want
    assert np.array_equal(_u64(got.keys), keys)
    assert np.array_equal(got.counts.numpy(), counts)
    assert (int(got.n_unique), int(got.kept_rows), int(got.total_rows)) == (
        int(n_unique), int(kept), int(total))


@pytest.mark.parametrize("out_size", [16, 200, 4096])
def test_freq_compact_plain_matches_reference(out_size):
    """Exact loss accounting below the unique count (16, 200 < ~300 keys)
    and sentinel padding above it."""
    keys, counts = _pairs(3000, 300, out_size)
    got = freq_compact_plain(torch.from_numpy(keys.view(np.int64)), torch.from_numpy(counts),
                             out_size)
    _assert_compacted(got, _compact_reference(keys, counts, out_size))


@pytest.mark.parametrize("out_size", [64, 1024])
def test_freq_compact_buffer_and_merge_modes_match_reference(out_size):
    """The wrapper's two modes (a table and a raw buffer; two tables) equal
    the reference's compaction of the concatenated pairs."""
    keys, counts = _pairs(2000, 700, 3)
    table = freq_compact_plain(torch.from_numpy(keys.view(np.int64)), torch.from_numpy(counts),
                               out_size)
    buf = np.random.default_rng(4).integers(0, 2**64 - 1, 900, dtype=np.uint64)
    buf[::7] = SENT
    known = _u64(table.keys)  # keys already in the table
    at = np.arange(0, len(buf), 5)[: len(known)]
    buf[at] = known[: len(at)]
    got = freq_compact(table.keys, table.counts, torch.from_numpy(buf.view(np.int64)), None,
                       out_size)
    want = _compact_reference(
        np.concatenate([_u64(table.keys), buf]),
        np.concatenate([table.counts.numpy(), (buf != SENT).astype(np.int64)]), out_size)
    _assert_compacted(got, want)
    other = freq_compact_plain(torch.from_numpy(buf.view(np.int64)),
                               torch.from_numpy((buf != SENT).astype(np.int64)), out_size)
    got = freq_compact(table.keys, table.counts, other.keys, other.counts, out_size)
    want = _compact_reference(
        np.concatenate([_u64(table.keys), _u64(other.keys)]),
        np.concatenate([table.counts.numpy(), other.counts.numpy()]), out_size)
    _assert_compacted(got, want)


@pytest.mark.parametrize("case", chip_smoke.FREQ_EDGE_CASES)
def test_freq_compact_edge_cases_match_reference(case):
    """The K7 cases the kernel is held on (keys that differ only in their
    lowest byte, on both sides of 2^63, a buffer half sentinels, an empty
    table, out_size below n_unique, runs longer than a tile, two
    overlapping tables): the wrapper's result on the CPU equals the
    reference's compaction of the concatenated pairs exactly."""
    a_keys, a_counts, b_keys, b_counts, out_size = chip_smoke.freq_edge_case(case)
    counts_b = b_counts if b_counts is not None else (b_keys != SENT).astype(np.int64)
    got = freq_compact(torch.from_numpy(a_keys.view(np.int64)), torch.from_numpy(a_counts),
                       torch.from_numpy(b_keys.view(np.int64)),
                       None if b_counts is None else torch.from_numpy(b_counts), out_size)
    want = _compact_reference(np.concatenate([a_keys, b_keys]),
                              np.concatenate([a_counts, counts_b]), out_size)
    _assert_compacted(got, want)


def test_freq_compact_all_sentinel():
    keys = torch.full((100,), -1, dtype=torch.int64)
    got = freq_compact_plain(keys, torch.zeros(100, dtype=torch.int64), 8)
    _assert_compacted(got, _compact_reference(
        np.full(100, SENT, dtype=np.uint64), np.zeros(100, dtype=np.int64), 8))


# ---------------------------------------------------------------------------
# FrequencyTableState and the table scan, batch by batch
# ---------------------------------------------------------------------------


def _key_table(n: int = 3000, seed: int = 5) -> pa.Table:
    """Columns of every key kind: int64 (negative, above 2^53, and one
    row whose SplitMix64 key is the sentinel), int8, bool, float64 (NaN,
    -0.0 and 0.0), and strings; with nulls."""
    rng = np.random.default_rng(seed)
    big = np.array([2**53, 2**53 + 1, 2**53 + 2, -(2**62), 2**63 - 1], dtype=np.int64)
    i64 = np.where(rng.random(n) < 0.3, big[rng.integers(0, 5, n)], rng.integers(-900, 900, n))
    # the int64 whose SplitMix64 is all ones: a real key equal to the sentinel
    i64[::97] = _splitmix64_preimage_of_sentinel()
    f = rng.integers(-40, 40, n) / 4.0
    f[rng.random(n) < 0.05] = np.nan
    f[rng.random(n) < 0.05] = -0.0
    return pa.table({
        "i": pa.array(i64, mask=rng.random(n) < 0.05),
        "b": pa.array(rng.random(n) < 0.3, mask=rng.random(n) < 0.05),
        "n8": pa.array(rng.integers(-128, 128, n).astype(np.int8)),
        "f": pa.array(f, mask=rng.random(n) < 0.03),
        "s": pa.array([None if v < 40 else f"s{v}" for v in rng.integers(0, 1500, n)]),
    })


def _splitmix64_preimage_of_sentinel() -> int:
    """SplitMix64 is a bijection; invert it at the sentinel."""
    def unxorshift(v, s):
        out = v
        for _ in range(64 // s + 1):
            out = v ^ (out >> np.uint64(s))
        return out

    with np.errstate(over="ignore"):
        v = np.array([SENT], dtype=np.uint64)
        v = unxorshift(v, 31)
        v = v * np.uint64(pow(0x94D049BB133111EB, -1, 2**64))
        v = unxorshift(v, 27)
        v = v * np.uint64(pow(0xBF58476D1CE4E5B9, -1, 2**64))
        v = unxorshift(v, 30)
    assert JH.splitmix64(v)[0] == SENT
    return int(v.view(np.int64)[0])


def _scans(columns, slots, buffer_entries, resident):
    kinds = tuple(
        "num" if c in ("i", "b", "n8") else "hash" for c in columns
    )
    args = (tuple(columns), kinds, slots, buffer_entries)
    return (JG.DeviceFrequencyTableScan(*args, resident=resident),
            TG.DeviceFrequencyTableScan(*args, resident=resident))


def _fold(jscan, tscan, table, batch_rows, jstate=None, tstate=None, batches=None):
    """Fold the table's batches in both packages; yields both states after
    each batch."""
    jstate = jscan.init_state() if jstate is None else jstate
    tstate = tscan.init_state(CPU) if tstate is None else tstate
    jbatches = list(JD.Dataset.from_arrow(table).batches(batch_rows))
    tbatches = list(TD.Dataset.from_arrow(table).batches(batch_rows))
    picked = range(len(jbatches)) if batches is None else batches
    for b in picked:
        jf = JF.FeatureBuilder(jscan.feature_specs()).build(jbatches[b])
        jstate = jscan.update(jstate, {k: jnp.asarray(v) for k, v in jf.items()})
        tf = TF.FeatureBuilder(tscan.feature_specs()).build(tbatches[b])
        tstate = tscan.update(tstate, to_device(tf, CPU))
        yield jstate, tstate


def _assert_same_leaves(jstate, tstate):
    name, leaves = to_reference(tstate)
    assert name == "FrequencyTableState"
    want = [np.asarray(x) for x in jax.tree_util.tree_leaves(jstate)]
    assert len(leaves) == len(want) == 9
    for i, (got, exp) in enumerate(zip(leaves, want)):
        assert got.dtype == exp.dtype and got.shape == exp.shape, i
        assert np.array_equal(got, exp), i


def _drained(scan, state):
    out = scan.drain(state)
    return None if out is None else (sorted(zip(out.keys.tolist(), out.counts.tolist())),
                                     out.num_rows)


@pytest.mark.parametrize("columns", [("i",), ("b",), ("n8",), ("f",), ("s",), ("i", "s"),
                                     ("s", "f", "b")])
@pytest.mark.parametrize("route", ["resident", "compaction"])
def test_table_state_append_and_compact_match_reference(columns, route):
    """Every leaf bit-equal after every batch: the resident append, and a
    1024-entry buffer that compacts into a 4096-slot table every batch."""
    table = _key_table()
    if route == "resident":
        jscan, tscan = _scans(columns, 8, 4096, True)
    else:
        jscan, tscan = _scans(columns, 4096, 1024, False)
    for jstate, tstate in _fold(jscan, tscan, table, 1024):
        _assert_same_leaves(jstate, tstate)
    assert _drained(tscan, tstate) == _drained(jscan, jstate)
    if columns == ("i",):
        assert int(tstate.sent_rows) > 0  # the sentinel-valued real key


def test_table_state_overflow_and_merge_match_reference():
    """A 256-slot table loses groups (exact loss counts), and merges of
    two states (each holding a filled buffer) equal the reference's."""
    table = _key_table()
    jscan, tscan = _scans(("i", "s"), 256, 1024, False)
    *_, (ja, ta) = _fold(jscan, tscan, table, 1024, batches=[0, 1])
    *_, (jb, tb) = _fold(jscan, tscan, table, 1024, batches=[2])
    _assert_same_leaves(ja, ta)
    assert int(ta.lost_rows) > 0 and tscan.drain(ta) is None
    _assert_same_leaves(ja.merge(jb), ta.merge(tb))
    # merges that keep every group
    jscan, tscan = _scans(("i", "s"), 4096, 1024, False)
    *_, (ja, ta) = _fold(jscan, tscan, table, 1024, batches=[0, 1])
    *_, (jb, tb) = _fold(jscan, tscan, table, 1024, batches=[2])
    jm, tm = ja.merge(jb), ta.merge(tb)
    _assert_same_leaves(jm, tm)
    assert _drained(tscan, tm) == _drained(jscan, jm)


def test_table_state_carried_across_both_ways():
    """Batches 1-2 in JAX, carried over and batch 3 in the port, equals
    JAX over all three; a port state carried back and merged in JAX
    drains to the same frequencies as the port's own merge."""
    table = _key_table()
    jscan, tscan = _scans(("i", "f"), 4096, 1024, False)
    states = list(_fold(jscan, tscan, table, 1024))
    jfull = states[-1][0]
    jhead = states[1][0]
    carried = from_reference("FrequencyTableState",
                             [np.asarray(x) for x in jax.tree_util.tree_leaves(jhead)], CPU)
    assert carried.fill == int(jhead.buf_fill)
    *_, (_, tstate) = _fold(jscan, tscan, table, 1024, tstate=carried, batches=[2])
    _assert_same_leaves(jfull, tstate)
    # and back: the port's state as a reference state, merged there
    _, leaves = to_reference(tstate)
    back = JaxTableState(*[jnp.asarray(x) for x in leaves])
    jm = back.merge(jfull)
    tm = tstate.merge(from_reference(
        "FrequencyTableState", [np.asarray(x) for x in jax.tree_util.tree_leaves(jfull)], CPU))
    _assert_same_leaves(jm, tm)
    assert _drained(jscan, jm) == _drained(tscan, tm)


# ---------------------------------------------------------------------------
# the planner and the cardinality probe
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("slots", [64, 1 << 10, 1 << 22])
@pytest.mark.parametrize("cap", [1 << 12, 1 << 16, 3000, 1 << 25])
def test_plan_table_scan_matches_reference(slots, cap, monkeypatch):
    monkeypatch.setenv("DEEQU_TPU_AUTOTUNE", "0")
    monkeypatch.setenv("DEEQU_TPU_FREQ_TABLE_SLOTS", str(slots))
    monkeypatch.setenv("DEEQU_TPU_FREQ_BUFFER_ENTRIES", str(cap))
    table = _key_table(10)
    jschema, tschema = JD.Dataset.from_arrow(table).schema, TD.Dataset.from_arrow(table).schema
    for rows in (0, 1, 1000, 4096, 4097, 65_536, 3_000_000, 50_000_000):
        for batch in (1, 1000, 1024, 1 << 20):
            for cols in (("i",), ("s", "f", "b")):
                want = JG.plan_table_scan(jschema, cols, rows, batch)
                got = TG.plan_table_scan(tschema, cols, rows, batch, slots, cap)
                assert (got.columns, got.column_kinds, got.slots, got.buffer_entries,
                        got.resident) == (want.columns, want.column_kinds, want.slots,
                                          want.buffer_entries, want.resident), (rows, batch)


def _probe_tables():
    n = (1 << 21) + 5000
    rng = np.random.default_rng(8)
    return {
        "low": pa.table({"k": rng.integers(0, 300, n), "m": rng.integers(0, 50, n)}),
        "high": pa.table({"k": rng.integers(0, 1 << 40, n), "m": rng.integers(0, 50, n)}),
        # sorted keys: every slice holds few distinct values, but new ones
        "clustered": pa.table({"k": np.sort(rng.integers(0, 100_000, n)),
                               "m": rng.integers(0, 50, n)}),
        "small": pa.table({"k": rng.integers(0, 300, 1000), "m": rng.integers(0, 50, 1000)}),
    }


@pytest.mark.parametrize("layout", ["low", "high", "clustered", "small"])
def test_probably_low_cardinality_matches_reference(layout, monkeypatch):
    monkeypatch.setenv("DEEQU_TPU_AUTOTUNE", "0")
    table = _probe_tables()[layout]
    jds, tds = JD.Dataset.from_arrow(table), TD.Dataset.from_arrow(table)
    for cols in (("k",), ("k", "m"), ("m",)):
        assert TG.probably_low_cardinality(tds, cols) == JG.probably_low_cardinality(jds, cols)
    if layout == "low":
        assert TG.probably_low_cardinality(tds, ("k",))
        assert TG.probably_low_cardinality(tds, ("k", "m"))  # 300 x 50 <= 2^15
    if layout in ("high", "clustered", "small"):
        assert not TG.probably_low_cardinality(tds, ("k",))


# ---------------------------------------------------------------------------
# the host group-by
# ---------------------------------------------------------------------------


def _group_table(n: int = 5000, seed: int = 9) -> pa.Table:
    rng = np.random.default_rng(seed)
    f = rng.integers(-30, 30, n) / 2.0
    f[rng.random(n) < 0.05] = np.nan
    f[rng.random(n) < 0.05] = -0.0
    return pa.table({
        "small": pa.array(rng.integers(-100, 100, n), mask=rng.random(n) < 0.05),
        "n8": pa.array(rng.integers(-128, 128, n).astype(np.int8)),
        "wide": pa.array(rng.integers(-(2**62), 2**62, n) // (2**50)),
        "s": pa.array([f"v{v}" for v in rng.integers(0, 800, n)]),
        "snull": pa.array([None if v < 30 else f"v{v}" for v in rng.integers(0, 800, n)]),
        "f": pa.array(f, mask=rng.random(n) < 0.02),
        "b": pa.array(rng.random(n) < 0.4),
    })


def _canonical(series: pd.Series):
    return sorted((repr(k), int(v)) for k, v in series.items())


@pytest.mark.parametrize("columns", [("small",), ("n8",), ("wide",), ("s",), ("snull",),
                                     ("f",), ("b",), ("small", "s"), ("f", "b", "n8")])
def test_host_group_by_matches_reference(columns):
    """The integer bincount (small, n8), np.unique (wide), Arrow string
    (s, snull), float groupby with NaN and -0.0 (f) and several-column
    paths, over batches with padding."""
    table = _group_table()
    j = JG.FrequenciesAndNumRows.empty(list(columns))
    t = TG.FrequenciesAndNumRows.empty(list(columns))
    for batch in JD.Dataset.from_arrow(table).batches(1500):
        j = j.update(batch)
    for batch in TD.Dataset.from_arrow(table).batches(1500):
        t = t.update(batch)
    assert t.num_rows == j.num_rows == table.num_rows
    assert _canonical(t.frequencies) == _canonical(j.frequencies)
    assert t.stream_summary() == j.stream_summary()


# ---------------------------------------------------------------------------
# whole runs: the port on the CPU against the reference at placement="device"
# ---------------------------------------------------------------------------

BIG_DICTIONARY = 70_000  # > 2^16: the table, not the dictionary scan


def _run_table(n: int = 6000, seed: int = 12) -> pa.Table:
    rng = np.random.default_rng(seed)
    big = (2**53 + np.arange(4)).astype(np.int64)
    i64 = np.where(rng.random(n) < 0.2, big[rng.integers(0, 4, n)], rng.integers(-3000, 3000, n))
    f = rng.integers(-500, 500, n) / 4.0
    f[rng.random(n) < 0.03] = np.nan
    f[rng.random(n) < 0.03] = -0.0
    f[rng.random(n) < 0.03] = 0.0
    words = pa.array([f"word-{i}" for i in range(BIG_DICTIONARY)])
    return pa.table({
        "i64": pa.array(i64, mask=rng.random(n) < 0.04),
        "i32": pa.array(rng.integers(-2000, 2000, n).astype(np.int32)),
        "i8": pa.array(rng.integers(-128, 128, n).astype(np.int8)),
        "b": pa.array(rng.random(n) < 0.5, mask=rng.random(n) < 0.04),
        "f": pa.array(f, mask=rng.random(n) < 0.04),
        "s": pa.array([None if v < 100 else f"k{v}" for v in rng.integers(0, 5000, n)]),
        "d": pa.DictionaryArray.from_arrays(
            pa.array(rng.integers(0, BIG_DICTIONARY, n).astype(np.int32),
                     mask=rng.random(n) < 0.04), words),
    })


SETS = [("i64",), ("i32",), ("i8",), ("b",), ("f",), ("s",), ("d",),
        ("i64", "s"), ("s", "i64"), ("i8", "f", "d"), ("d", "f", "i8")]


def _battery(m, cols):
    return [m.Uniqueness(list(cols)), m.Distinctness(list(cols)),
            m.UniqueValueRatio(list(cols)), m.CountDistinct(list(cols)),
            m.Entropy(list(cols)) if len(cols) == 1 else m.Uniqueness(list(cols))]


def _values(ctx, battery):
    return {repr(a): ctx.metric(a).value.get() for a in battery}


def _assert_values_match(got: dict, want: dict):
    assert set(got) == set(want)
    for key, w in want.items():
        g = got[key]
        if key.startswith("Entropy"):
            assert math.isclose(g, w, rel_tol=RTOL, abs_tol=0.0), (key, g, w)
        else:
            assert g == w, (key, g, w)


ROUTES = {
    "resident": ({}, {}),
    "compaction": ({"freq_buffer_entries": 2048}, {"DEEQU_TPU_FREQ_BUFFER_ENTRIES": "2048"}),
    "overflow": ({"freq_buffer_entries": 2048, "freq_table_slots": 64},
                 {"DEEQU_TPU_FREQ_BUFFER_ENTRIES": "2048", "DEEQU_TPU_FREQ_TABLE_SLOTS": "64"}),
}


@pytest.mark.parametrize("cols", SETS, ids=lambda c: "-".join(c))
@pytest.mark.parametrize("route", sorted(ROUTES))
def test_runs_match_reference(cols, route, monkeypatch):
    monkeypatch.setenv("DEEQU_TPU_AUTOTUNE", "0")
    options, env = ROUTES[route]
    for key, value in env.items():
        monkeypatch.setenv(key, value)
    table = _run_table()
    jm, tm = JaxMonitor(), RunMonitor()
    jbat, tbat = _battery(J, cols), _battery(T, cols)
    want = _values(JaxRunner.do_analysis_run(
        JD.Dataset.from_arrow(table), jbat, batch_size=1024, placement="device", monitor=jm),
        jbat)
    got = _values(AnalysisRunner.do_analysis_run(
        TD.Dataset.from_arrow(table), tbat, batch_size=1024, device="cpu", monitor=tm,
        **options), tbat)
    _assert_values_match(got, want)
    assert tm.device_freq_sets == jm.device_freq_sets == 1
    # every set but the boolean one (two groups) overflows 64 slots
    overflows = route == "overflow" and cols != ("b",)
    assert tm.freq_overflow_fallbacks == jm.freq_overflow_fallbacks == int(overflows)


def test_all_sets_in_one_run_match_reference(monkeypatch):
    """Every set of the battery in one pass, beside scan analyzers."""
    monkeypatch.setenv("DEEQU_TPU_AUTOTUNE", "0")
    table = _run_table()
    jbat = [a for cols in SETS for a in _battery(J, cols)] + [J.Size(), J.Completeness("f")]
    tbat = [a for cols in SETS for a in _battery(T, cols)] + [T.Size(), T.Completeness("f")]
    jm, tm = JaxMonitor(), RunMonitor()
    want = _values(JaxRunner.do_analysis_run(
        JD.Dataset.from_arrow(table), jbat, batch_size=1024, placement="device", monitor=jm),
        jbat)
    got = _values(AnalysisRunner.do_analysis_run(
        TD.Dataset.from_arrow(table), tbat, batch_size=1024, device="cpu", monitor=tm), tbat)
    _assert_values_match(got, want)
    assert tm.device_freq_sets == jm.device_freq_sets == len(SETS)
    assert tm.passes == 1


@pytest.mark.parametrize("cols", SETS, ids=lambda c: "-".join(c))
def test_device_table_equals_host_group_by(cols):
    """The port's own bar: the device table and the host group-by
    (``device_freq=False``) give the same metrics."""
    ds = TD.Dataset.from_arrow(_run_table())
    battery = _battery(T, cols)
    mon = RunMonitor()
    dev = _values(AnalysisRunner.do_analysis_run(ds, battery, batch_size=1024, device="cpu",
                                                 monitor=mon), battery)
    host = _values(AnalysisRunner.do_analysis_run(ds, battery, batch_size=1024, device="cpu",
                                                  device_freq=False), battery)
    assert mon.device_freq_sets == 1
    _assert_values_match(dev, host)


def test_low_cardinality_set_takes_the_host_group_by(monkeypatch):
    """Above 2^21 rows the probe sends a small set to the host group-by,
    in both packages, with equal metrics."""
    monkeypatch.setenv("DEEQU_TPU_AUTOTUNE", "0")
    table = _probe_tables()["low"]
    jbat, tbat = _battery(J, ("k",)), _battery(T, ("k",))
    jm, tm = JaxMonitor(), RunMonitor()
    want = _values(JaxRunner.do_analysis_run(
        JD.Dataset.from_arrow(table), jbat, batch_size=1 << 20, placement="device", monitor=jm),
        jbat)
    got = _values(AnalysisRunner.do_analysis_run(
        TD.Dataset.from_arrow(table), tbat, batch_size=1 << 20, device="cpu", monitor=tm), tbat)
    _assert_values_match(got, want)
    assert tm.device_freq_sets == jm.device_freq_sets == 0


@pytest.mark.parametrize("analyzer", [T.Histogram("f"), T.Histogram("s")])
def test_histogram_over_a_plain_column_still_raises(analyzer):
    with pytest.raises(NotImplementedError, match="not dictionary-encoded"):
        AnalysisRunner.do_analysis_run(TD.Dataset.from_arrow(_run_table(500)), [analyzer],
                                       device="cpu")


def test_mutual_information_is_not_in_the_port():
    with pytest.raises(NotImplementedError, match="not supported by deequ_tpu_torch"):
        AnalysisRunner.do_analysis_run(TD.Dataset.from_arrow(_run_table(500)),
                                       [J.MutualInformation(["i8", "b"])], device="cpu")
