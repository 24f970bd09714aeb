"""Per-kernel parity of the PyTorch/CUDA port (deequ_tpu_torch) with the JAX
reference (deequ_tpu).

CPU tests: the same batch (made with numpy from a seed, one pyarrow table
for both packages) goes through the JAX analyzer's ``update`` and the
port's ``update`` on ``device="cpu"``, where each kernel wrapper runs its
plain PyTorch version. Tolerances:

- counts, min, max, HLL registers and dictionary counts: bit-exact
  (floats compared with their sign bit; NaN equals NaN);
- float64 sums, means and M2: within 1e-12 relative to the magnitude that
  bounds their rounding when the adds are reordered: the sum of |v| for a
  sum, max |v| for a mean, the sum of v^2 for M2.

The co-moment slot of K1 goes through ``Correlation.update`` in both
packages (n bit-exact; means within 1e-12 of max |v|, co-moments within
1e-12 of the sums of squares that bound them). K8 ``state_fold``'s plain
version goes through ``merge_states_batched`` in both packages: counts,
min, max, DataType counts and HLL registers bit-exact, float64 sums,
moments and co-moments within 1e-12 relative, KLL sketches bit-exact.

The kernels themselves are held against these plain versions on the card
by ``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pyarrow as pa
import pytest
import torch

import dataclasses
import math

import chip_smoke
import deequ_tpu.analyzers as J
import deequ_tpu.analyzers.base as JB
import deequ_tpu.analyzers.states as JS
import deequ_tpu.ops.kll as JK
import deequ_tpu.analyzers.grouping as JG
import deequ_tpu.data as JD
import deequ_tpu.runners.features as JF
import deequ_tpu_torch.analyzers as T
import deequ_tpu_torch.analyzers.grouping as TG
import deequ_tpu_torch.data as TD
import deequ_tpu_torch.runners.features as TF
import deequ_tpu_torch as dq
from deequ_tpu_torch.analyzers.base import merge_states_batched
from deequ_tpu_torch.analyzers.states import leaves as torch_leaves
from deequ_tpu_torch.convert import to_reference
from deequ_tpu_torch.kernels.state_fold import ADD_I64, MAX_I32, FoldSlot, state_fold
from deequ_tpu_torch.ops.kll import kll_init, kll_update
from deequ_tpu_torch.kernels.dict_code_counts import dict_code_counts
from deequ_tpu_torch.kernels.scan_reduce import (
    KIND_COMOMENTS,
    KIND_COUNTS,
    KIND_MOMENTS,
    Slot,
    scan_reduce,
)
from deequ_tpu_torch.runners.engine import to_device

CPU = torch.device("cpu")
RTOL = 1e-12

# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------


def _table(n: int = 3000, seed: int = 7) -> pa.Table:
    rng = np.random.default_rng(seed)
    v = rng.normal(5.0, 2.0, n)
    v[rng.random(n) < 0.03] = np.nan
    v[rng.random(n) < 0.02] = np.inf
    v[rng.random(n) < 0.02] = -np.inf
    v[:4] = [0.0, -0.0, -0.0, 0.0]
    w = rng.normal(-1.0, 10.0, n)
    zeros = np.where(rng.random(n) < 0.5, -0.0, 0.0)
    strings = [None if i % 9 == 0 else "x" * (i % 13) + "@" + str(i % 5) for i in range(n)]
    codes = rng.integers(0, 40, n).astype(np.int32)
    return pa.table({
        "v": pa.array(v, mask=rng.random(n) < 0.1),
        "w": pa.array(w, mask=rng.random(n) < 0.05),
        "allnan": pa.array(np.full(n, np.nan), mask=rng.random(n) < 0.2),
        "zeros": pa.array(zeros, mask=rng.random(n) < 0.2),
        "ints": pa.array(rng.integers(-1000, 1000, n)),
        "s": pa.array(strings),
        "d": pa.DictionaryArray.from_arrays(
            pa.array(codes, mask=rng.random(n) < 0.1),
            pa.array([f"k{i:02d}" for i in range(40)]),
        ),
    })


def _batches(table: pa.Table, batch_size: int):
    """The same padded batches in both packages."""
    jb = list(JD.Dataset.from_arrow(table).batches(batch_size))
    tb = list(TD.Dataset.from_arrow(table).batches(batch_size))
    assert len(jb) == len(tb)
    return jb, tb


def _jax_features(analyzer, batch):
    built = JF.FeatureBuilder(analyzer.feature_specs()).build(batch)
    return {k: jnp.asarray(v) for k, v in built.items()}


def _torch_features(analyzer, batch):
    return to_device(TF.FeatureBuilder(analyzer.feature_specs()).build(batch), CPU)


def _fold(jax_a, torch_a, table, batch_size=1024):
    """Fold every batch through both packages' updates; returns the JAX
    leaves and the port's leaves as numpy arrays."""
    jb, tb = _batches(table, batch_size)
    js, ts = jax_a.init_state(), torch_a.init_state(CPU)
    for jbatch, tbatch in zip(jb, tb):
        js = jax_a.update(js, _jax_features(jax_a, jbatch))
        ts = torch_a.update(ts, _torch_features(torch_a, tbatch))
    return (
        [np.asarray(x) for x in jax.tree_util.tree_leaves(js)],
        [t.numpy() for t in torch_leaves(ts)],
    )


def _bits_equal(a: np.ndarray, b: np.ndarray) -> bool:
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if np.issubdtype(a.dtype, np.floating):
        nan_a, nan_b = np.isnan(a), np.isnan(b)
        return bool(
            np.array_equal(nan_a, nan_b)
            and np.array_equal(a[~nan_a], b[~nan_b])
            and np.array_equal(np.signbit(a[~nan_a]), np.signbit(b[~nan_b]))
        )
    return bool(np.array_equal(a, b))


def _close(a: np.ndarray, b: np.ndarray, scale: float) -> bool:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    nan_a, nan_b = np.isnan(a), np.isnan(b)
    if not np.array_equal(nan_a, nan_b):
        return False
    a, b = a[~nan_a], b[~nan_b]
    inf = np.isinf(a) | np.isinf(b)
    if not np.array_equal(a[inf], b[inf]):
        return False
    return bool(np.all(np.abs(a[~inf] - b[~inf]) <= RTOL * max(scale, 1.0)))


def _scales(table: pa.Table, column) -> dict:
    """Rounding scales of a column's finite values, per float leaf kind."""
    if column not in ("v", "w", "ints"):
        return {"sum": 0.0, "avg": 0.0, "m2": 0.0}
    vals = table[column].to_numpy(zero_copy_only=False).astype(np.float64)
    vals = vals[np.isfinite(vals)]
    return {
        "sum": float(np.abs(vals).sum()),
        "avg": float(np.abs(vals).max()),
        "m2": float((vals * vals).sum()),
    }


# ---------------------------------------------------------------------------
# K1 scan_reduce, through every slot analyzer's update
# ---------------------------------------------------------------------------

#: (analyzer constructor, per-leaf comparison): "exact" leaves are counts,
#: min and max; "sum", "avg" and "m2" leaves are float64 moments
SCAN_CASES = {
    "size": (lambda m: m.Size(), ["exact"]),
    "size_where": (lambda m: m.Size(where="w > 0"), ["exact"]),
    "completeness_nulls": (lambda m: m.Completeness("v"), ["exact", "exact"]),
    "completeness_where": (lambda m: m.Completeness("s", "w < 3"), ["exact", "exact"]),
    "compliance": (lambda m: m.Compliance("v pos", "v > 0"), ["exact", "exact"]),
    "compliance_where": (lambda m: m.Compliance("i", "ints >= 0", "v < 5"), ["exact", "exact"]),
    "pattern_match": (lambda m: m.PatternMatch("s", r"x{3,}@[12]"), ["exact", "exact"]),
    "mean_nan_inf": (lambda m: m.Mean("v"), ["sum", "exact"]),
    "mean_finite": (lambda m: m.Mean("w"), ["sum", "exact"]),
    "mean_where": (lambda m: m.Mean("w", "ints > 100"), ["sum", "exact"]),
    "mean_all_masked": (lambda m: m.Mean("w", "w > 1e12"), ["sum", "exact"]),
    "sum_ints": (lambda m: m.Sum("ints"), ["sum", "exact"]),
    "sum_where": (lambda m: m.Sum("w", "v > 5"), ["sum", "exact"]),
    "min_nan_inf_zeros": (lambda m: m.Minimum("v"), ["exact", "exact"]),
    "min_nan_only": (lambda m: m.Minimum("allnan"), ["exact", "exact"]),
    "min_signed_zeros": (lambda m: m.Minimum("zeros"), ["exact", "exact"]),
    "min_all_masked": (lambda m: m.Minimum("w", "w > 1e12"), ["exact", "exact"]),
    "max_nan_inf": (lambda m: m.Maximum("v"), ["exact", "exact"]),
    "max_where_no_nan": (lambda m: m.Maximum("v", "v < 1e300"), ["exact", "exact"]),
    "max_nan_only": (lambda m: m.Maximum("allnan"), ["exact", "exact"]),
    "max_signed_zeros": (lambda m: m.Maximum("zeros"), ["exact", "exact"]),
    "max_all_masked": (lambda m: m.Maximum("w", "w > 1e12"), ["exact", "exact"]),
    "min_length": (lambda m: m.MinLength("s"), ["exact", "exact"]),
    "max_length_where": (lambda m: m.MaxLength("s", "ints < 0"), ["exact", "exact"]),
    "stddev": (lambda m: m.StandardDeviation("w"), ["exact", "avg", "m2"]),
    "stddev_where": (lambda m: m.StandardDeviation("ints", "w > 0"), ["exact", "avg", "m2"]),
    "stddev_nan": (lambda m: m.StandardDeviation("v"), ["exact", "avg", "m2"]),
    "stddev_all_masked": (lambda m: m.StandardDeviation("w", "w > 1e12"), ["exact", "avg", "m2"]),
}


@pytest.mark.parametrize("case", sorted(SCAN_CASES))
def test_scan_reduce_update_matches_jax(case):
    make, kinds = SCAN_CASES[case]
    table = _table()
    jax_a, torch_a = make(J), make(T)
    jl, tl = _fold(jax_a, torch_a, table)
    assert len(jl) == len(tl) == len(kinds)
    scales = _scales(table, getattr(torch_a, "column", None))
    for i, (a, b, kind) in enumerate(zip(jl, tl, kinds)):
        if kind == "exact":
            assert _bits_equal(a, b), (case, i, a, b)
        else:
            assert _close(a, b, scales[kind]), (case, i, a, b)


def test_scan_reduce_plain_batches_many_slots_at_once():
    """One launch over a table of slots equals one launch per slot."""
    rng = np.random.default_rng(3)
    n = 5000
    rows = torch.from_numpy(rng.random(n) < 0.95)
    masks = [torch.from_numpy(rng.random(n) < p) for p in (0.3, 0.7, 0.99)]
    vals = torch.from_numpy(np.where(rng.random(n) < 0.01, np.nan, rng.normal(0, 1, n)))
    lens = torch.from_numpy(rng.integers(0, 50, n).astype(np.int32))
    slots = [
        Slot(KIND_COUNTS),
        Slot(KIND_COUNTS, where=masks[0], sel=masks[1]),
        Slot(KIND_MOMENTS, sel=masks[2], vals=vals),
        Slot(KIND_MOMENTS, where=masks[1], sel=masks[2], vals=lens),
    ]
    out_i, out_f = scan_reduce(slots, rows)
    for s, slot in enumerate(slots):
        one_i, one_f = scan_reduce([slot], rows)
        assert torch.equal(out_i[s], one_i[0])
        assert _bits_equal(out_f[s].numpy(), one_f[0].numpy())


def test_scan_reduce_rejects_bad_inputs():
    rows = torch.ones(10, dtype=torch.bool)
    # values of a float type no entry takes, and float32 beside float64
    # (a launch accumulates in one type: float64, or float32 in the 32-bit
    # accumulator mode)
    with pytest.raises(TypeError):
        scan_reduce([Slot(KIND_MOMENTS, vals=torch.zeros(10, dtype=torch.float16))], rows)
    with pytest.raises(TypeError):
        scan_reduce([Slot(KIND_MOMENTS, vals=torch.zeros(10, dtype=torch.float32)),
                     Slot(KIND_MOMENTS, vals=torch.zeros(10, dtype=torch.float64))], rows)
    with pytest.raises(ValueError):
        scan_reduce([Slot(KIND_COUNTS, sel=torch.ones(9, dtype=torch.bool))], rows)
    with pytest.raises(ValueError):
        scan_reduce([Slot(KIND_MOMENTS)], rows)
    with pytest.raises(ValueError):
        scan_reduce([], rows)


# ---------------------------------------------------------------------------
# K2 hll_registers, through ApproxCountDistinct.update
# ---------------------------------------------------------------------------

HLL_CASES = {
    "numeric_nulls": lambda m: m.ApproxCountDistinct("v"),
    "integral": lambda m: m.ApproxCountDistinct("ints"),
    "strings_nulls": lambda m: m.ApproxCountDistinct("s"),
    "dictionary": lambda m: m.ApproxCountDistinct("d"),
    "where": lambda m: m.ApproxCountDistinct("ints", "w > 2"),
    "all_masked": lambda m: m.ApproxCountDistinct("ints", "w > 1e12"),
}


@pytest.mark.parametrize("case", sorted(HLL_CASES))
def test_hll_registers_update_matches_jax(case):
    make = HLL_CASES[case]
    jl, tl = _fold(make(J), make(T), _table())
    assert len(jl) == len(tl) == 1
    assert _bits_equal(jl[0], tl[0])


# ---------------------------------------------------------------------------
# K3 dict_code_counts, through DeviceFrequencyScan.update
# ---------------------------------------------------------------------------


def _dict_table(k: int, n: int = 3000, seed: int = 11) -> pa.Table:
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, k, n).astype(np.int32)
    if k > 1:
        codes[: min(n, k) // 2] = np.arange(min(n, k) // 2, dtype=np.int32)
    return pa.table({
        "c": pa.DictionaryArray.from_arrays(
            pa.array(codes, mask=rng.random(n) < 0.1),
            pa.array([f"v{i}" for i in range(k)]),
        ),
    })


@pytest.mark.parametrize("k", [1, 4096, 4097, 65536])
def test_dict_code_counts_update_matches_jax(k):
    table = _dict_table(k)
    jl, tl = _fold(JG.DeviceFrequencyScan("c", k), TG.DeviceFrequencyScan("c", k), table)
    assert len(jl) == len(tl) == 2
    assert _bits_equal(jl[0], tl[0])  # counts[k]
    assert _bits_equal(jl[1], tl[1])  # num_rows


def test_dict_code_counts_plain_drops_masked_and_sentinel():
    codes = torch.tensor([0, 1, 2, 3, 3, -1, 1], dtype=torch.int32)
    rows = torch.tensor([1, 1, 1, 1, 0, 1, 1], dtype=torch.bool)
    present = torch.tensor([1, 1, 0, 1, 1, 1, 1], dtype=torch.bool)
    counts, num_rows = dict_code_counts(codes, rows, present, 3)
    assert counts.tolist() == [1, 2, 0]  # code 3 is the sentinel K
    assert int(num_rows) == 6


# ---------------------------------------------------------------------------
# K1's co-moment slot, through Correlation.update
# ---------------------------------------------------------------------------


def _pair_table(n: int = 3000, seed: int = 13) -> pa.Table:
    """Two correlated columns with nulls, NaN in one, and constants."""
    rng = np.random.default_rng(seed)
    x = rng.normal(100.0, 10.0, n)
    y = 0.3 * x + rng.normal(0.0, 2.0, n)
    xn = x.copy()
    xn[rng.random(n) < 0.01] = np.nan
    return pa.table({
        "x": pa.array(x, mask=rng.random(n) < 0.05),
        "y": pa.array(y, mask=rng.random(n) < 0.1),
        "xn": pa.array(xn),
        "c": pa.array(np.full(n, 2.5)),
        "c2": pa.array(np.full(n, -7.0), mask=rng.random(n) < 0.2),
        "ints": pa.array(rng.integers(-50, 50, n)),
    })


CORRELATION_CASES = {
    "nulls": lambda m: m.Correlation("x", "y"),
    "where": lambda m: m.Correlation("x", "y", "ints > 0"),
    "nan": lambda m: m.Correlation("xn", "y"),
    "constant": lambda m: m.Correlation("c", "y"),
    "both_constant": lambda m: m.Correlation("c", "c2"),
    "integral": lambda m: m.Correlation("ints", "x"),
    "empty": lambda m: m.Correlation("x", "y", "ints > 1000"),
}


@pytest.mark.parametrize("batch_size", [512, 4096])
@pytest.mark.parametrize("case", sorted(CORRELATION_CASES))
def test_comoment_slot_update_matches_jax(case, batch_size):
    make = CORRELATION_CASES[case]
    table = _pair_table()
    jax_a, torch_a = make(J), make(T)
    jl, tl = _fold(jax_a, torch_a, table, batch_size)
    assert len(jl) == len(tl) == 6
    cols = [table[c].to_numpy(zero_copy_only=False).astype(np.float64)
            for c in (torch_a.first_column, torch_a.second_column)]
    cols = [v[np.isfinite(v)] for v in cols]
    xx, yy = (float((v * v).sum()) for v in cols)
    scales = [0.0, float(np.abs(cols[0]).max()), float(np.abs(cols[1]).max()),
              math.sqrt(xx * yy), xx, yy]
    assert _bits_equal(jl[0], tl[0]), (case, jl[0], tl[0])
    for i in range(1, 6):
        assert _close(jl[i], tl[i], scales[i]), (case, i, jl[i], tl[i])
    jm, tm = jax_a.compute_metric_from(
        type(jax_a.init_state())(*[jnp.asarray(x) for x in jl])), torch_a.compute_metric_from(
        T.CorrelationState(*[torch.from_numpy(np.asarray(x)) for x in tl]))
    if jm.value.is_success and not math.isnan(jm.value.get()):
        assert abs(jm.value.get() - tm.value.get()) <= 1e-9
    else:
        assert repr(jm.value)[:12] == repr(tm.value)[:12]


def test_comoment_slot_takes_two_columns():
    rows = torch.ones(10, dtype=torch.bool)
    x = torch.zeros(10, dtype=torch.float64)
    with pytest.raises(ValueError):
        scan_reduce([Slot(KIND_COMOMENTS, vals=x)], rows)
    with pytest.raises(ValueError):
        scan_reduce([Slot(KIND_MOMENTS, vals=x, vals2=x)], rows)
    with pytest.raises(TypeError):
        scan_reduce([Slot(KIND_COMOMENTS, vals=x, vals2=x.float())], rows)
    out_i, out_f = scan_reduce([Slot(KIND_COMOMENTS, vals=x, vals2=x + 1)], rows)
    assert out_i[0, 0] == 10 and out_f[0].tolist() == [0.0, 1.0, 0.0, 0.0, 0.0]


# ---------------------------------------------------------------------------
# K8 state_fold's plain version, through merge_states_batched
# ---------------------------------------------------------------------------


def _jax_analyzer(analyzer):
    kwargs = {f.name: getattr(analyzer, f.name) for f in dataclasses.fields(analyzer) if f.init}
    return getattr(J, type(analyzer).__name__)(**kwargs)


def _jax_state(state):
    name, leaves = to_reference(state)
    cls = JK.KLLSketchState if name == "KLLSketchState" else getattr(JS, name)
    if name == "KLLSketchState":
        return cls(*leaves, sketch_size=state.sketch_size)
    return cls(*leaves)


#: float leaves compared within 1e-12 relative (sums and Chan merges)
_MOMENT_STATES = ("MeanState", "SumState", "StandardDeviationState", "CorrelationState")


def _assert_state_matches_jax(torch_state, jax_state):
    name, tl = to_reference(torch_state)
    jl = [np.asarray(x) for x in jax.tree_util.tree_leaves(jax_state)]
    assert len(tl) == len(jl)
    for i, (a, b) in enumerate(zip(jl, tl)):
        if name in _MOMENT_STATES and a.dtype == np.float64:
            scale = float(np.nan_to_num(np.abs(a), posinf=0.0).max()) if a.size else 0.0
            assert _close(a, b, scale), (name, i, a, b)
        else:
            assert _bits_equal(a, b), (name, i, a, b)


FOLD_KINDS = [type(a).__name__ for a, _ in chip_smoke.fold_groups(dq, 1, 0)]


@pytest.mark.parametrize("n", [1, 2, 3, 32])
@pytest.mark.parametrize("kind", FOLD_KINDS)
def test_state_fold_plain_matches_jax_merge_states_batched(kind, n):
    groups = {type(a).__name__: (a, states) for a, states in chip_smoke.fold_groups(dq, n, n)}
    analyzer, states = groups[kind]
    got = merge_states_batched(analyzer, states, "cpu")
    assert chip_smoke.same_state_bits(got, chip_smoke.sequential_fold(states))
    want = JB.merge_states_batched(_jax_analyzer(analyzer), [_jax_state(s) for s in states])
    _assert_state_matches_jax(got, want)


def _kll_states(n, k=128, seed=0):
    rng = np.random.default_rng(seed)
    states = []
    for i in range(n):
        rows = 700 + 97 * i
        v = torch.from_numpy(rng.normal(i, 3.0, rows))
        mask = torch.from_numpy(rng.random(rows) < 0.95)
        states.append(kll_update(kll_init(k, 8), v, mask))
    return states


@pytest.mark.parametrize("n", [1, 2, 3, 32])
def test_kll_fold_matches_jax_merge_states_batched(n):
    states = _kll_states(n)
    got = merge_states_batched(T.KLLSketch("x"), states, "cpu")
    assert chip_smoke.same_state_bits(got, chip_smoke.sequential_fold(states))
    want = JB.merge_states_batched(J.KLLSketch("x"), [_jax_state(s) for s in states])
    _assert_state_matches_jax(got, want)


def test_merge_states_batched_skips_none_states():
    (analyzer, states), = [g for g in chip_smoke.fold_groups(dq, 3, 4)
                           if isinstance(g[0], T.Correlation)]
    got = merge_states_batched(analyzer, [None, states[0], None, states[1], states[2]], "cpu")
    assert chip_smoke.same_state_bits(got, chip_smoke.sequential_fold(states))
    assert merge_states_batched(analyzer, [None, None], "cpu") is None
    want = JB.merge_states_batched(_jax_analyzer(analyzer),
                                   [None] + [_jax_state(s) for s in states])
    _assert_state_matches_jax(got, want)


def test_merge_states_batched_differing_kll_widths_take_the_sequential_path():
    narrow, wide = _kll_states(1, k=64)[0], _kll_states(1, k=128)[0]
    with pytest.raises(ValueError):
        merge_states_batched(T.KLLSketch("x"), [narrow, wide], "cpu")
    with pytest.raises(AssertionError):
        JB.merge_states_batched(J.KLLSketch("x"), [_jax_state(narrow), _jax_state(wide)])


def test_state_fold_rejects_bad_tables():
    f = torch.zeros((2, 0), dtype=torch.float64)
    i = torch.zeros((2, 3), dtype=torch.int64)
    r = torch.zeros((2, 4), dtype=torch.int32)
    ok = [FoldSlot(ADD_I64, 0, 3), FoldSlot(MAX_I32, 0, 4)]
    out_f, out_i, out_r = state_fold(f, i, r, ok)
    assert out_i.tolist() == [0, 0, 0] and out_r.tolist() == [0, 0, 0, 0]
    with pytest.raises(ValueError):  # a column nobody folds
        state_fold(f, i, r, [FoldSlot(ADD_I64, 0, 2), FoldSlot(MAX_I32, 0, 4)])
    with pytest.raises(ValueError):  # two slots on one column
        state_fold(f, i, r, ok + [FoldSlot(ADD_I64, 2, 1)])
    with pytest.raises(TypeError):
        state_fold(f, i.to(torch.int32), r, ok)


# ---------------------------------------------------------------------------
# K8's carry entry (the host tier's fold) and K5's ingest entry, plain
# ---------------------------------------------------------------------------

CARRY_KINDS = [type(a).__name__ for a, _ in chip_smoke.carry_groups(dq, 1, 0)]


@pytest.mark.parametrize("chunk", [1, 7, 32])
@pytest.mark.parametrize("kind", CARRY_KINDS)
def test_state_fold_carry_plain_matches_the_sequential_merge(kind, chunk):
    """The carry after a chunk equals the left fold of [carry; partials]
    with the states' own merge, bit for bit (the reference's ingest scan
    without padding steps)."""
    from deequ_tpu_torch.analyzers.base import fold_layout, pack_states, unpack_states
    from deequ_tpu_torch.kernels.state_fold import state_fold_carry

    groups = {type(a).__name__: states for a, states in chip_smoke.carry_groups(dq, chunk + 1, 5)}
    states = groups[kind]
    mats, slots, places = pack_states([states], fold_layout())
    carry = [m[0].clone() for m in mats]
    parts = [m[1:].contiguous() for m in mats]
    state_fold_carry(carry, parts, slots)
    (got,) = unpack_states([states], places, carry)
    assert chip_smoke.same_state_bits(got, chip_smoke.sequential_fold(states))


def test_state_fold_carry_folds_several_analyzers_in_order():
    from deequ_tpu_torch.analyzers.base import fold_layout, pack_states, unpack_states
    from deequ_tpu_torch.kernels.state_fold import state_fold_carry

    jobs = [states for _, states in chip_smoke.carry_groups(dq, 33, 6)]
    mats, slots, places = pack_states(jobs, fold_layout())
    carry = [m[0].clone() for m in mats]
    # two chunks, 32 then the rest: the same fold as one
    state_fold_carry(carry, [m[1:17].contiguous() for m in mats], slots)
    state_fold_carry(carry, [m[17:].contiguous() for m in mats], slots)
    for got, states in zip(unpack_states(jobs, places, carry), jobs):
        assert chip_smoke.same_state_bits(got, chip_smoke.sequential_fold(states))


def test_state_fold_carry_rejects_bad_inputs():
    from deequ_tpu_torch.kernels.state_fold import state_fold_carry

    carry = [torch.zeros(0, dtype=torch.float64), torch.zeros(3, dtype=torch.int64),
             torch.zeros(0, dtype=torch.int32)]
    parts = [torch.zeros((2, 0), dtype=torch.float64), torch.ones((2, 3), dtype=torch.int64),
             torch.zeros((2, 0), dtype=torch.int32)]
    slots = [FoldSlot(ADD_I64, 0, 3)]
    state_fold_carry(carry, parts, slots)
    assert carry[1].tolist() == [2, 2, 2]
    with pytest.raises(ValueError):  # no partials
        state_fold_carry(carry, [p[:0] for p in parts], slots)
    with pytest.raises(ValueError):  # widths differ
        state_fold_carry(carry, [parts[0], parts[1][:, :2].contiguous(), parts[2]], slots)
    with pytest.raises(TypeError):
        state_fold_carry(carry, [parts[0], parts[1].int(), parts[2]], slots)


_jit_ingest = jax.jit(JK.kll_ingest_sampled)


def _ingest_chunks(k: int, n_blocks: int, seed: int):
    """Host samples as the native sampler gives them: m in [0, 2k] items
    ascending at h in [0, 6] (an empty block now and then, items beyond the
    float32 range, infinities), in a 4k-wide +inf-padded row."""
    rng = np.random.default_rng(seed)
    blocks = []
    for b in range(n_blocks):
        m = int(rng.integers(0, 2 * k + 1)) if b % 9 else (0 if b % 2 else 2 * k)
        items = np.full(4 * k, np.inf)
        vals = np.sort(rng.normal(b % 5, 10.0, m))
        if m > 3 and b % 4 == 0:
            vals[0], vals[-1] = -np.inf, 3e40
            vals = np.sort(vals)
        items[:m] = vals
        h = int(rng.integers(0, 7))
        nv = 0 if m == 0 else m << h
        mn, mx = (np.inf, -np.inf) if m == 0 else (float(vals[0]), float(vals[-1]))
        blocks.append((items, m, h, nv, mn, mx))
    return blocks


@pytest.mark.parametrize("k", [4, 16])
def test_kll_ingest_sampled_matches_jax(k):
    """Per block, the port's kll_ingest_sampled (K5's ingest entry, plain)
    equals the reference's on all seven leaves, through states that cross
    several compaction levels."""
    from deequ_tpu_torch.ops.kll import kll_ingest_sampled

    js, ts = JK.kll_init(k, 12), kll_init(k, 12)
    for items, m, h, nv, mn, mx in _ingest_chunks(k, 80, k):
        js = _jit_ingest(js, items, np.int32(m), np.int32(h), np.int64(nv), mn, mx)
        ts = kll_ingest_sampled(ts, items, m, h, nv, mn, mx)
        _assert_state_matches_jax(ts, js)
    assert int(np.count_nonzero(np.asarray(js.sizes))) >= 4


@pytest.mark.parametrize("chunk", [1, 7, 32])
def test_kll_compact_ingest_chunks_of_stacked_sketches(chunk):
    """One ingest call folds B blocks into each of S stacked sketches in
    order: the same sketches as the reference's sequential ingest."""
    from deequ_tpu_torch.kernels.kll_compact import kll_compact_ingest

    k, n_sketch = 8, 3
    blocks = [_ingest_chunks(k, 2 * chunk, 30 + s) for s in range(n_sketch)]
    stacked = [torch.stack(list(col)).contiguous()
               for col in zip(*(kll_init(k, 10).tensors() for _ in range(n_sketch)))]
    for start in range(0, 2 * chunk, chunk):
        fields = [np.stack([[blk[start + b][f] for b in range(chunk)] for blk in blocks])
                  for f in range(6)]
        samples = [torch.from_numpy(np.ascontiguousarray(a, dtype=d)) for a, d in zip(
            fields, (np.float64, np.int32, np.int32, np.int64, np.float64, np.float64))]
        kll_compact_ingest(stacked, samples, k)
    for s in range(n_sketch):
        js = JK.kll_init(k, 10)
        for items, m, h, nv, mn, mx in blocks[s]:
            js = _jit_ingest(js, items, np.int32(m), np.int32(h), np.int64(nv), mn, mx)
        got = T.KLLSketch("x").init_state(CPU)
        got = type(got)(*(leaf[s] for leaf in stacked), sketch_size=k)
        _assert_state_matches_jax(got, js)


def test_kll_compact_ingest_rejects_bad_inputs():
    from deequ_tpu_torch.kernels.kll_compact import kll_compact_ingest

    k = 4
    stacked = [t.reshape(1, *t.shape).clone() for t in kll_init(k, 6).tensors()]
    good = [torch.full((1, 2, 4 * k), float("inf"), dtype=torch.float64),
            torch.zeros((1, 2), dtype=torch.int32), torch.zeros((1, 2), dtype=torch.int32),
            torch.zeros((1, 2), dtype=torch.int64), torch.zeros((1, 2), dtype=torch.float64),
            torch.zeros((1, 2), dtype=torch.float64)]
    kll_compact_ingest(stacked, good, k)
    assert int(stacked[3][0]) == 2
    with pytest.raises(TypeError):
        kll_compact_ingest(stacked, [good[0].float(), *good[1:]], k)
    with pytest.raises(ValueError):
        kll_compact_ingest(stacked, [good[0][:, :, :k].contiguous(), *good[1:]], k)
    with pytest.raises(ValueError):
        kll_compact_ingest(stacked, [g[:, :0].contiguous() for g in good], k)
