"""The CUDA kernels of deequ_tpu_torch against their plain PyTorch versions,
on the card.

K4 ``kll_sample`` and K5 ``kll_compact`` must match their plain versions
bit for bit on every output (items, sizes, parities, counters, and the bits
of min and max), as must the class counts of ``scan_reduce``. K8
``state_fold`` must match its plain version and the sequential fold of the
states' own ``merge`` bit for bit (NaN equal to NaN), and ``scan_reduce``'s
co-moment slot its plain version within 1e-12 of the magnitudes that bound
its rounding.

Every test here is marked ``cuda`` and needs a CUDA device and ``nvcc``:
without a card it skips (the kernels are CUDA C++ with no CPU build). The
file imports neither JAX nor the reference package, so on a machine
without JAX it runs with ``python -m pytest --noconftest -m cuda
tests/test_torch_cuda.py``. Tolerances: counts, min, max, HLL registers
and dictionary counts bit-exact (floats with their sign bit, NaN equal to
NaN); float64 sums, means and M2 within 1e-12 relative to the magnitude
that bounds their rounding when the adds are reordered (sum of |v|, max |v|
and sum of v^2).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from deequ_tpu_torch.kernels import launch_counts, reset_launch_counts
from deequ_tpu_torch.kernels.dict_code_counts import dict_code_counts, dict_code_counts_plain
from deequ_tpu_torch.kernels.hll_registers import hll_registers, hll_registers_plain
from deequ_tpu_torch.kernels.kll_compact import (
    kll_compact_merge,
    kll_compact_merge_plain,
    kll_compact_update,
    kll_compact_update_plain,
)
from deequ_tpu_torch.kernels.kll_sample import kll_sample, kll_sample_plain
import chip_smoke
import deequ_tpu_torch as dq
from deequ_tpu_torch.analyzers.base import (
    merge_states_batched_many,
    pack_states,
    unpack_states,
)
from deequ_tpu_torch.analyzers.state_provider import InMemoryStateProvider
from deequ_tpu_torch.kernels.scan_reduce import (
    KIND_CLASSES,
    KIND_COMOMENTS,
    KIND_COUNTS,
    KIND_MOMENTS,
    Slot,
    scan_reduce,
    scan_reduce_plain,
)
from deequ_tpu_torch.kernels.state_fold import state_fold, state_fold_plain
from deequ_tpu_torch.ops.kll import KLLSketchState, kll_init

RTOL = 1e-12


def _bits_equal(a: np.ndarray, b: np.ndarray) -> bool:
    nan_a, nan_b = np.isnan(a), np.isnan(b)
    return bool(
        np.array_equal(nan_a, nan_b)
        and np.array_equal(a[~nan_a], b[~nan_b])
        and np.array_equal(np.signbit(a[~nan_a]), np.signbit(b[~nan_b]))
    )


def _close(a: float, b: float, scale: float) -> bool:
    if np.isnan(a) or np.isnan(b):
        return bool(np.isnan(a) and np.isnan(b))
    if np.isinf(a) or np.isinf(b):
        return a == b
    return abs(a - b) <= RTOL * max(scale, 1.0)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels are CUDA C++ with no CPU build")
    return torch.device("cuda")


def _random_slots(n, device, seed=5):
    rng = np.random.default_rng(seed)

    def mask(p):
        return torch.from_numpy(rng.random(n) < p).to(device)

    v = rng.normal(3.0, 7.0, n)
    v[rng.random(n) < 0.001] = np.nan
    v[rng.random(n) < 0.001] = np.inf
    head = np.array([0.0, -0.0, -0.0, 0.0, -np.inf, np.inf])
    v[: min(n, 6)] = head[: min(n, 6)]
    vals = torch.from_numpy(v).to(device)
    finite = torch.from_numpy(rng.normal(-2.0, 1.0, n)).to(device)
    zeros = torch.from_numpy(np.where(rng.random(n) < 0.5, -0.0, 0.0)).to(device)
    lens = torch.from_numpy(rng.integers(0, 90, n).astype(np.int32)).to(device)
    nothing = torch.zeros(n, dtype=torch.bool, device=device)
    slots = [
        Slot(KIND_COUNTS),
        Slot(KIND_COUNTS, where=mask(0.5)),
        Slot(KIND_COUNTS, where=mask(0.5), sel=mask(0.9)),
        Slot(KIND_MOMENTS, sel=mask(0.95), vals=vals),
        Slot(KIND_MOMENTS, sel=mask(0.95), vals=finite),
        Slot(KIND_MOMENTS, where=mask(0.3), sel=mask(0.95), vals=finite),
        Slot(KIND_MOMENTS, sel=mask(0.8), vals=zeros),
        Slot(KIND_MOMENTS, sel=nothing, vals=finite),
        Slot(KIND_MOMENTS, sel=mask(0.9), vals=lens),
    ]
    return slots, mask(0.97)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 4095, 4096, 1_000_003])
def test_scan_reduce_kernel_matches_plain(cuda_device, n):
    slots, rows = _random_slots(n, cuda_device)
    ki, kf = scan_reduce(slots, rows)
    pi, pf = scan_reduce_plain(slots, rows)
    torch.cuda.synchronize()
    assert torch.equal(ki, pi)
    kf, pf = kf.cpu().numpy(), pf.cpu().numpy()
    for col in (1, 2):  # min, max: bit-exact
        assert _bits_equal(kf[:, col], pf[:, col]), col
    for s, slot in enumerate(slots):  # sum, mean, m2: reordered float adds
        if slot.vals is None:
            continue
        v = slot.vals.double().cpu().numpy()
        v = v[np.isfinite(v)]
        if v.size == 0:
            continue
        scales = (np.abs(v).sum(), np.abs(v).max(), (v * v).sum())
        for col, scale in zip((0, 3, 4), scales):
            assert _close(kf[s, col], pf[s, col], float(scale)), (s, col)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 1_000_003])
def test_hll_registers_kernel_matches_plain(cuda_device, n):
    rng = np.random.default_rng(9)
    keys = torch.from_numpy(rng.integers(0, 1 << 15, n).astype(np.uint16)).to(cuda_device)
    rows = torch.from_numpy(rng.random(n) < 0.97).to(cuda_device)
    where = torch.from_numpy(rng.random(n) < 0.6).to(cuda_device)
    present = torch.from_numpy(rng.random(n) < 0.9).to(cuda_device)
    for w in (None, where):
        got = hll_registers(keys, rows, w, present)
        want = hll_registers_plain(keys, rows, w, present)
        torch.cuda.synchronize()
        assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("k", [0, 1, 4096, 4097, 20000, 32768, 32769, 65536])
def test_dict_code_counts_kernel_matches_plain(cuda_device, k):
    n = 1_000_003
    rng = np.random.default_rng(k)
    codes = rng.integers(0, k + 1, n).astype(np.int32)  # k is the sentinel
    codes_t = torch.from_numpy(codes).to(cuda_device)
    rows = torch.from_numpy(rng.random(n) < 0.97).to(cuda_device)
    present = torch.from_numpy(rng.random(n) < 0.9).to(cuda_device)
    counts, num_rows = dict_code_counts(codes_t, rows, present, k)
    want_counts, want_rows = dict_code_counts_plain(codes_t, rows, present, k)
    torch.cuda.synchronize()
    assert torch.equal(counts, want_counts)
    assert int(num_rows) == int(want_rows)


@pytest.mark.cuda
def test_kernels_count_their_launches(cuda_device):
    reset_launch_counts()
    slots, rows = _random_slots(1000, cuda_device)
    scan_reduce(slots, rows)
    scan_reduce_plain(slots, rows)
    assert launch_counts()["scan_reduce"] == 1


@pytest.mark.cuda
@pytest.mark.parametrize("n", [0, 1, 4096, 1_000_003])
def test_class_count_slot_matches_plain(cuda_device, n):
    rng = np.random.default_rng(n)
    codes = torch.from_numpy(rng.integers(-1, 6, n).astype(np.int32)).to(cuda_device)
    rows = torch.from_numpy(rng.random(n) < 0.97).to(cuda_device)
    where = torch.from_numpy(rng.random(n) < 0.5).to(cuda_device)
    slots = [Slot(KIND_CLASSES, vals=codes), Slot(KIND_CLASSES, where=where, vals=codes),
             Slot(KIND_COUNTS, where=where)]
    ki, kf = scan_reduce(slots, rows)
    pi, pf = scan_reduce_plain(slots, rows)
    torch.cuda.synchronize()
    assert torch.equal(ki, pi)
    assert _bits_equal(kf.cpu().numpy().ravel(), pf.cpu().numpy().ravel())


def _assert_bits(got: torch.Tensor, want: torch.Tensor, what: str) -> None:
    g, w = got.cpu().numpy(), want.cpu().numpy()
    assert g.dtype == w.dtype and g.shape == w.shape, what
    assert g.tobytes() == w.tobytes(), what


def _kll_batch(n: int, device, seed: int):
    """Values with signed zeros, NaN, +-inf and values beyond the float32
    range, and the three masks of a KLL analyzer's update."""
    rng = np.random.default_rng(seed)
    v = rng.normal(50.0, 20.0, n)
    v[rng.random(n) < 0.05] = 0.0
    v[rng.random(n) < 0.05] = -0.0
    v[rng.random(n) < 0.01] = np.nan
    v[rng.random(n) < 0.005] = np.inf
    v[rng.random(n) < 0.005] = -1e300
    masks = [torch.from_numpy(rng.random(n) < p).to(device) for p in (0.98, 0.7, 0.9)]
    return (torch.from_numpy(v).to(device), *masks)


def _kll_sizes(k: int):
    return [0, 1, k, k + 1, 1 << 20]


@pytest.mark.cuda
@pytest.mark.parametrize("k", [400, 2048])
@pytest.mark.parametrize("which", range(5))
def test_kll_sample_kernel_matches_plain(cuda_device, k, which):
    n = _kll_sizes(k)[which]
    values, rows, where, present = _kll_batch(n, cuda_device, seed=n + k)
    for ticks, w in ((0, None), (1, where), (12345, where), (2**31 - 1, None)):
        t = torch.tensor(ticks, dtype=torch.int32, device=cuda_device)
        got = kll_sample(values, rows, w, present, t, k)
        want = kll_sample_plain(values, rows, w, present, t, k)
        torch.cuda.synchronize()
        for name, g, p in zip(("samples", "meta", "minmax"), got, want):
            _assert_bits(g, p, name)


def _fold_kernel_and_plain(k: int, n: int, batches: int, device, seed: int):
    """The same batches through K4 + K5 and through their plain versions,
    compared leaf by leaf after every batch."""
    kern = plain = kll_init(k, device=device).tensors()
    for b in range(batches):
        values, rows, where, present = _kll_batch(n, device, seed + b)
        ticks = kern[3]
        kern = kll_compact_update(kern, kll_sample(values, rows, where, present, ticks, k), k)
        plain = kll_compact_update_plain(
            plain, kll_sample_plain(values, rows, where, present, plain[3], k), k)
        torch.cuda.synchronize()
        for i, (g, p) in enumerate(zip(kern, plain)):
            _assert_bits(g, p, f"batch {b} leaf {i}")
    return kern, plain


@pytest.mark.cuda
@pytest.mark.parametrize("k", [400, 2048, 8192])
def test_kll_compact_kernel_matches_plain(cuda_device, k):
    """Cascades several levels deep; k = 8192 sorts its levels in device
    scratch instead of shared memory. Then a merge of two such sketches."""
    a, a_plain = _fold_kernel_and_plain(k, 3 * k + 5, 24, cuda_device, seed=k)
    b, b_plain = _fold_kernel_and_plain(k, 2 * k - 1, 17, cuda_device, seed=7 * k)
    assert int(torch.nonzero(a[1]).max()) >= 3  # the cascade climbed
    for x, y in ((a, b), (b, a), (a, kll_init(k, device=cuda_device).tensors())):
        got = kll_compact_merge(x, y, k)
        want = kll_compact_merge_plain(x, y, k)
        torch.cuda.synchronize()
        for i, (g, p) in enumerate(zip(got, want)):
            _assert_bits(g, p, f"merge leaf {i}")
    assert isinstance(KLLSketchState(*a, sketch_size=k).merge(KLLSketchState(*b, sketch_size=k)),
                      KLLSketchState)


@pytest.mark.cuda
def test_kll_kernels_count_their_launches(cuda_device):
    values, rows, where, present = _kll_batch(5000, cuda_device, seed=1)
    state = kll_init(64, device=cuda_device).tensors()
    reset_launch_counts()
    sample = kll_sample(values, rows, where, present, state[3], 64)
    kll_compact_update(state, sample, 64)
    kll_sample_plain(values, rows, where, present, state[3], 64)
    counts = launch_counts()
    assert counts["kll_sample"] == 1 and counts["kll_compact"] == 1


# ---------------------------------------------------------------------------
# K6 freq_keys and K7 freq_compact: keys, counts and table bit-exact
# ---------------------------------------------------------------------------


def _key_columns(n, ncols, device, seed=0):
    """``ncols`` key columns of every kind the kernel reads: int64 (with
    the int64 whose SplitMix64 is the sentinel), int8, uint8, int16, int32,
    float64 0/1 (booleans) and xxhash64 bits; each with its own mask."""
    from deequ_tpu_torch.kernels.freq_keys import KIND_HASH, KIND_NUM, KeyColumn

    rng = np.random.default_rng(seed)
    sentinel_preimage = -3487469807577879104  # SplitMix64 of it is all ones
    makers = [
        lambda: np.where(rng.random(n) < 0.01, sentinel_preimage,
                         rng.integers(-(2**63), 2**63 - 1, n, dtype=np.int64)),
        lambda: rng.integers(-128, 128, n).astype(np.int8),
        lambda: rng.integers(0, 256, n).astype(np.uint8),
        lambda: rng.integers(-2**15, 2**15, n).astype(np.int16),
        lambda: rng.integers(-2**31, 2**31, n).astype(np.int32),
        lambda: (rng.random(n) < 0.5).astype(np.float64),
        lambda: rng.integers(-(2**63), 2**63 - 1, n, dtype=np.int64),
        lambda: rng.integers(0, 5, n).astype(np.int64),
    ]
    cols = []
    for c in range(ncols):
        kind = KIND_HASH if c == 6 else KIND_NUM
        values = torch.from_numpy(np.ascontiguousarray(makers[c % len(makers)]())).to(device)
        mask = torch.from_numpy(rng.random(n) < 0.97).to(device)
        cols.append(KeyColumn(kind, values, mask))
    rows = torch.from_numpy(rng.random(n) < 0.95).to(device)
    return cols, rows


@pytest.mark.cuda
@pytest.mark.parametrize("n", [0, 1, (1 << 20) + 3])
@pytest.mark.parametrize("ncols", [1, 2, 3, 8])
def test_freq_keys_kernel_matches_plain(cuda_device, n, ncols):
    """Keys at an offset into a larger buffer, and the (sent_rows,
    num_rows) counters; the one-column case holds sentinel-valued keys."""
    from deequ_tpu_torch.kernels.freq_keys import freq_keys, freq_keys_plain

    cols, rows = _key_columns(n, ncols, cuda_device, seed=n + ncols)
    got_buf = torch.zeros(n + 11, dtype=torch.int64, device=cuda_device)
    want_buf = got_buf.clone()
    got = freq_keys(cols, rows, got_buf, 7)
    want = freq_keys_plain(cols, rows, want_buf, 7)
    torch.cuda.synchronize()
    assert torch.equal(got_buf, want_buf)
    assert torch.equal(got, want)
    if ncols == 1 and n > 1000:
        assert int(got[0]) > 0


def _random_table(slots, distinct, device, seed):
    from deequ_tpu_torch.kernels.freq_compact import freq_compact_plain

    rng = np.random.default_rng(seed)
    keys = rng.integers(0, 2**64 - 1, distinct, dtype=np.uint64).view(np.int64)
    return freq_compact_plain(torch.from_numpy(keys).to(device),
                              torch.from_numpy(rng.integers(1, 9, distinct)).to(device), slots)


def _assert_same_compaction(got, want):
    torch.cuda.synchronize()
    for name, g, w in zip(got._fields, got, want):
        assert torch.equal(g, w), name


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["empty buffer", "all sentinel", "overflow", "fits",
                                  "large"])
def test_freq_compact_kernel_matches_plain(cuda_device, case):
    """A sorted table and a raw key buffer: an empty buffer, a buffer of
    sentinels only, more unique keys than slots (exact loss counts), a
    buffer that fits, and a 2^18-slot table with a 2^16-key buffer."""
    from deequ_tpu_torch.kernels.freq_compact import freq_compact

    slots, distinct, nb = {"empty buffer": (1024, 700, 0), "all sentinel": (1024, 700, 5000),
                           "overflow": (1024, 900, 20_000), "fits": (1 << 16, 900, 20_000),
                           "large": (1 << 18, 200_000, 1 << 16)}[case]
    table = _random_table(slots, distinct, cuda_device, seed=slots + nb)
    rng = np.random.default_rng(nb)
    buf = rng.integers(0, 2**64 - 1, nb, dtype=np.uint64).view(np.int64)
    if case == "all sentinel":
        buf[:] = -1
    else:
        buf[::9] = -1
        known = table.keys.cpu().numpy()[: int(table.n_unique)]
        buf[1::4] = known[rng.integers(0, len(known), len(buf[1::4]))]
    buf = torch.from_numpy(buf).to(cuda_device)
    got = freq_compact(table.keys, table.counts, buf, None, slots)
    want = freq_compact(table.keys.cpu(), table.counts.cpu(), buf.cpu(), None, slots)
    _assert_same_compaction(got, [w.to(cuda_device) for w in want])
    if case == "overflow":
        assert int(got.n_unique) > slots and int(got.kept_rows) < int(got.total_rows)


@pytest.mark.cuda
@pytest.mark.parametrize("out_size", [1 << 12, 1 << 16])
def test_freq_compact_merge_kernel_matches_plain(cuda_device, out_size):
    """Merge mode: two sorted tables, sharing some keys; the smaller
    out_size drops groups."""
    from deequ_tpu_torch.kernels.freq_compact import freq_compact

    a = _random_table(1 << 14, 9000, cuda_device, seed=1)
    b = _random_table(1 << 14, 9000, cuda_device, seed=1)  # the same keys
    c = _random_table(1 << 14, 5000, cuda_device, seed=2)
    for x, y in ((a, b), (a, c), (c, a)):
        got = freq_compact(x.keys, x.counts, y.keys, y.counts, out_size)
        want = freq_compact(x.keys.cpu(), x.counts.cpu(), y.keys.cpu(), y.counts.cpu(), out_size)
        _assert_same_compaction(got, [w.to(cuda_device) for w in want])


@pytest.mark.cuda
def test_freq_kernels_count_their_launches(cuda_device):
    from deequ_tpu_torch.kernels.freq_compact import freq_compact
    from deequ_tpu_torch.kernels.freq_keys import freq_keys, freq_keys_plain

    cols, rows = _key_columns(5000, 2, cuda_device)
    buf = torch.zeros(5000, dtype=torch.int64, device=cuda_device)
    table = _random_table(64, 50, cuda_device, seed=3)
    reset_launch_counts()
    freq_keys(cols, rows, buf, 0)
    freq_keys_plain(cols, rows, buf, 0)
    freq_compact(table.keys, table.counts, buf, None, 64)
    counts = launch_counts()
    assert counts["freq_keys"] == 1 and counts["freq_compact"] == 1


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 2, 3, 33])
def test_state_fold_kernel_matches_plain(cuda_device, n):
    groups = chip_smoke.fold_groups(dq, n, seed=n)
    jobs = [states for _, states in groups]
    mats, slots, places = pack_states(jobs)
    mats = [m.to(cuda_device) for m in mats]
    reset_launch_counts()
    got = state_fold(*mats, slots)
    assert launch_counts()["state_fold"] == 1
    want = state_fold_plain(*mats, slots)
    torch.cuda.synchronize()
    for g, w in zip(unpack_states(jobs, places, got), unpack_states(jobs, places, want)):
        assert chip_smoke.same_state_bits(g, w)
    # the whole path: host states to the card, one launch, as the
    # sequential fold of the states' own merge on the CPU
    merged = merge_states_batched_many(groups, "cuda")
    for (a, states), m in zip(groups, merged):
        assert m.__class__ is states[0].__class__
        assert all(t.device.type == "cuda" for t in m.__dict__.values()
                   if isinstance(t, torch.Tensor)), a
        assert chip_smoke.same_state_bits(m, chip_smoke.sequential_fold(states)), a


def _comoment_inputs(n, device, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(100.0, 10.0, n)
    y = 0.5 * x + rng.normal(-3.0, 4.0, n)
    x[rng.random(n) < 0.0005] = np.nan

    def mask(p):
        return torch.from_numpy(rng.random(n) < p).to(device)

    const = torch.full((n,), 7.25, dtype=torch.float64, device=device)
    xs, ys = torch.from_numpy(x).to(device), torch.from_numpy(y).to(device)
    finite = torch.from_numpy(np.nan_to_num(x, nan=1.0)).to(device)
    slots = [
        Slot(KIND_COMOMENTS, sel=mask(0.95), vals=xs, vals2=ys, sel2=mask(0.9)),
        Slot(KIND_COMOMENTS, where=mask(0.5), sel=mask(0.95), vals=finite, vals2=ys,
             sel2=mask(0.9)),
        Slot(KIND_COMOMENTS, sel=mask(0.95), vals=const, vals2=ys, sel2=mask(0.9)),
        Slot(KIND_COMOMENTS, sel=mask(0.0), vals=finite, vals2=ys, sel2=mask(0.9)),
        Slot(KIND_MOMENTS, sel=mask(0.9), vals=finite),
    ]
    return slots, mask(0.98), finite, ys


@pytest.mark.cuda
@pytest.mark.parametrize("n", [0, 1, (1 << 20) + 3])
def test_comoment_slot_matches_plain(cuda_device, n):
    slots, rows, x, y = _comoment_inputs(n, cuda_device, seed=n % 97)
    ki, kf = scan_reduce(slots, rows)
    pi, pf = scan_reduce_plain(slots, rows)
    torch.cuda.synchronize()
    assert torch.equal(ki, pi)
    kf, pf = kf.cpu().numpy(), pf.cpu().numpy()
    xa = float(x.abs().max()) if n else 1.0
    ya = float(y.abs().max()) if n else 1.0
    xx, yy = float((x * x).sum()) if n else 1.0, float((y * y).sum()) if n else 1.0
    for s in range(4):
        scales = (xa, ya, (xx * yy) ** 0.5, xx, yy)
        for col, scale in enumerate(scales):
            assert _close(kf[s, col], pf[s, col], scale), (s, col, kf[s, col], pf[s, col])


@pytest.mark.cuda
def test_persisted_state_unchanged_after_the_run_goes_on(cuda_device):
    rng = np.random.default_rng(3)
    n = 50_000
    import pyarrow as pa

    table = pa.table({
        "x0": pa.array(rng.normal(0, 1, n), mask=rng.random(n) < 0.05),
        "x1": pa.array(rng.normal(5, 2, n)),
        "cat": pa.array(rng.integers(0, 1000, n)),
    })
    analyzers = [dq.Size(), dq.Mean("x0"), dq.Correlation("x0", "x1"),
                 dq.ApproxCountDistinct("cat"), dq.KLLSketch("x1"), dq.Uniqueness(["cat"])]
    first = InMemoryStateProvider()
    data = dq.Dataset.from_arrow(table)
    dq.AnalysisRunner.do_analysis_run(data, analyzers, save_states_with=first,
                                      batch_size=8192, device="cuda")
    kept = {a: first.load(a) for a in analyzers}
    snapshot = {a: None if isinstance(s, dq.analyzers.FrequenciesAndNumRows) else
                [t.cpu().numpy().tobytes() for t in s.__dict__.values()
                 if isinstance(t, torch.Tensor)] for a, s in kept.items()}
    second = InMemoryStateProvider()
    for _ in range(2):
        dq.AnalysisRunner.do_analysis_run(data, analyzers, aggregate_with=first,
                                          save_states_with=second, batch_size=8192,
                                          device="cuda")
        dq.AnalysisRunner.run_on_aggregated_states(data.schema, analyzers, [first, second],
                                                   device="cuda")
    torch.cuda.synchronize()
    for a, s in kept.items():
        assert first.load(a) is s
        if snapshot[a] is not None:
            assert [t.cpu().numpy().tobytes() for t in s.__dict__.values()
                    if isinstance(t, torch.Tensor)] == snapshot[a], a


# ---------------------------------------------------------------------------
# the host ingest tier's entries: K8's carry and K5's ingest
# ---------------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("chunk", [1, 7, 32])
def test_state_fold_carry_kernel_matches_plain(cuda_device, chunk):
    """Every kind a host partial gives, [carry; chunk] folded in place: the
    kernel equals its plain version and the states' sequential merge bit
    for bit."""
    from deequ_tpu_torch.kernels.state_fold import state_fold_carry, state_fold_carry_plain

    jobs = [states for _, states in chip_smoke.carry_groups(dq, chunk + 1, seed=chunk)]
    mats, slots, places = pack_states(jobs)
    carry = [m[0].to(cuda_device) for m in mats]
    parts = [m[1:].contiguous().to(cuda_device) for m in mats]
    plain = [c.clone() for c in carry]
    reset_launch_counts()
    state_fold_carry(carry, parts, slots)
    assert launch_counts()["state_fold_carry"] == 1 and launch_counts()["state_fold"] == 0
    state_fold_carry_plain(plain, parts, slots)
    torch.cuda.synchronize()
    for g, w, states in zip(unpack_states(jobs, places, carry),
                            unpack_states(jobs, places, plain), jobs):
        assert chip_smoke.same_state_bits(g, w)
        assert chip_smoke.same_state_bits(g, chip_smoke.sequential_fold(states))


@pytest.mark.cuda
@pytest.mark.parametrize("k", [400, 2048, 8192])
def test_kll_compact_ingest_kernel_matches_plain(cuda_device, k):
    """Three stacked sketches take two chunks of 32 edge samples (m from 0
    to 2k, h from 0 to 6, infinities); at k = 8192 a level's sort takes
    device scratch."""
    from deequ_tpu_torch.kernels.kll_compact import kll_compact_ingest, kll_compact_ingest_plain
    from deequ_tpu_torch.runners.engine import stack_samples

    n_sketch = 3
    stacked = [torch.stack(list(col)).contiguous().to(cuda_device)
               for col in zip(*(kll_init(k, 16).tensors() for _ in range(n_sketch)))]
    plain = [t.clone() for t in stacked]
    reset_launch_counts()
    for c in range(2):
        samples = [chip_smoke.edge_samples(k, 32, seed=10 * c + s) for s in range(n_sketch)]
        fields = stack_samples(samples, 4 * k, lambda t: t.to(cuda_device))
        kll_compact_ingest(stacked, fields, k)
        kll_compact_ingest_plain(plain, fields, k)
        torch.cuda.synchronize()
        for g, w in zip(stacked, plain):
            assert g.cpu().numpy().tobytes() == w.cpu().numpy().tobytes()
    assert launch_counts()["kll_compact_ingest"] == 2 and launch_counts()["kll_compact"] == 0
    assert int(stacked[1].cpu().count_nonzero(dim=1).min()) >= 2  # several levels hold items


@pytest.mark.cuda
def test_host_tier_run_on_the_card_launches_both_entries(cuda_device):
    """A host-tier run on the card launches the carry and ingest entries,
    and equals the same run on the CPU (the plain versions) bit for bit."""
    import pyarrow as pa

    rng = np.random.default_rng(4)
    n = 70_000
    table = pa.table({
        "x": pa.array(rng.normal(0, 1, n), mask=rng.random(n) < 0.05),
        "y": pa.array(rng.normal(5, 2, n)),
        "cat": pa.array(rng.integers(0, 3000, n)),
        "s": pa.array([f"s{v}" for v in rng.integers(0, 40, n)]),
    })
    analyzers = [dq.Size(), dq.Mean("x"), dq.StandardDeviation("y"), dq.Correlation("x", "y"),
                 dq.Minimum("x"), dq.Maximum("y"), dq.ApproxCountDistinct("cat"),
                 dq.DataType("s"), dq.PatternMatch("s", r"s1\d"), dq.KLLSketch("x"),
                 dq.ApproxQuantile("y", 0.25), dq.Histogram("s")]
    runs = {}
    for device in ("cuda", "cpu"):
        monitor = dq.RunMonitor()
        reset_launch_counts()
        ctx = dq.AnalysisRunner.do_analysis_run(
            dq.Dataset.from_arrow(table), analyzers, batch_size=1024, placement="host",
            device=device, monitor=monitor)
        runs[device] = (ctx, launch_counts(), monitor)
    ctx, counts, monitor = runs["cuda"]
    assert monitor.placement == "host" and monitor.ingest_folds == 3
    # one ingest launch per chunk for each sketch size: KLLSketch's and
    # ApproxQuantile's
    assert counts["state_fold_carry"] == 3 and counts["kll_compact_ingest"] == 3 * 2
    assert counts["scan_reduce"] == 0 and counts["kll_sample"] == 0
    for a in analyzers:
        got, want = ctx.metric(a).value.get(), runs["cpu"][0].metric(a).value.get()
        assert repr(got) == repr(want), a
