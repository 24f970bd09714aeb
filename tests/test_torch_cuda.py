"""The CUDA kernels of deequ_tpu_torch against their plain PyTorch versions,
on the card.

K4 ``kll_sample`` and K5 ``kll_compact`` must match their plain versions
bit for bit on every output (items, sizes, parities, counters, and the bits
of min and max), as must the class counts of ``scan_reduce``, and K3
``dict_code_counts`` on each of its three paths. Each session of a
stacked ``scan_reduce`` launch must equal a launch over its batch alone
bit for bit, at batch sizes on either side of its chunk. K8
``state_fold`` must match its plain version and the sequential fold of the
states' own ``merge`` bit for bit (NaN equal to NaN), and ``scan_reduce``'s
co-moment slot its plain version within 1e-12 of the magnitudes that bound
its rounding.

The engine's feed pipeline at depth 2 (features staged through pinned
memory and copied on a side stream) must give the serial loop's states
bit for bit, with the same launches, also when the pass launches on a
busy non-default stream.

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
from deequ_tpu_torch.kernels.hll_registers import (
    hll_registers,
    hll_registers_plain,
    hll_registers_stacked,
    hll_registers_stacked_plain,
)
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
    scan_reduce_stacked,
    scan_reduce_stacked_plain,
)
from deequ_tpu_torch.kernels.state_fold import state_fold, state_fold_plain
from deequ_tpu_torch.runners.engine import ScanEngine
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
# K4 and K5 on the inputs their designs are most sensitive to: K4's tiles
# and look-back, K5's runs (chip_smoke.py builds the inputs; its phase 2
# runs the same cases)
# ---------------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("n", [0, 1, 2047, 2048, 2049, 1 << 20, 1 << 22])
@pytest.mark.parametrize("column", chip_smoke.KLL_COLUMNS)
def test_kll_sample_kernel_matches_plain_on_special_columns(cuda_device, column, n):
    """k = 2048; 2^22 rows are 512 tiles of look-back."""
    k = 2048
    v, rows, present = (torch.from_numpy(x).to(cuda_device)
                        for x in chip_smoke.kll_column(column, n, n + 3))
    for ticks in (0, 7, 2**31 - 1):
        t = torch.tensor(ticks, dtype=torch.int32, device=cuda_device)
        got = kll_sample(v, rows, None, present, t, k)
        want = kll_sample_plain(v, rows, None, present, t, k)
        torch.cuda.synchronize()
        for name, g, p in zip(("samples", "meta", "minmax"), got, want):
            _assert_bits(g, p, f"{name} at ticks {ticks}")


def _on(leaves, device):
    return tuple(t.to(device) for t in leaves)


def _assert_leaves(got, want, what: str) -> None:
    for i, (g, w) in enumerate(zip(got, want)):
        _assert_bits(g, w, f"{what} leaf {i}")


RUN_TARGET_IDS = ["k", "k+1", "4k"]


@pytest.mark.cuda
@pytest.mark.parametrize("k", [2048, 8192])
@pytest.mark.parametrize("target", chip_smoke.KLL_RUN_TARGETS, ids=RUN_TARGET_IDS)
@pytest.mark.parametrize("case", chip_smoke.KLL_RUN_CASES)
def test_kll_compact_update_kernel_matches_plain_on_runs(cuda_device, case, target, k):
    """Level 1 of k, k + 1 or 4k items in runs (k = 8192 sorts in device
    scratch)."""
    from deequ_tpu_torch.kernels.kll_sample import Sample

    state, sample = chip_smoke.run_update_case(k, case, target, seed=3)
    state, sample = _on(state, cuda_device), Sample(*_on(sample, cuda_device))
    got = kll_compact_update(state, sample, k)
    want = kll_compact_update_plain(state, sample, k)
    torch.cuda.synchronize()
    _assert_leaves(got, want, "update")


@pytest.mark.cuda
@pytest.mark.parametrize("k", [2048, 8192])
@pytest.mark.parametrize("target", chip_smoke.KLL_RUN_TARGETS, ids=RUN_TARGET_IDS)
@pytest.mark.parametrize("case", chip_smoke.KLL_RUN_CASES)
def test_kll_compact_merges_match_plain_on_runs(cuda_device, case, target, k):
    """Both orders of a merge, and the stacked merge of the two pairs."""
    from deequ_tpu_torch.kernels.kll_compact import (
        kll_compact_merge_stacked,
        kll_compact_merge_stacked_plain,
    )

    a, b = (_on(s, cuda_device) for s in chip_smoke.run_merge_case(k, case, target, seed=4))
    for x, y in ((a, b), (b, a)):
        _assert_leaves(kll_compact_merge(x, y, k), kll_compact_merge_plain(x, y, k), "merge")
    sa = [torch.stack([x, y]) for x, y in zip(a, b)]
    sb = [torch.stack([y, x]) for x, y in zip(a, b)]
    got = kll_compact_merge_stacked(sa, sb, k)
    want = kll_compact_merge_stacked_plain(sa, sb, k)
    torch.cuda.synchronize()
    _assert_leaves(got, want, "stacked merge")


@pytest.mark.cuda
@pytest.mark.parametrize("k", [2048, 8192])
@pytest.mark.parametrize("target", chip_smoke.KLL_RUN_TARGETS, ids=RUN_TARGET_IDS)
@pytest.mark.parametrize("case", chip_smoke.KLL_RUN_CASES)
def test_kll_compact_ingest_kernel_matches_plain_on_runs(cuda_device, case, target, k):
    """Two sketches, three samples each (h 1, 2, 0), the items in the
    case's pattern (the unsorted case's samples unsorted too)."""
    from deequ_tpu_torch.kernels.kll_compact import kll_compact_ingest, kll_compact_ingest_plain
    from deequ_tpu_torch.runners.engine import stack_samples

    sketches, chunk = chip_smoke.run_ingest_case(k, case, target, seed=5)
    fields = stack_samples(chunk, 4 * k, lambda t: t.to(cuda_device))
    got, want = list(_on(sketches, cuda_device)), list(_on(sketches, cuda_device))
    kll_compact_ingest(got, fields, k)
    kll_compact_ingest_plain(want, fields, k)
    torch.cuda.synchronize()
    _assert_leaves(got, want, "ingest")


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
@pytest.mark.parametrize("case", chip_smoke.FREQ_EDGE_CASES)
def test_freq_compact_kernel_matches_plain_on_edge_cases(cuda_device, case):
    """The edge cases the CPU tests hold the plain version to against the
    reference (tests/test_torch_freq.py): the kernel equals the plain
    version bit for bit, every output and meta word."""
    from deequ_tpu_torch.kernels.freq_compact import freq_compact

    *arrays, out_size = chip_smoke.freq_edge_case(case)
    cpu = [None if x is None else torch.from_numpy(x.view(np.int64)) for x in arrays]
    got = freq_compact(*(None if x is None else x.to(cuda_device) for x in cpu), out_size)
    want = freq_compact(*cpu, out_size)
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
@pytest.mark.parametrize("n", [1, 2, 3, 33, 64])
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


def _stacked_random_slots(width, n, device):
    """W sessions' slots of every kind but the co-moments, stacked ``[W, n]``."""
    per = [_random_slots(n, device, seed=5 + w) for w in range(width)]
    fields = ("where", "sel", "vals", "vals2", "sel2")
    slots = []
    for column in zip(*(p[0] for p in per)):  # one slot of every session
        slots.append(Slot(column[0].kind, **{
            f: None if getattr(column[0], f) is None
            else torch.stack([getattr(slot, f) for slot in column]) for f in fields}))
    return slots, torch.stack([p[1] for p in per])


@pytest.mark.cuda
@pytest.mark.parametrize("width,n", [(1, 4097), (3, 1), (16, 4096), (5, 65_536)])
def test_scan_reduce_stacked_kernel_matches_plain_and_single_launches(cuda_device, width, n):
    """The stacked entry against its stacked plain version (counts, min and
    max bit for bit, sums within 1e-12) and each session against a
    one-session launch over its arrays, bit for bit."""
    slots, rows = _stacked_random_slots(width, n, cuda_device)
    reset_launch_counts()
    ki, kf = scan_reduce_stacked(slots, rows)
    pi, pf = scan_reduce_stacked_plain(slots, rows)
    torch.cuda.synchronize()
    assert launch_counts()["scan_reduce_stacked"] == 1 and launch_counts()["scan_reduce"] == 0
    assert torch.equal(ki, pi)
    kf_h, pf_h = kf.cpu().numpy(), pf.cpu().numpy()
    for w in range(width):
        one = [Slot(s.kind, *(None if t is None else t[w] for t in (
            s.where, s.sel, s.vals, s.vals2, s.sel2))) for s in slots]
        oi, of = scan_reduce(one, rows[w])
        assert torch.equal(oi, ki[w])
        assert of.cpu().numpy().tobytes() == kf_h[w].tobytes()
        for col in (1, 2):
            assert _bits_equal(kf_h[w, :, col], pf_h[w, :, col]), (w, col)
        for s, slot in enumerate(slots):
            if slot.vals is None:
                continue
            v = slot.vals[w].double().cpu().numpy()
            v = v[np.isfinite(v)]
            if v.size == 0:
                continue
            scales = (np.abs(v).sum(), np.abs(v).max(), (v * v).sum())
            for col, scale in zip((0, 3, 4), scales):
                assert _close(kf_h[w, s, col], pf_h[w, s, col], float(scale)), (w, s, col)


@pytest.mark.cuda
@pytest.mark.parametrize("width,n", [(1, 1), (16, 4096), (7, 100_003)])
def test_hll_registers_stacked_kernel_matches_plain_and_single_launches(cuda_device, width, n):
    rng = np.random.default_rng(width)
    shape = (width, n)
    keys = torch.from_numpy(rng.integers(0, 1 << 15, shape).astype(np.uint16)).to(cuda_device)
    rows = torch.from_numpy(rng.random(shape) < 0.97).to(cuda_device)
    where = torch.from_numpy(rng.random(shape) < 0.6).to(cuda_device)
    present = torch.from_numpy(rng.random(shape) < 0.9).to(cuda_device)
    for w_mask in (None, where):
        got = hll_registers_stacked(keys, rows, w_mask, present)
        assert torch.equal(got, hll_registers_stacked_plain(keys, rows, w_mask, present))
        for w in range(width):
            one = hll_registers(keys[w], rows[w], None if w_mask is None else w_mask[w],
                                present[w])
            assert torch.equal(one, got[w])


@pytest.mark.cuda
def test_coalesced_service_run_on_the_card(cuda_device):
    """A short streaming run on the card: coalesced folds launch the stacked
    entries, and every session's metrics equal the serial run's bit for
    bit (chip_smoke phase 8 at 40 sessions x 2 x 2,048 rows)."""
    table = chip_smoke.build_stream_table(40, chip_smoke.STREAM_BATCHES, 2048, seed=3)
    coalesced, summary, launches = chip_smoke.stream_run(
        torch, dq, table, 40, 2048, True, label="cuda test coalesced",
        kernels=chip_smoke.STREAM_KERNELS)
    serial, _, _ = chip_smoke.stream_run(torch, dq, table, 40, 2048, False,
                                         label="cuda test serial", kernels=("scan_reduce", "state_fold"))
    assert summary["width_sum"] >= 80
    for got, want in zip(coalesced, serial):
        assert chip_smoke.compare_metrics(got, want, 0.0) == []


# ---------------------------------------------------------------------------
# the mesh's entries: K8's butterfly and stacked carry, K5's stacked merge
# ---------------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("n_dev,k", [(8, 1), (4, 2), (3, 1), (1, 4), (64, 1)])
def test_state_fold_butterfly_kernel_matches_plain(cuda_device, n_dev, k):
    """Every shard's final row of the collective merge, bit for bit the
    plain version, in one launch; with the wide dictionary slot of
    ``carry_groups`` spanning several blocks."""
    from deequ_tpu_torch.kernels.state_fold import state_fold_butterfly, state_fold_butterfly_plain

    jobs = [states for _, states in chip_smoke.carry_groups(dq, n_dev * k, seed=n_dev + k)]
    mats, slots, _ = pack_states(jobs)
    mats = [m.to(cuda_device) for m in mats]
    reset_launch_counts()
    got = state_fold_butterfly(*mats, slots, n_dev)
    assert launch_counts()["state_fold_butterfly"] == 1
    want = state_fold_butterfly_plain(*mats, slots, n_dev)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert g.shape[0] == n_dev
        if g.dtype == torch.float64:
            assert _bits_equal(g.cpu().numpy(), w.cpu().numpy())
        else:
            assert torch.equal(g.cpu(), w.cpu())


def _assert_rows(got, want):
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        if g.dtype == torch.float64:
            assert _bits_equal(g.cpu().numpy(), w.cpu().numpy())
        else:
            assert torch.equal(g.cpu(), w.cpu())


@pytest.mark.cuda
@pytest.mark.parametrize("n_dev,k", [(n, k) for n in (1, 2, 3, 4, 8, 16, 32, 64) for k in (1, 3)]
                         + [(1000, 1), (1024, 1)])
def test_state_fold_butterfly_kernel_matches_plain_at_every_mesh_size(cuda_device, n_dev, k):
    """The butterfly's XOR rounds at the sizes the CPU tests hold against
    the reference (1-16), at a warp's width and past it (32, 64), the
    gather route (3, 1000) and the largest mesh (1024, k = 1); every
    state kind (fold_groups), bit for bit."""
    from deequ_tpu_torch.kernels.state_fold import state_fold_butterfly, state_fold_butterfly_plain

    jobs = [states for _, states in chip_smoke.fold_groups(dq, n_dev * k, seed=n_dev * 3 + k)]
    mats, slots, _ = pack_states(jobs)
    mats = [m.to(cuda_device) for m in mats]
    reset_launch_counts()
    got = state_fold_butterfly(*mats, slots, n_dev)
    assert launch_counts()["state_fold_butterfly"] == 1
    _assert_rows(got, state_fold_butterfly_plain(*mats, slots, n_dev))


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 2, 33])
def test_state_fold_kernel_matches_plain_on_a_65536_column_slot(cuda_device, n):
    """One dictionary column's 2^16 code counts beside every other kind:
    the wide slot spreads over 256 work items; the fold and the carry entry
    bit for bit their plain versions."""
    from deequ_tpu_torch.kernels.state_fold import (
        ADD_I64,
        FoldSlot,
        state_fold_carry,
        state_fold_carry_plain,
    )

    jobs = [states for _, states in chip_smoke.fold_groups(dq, n, seed=n)]
    mats, slots, _ = pack_states(jobs)
    rng = np.random.default_rng(n)
    wide = torch.from_numpy(rng.integers(0, 1 << 40, (n, 1 << 16)))
    mats[1] = torch.cat([mats[1], wide], dim=1).contiguous()
    slots = list(slots) + [FoldSlot(ADD_I64, mats[1].shape[1] - (1 << 16), 1 << 16)]
    mats = [m.to(cuda_device) for m in mats]
    _assert_rows(state_fold(*mats, slots), state_fold_plain(*mats, slots))
    if n > 1:
        carry = [m[0].clone() for m in mats]
        plain = [m[0].clone() for m in mats]
        parts = [m[1:].contiguous() for m in mats]
        state_fold_carry(carry, parts, slots)
        state_fold_carry_plain(plain, parts, slots)
        _assert_rows(carry, plain)


@pytest.mark.cuda
@pytest.mark.parametrize("n_dev,local", [(8, 4), (3, 2), (1, 32), (5, 300), (64, 1)])
def test_state_fold_carry_stacked_kernel_matches_plain(cuda_device, n_dev, local):
    from deequ_tpu_torch.kernels.state_fold import (
        state_fold_carry_stacked,
        state_fold_carry_stacked_plain,
    )

    rng = np.random.default_rng(n_dev)
    jobs = [states for _, states in chip_smoke.carry_groups(dq, n_dev * (local + 1), seed=7)]
    mats, slots, _ = pack_states(jobs)
    carry = [m[:n_dev].contiguous().to(cuda_device) for m in mats]
    parts = [m[n_dev:].contiguous().to(cuda_device) for m in mats]
    flags = torch.from_numpy(rng.random(n_dev * local) < 0.75).to(cuda_device)
    plain = [c.clone() for c in carry]
    reset_launch_counts()
    state_fold_carry_stacked(carry, parts, slots, flags)
    assert launch_counts()["state_fold_carry_stacked"] == 1
    state_fold_carry_stacked_plain(plain, parts, slots, flags)
    torch.cuda.synchronize()
    for g, w in zip(carry, plain):
        if g.dtype == torch.float64:
            assert _bits_equal(g.cpu().numpy(), w.cpu().numpy())
        else:
            assert torch.equal(g.cpu(), w.cpu())


@pytest.mark.cuda
@pytest.mark.parametrize("k", [64, 2048, 8192])
def test_kll_compact_merge_stacked_kernel_matches_plain(cuda_device, k):
    from deequ_tpu_torch.kernels.kll_compact import (
        kll_compact_ingest_plain,
        kll_compact_merge_stacked,
        kll_compact_merge_stacked_plain,
    )
    from deequ_tpu_torch.runners.engine import stack_samples

    m = 8
    sides = []
    for side in range(2):
        stacked = [torch.stack(list(col)).contiguous()
                   for col in zip(*(kll_init(k, 16).tensors() for _ in range(m)))]
        samples = [chip_smoke.edge_samples(k, 6, seed=20 * side + s) for s in range(m)]
        kll_compact_ingest_plain(stacked, stack_samples(samples, 4 * k, lambda t: t), k)
        sides.append([t.to(cuda_device) for t in stacked])
    reset_launch_counts()
    got = kll_compact_merge_stacked(sides[0], sides[1], k)
    assert launch_counts()["kll_compact_merge_stacked"] == 1
    want = kll_compact_merge_stacked_plain(sides[0], sides[1], k)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert g.cpu().numpy().tobytes() == w.cpu().numpy().tobytes()


@pytest.mark.cuda
@pytest.mark.parametrize("placement", ["host", "device"])
def test_mesh_run_on_the_card_equals_the_cpu_mesh_run(cuda_device, placement):
    """A run over ``make_mesh(8)`` on the card launches the mesh's entries
    and equals the same run over a mesh of 8 on the CPU."""
    import pyarrow as pa

    from deequ_tpu_torch.parallel import make_mesh

    rng = np.random.default_rng(9)
    n = 90_000
    table = pa.table({
        "x": pa.array(rng.normal(0, 1, n), mask=rng.random(n) < 0.05),
        "y": pa.array(rng.normal(5, 2, n)),
        "cat": pa.array(rng.integers(0, 3000, n)),
    })
    analyzers = [dq.Size(), dq.Mean("x"), dq.StandardDeviation("y"), dq.Correlation("x", "y"),
                 dq.Minimum("x"), dq.Maximum("y"), dq.ApproxCountDistinct("cat"),
                 dq.KLLSketch("x")]
    runs = {}
    for device in ("cuda", "cpu"):
        reset_launch_counts()
        ctx = dq.AnalysisRunner.do_analysis_run(
            dq.Dataset.from_arrow(table), analyzers, batch_size=1024, placement=placement,
            sharding=make_mesh(8, device=device))
        runs[device] = (ctx, launch_counts())
    counts = runs["cuda"][1]
    if placement == "host":
        assert counts["state_fold_carry_stacked"] > 0 and counts["state_fold_butterfly"] > 0
        assert counts["kll_compact_merge_stacked"] > 0 and counts["kll_compact_ingest"] > 0
    else:
        assert counts["scan_reduce_stacked"] > 0 and counts["hll_registers_stacked"] > 0
        assert counts["state_fold"] > 0
    for a in analyzers:
        got, want = runs["cuda"][0].metric(a).value.get(), runs["cpu"][0].metric(a).value.get()
        if placement == "device" and isinstance(got, float):
            assert _close(got, want, abs(want)), a  # K1's reordered sums
        else:
            assert repr(got) == repr(want), a


@pytest.mark.cuda
def test_a_shard_lost_on_the_card_salvages_on_the_card(cuda_device, monkeypatch):
    """Shard 5 of eight on the card lost at the second fold: the seven
    survivors merge on the card (``state_fold``), the mesh re-shards to 4
    and the metrics equal the same loss on a CPU mesh; with a ladder of 8
    alone no rung fits, and a mesh on one card fails the run with
    ``MeshExhaustedError`` instead of finishing on the host."""
    import pyarrow as pa

    from deequ_tpu_torch.exceptions import MeshExhaustedError
    from deequ_tpu_torch.parallel import elastic, make_mesh
    from deequ_tpu_torch.reliability import FaultSpec, inject

    rng = np.random.default_rng(12)
    n = 64 * 1024
    table = pa.table({"x": pa.array(rng.normal(0, 1, n), mask=rng.random(n) < 0.05),
                      "cat": pa.array(rng.integers(0, 3000, n))})
    analyzers = [dq.Size(), dq.Mean("x"), dq.StandardDeviation("x"), dq.Minimum("x"),
                 dq.ApproxCountDistinct("cat"), dq.KLLSketch("x")]

    def run(device):
        monitor = dq.RunMonitor()
        with inject(FaultSpec("sharded_fold", "mesh_loss", at=2, shard=5)) as inj:
            ctx = dq.AnalysisRunner.do_analysis_run(
                dq.Dataset.from_arrow(table), analyzers, batch_size=1024, placement="host",
                sharding=make_mesh(8, device=device), monitor=monitor)
        assert inj.fired
        return ctx, monitor

    reset_launch_counts()
    on_card, monitor = run("cuda")
    assert launch_counts()["state_fold"] > 0
    assert (monitor.shard_losses, monitor.mesh_reshards, monitor.salvaged_states) == (1, 1, 7)
    assert "mesh:8->4" in monitor.degraded
    on_cpu, _ = run("cpu")
    for a in analyzers:
        assert repr(on_card.metric(a).value.get()) == repr(on_cpu.metric(a).value.get()), a
    monkeypatch.setenv(elastic.MESH_LADDER_ENV, "8")
    with pytest.raises(MeshExhaustedError):
        run("cuda")


# ---------------------------------------------------------------------------
# K1 and K3 as staged for the H100: chunk edges, shared arrays, signed zeros
# and NaN, every session of a stacked launch, and every path of K3
# ---------------------------------------------------------------------------

import deequ_tpu_torch.kernels.dict_code_counts as K3
import deequ_tpu_torch.kernels.scan_reduce as K1


def _scan_matches_plain(slots, ki, kf, pi, pf) -> None:
    """Counts, class counts, min and max bit for bit; sums, means and M2
    within 1e-12 of their magnitudes (co-moments: of theirs)."""
    assert torch.equal(ki, pi)
    kf, pf = kf.cpu().numpy(), pf.cpu().numpy()
    for s, slot in enumerate(slots):
        if slot.kind == KIND_COMOMENTS:
            x = slot.vals.double().cpu().numpy()
            y = slot.vals2.double().cpu().numpy()
            xx, yy = float(np.nansum(x * x)), float(np.nansum(y * y))
            scales = (np.nanmax(np.abs(x), initial=1.0), np.nanmax(np.abs(y), initial=1.0),
                      (xx * yy) ** 0.5, xx, yy)
            for col, scale in enumerate(scales):
                assert _close(kf[s, col], pf[s, col], float(scale)), (s, col)
            continue
        assert _bits_equal(kf[s, 1:3], pf[s, 1:3]), (s, kf[s], pf[s])
        if slot.vals is None:
            assert _bits_equal(kf[s], pf[s]), s
            continue
        v = slot.vals.double().cpu().numpy()
        v = v[np.isfinite(v)]
        scales = (np.abs(v).sum(), np.abs(v).max(initial=0.0), (v * v).sum())
        for col, scale in zip((0, 3, 4), scales):
            assert _close(kf[s, col], pf[s, col], float(scale)), (s, col, kf[s], pf[s])


def _shared_array_slots(n, device, seed=11):
    """A table whose slots share their row filter, masks and columns, with
    columns of signed zeros, NaN only, infinities only and int32 lengths,
    a class-count slot and two co-moment slots."""
    rng = np.random.default_rng(seed)

    def mask(p):
        return torch.from_numpy(rng.random(n) < p).to(device)

    def col(v):
        return torch.from_numpy(np.asarray(v, dtype=np.float64)).to(device)

    x = rng.normal(5.0, 3.0, n)
    x[rng.random(n) < 0.002] = np.nan
    zeros = col(np.where(rng.random(n) < 0.5, -0.0, 0.0))
    negzero = col(np.full(n, -0.0))
    nans = col(np.full(n, np.nan))
    infs = col(np.where(rng.random(n) < 0.5, -np.inf, np.inf))
    xs, ys = col(x), col(0.25 * np.nan_to_num(x) + rng.normal(0, 1, n))
    lens = torch.from_numpy(rng.integers(0, 40, n).astype(np.int32)).to(device)
    codes = torch.from_numpy(rng.integers(-1, 7, n).astype(np.int32)).to(device)
    where, present, other = mask(0.6), mask(0.9), mask(0.8)
    slots = [
        Slot(KIND_COUNTS),
        Slot(KIND_COUNTS, where=where),
        Slot(KIND_COUNTS, where=where, sel=present),
        Slot(KIND_MOMENTS, sel=present, vals=xs),
        Slot(KIND_MOMENTS, where=where, sel=present, vals=xs),
        Slot(KIND_MOMENTS, sel=other, vals=zeros),
        Slot(KIND_MOMENTS, sel=present, vals=negzero),
        Slot(KIND_MOMENTS, sel=present, vals=nans),
        Slot(KIND_MOMENTS, where=where, sel=other, vals=infs),
        Slot(KIND_MOMENTS, sel=present, vals=lens),
        Slot(KIND_CLASSES, where=where, vals=codes),
        Slot(KIND_COMOMENTS, sel=present, vals=xs, vals2=ys, sel2=other),
        Slot(KIND_COMOMENTS, where=where, sel=other, vals=ys, vals2=zeros, sel2=present),
    ]
    return slots, mask(0.97)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [0, 1, 127, 128, 129, 511, 512, 513, 1023, 1024, 1025, 4095, 4096,
                               4097, 8191, 8192, 8193, 65_537, 1_000_003])
def test_scan_reduce_at_either_side_of_its_chunk(cuda_device, n):
    """Batches of one row under, at and over a chunk and over the sizes at
    which the chunk grows, on a table that shares arrays between slots."""
    slots, rows = _shared_array_slots(n, cuda_device)
    plan = K1.stage_plan(slots, rows)
    assert len(plan.arrays) < sum(
        1 + sum(getattr(s, f) is not None for f in ("where", "sel", "vals", "vals2", "sel2"))
        for s in slots)
    ki, kf = scan_reduce(slots, rows)
    pi, pf = scan_reduce_plain(slots, rows)
    torch.cuda.synchronize()
    _scan_matches_plain(slots, ki, kf, pi, pf)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 1000, 1_000_003])
def test_scan_reduce_min_max_of_signed_zeros_and_nan_columns(cuda_device, n):
    """min and max of columns of -0.0 and +0.0, of NaN only, of infinities
    only: the bits of the plain version (-0.0 wins min, +0.0 wins max,
    NaN min when no value is left, NaN max when any is NaN)."""
    slots, rows = _shared_array_slots(n, cuda_device, seed=n)
    ki, kf = scan_reduce(slots, rows)
    pi, pf = scan_reduce_plain(slots, rows)
    torch.cuda.synchronize()
    kf_h, pf_h = kf.cpu().numpy(), pf.cpu().numpy()
    for s in (5, 6, 7, 8):
        assert _bits_equal(kf_h[s, 1:3], pf_h[s, 1:3]), (s, kf_h[s], pf_h[s])
    assert np.isnan(kf_h[7, 1]) and np.isnan(kf_h[7, 2])  # NaN only
    if int(pi[6, 0]) > 0:
        assert np.signbit(kf_h[6, 1]) and np.signbit(kf_h[6, 2])  # -0.0 only


def _stacked_shared_slots(width, n, device):
    per = [_shared_array_slots(n, device, seed=17 + w) for w in range(width)]
    fields = ("where", "sel", "vals", "vals2", "sel2")
    stacked = {}

    def stack(ts):
        # one [W, n] tensor per array the sessions share, as a battery's
        # features are one stacked tensor per key
        key = tuple(id(t) for t in ts)
        if key not in stacked:
            stacked[key] = torch.stack(ts)
        return stacked[key]

    slots = [Slot(column[0].kind, **{
        f: None if getattr(column[0], f) is None else stack([getattr(s, f) for s in column])
        for f in fields}) for column in zip(*(p[0] for p in per))]
    return slots, torch.stack([p[1] for p in per])


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 4095, 4097, 65_536])
@pytest.mark.parametrize("width", [1, 3, 16])
def test_scan_reduce_stacked_sessions_equal_one_session_launches(cuda_device, width, n):
    """Every session of a stacked launch, co-moment slots included, equals a
    launch over its batch alone bit for bit, and the plain version."""
    slots, rows = _stacked_shared_slots(width, n, cuda_device)
    assert K1.chunk_rows(n, K1.stage_plan(slots, rows).row_bytes) == K1.chunk_rows(
        n, K1.stage_plan([Slot(s.kind, *(None if t is None else t[0] for t in (
            s.where, s.sel, s.vals, s.vals2, s.sel2))) for s in slots], rows[0]).row_bytes)
    reset_launch_counts()
    ki, kf = scan_reduce_stacked(slots, rows)
    pi, pf = scan_reduce_stacked_plain(slots, rows)
    torch.cuda.synchronize()
    assert launch_counts()["scan_reduce_stacked"] == 1
    assert torch.equal(ki, pi)
    for w in range(width):
        one = [Slot(s.kind, *(None if t is None else t[w] for t in (
            s.where, s.sel, s.vals, s.vals2, s.sel2))) for s in slots]
        oi, of = scan_reduce(one, rows[w])
        assert torch.equal(oi, ki[w]), w
        assert of.cpu().numpy().tobytes() == kf[w].cpu().numpy().tobytes(), w
        _scan_matches_plain(one, ki[w], kf[w], pi[w], pf[w])


def _zipf_codes(n, k, rng):
    """build_table's dictionary codes: Zipf(1.3), clipped, spread by 7919."""
    codes = np.minimum(rng.zipf(1.3, n) - 1, k - 1)
    return ((codes * 7919) % k).astype(np.int32)


def _counts_match_plain(codes, rows, present, k) -> None:
    counts, num_rows = dict_code_counts(codes, rows, present, k)
    want_counts, want_rows = dict_code_counts_plain(codes, rows, present, k)
    torch.cuda.synchronize()
    assert counts.shape == (k,)
    assert torch.equal(counts, want_counts)
    assert int(num_rows) == int(want_rows)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["zipf 50000", "one hot code", "shared limit",
                                  "shared limit + 1", "65536", "70000", "zipf 1000"])
def test_dict_code_counts_every_path_matches_plain(cuda_device, case):
    limit = K3.shared_limit(cuda_device)
    top = K3.shared_max_k(limit)
    k = {"zipf 50000": 50_000, "one hot code": 1000, "shared limit": top,
         "shared limit + 1": top + 1, "65536": 65_536, "70000": 70_000,
         "zipf 1000": 1000}[case]
    path = {"shared limit + 1": "cluster", "65536": "cluster", "70000": "global"}.get(case, "shared")
    assert K3.plan_path(k, limit) == path
    n = 1_000_003
    rng = np.random.default_rng(k)
    if case.startswith("zipf"):
        codes = _zipf_codes(n, k, rng)
    elif case == "one hot code":
        codes = np.full(n, 417, dtype=np.int32)
    else:
        codes = rng.integers(0, k + 1, n).astype(np.int32)  # k is the sentinel
    codes_t = torch.from_numpy(codes).to(cuda_device)
    rows = torch.from_numpy(rng.random(n) < 0.97).to(cuda_device)
    present = torch.from_numpy(rng.random(n) < 0.9).to(cuda_device)
    reset_launch_counts()
    _counts_match_plain(codes_t, rows, present, k)
    assert launch_counts()["dict_code_counts"] == 1
    # views that start off their vector width take the one-row-a-step loop
    _counts_match_plain(codes_t[1:], rows[1:], present[1:], k)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [0, 1, 3, 5, 4097])
@pytest.mark.parametrize("k", [1, 60_000, 65_537])
def test_dict_code_counts_short_batches(cuda_device, n, k):
    """Batches shorter than a warp's step, and a tail after the last whole
    step, on each path."""
    rng = np.random.default_rng(n + k)
    codes = torch.from_numpy(rng.integers(-2, k + 2, n).astype(np.int32)).to(cuda_device)
    rows = torch.from_numpy(rng.random(n) < 0.9).to(cuda_device)
    present = torch.from_numpy(rng.random(n) < 0.9).to(cuda_device)
    _counts_match_plain(codes, rows, present, k)


# ---------------------------------------------------------------------------
# K2 hll_registers and K6 freq_keys on the edge cases of chip_smoke's phase 2
# ---------------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("case", chip_smoke.HLL_EDGE_CASES)
def test_hll_registers_kernel_matches_plain_on_edge_cases(cuda_device, case):
    """n = 0, 1 and 17, every row masked, every valid row on one register,
    ``[1:]`` views and every packed key: bit for bit, with and without a
    where-filter."""
    keys, rows, where, present = chip_smoke.hll_edge_inputs(torch, case, cuda_device)
    for w in (None, where):
        got = hll_registers(keys, rows, w, present)
        assert torch.equal(got, hll_registers_plain(keys, rows, w, present))
    if case == "all rows masked":
        assert not got.any()


@pytest.mark.cuda
@pytest.mark.parametrize("width,n,skip", [(1, 4097, 0), (1, 4097, 1), (16, 4097, 1),
                                          (16, 65_537, 0), (16, 65_537, 1), (3, 1, 0),
                                          (2, 0, 0)])
def test_hll_registers_stacked_sessions_at_odd_sizes_and_starts(cuda_device, width, n, skip):
    """W = 1 and 16 sessions of odd n, the stacked tensors starting at an
    aligned and at an odd element: each session equals its one-session
    launch and the plain version bit for bit."""
    keys, rows, where, present = chip_smoke.hll_stacked_inputs(torch, width, n, cuda_device, skip)
    for w_mask in (None, where):
        reset_launch_counts()
        got = hll_registers_stacked(keys, rows, w_mask, present)
        assert launch_counts()["hll_registers_stacked"] == 1
        assert torch.equal(got, hll_registers_stacked_plain(keys, rows, w_mask, present))
        for w in range(width):
            one = hll_registers(keys[w], rows[w], None if w_mask is None else w_mask[w],
                                present[w])
            assert torch.equal(one, got[w]), w


@pytest.mark.cuda
@pytest.mark.parametrize("ncols,n", [(1, 100_003), (2, 1 << 20), (16, 100_003), (16, 1 << 20),
                                     (33, 4097), (2, 0), (3, 1)])
def test_hll_registers_columns_matches_plain_with_previous_registers(cuda_device, ncols, n):
    """The battery entry over columns with nonzero previous registers, some
    with where-filters and some one element off their masks: bit for bit,
    one launch a 32 columns, the inputs untouched, and the same call twice
    (the workspace is left zeroed)."""
    from deequ_tpu_torch.kernels.hll_registers import (
        MAX_COLUMNS, hll_registers_columns, hll_registers_columns_plain)

    columns, rows = chip_smoke.hll_battery_inputs(torch, ncols, n, cuda_device)
    prev = [c.prev.clone() for c in columns]
    want = hll_registers_columns_plain(columns, rows)
    reset_launch_counts()
    for _ in range(2):
        assert torch.equal(hll_registers_columns(columns, rows), want)
    assert launch_counts()["hll_registers_columns"] == 2 * -(-ncols // MAX_COLUMNS)
    assert all(torch.equal(c.prev, p) for c, p in zip(columns, prev))


@pytest.mark.cuda
def test_hll_registers_on_two_streams(cuda_device):
    """Launches of several blocks a group on two streams at once each meet
    in their own stream's workspace."""
    from deequ_tpu_torch.kernels.hll_registers import (
        hll_registers_columns, hll_registers_columns_plain)

    side = torch.cuda.Stream()
    a = chip_smoke.hll_battery_inputs(torch, 4, 1 << 20, cuda_device, seed=1)
    b = chip_smoke.hll_battery_inputs(torch, 4, 1 << 20, cuda_device, seed=2)
    torch.cuda.synchronize()
    got = []
    for i in range(4):
        stream = side if i % 2 else torch.cuda.current_stream()
        with torch.cuda.stream(stream):
            got.append(hll_registers_columns(*(b if i % 2 else a)))
    torch.cuda.synchronize()
    for i, regs in enumerate(got):
        assert torch.equal(regs, hll_registers_columns_plain(*(b if i % 2 else a))), i


@pytest.mark.cuda
def test_a_battery_folds_its_hll_columns_in_one_launch_a_batch(cuda_device):
    """Three ApproxCountDistinct analyzers (one with a where-filter) over
    five batches: one ``hll_registers_columns`` launch a batch, none of
    the one-column entry, and the registers of the CPU run bit for bit."""
    rng = np.random.default_rng(4)
    n = 50_000
    table = {"a": rng.integers(0, 5000, n), "b": rng.normal(size=n),
             "c": np.where(rng.random(n) < 0.1, None, rng.integers(0, 90, n).astype(str))}
    import pyarrow as pa

    data = dq.Dataset.from_arrow(pa.table(table))
    analyzers = [dq.ApproxCountDistinct("a"), dq.ApproxCountDistinct("b", "a > 100"),
                 dq.ApproxCountDistinct("c")]
    runs = {}
    for device in ("cuda", "cpu"):
        reset_launch_counts()
        ctx = dq.AnalysisRunner.do_analysis_run(data, analyzers, batch_size=10_000,
                                                device=device)
        runs[device] = (ctx, launch_counts())
    counts = runs["cuda"][1]
    assert counts["hll_registers_columns"] == 5 and counts["hll_registers"] == 0
    for a in analyzers:
        assert runs["cuda"][0].metric(a).value.get() == runs["cpu"][0].metric(a).value.get()


@pytest.mark.cuda
@pytest.mark.parametrize("case", chip_smoke.FREQ_KEY_EDGE_CASES)
def test_freq_keys_kernel_matches_plain_on_edge_cases(cuda_device, case):
    """n = 0, 1 and 13, every row masked, ``[1:]`` views, an odd offset into
    the buffer, inputs that share no aligned row, a valid row keyed as the
    sentinel and a key column of each dtype: the buffer (around the keys
    too) and both counters bit for bit, twice."""
    from deequ_tpu_torch.kernels.freq_keys import freq_keys, freq_keys_plain

    columns, rows, out, offset = chip_smoke.freq_key_edge_inputs(torch, case, cuda_device)
    want_out = out.clone()
    want = freq_keys_plain(columns, rows, want_out, offset)
    for _ in range(2):
        got = freq_keys(columns, rows, out, offset)
        torch.cuda.synchronize()
        assert torch.equal(out, want_out)
        assert torch.equal(got, want)
    if case == "sentinel row":
        assert int(got[0]) > 0


# ---------------------------------------------------------------------------
# the engine's feed pipeline: depth 2 against the serial loop
# ---------------------------------------------------------------------------

@pytest.mark.cuda
def test_the_feed_at_depth_2_equals_the_serial_loop(cuda_device, monkeypatch):
    """On the card, depth 2 builds each batch on the feed thread (the
    launching thread waits for it: phase ``feed_wait``) and gives the
    serial loop's states bit for bit, with the same launches."""
    import chip_smoke
    from deequ_tpu_torch.kernels import launch_counts, reset_launch_counts

    rng = np.random.default_rng(11)
    rows = 300_000
    data = dq.Dataset.from_dict({"x": rng.normal(size=rows), "k": rng.integers(0, 900, rows)})
    battery = [dq.Size(), dq.Mean("x"), dq.Sum("x"), dq.Minimum("x"),
               dq.ApproxCountDistinct("k"), dq.KLLSketch("x")]
    out = []
    for depth in (0, 2, 2, 0):
        monkeypatch.setenv("DEEQU_TPU_PREFETCH_DEPTH", str(depth))
        monitor = dq.RunMonitor()
        reset_launch_counts()
        states = ScanEngine(battery, cuda_device, monitor=monitor, placement="device").run(
            data, batch_size=1 << 15)
        out.append((states, monitor, launch_counts()))
    for states, monitor, launches in out[1:]:
        assert all(chip_smoke.same_state_bits(a, b) for a, b in zip(states, out[0][0]))
        assert launches == out[0][2]
    assert "feed_wait" in out[1][1].phase_seconds
    assert "feed_wait" not in out[0][1].phase_seconds


@pytest.mark.cuda
def test_the_feed_on_a_busy_stream_equals_the_serial_loop(cuda_device, monkeypatch):
    """A depth-2 pass started on a busy non-default stream gives the
    serial loop's states bit for bit: each batch's copy is waited for
    before its launches, and its launches before the next batch's copy."""
    import chip_smoke

    rng = np.random.default_rng(12)
    data = dq.Dataset.from_dict({"x": rng.normal(size=200_000)})
    battery = [dq.Sum("x"), dq.Maximum("x")]
    monkeypatch.setenv("DEEQU_TPU_PREFETCH_DEPTH", "0")
    want = ScanEngine(battery, cuda_device, placement="device").run(data, batch_size=1 << 14)
    monkeypatch.setenv("DEEQU_TPU_PREFETCH_DEPTH", "2")
    stream = torch.cuda.Stream()
    with torch.cuda.stream(stream):
        busy = torch.randn(4096, 4096, device=cuda_device)
        for _ in range(8):
            busy = busy @ busy  # queue work ahead of the pass's launches
        got = ScanEngine(battery, cuda_device, placement="device").run(data,
                                                                       batch_size=1 << 14)
    stream.synchronize()
    assert all(chip_smoke.same_state_bits(a, b) for a, b in zip(got, want))
