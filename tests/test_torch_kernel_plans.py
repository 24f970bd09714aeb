"""The pure-Python planning of K1 ``scan_reduce``'s and K3
``dict_code_counts``'s wrappers, on the CPU: K1's list of a slot table's
distinct arrays and each slot's indices into it (shared masks and columns
are one array, in a stable order), its chunk and blocks per session (a
function of the batch's rows and the table, never of the number of
sessions), and K3's choice of path by dictionary size and shared memory.
The kernels that read these plans are held against their plain versions
on the card (tests/test_torch_cuda.py, chip_smoke.py phase 2)."""

from __future__ import annotations

import numpy as np
import pytest
import torch

import deequ_tpu_torch.kernels.dict_code_counts as K3
import deequ_tpu_torch.kernels.scan_reduce as K1
from deequ_tpu_torch.kernels.scan_reduce import (
    KIND_CLASSES,
    KIND_COMOMENTS,
    KIND_COUNTS,
    KIND_MOMENTS,
    NONE,
    Slot,
)

#: an H100's opt-in shared memory a block, bytes
H100_SHARED = 232_448


def _table(n: int, width: int = 0):
    """Slots over one batch (width 0) or ``width`` stacked sessions, whose
    row filter, masks and columns several slots share."""
    shape = (width, n) if width else (n,)
    rng = np.random.default_rng(n + width)

    def mask():
        return torch.from_numpy(rng.random(shape) < 0.5)

    rows, where, present, other = mask(), mask(), mask(), mask()
    x = torch.from_numpy(rng.normal(size=shape))
    y = torch.from_numpy(rng.normal(size=shape))
    lens = torch.from_numpy(rng.integers(0, 9, shape).astype(np.int32))
    slots = [
        Slot(KIND_COUNTS),
        Slot(KIND_COUNTS, where=where, sel=present),
        Slot(KIND_MOMENTS, sel=present, vals=x),
        Slot(KIND_MOMENTS, where=where, sel=present, vals=x),
        Slot(KIND_MOMENTS, sel=other, vals=lens),
        Slot(KIND_CLASSES, where=where, vals=lens),
        Slot(KIND_COMOMENTS, sel=present, vals=x, vals2=y, sel2=other),
    ]
    return slots, rows, (rows, where, present, x, other, lens, y)


@pytest.mark.parametrize("n", [1, 100, 4096])
def test_distinct_arrays_are_each_named_once_in_first_use_order(n):
    slots, rows, order = _table(n)
    plan = K1.stage_plan(slots, rows)
    assert [t.data_ptr() for t in plan.arrays] == [t.data_ptr() for t in order]
    assert plan.row_bytes == 1 + 1 + 1 + 8 + 1 + 4 + 8
    at = {t.data_ptr(): i for i, t in enumerate(plan.arrays)}

    def index(t):
        return NONE if t is None else at[t.data_ptr()]

    for slot, entry in zip(slots, plan.slots):
        assert entry == (slot.kind, int(slot.vals is not None and slot.vals.dtype == torch.int32),
                         index(slot.where), index(slot.sel), index(slot.vals),
                         index(slot.vals2), index(slot.sel2))


@pytest.mark.parametrize("n", [10, 5000])
def test_distinct_arrays_follow_memory_not_tensor_objects(n):
    """Two views of one tensor are one array; two equal tensors are two."""
    rows = torch.ones(n, dtype=torch.bool)
    mask = torch.zeros(n, dtype=torch.bool)
    copy = mask.clone()
    vals = torch.zeros(n, dtype=torch.float64)
    slots = [Slot(KIND_COUNTS, sel=mask), Slot(KIND_COUNTS, sel=mask.view(n)),
             Slot(KIND_COUNTS, sel=copy), Slot(KIND_MOMENTS, vals=vals),
             Slot(KIND_MOMENTS, sel=mask, vals=vals[:])]
    plan = K1.stage_plan(slots, rows)
    assert len(plan.arrays) == 4
    assert [e[3] for e in plan.slots] == [1, 1, 2, NONE, 1]
    assert [e[4] for e in plan.slots] == [NONE, NONE, NONE, 3, 3]


def test_the_row_mask_is_first_even_when_a_slot_names_it():
    rows = torch.ones(64, dtype=torch.bool)
    plan = K1.stage_plan([Slot(KIND_COUNTS, where=rows, sel=rows)], rows)
    assert len(plan.arrays) == 1 and plan.slots[0][2:4] == (0, 0)


@pytest.mark.parametrize("n", [0, 1, 127, 1000, 1024, 4095, 4096, 8192, 65_536, 1 << 20])
@pytest.mark.parametrize("row_bytes", [1, 19, 28, 63, 113, 600, 1217])
def test_chunk_fits_shared_memory_and_spreads_small_batches(n, row_bytes):
    chunk = K1.chunk_rows(n, row_bytes)
    assert chunk in K1.CHUNK_ROWS
    assert chunk * row_bytes <= K1.STAGE_BYTES or chunk == K1.CHUNK_ROWS[-1]
    if n >= K1.MIN_CHUNKS * chunk:
        bigger = [c for c in K1.CHUNK_ROWS if c > chunk]
        # a bigger chunk would overflow the stage or leave too few chunks
        assert all(c * row_bytes > K1.STAGE_BYTES or K1.MIN_CHUNKS * c > n for c in bigger)
    assert K1.blocks_per_session(n, row_bytes) == max(1, -(-n // chunk))


@pytest.mark.parametrize("n", [1, 4095, 4097, 65_536])
@pytest.mark.parametrize("width", [1, 3, 16, 100])
def test_blocks_per_session_depend_on_rows_never_on_sessions(n, width):
    """A stacked launch's table has the one-session table's arrays, so its
    row bytes, chunk and blocks per session are those of a launch over one
    session, whatever the number of sessions."""
    slots, rows, _ = _table(n, width)
    stacked = K1.stage_plan(slots, rows)
    one = K1.stage_plan([Slot(s.kind, *(None if t is None else t[0] for t in (
        s.where, s.sel, s.vals, s.vals2, s.sel2))) for s in slots], rows[0])
    assert stacked.row_bytes == one.row_bytes
    assert stacked.slots == one.slots
    assert K1.chunk_rows(n, stacked.row_bytes) == K1.chunk_rows(n, one.row_bytes)
    assert K1.blocks_per_session(n, stacked.row_bytes) == K1.blocks_per_session(n, one.row_bytes)


def test_the_table_fits_a_launch_s_parameters():
    import ctypes

    # under the 4 KB of a launch's parameters with the kernel's other four
    assert ctypes.sizeof(K1._Table) + 4 * 8 <= 4096
    assert K1.MAX_ARRAYS == 1 + 5 * K1.MAX_SLOTS


@pytest.mark.parametrize("k,path", [
    (0, "shared"), (1, "shared"), (1000, "shared"), (50_000, "shared"), (58_096, "shared"),
    (58_097, "cluster"), (60_000, "cluster"), (65_536, "cluster"), (65_537, "global"),
    (70_000, "global"), ((1 << 31) - 1, "global"),
])
def test_k3_path_on_an_h100(k, path):
    assert K3.plan_path(k, H100_SHARED) == path


@pytest.mark.parametrize("limit", [48 * 1024, 100 * 1024, 163 * 1024, H100_SHARED])
def test_k3_paths_follow_the_shared_limit(limit):
    top = K3.shared_max_k(limit)
    assert 4 * top + K3.STATIC_SHARED_BYTES <= limit and top % 4 == 0
    assert K3.plan_path(top, limit) == "shared"
    assert K3.plan_path(top + 1, limit) in ("cluster", "global")
    # the cluster takes what two blocks' halves hold, up to 65,536 codes
    for k in (top + 1, 2 * top, K3.CLUSTER_MAX_K, K3.CLUSTER_MAX_K + 1):
        half = -(-k // K3.CLUSTER_SIZE)
        fits = k <= K3.CLUSTER_MAX_K and 4 * ((half + 3) & ~3) + K3.STATIC_SHARED_BYTES <= limit
        if k > top:
            assert K3.plan_path(k, limit) == ("cluster" if fits else "global"), k


@pytest.mark.parametrize("k", [0, 3, 1000, 65_537])
def test_k3_plain_version_keeps_its_shapes(k):
    n = 500
    rng = np.random.default_rng(k)
    codes = torch.from_numpy(rng.integers(-1, k + 2, n).astype(np.int32))
    rows = torch.from_numpy(rng.random(n) < 0.9)
    present = torch.from_numpy(rng.random(n) < 0.8)
    counts, num_rows = K3.dict_code_counts(codes, rows, present, k)
    assert counts.shape == (k,) and counts.dtype == torch.int64
    assert num_rows.shape == () and int(num_rows) == int(rows.sum())
    valid = (rows & present).numpy() & (codes.numpy() >= 0) & (codes.numpy() < k)
    assert np.array_equal(counts.numpy(), np.bincount(codes.numpy()[valid], minlength=k)[:k])


@pytest.mark.parametrize("n", [1, 4096])
def test_the_table_a_launch_reads_holds_the_plan(n):
    """The reused launch table, filled for one table and then for another
    and back, holds each plan's pointers, row offsets and slot words."""
    import ctypes

    buf = K1._TableBuffer()
    first = _table(n)
    other = _table(n + 1, 2)
    for slots, rows, _ in (first, other, first):
        plan = K1.stage_plan(slots, rows)
        buf.fill(plan)
        raw = ctypes.string_at(ctypes.addressof(buf.table), ctypes.sizeof(K1._Table))
        ptr = np.frombuffer(raw, np.uint64, K1.MAX_ARRAYS, K1._Table.ptr.offset)
        at = np.frombuffer(raw, np.uint16, K1.MAX_ARRAYS + 1, K1._Table.at.offset)
        words = np.frombuffer(raw, np.uint16, 6 * K1.MAX_SLOTS,
                              K1._Table.slot.offset).reshape(-1, 6)
        counts = np.frombuffer(raw, np.int32, 2, K1._Table.n_arrays.offset)
        a, s = len(plan.arrays), len(plan.slots)
        assert list(counts) == [a, s]
        assert list(ptr[:a]) == [t.data_ptr() for t in plan.arrays]
        assert list(at[:a + 1]) == list(np.cumsum((0,) + plan.sizes))
        for entry, w in zip(plan.slots, words[:s]):
            assert w[0] == entry[0] | (entry[1] << 8) and tuple(w[1:]) == entry[2:]
