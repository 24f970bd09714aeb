"""The launch plans of K2 ``hll_registers`` and K6 ``freq_keys``, in plain
Python, without a card.

- K2: blocks per (column, session) group from the rows
  (:func:`blocks_per_group`), the element phase its arrays share
  (:func:`row_phase`) and the split of a session's rows into one-by-one
  rows and 16-row tiles of 16-byte loads (:func:`tile_split`), at aligned
  and odd starts and for every session of a stacked launch.
- K6: the first row at which every input is aligned for its vector loads
  (:func:`tile_head`), the blocks of a launch, and the layout cache: a
  layout's kinds and dtypes are checked once, a malformed call raises
  every time.
- Both wrappers' by-value tables, as the kernels read them, captured from
  a stand-in library (the kernels themselves run on the card:
  ``tests/test_torch_cuda.py``); a launch error raises.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import deequ_tpu_torch.kernels as kernels
import deequ_tpu_torch.kernels.freq_keys as K6
import deequ_tpu_torch.kernels.hll_registers as K2
from deequ_tpu_torch.kernels.freq_keys import KIND_HASH, KIND_NUM, KeyColumn
from deequ_tpu_torch.kernels.hll_registers import HllColumn

H100_SMS = 132


# ---------------------------------------------------------------------------
# K2
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n,groups,want", [
    (0, 1, 1), (1, 1, 1), (4096, 1, 1), (4097, 1, 2), (1 << 20, 1, 256),
    (1 << 20, 2, 256), (1 << 20, 16, 66), (4096, 16, 1), (65_536, 16, 16),
    (65_537, 16, 17), (1 << 20, 5000, 1),
])
def test_k2_blocks_per_group_follow_the_rows(n, groups, want):
    """About one 16-row tile a thread; at most eight blocks an SM in all; a
    short session gets one block (no workspace), whatever the width."""
    got = K2.blocks_per_group(n, groups, H100_SMS)
    assert got == want
    assert got * groups <= max(K2.BLOCKS_PER_SM * H100_SMS, groups)


def _aligned(t: torch.Tensor, row: int) -> bool:
    return (t.data_ptr() + row * t.element_size()) % 16 == 0


@pytest.mark.parametrize("skip", range(0, 18))
@pytest.mark.parametrize("n", [0, 1, 15, 16, 17, 31, 1000, 4097])
def test_k2_tile_split_covers_every_row_with_aligned_tiles(skip, n):
    """Views ``skip`` elements into their allocations: head, tiles and tail
    cover the n rows once, and every tile starts 16-byte aligned in the
    keys and in each mask."""
    base = torch.zeros(4096 * 2 + 64, dtype=torch.uint16)
    masks = [torch.zeros(4096 * 2 + 64, dtype=torch.bool) for _ in range(3)]
    keys = base[skip:skip + n]
    views = [m[skip:skip + n] for m in masks]
    phase = K2.row_phase(keys.data_ptr(), [v.data_ptr() for v in views])
    if n:  # an empty view's data_ptr() need not follow its offset
        assert phase == (masks[0].data_ptr() + skip) % 16
    head, tiles, tail = K2.tile_split(n, phase)
    assert head + K2.TILE * tiles + tail == n
    assert 0 <= head < K2.TILE and 0 <= tail < K2.TILE or n < K2.TILE
    for t in range(tiles):
        row = head + K2.TILE * t
        assert _aligned(keys, row) and all(_aligned(v, row) for v in views)


def test_k2_row_phase_refuses_arrays_that_share_no_tile():
    keys = torch.zeros(100, dtype=torch.uint16)
    mask = torch.zeros(100, dtype=torch.bool)
    other = torch.zeros(100, dtype=torch.bool)
    assert K2.row_phase(keys[1:].data_ptr(), [mask[1:].data_ptr(), other[1:].data_ptr()]) >= 0
    assert K2.row_phase(keys[1:].data_ptr(), [mask.data_ptr()]) == -1
    assert K2.row_phase(keys.data_ptr(), [mask[1:].data_ptr(), other.data_ptr()]) == -1
    assert K2.row_phase(keys.data_ptr() + 1, [mask.data_ptr()]) == -1
    assert K2.tile_split(37, -1) == (37, 0, 0)


@pytest.mark.parametrize("width,n,skip", [(1, 4097, 0), (16, 4097, 1), (16, 65_537, 3),
                                          (7, 33, 0)])
def test_k2_every_session_of_a_stacked_launch_splits_into_aligned_tiles(width, n, skip):
    """A stacked launch's sessions start at w * n: odd n shifts each
    session's phase; the shift is the same for every array, so the phase
    of row 0 decides for all sessions."""
    keys = torch.zeros(width * n + skip, dtype=torch.uint16)[skip:].view(width, n)
    masks = [torch.zeros(width * n + skip, dtype=torch.bool)[skip:].view(width, n)
             for _ in range(2)]
    phase = K2.row_phase(keys.data_ptr(), [m.data_ptr() for m in masks])
    assert phase >= 0
    for w in range(width):
        head, tiles, tail = K2.tile_split(n, phase, w * n)
        assert head + K2.TILE * tiles + tail == n
        for t in range(tiles):
            row = head + K2.TILE * t
            assert _aligned(keys[w], row) and all(_aligned(m[w], row) for m in masks)


class _FakeLaunch:
    """A stand-in library that records the table of each launch."""

    def __init__(self, words: int, status: int = 0):
        self.tables, self.status, self.words = [], status, words

    def __getattr__(self, name):
        def launch(table, stream):
            self.tables.append(np.frombuffer(bytes(table._obj), np.int64)[:self.words].copy())
            return self.status
        return launch


def _fake_card(monkeypatch, module, fake):
    monkeypatch.setattr(module, "_lib", lambda: fake)
    monkeypatch.setattr(module, "on_cuda", lambda t, name: True)
    monkeypatch.setattr(module, "stream_handle", lambda device: 7)
    monkeypatch.setattr(module, "sm_count", lambda device: H100_SMS)
    monkeypatch.setattr(kernels, "_WORKSPACES", {})
    monkeypatch.setattr(module, "count_launch", lambda name: None)


def test_k2_battery_entry_packs_one_table_a_32_columns(monkeypatch):
    """The battery entry's table: the row mask, n, the columns, one session,
    the blocks, no workspace for one-block groups; per column its keys,
    filter (0 for none), presence, previous registers (0 for none), its
    output row and its phase. 33 columns take two launches."""
    fake = _FakeLaunch(6 + 6 * K2.MAX_COLUMNS)
    _fake_card(monkeypatch, K2, fake)
    n = 4000
    rows = torch.zeros(n, dtype=torch.bool)
    columns = [HllColumn(torch.zeros(n + 1, dtype=torch.uint16)[c % 2:c % 2 + n],
                         torch.zeros(n, dtype=torch.bool),
                         torch.zeros(n, dtype=torch.bool) if c % 3 == 0 else None,
                         torch.zeros(512, dtype=torch.int32) if c % 2 else None)
               for c in range(33)]
    out = K2.hll_registers_columns(columns, rows)
    assert out.shape == (33, 512) and len(fake.tables) == 2
    for launch, table in enumerate(fake.tables):
        part = columns[32 * launch:32 * launch + 32]
        assert list(table[:6]) == [rows.data_ptr(), n, len(part), 1, 1, 0]
        for c, col in enumerate(part):
            words = table[6 + 6 * c:12 + 6 * c]
            masks = [rows.data_ptr(), col.present.data_ptr()] + (
                [] if col.where is None else [col.where.data_ptr()])
            assert list(words) == [
                col.keys.data_ptr(), 0 if col.where is None else col.where.data_ptr(),
                col.present.data_ptr(), 0 if col.prev is None else col.prev.data_ptr(),
                out[32 * launch + c].data_ptr(), K2.row_phase(col.keys.data_ptr(), masks)]


def test_k2_a_group_of_several_blocks_gets_the_streams_zeroed_workspace(monkeypatch):
    fake = _FakeLaunch(12)
    _fake_card(monkeypatch, K2, fake)
    n = 1 << 20
    keys = torch.zeros((16, n // 16), dtype=torch.uint16)
    mask = torch.zeros((16, n // 16), dtype=torch.bool)
    K2.hll_registers_stacked(keys, mask, None, mask)
    table = fake.tables[0]
    assert list(table[1:5]) == [n // 16, 1, 16, K2.blocks_per_group(n // 16, 16, H100_SMS)]
    (ws,) = kernels._WORKSPACES.values()
    assert table[5] == ws.data_ptr() and not ws.any()
    assert ws.numel() >= 16 * (K2.SPREAD * K2.REGISTERS + 1)


def test_k2_a_failed_launch_raises(monkeypatch):
    _fake_card(monkeypatch, K2, _FakeLaunch(12, status=700))
    keys = torch.zeros(10, dtype=torch.uint16)
    mask = torch.zeros(10, dtype=torch.bool)
    with pytest.raises(RuntimeError, match="cudaError 700"):
        K2.hll_registers(keys, mask, None, mask)


# ---------------------------------------------------------------------------
# K6
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n,want", [(0, 1), (1, 1), (1024, 1), (1025, 2), (1 << 20, 1024),
                                    (25_000_000, K6.BLOCKS_PER_SM * H100_SMS)])
def test_k6_blocks_for(n, want):
    """One tile a thread, up to one wave of eight blocks an SM."""
    assert K6.blocks_for(n, H100_SMS) == want


def test_k6_tile_head_aligns_every_input():
    rng = np.random.default_rng(0)
    sizes = (1, 2, 4, 8)
    for _ in range(2000):
        arrays = [(int(rng.integers(0, 1 << 20)) * s, s) for s in rng.choice(sizes, 4)]
        head = K6.tile_head(arrays)
        aligned = [all((a + s * h) % min(K6.TILE * s, 16) == 0 for a, s in arrays)
                   for h in range(K6.TILE)]
        if head < 0:
            assert not any(aligned)
        else:
            assert aligned[head] and not any(aligned[:head])
            # tiles keep the alignment
            assert all((a + s * (head + K6.TILE)) % min(K6.TILE * s, 16) == 0 for a, s in arrays)


def test_k6_tile_head_of_views_one_element_in():
    base = [torch.zeros(64, dtype=d) for d in (torch.bool, torch.int8, torch.int16, torch.int32,
                                               torch.int64, torch.float64)]
    views = [(t[1:].data_ptr(), t.element_size()) for t in base]
    assert K6.tile_head(views) == K6.TILE - 1
    assert K6.tile_head([(t.data_ptr(), t.element_size()) for t in base]) == 0
    # an int64 column one element off its mask shares no aligned row with it
    assert K6.tile_head([(base[0].data_ptr(), 1), (base[4][1:].data_ptr(), 8)]) == -1


def test_k6_layout_is_checked_once_and_a_bad_layout_every_time():
    K6.column_layout.cache_clear()
    layout = ((KIND_NUM, torch.int64), (KIND_HASH, torch.int64), (KIND_NUM, torch.int8))
    assert K6.column_layout(layout) == ((KIND_NUM, 4, 8), (KIND_HASH, 4, 8), (KIND_NUM, 0, 1))
    K6.column_layout(layout)
    info = K6.column_layout.cache_info()
    assert (info.hits, info.misses, info.currsize) == (1, 1, 1)
    for bad, error in ((((KIND_NUM, torch.float32),), TypeError),
                       (((KIND_HASH, torch.int32),), TypeError),
                       (((7, torch.int64),), ValueError),
                       (((KIND_NUM, torch.int64),) * 9, ValueError), ((), ValueError)):
        for _ in range(2):
            with pytest.raises(error):
                K6.column_layout(bad)
    assert K6.column_layout.cache_info().currsize == 1


def _key_columns(n: int):
    rng = np.random.default_rng(1)
    return [KeyColumn(KIND_NUM, torch.from_numpy(rng.integers(-9, 9, n)),
                      torch.from_numpy(rng.random(n) < 0.9)),
            KeyColumn(KIND_HASH, torch.from_numpy(rng.integers(-(2**62), 2**62, n)),
                      torch.from_numpy(rng.random(n) < 0.9))], torch.ones(n, dtype=torch.bool)


def test_k6_malformed_calls_raise_every_time():
    n = 50
    columns, rows = _key_columns(n)
    out = torch.zeros(n, dtype=torch.int64)
    bad = [
        ([KeyColumn(KIND_NUM, columns[0].values.float(), columns[0].mask)], rows, out, 0,
         TypeError),
        ([KeyColumn(KIND_HASH, columns[1].values.int(), columns[1].mask)], rows, out, 0,
         TypeError),
        ([KeyColumn(3, columns[0].values, columns[0].mask)], rows, out, 0, ValueError),
        (columns * 5, rows, out, 0, ValueError),
        ([], rows, out, 0, ValueError),
        ([KeyColumn(KIND_NUM, columns[0].values[:-1], columns[0].mask)], rows, out, 0,
         ValueError),
        ([KeyColumn(KIND_NUM, columns[0].values, columns[0].mask.int())], rows, out, 0,
         TypeError),
        (columns, rows[None], out, 0, ValueError),
        (columns, rows, out, 1, ValueError),
        (columns, rows, out.int(), 0, ValueError),
        ([KeyColumn(KIND_NUM, columns[0].values[::2].repeat(2), columns[0].mask)], rows,
         out[::1], 0, None),
    ]
    for cols, r, o, offset, error in bad:
        for _ in range(2):
            if error is None:
                K6.freq_keys(cols, r, o, offset)
                continue
            with pytest.raises(error):
                K6.freq_keys(cols, r, o, offset)


def test_k6_packs_its_table(monkeypatch):
    """The table as the kernel reads it: the row mask, the keys at the
    offset, the counters, the stream's workspace, n, the columns, the
    first tile's row, the 16-byte store flag, the blocks; per column its
    kind, dtype code, values and mask. No memset: the counters come back
    from ``torch.empty``."""
    fake = _FakeLaunch(9 + 4 * K6.MAX_COLUMNS)
    _fake_card(monkeypatch, K6, fake)
    n = 5000
    columns, rows = _key_columns(n)
    out = torch.zeros(n + 9, dtype=torch.int64)
    for offset in (0, 7):
        counts = K6.freq_keys(columns, rows, out, offset)
        assert counts.shape == (2,) and counts.dtype == torch.int64
        table = fake.tables[-1]
        (ws,) = kernels._WORKSPACES.values()
        out_ptr = out.data_ptr() + 8 * offset
        arrays = [(rows.data_ptr(), 1)] + [(a.data_ptr(), a.element_size()) for c in columns
                                           for a in (c.values, c.mask)]
        head = K6.tile_head(arrays)
        assert head == 0
        assert list(table[:9]) == [rows.data_ptr(), out_ptr, counts.data_ptr(), ws.data_ptr(),
                                   n, 2, head, int(out_ptr % 16 == 0),
                                   K6.blocks_for(n, H100_SMS)]
        assert list(table[9:17]) == [KIND_NUM, 4, columns[0].values.data_ptr(),
                                     columns[0].mask.data_ptr(), KIND_HASH, 4,
                                     columns[1].values.data_ptr(), columns[1].mask.data_ptr()]
    assert ws.numel() == 2 and not ws.any()


def test_k6_a_failed_launch_raises(monkeypatch):
    _fake_card(monkeypatch, K6, _FakeLaunch(9, status=700))
    columns, rows = _key_columns(10)
    with pytest.raises(RuntimeError, match="cudaError 700"):
        K6.freq_keys(columns, rows, torch.zeros(10, dtype=torch.int64), 0)
