"""K6 ``freq_keys``: the 64-bit group key of every row of one batch.

Replaces ``DeviceFrequencyTableScan.update`` of the JAX reference
(deequ_tpu/analyzers/grouping.py:911, with ``splitmix64_jnp`` and
``xxhash64_u64_jnp`` of deequ_tpu/ops/hashing.py:150,182 and the append of
``FrequencyTableState.append_keys``, deequ_tpu/analyzers/states.py:139).
The CUDA source is ``csrc/freq_keys.cu``; :func:`freq_keys_plain` is the
same function in plain PyTorch.

Keys are uint64 values held in int64 tensors (the same bits). Both
versions write the batch's keys into ``out[offset:offset + n]``, the
frequency table state's key buffer, with no separate append copy.

The launch plan is plain Python: :func:`column_layout` checks each
column's kind and dtype once per layout (cached; a bad layout raises every
time and is never cached), :func:`tile_head` finds the first row at which
every input is aligned for the kernel's vector loads, and
:func:`blocks_for` sizes the grid. The counters meet in a per-stream
workspace (two ticket words the counts ride in) that the kernel leaves
zeroed, so no launch needs a memset.
"""

from __future__ import annotations

import ctypes
import functools
import threading
from typing import NamedTuple, Sequence, Tuple

import numpy as np
import torch

from ..ops.hashing import FREQ_KEY_SENTINEL_I64, splitmix64_torch, xxhash64_u64_torch
from . import (
    build, check_status, check_tensor, count_launch, on_cuda, sm_count, stream_handle,
    stream_workspace)

NAME = "freq_keys"
#: SplitMix64 of an integral or boolean value, or a uint64 hash taken as is
KIND_NUM = 0
KIND_HASH = 1
#: columns per launch; equals FK_MAX_COLS in csrc/freq_keys.cu
MAX_COLUMNS = 8
#: threads of a block, rows of a thread's tile and blocks of a launch at
#: most; FK_THREADS, FK_TILE, FK_MAX_BLOCKS
THREADS = 128
TILE = 8
MAX_BLOCKS = 4096
#: blocks an SM holds at once (the kernel's launch bounds), for sizing a
#: launch to one wave; FK_BLOCKS_PER_SM
BLOCKS_PER_SM = 8

#: value dtypes the kernel reads, by its dtype codes (FK_I8 .. FK_F64)
_DTYPE_CODES = {
    torch.int8: 0, torch.uint8: 1, torch.int16: 2, torch.int32: 3,
    torch.int64: 4, torch.float64: 5,
}
#: the 8-byte words of the table's header and of one column
_HEAD_WORDS = 9
_COLUMN_WORDS = 4


class KeyColumn(NamedTuple):
    """One column of a group key: ``values`` are integers of at most 64
    bits or float64 0/1 (booleans) for :data:`KIND_NUM`, the int64 bits of
    the host's xxhash64 for :data:`KIND_HASH`; ``mask`` marks present rows."""

    kind: int
    values: torch.Tensor
    mask: torch.Tensor


class _Table(ctypes.Structure):
    # mirrors struct FkTable in csrc/freq_keys.cu: every field an 8-byte
    # word, so the table fills as one int64 array
    _fields_ = [("words", ctypes.c_int64 * (_HEAD_WORDS + _COLUMN_WORDS * MAX_COLUMNS))]


class _TableBuffer(threading.local):
    """One reused table a thread refills for its launches (a launch copies
    the table into its parameters)."""

    def __init__(self):
        self.table = _Table()
        self.words = np.frombuffer(self.table, np.int64)


_TABLES = _TableBuffer()


@functools.lru_cache(maxsize=256)
def column_layout(layout: Tuple[Tuple[int, torch.dtype], ...]) -> Tuple[Tuple[int, int, int], ...]:
    """Per column ``(kind, dtype code, element size)`` for a layout of
    ``(kind, values dtype)`` pairs; raises for a layout the kernel does
    not take (lru_cache keeps no exception, so such a call raises every
    time)."""
    if not layout or len(layout) > MAX_COLUMNS:
        raise ValueError(f"{NAME}: takes 1 to {MAX_COLUMNS} columns, got {len(layout)}")
    out = []
    for i, (kind, dtype) in enumerate(layout):
        if kind == KIND_HASH:
            if dtype != torch.int64:
                raise TypeError(f"{NAME}: column {i} hashes must be torch.int64, got {dtype}")
        elif kind == KIND_NUM:
            if dtype not in _DTYPE_CODES:
                raise TypeError(f"{NAME}: column {i} values of {dtype} are not taken")
        else:
            raise ValueError(f"{NAME}: column {i} has unknown kind {kind}")
        out.append((kind, _DTYPE_CODES[dtype], torch.empty((), dtype=dtype).element_size()))
    return tuple(out)


def tile_head(arrays: Sequence[Tuple[int, int]]) -> int:
    """The first row (0 .. TILE - 1) at which every input, given as
    ``(address, element size)``, is aligned for the kernel's vector loads of
    a tile (``min(TILE * size, 16)`` bytes), or -1 when no row is: the
    kernel then reads every row with scalar loads. Tiles then start at
    ``head + TILE * t``, which keeps each alignment."""
    for head in range(TILE):
        if all((addr + size * head) % min(TILE * size, 16) == 0 for addr, size in arrays):
            return head
    return -1


def blocks_for(n: int, sms: int) -> int:
    """Blocks of a launch over ``n`` rows: one tile a thread, at most one
    wave (:data:`BLOCKS_PER_SM` on ``sms`` SMs; the threads then take
    several tiles each) and :data:`MAX_BLOCKS`; at least one, which writes
    the counters when n is 0."""
    want = -(-n // (THREADS * TILE))
    return max(1, min(want, BLOCKS_PER_SM * sms, MAX_BLOCKS))


def _lib() -> ctypes.CDLL:
    lib = build.load(NAME)
    if not getattr(lib, "_deequ_bound", False):
        for fn in ("freq_keys_max_columns", "freq_keys_max_blocks", "freq_keys_threads",
                   "freq_keys_tile", "freq_keys_table_bytes", "freq_keys_blocks_per_sm"):
            getattr(lib, fn).restype = ctypes.c_int
            getattr(lib, fn).argtypes = []
        lib.freq_keys_launch.restype = ctypes.c_int
        lib.freq_keys_launch.argtypes = [ctypes.POINTER(_Table), ctypes.c_void_p]
        if (lib.freq_keys_max_columns() != MAX_COLUMNS
                or lib.freq_keys_max_blocks() != MAX_BLOCKS
                or lib.freq_keys_threads() != THREADS or lib.freq_keys_tile() != TILE
                or lib.freq_keys_table_bytes() != ctypes.sizeof(_Table)
                or lib.freq_keys_blocks_per_sm() != BLOCKS_PER_SM):
            raise build.KernelLaunchError("freq_keys library and wrapper disagree on the table")
        lib._deequ_bound = True
    return lib


def _validate(columns: Sequence[KeyColumn], rows: torch.Tensor, out: torch.Tensor,
              offset: int) -> Tuple[int, Tuple[Tuple[int, int, int], ...]]:
    """Check a call; returns ``n`` and the columns' layout. The layout's
    kinds and dtypes are checked once (:func:`column_layout`), each
    tensor's shape, device and contiguity every call."""
    if not columns or len(columns) > MAX_COLUMNS:
        raise ValueError(f"{NAME}: takes 1 to {MAX_COLUMNS} columns, got {len(columns)}")
    layout = column_layout(tuple([(col.kind, col.values.dtype) for col in columns]))
    if rows.dim() != 1:
        raise ValueError(f"{NAME}: rows must have one dimension, got {tuple(rows.shape)}")
    n = rows.shape[0]
    shape, where = rows.shape, rows.get_device()
    for t, what, dtype in [(rows, "rows", torch.bool)] + [
            (t, f"column {i} {what}", t.dtype if what == "values" else torch.bool)
            for i, col in enumerate(columns) for t, what in ((col.mask, "mask"),
                                                             (col.values, "values"))]:
        # get_device() is -1 on the CPU and the card's index on a card
        if not (t.dtype == dtype and t.shape == shape and t.get_device() == where
                and t.is_contiguous()):
            check_tensor(t, NAME, what, dtype, n, rows.device)
    if out.dim() != 1 or out.dtype != torch.int64 or out.get_device() != where:
        raise ValueError(f"{NAME}: out must be a 1-D int64 tensor on {rows.device}")
    if not out.is_contiguous():
        raise ValueError(f"{NAME}: out must be contiguous")
    if offset < 0 or offset + n > out.shape[0]:
        raise ValueError(f"{NAME}: {n} keys at offset {offset} overrun {out.shape[0]} entries")
    return n, layout


def freq_keys(columns: Sequence[KeyColumn], rows: torch.Tensor, out: torch.Tensor,
              offset: int) -> torch.Tensor:
    """Write the batch's keys into ``out[offset:offset + n]`` (the sentinel
    for invalid rows and for valid rows whose key is the sentinel); returns
    int64[2]: (valid rows keyed as the sentinel, rows of the row mask). CPU
    tensors take :func:`freq_keys_plain`; CUDA tensors launch the kernel."""
    n, layout = _validate(columns, rows, out, offset)
    if not on_cuda(rows, NAME):
        return freq_keys_plain(columns, rows, out, offset)
    lib = _lib()
    device = rows.device
    stream = stream_handle(device)
    counts = torch.empty(2, dtype=torch.int64, device=device)
    out_ptr = out.data_ptr() + 8 * offset
    rows_ptr = rows.data_ptr()
    # the two ticket words the counters ride in
    ws = stream_workspace(NAME, device, stream, 2, torch.int64)
    words = [rows_ptr, out_ptr, counts.data_ptr(), ws.data_ptr(), n, len(columns), 0, 0,
             blocks_for(n, sm_count(device))]
    arrays = [(rows_ptr, 1)]
    bits = rows_ptr
    for col, (kind, code, size) in zip(columns, layout):
        values, mask = col.values.data_ptr(), col.mask.data_ptr()
        words += [kind, code, values, mask]
        arrays += [(values, size), (mask, 1)]
        bits |= values | mask
    # every input 16-byte aligned at row 0 (the usual case): the tiles start
    # there
    head = 0 if bits % 16 == 0 else tile_head(arrays)
    words[6] = head
    words[7] = int(head >= 0 and (out_ptr + 8 * head) % 16 == 0)
    buf = _TABLES
    buf.words[:len(words)] = words
    check_status(NAME, lib.freq_keys_launch(ctypes.byref(buf.table), stream))
    count_launch(NAME)
    return counts


def freq_keys_plain(columns: Sequence[KeyColumn], rows: torch.Tensor, out: torch.Tensor,
                    offset: int) -> torch.Tensor:
    """The same function as the kernel in plain PyTorch, on int64 bit
    patterns (``ops/hashing.py``)."""
    valid = rows.clone()
    for col in columns:
        valid &= col.mask
    key = None
    for col in columns:
        if col.kind == KIND_NUM:
            # signed integers sign-extend, float64 0/1 converts by value
            ck = splitmix64_torch(col.values.to(torch.int64))
        else:
            ck = col.values
        key = ck if key is None else xxhash64_u64_torch(ck, key)
    is_sent = valid & (key == FREQ_KEY_SENTINEL_I64)
    out[offset:offset + rows.shape[0]] = torch.where(
        valid & ~is_sent, key, torch.full_like(key, FREQ_KEY_SENTINEL_I64)
    )
    return torch.stack([is_sent.sum(dtype=torch.int64), rows.sum(dtype=torch.int64)])
