"""K2 ``hll_registers``: HLL++ register maxima of one batch.

Replaces ``ApproxCountDistinct.update`` of the JAX reference
(deequ_tpu/analyzers/sketches.py:277, over ``chunked_key_fold``,
deequ_tpu/ops/__init__.py:9). The CUDA source is ``csrc/hll_registers.cu``;
each entry has its function in plain PyTorch beside it.

- :func:`hll_registers_columns` folds one batch into every HLL column of a
  battery in one launch, each column's previous registers folded in: the
  reference's jitted fused update holds every HLL update of a battery
  (deequ_tpu/runners/engine.py:366). ``BundledScanProgram`` and
  ``ApproxCountDistinct.update`` call it; it counts under
  :data:`NAME_COLUMNS`.
- :func:`hll_registers` is one column's registers with no previous ones.
- :func:`hll_registers_stacked` runs W sessions' batches in one launch (the
  streaming service's coalesced fold and the mesh's shards, replacing the
  HLL update inside the reference's
  ``PackedScanProgram.call_with_slots_stacked``,
  deequ_tpu/runners/engine.py:501).

The launch plan is plain Python: :func:`blocks_per_group` sizes the grid
from the rows, :func:`row_phase` and :func:`tile_split` say which rows the
kernel reads as 16-row tiles of 16-byte loads and which one by one. Groups
of several blocks meet in a per-stream workspace the kernel leaves zeroed
(:func:`~deequ_tpu_torch.kernels.stream_workspace`), so no launch needs a
zero fill.
"""

from __future__ import annotations

import ctypes
import threading
from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from . import (
    build, check_status, check_tensor, count_launch, on_cuda, sm_count, stream_handle,
    stream_workspace)

NAME = "hll_registers"
#: the stacked entry's launch-count name
NAME_STACKED = "hll_registers_stacked"
#: the battery entry's launch-count name
NAME_COLUMNS = "hll_registers_columns"
REGISTERS = 512
#: columns of one launch; equals HLL_MAX_PARTS in csrc/hll_registers.cu
MAX_COLUMNS = 32
#: threads of a block, rows of a tile and accumulator rows of a group;
#: HLL_THREADS, HLL_TILE, HLL_SPREAD
THREADS = 256
TILE = 16
SPREAD = 8
#: blocks an SM holds at once, for sizing a launch near one wave
BLOCKS_PER_SM = 8
#: the 8-byte words of the table's header and of one column
_HEAD_WORDS = 6
_PART_WORDS = 6


class HllColumn(NamedTuple):
    """One column of :func:`hll_registers_columns`: packed keys (uint16,
    ``(register << 6) | rank``), the presence mask, an optional
    where-filter and optional previous registers (int32[512])."""

    keys: torch.Tensor
    present: torch.Tensor
    where: Optional[torch.Tensor] = None
    prev: Optional[torch.Tensor] = None


class _Table(ctypes.Structure):
    # mirrors struct HllTable in csrc/hll_registers.cu: every field an
    # 8-byte word, so the table fills as one int64 array
    _fields_ = [("words", ctypes.c_int64 * (_HEAD_WORDS + _PART_WORDS * MAX_COLUMNS))]


class _TableBuffer(threading.local):
    """One reused table a thread fills for its launches (a launch copies
    the table into its parameters)."""

    def __init__(self):
        self.table = _Table()
        self.words = np.frombuffer(self.table, np.int64)


_TABLES = _TableBuffer()


def blocks_per_group(n: int, groups: int, sms: int) -> int:
    """Blocks of each of a launch's ``groups`` (columns x sessions) for
    ``n`` rows a group: about one tile a thread, and together at most
    :data:`BLOCKS_PER_SM` blocks an SM on ``sms`` SMs (at least one a
    group). A group of one block needs no workspace."""
    want = -(-n // (THREADS * TILE))
    cap = max(1, (BLOCKS_PER_SM * sms) // max(groups, 1))
    return max(1, min(want, cap))


def row_phase(keys_ptr: int, mask_ptrs: Sequence[int]) -> int:
    """The element phase (0..15) at row 0 shared by a column's arrays (the
    uint16 keys and the byte masks), or -1 when they share none: the
    kernel's 16-row tiles start where every array is 16-byte aligned,
    which a row can be only if each mask's address is the same modulo 16
    and the keys' address (in elements) agrees with it modulo 8."""
    phases = {p % 16 for p in mask_ptrs}
    if len(phases) != 1 or keys_ptr % 2:
        return -1
    phase = phases.pop()
    return phase if (keys_ptr // 2) % 8 == phase % 8 else -1


def tile_split(n: int, phase: int, offset: int = 0) -> Tuple[int, int, int]:
    """``(head, tiles, tail)``: the rows the kernel reads one by one before
    its first tile, its 16-row tiles, and the rows after them, for a
    session of ``n`` rows starting ``offset`` rows into arrays of element
    ``phase`` (:func:`row_phase`; -1 reads every row one by one). The same
    arithmetic as the kernel's."""
    if phase < 0:
        return n, 0, 0
    head = min(n, (TILE - (phase + offset) % TILE) % TILE)
    tiles = (n - head) // TILE
    return head, tiles, n - head - tiles * TILE


def _lib() -> ctypes.CDLL:
    lib = build.load(NAME)
    if not getattr(lib, "_deequ_bound", False):
        for fn in ("hll_registers_max_parts", "hll_registers_table_bytes",
                   "hll_registers_threads", "hll_registers_tile", "hll_registers_spread"):
            getattr(lib, fn).restype = ctypes.c_int
            getattr(lib, fn).argtypes = []
        lib.hll_registers_launch.restype = ctypes.c_int
        lib.hll_registers_launch.argtypes = [ctypes.POINTER(_Table), ctypes.c_void_p]
        if (lib.hll_registers_max_parts() != MAX_COLUMNS
                or lib.hll_registers_table_bytes() != ctypes.sizeof(_Table)
                or lib.hll_registers_threads() != THREADS
                or lib.hll_registers_tile() != TILE or lib.hll_registers_spread() != SPREAD):
            raise build.KernelLaunchError(
                "hll_registers library and wrapper disagree on the table")
        lib._deequ_bound = True
    return lib


def _launch(parts, rows: torch.Tensor, n: int, sessions: int, name: str) -> None:
    """One launch over ``parts``, each ``(keys, where, present, prev,
    out)`` tensors on ``rows``' device (``where`` and ``prev`` may be
    None), every array ``[sessions, n]``."""
    lib = _lib()
    device = rows.device
    stream = stream_handle(device)
    groups = len(parts) * sessions
    blocks = blocks_per_group(n, groups, sm_count(device))
    # a group of several blocks meets in SPREAD accumulator rows and a ticket
    ws = stream_workspace(NAME, device, stream, max(groups, 16) * (SPREAD * REGISTERS + 1),
                          torch.int32) if blocks > 1 else None
    rows_ptr = rows.data_ptr()
    words = [rows_ptr, n, len(parts), sessions, blocks, 0 if ws is None else ws.data_ptr()]
    for keys, where, present, prev, out in parts:
        k, p = keys.data_ptr(), present.data_ptr()
        w = 0 if where is None else where.data_ptr()
        masks = (rows_ptr, p) if where is None else (rows_ptr, p, w)
        words += [k, w, p, 0 if prev is None else prev.data_ptr(), out.data_ptr(),
                  row_phase(k, masks)]
    buf = _TABLES
    buf.words[:len(words)] = words
    check_status(name, lib.hll_registers_launch(ctypes.byref(buf.table), stream))


def _check(t, name: str, what: str, dtype: torch.dtype, shape, like: torch.Tensor) -> None:
    """:func:`check_tensor` against ``like``'s device, its message built
    only for a bad tensor (``get_device()`` is -1 on the CPU and the card's
    index on a card)."""
    if not (t.dtype == dtype and t.shape == shape and t.get_device() == like.get_device()
            and t.is_contiguous()):
        check_tensor(t, name, what, dtype, tuple(shape), like.device)


def _validate(keys, rows, where, present, name: str) -> None:
    shape = keys.shape
    _check(keys, name, "keys", torch.uint16, shape, keys)
    _check(rows, name, "rows", torch.bool, shape, keys)
    _check(present, name, "present", torch.bool, shape, keys)
    if where is not None:
        _check(where, name, "where", torch.bool, shape, keys)


def hll_registers(
    keys: torch.Tensor,
    rows: torch.Tensor,
    where: Optional[torch.Tensor],
    present: torch.Tensor,
) -> torch.Tensor:
    """int32[512] registers of the batch: for each register, the largest
    rank among valid rows (``rows & where & present``) whose packed key
    ``(register << 6) | rank`` names it; 0 where no valid row does."""
    if keys.dim() != 1:
        raise ValueError(f"{NAME}: keys must have one dimension, got {tuple(keys.shape)}")
    _validate(keys, rows, where, present, NAME)
    if not on_cuda(keys, NAME):
        return hll_registers_plain(keys, rows, where, present)
    out = torch.empty(REGISTERS, dtype=torch.int32, device=keys.device)
    _launch([(keys, where, present, None, out)], rows, keys.shape[0], 1, NAME)
    count_launch(NAME)
    return out


def hll_registers_stacked(
    keys: torch.Tensor,
    rows: torch.Tensor,
    where: Optional[torch.Tensor],
    present: torch.Tensor,
) -> torch.Tensor:
    """int32[W, 512]: :func:`hll_registers` of each of W sessions' batches
    in one launch (every input ``[W, n]``, session w in row w). Max is
    exact and order-free, so row w equals the one-batch registers bit for
    bit."""
    if keys.dim() != 2 or keys.shape[0] < 1:
        raise ValueError(f"{NAME_STACKED}: keys must be [W, n], got {tuple(keys.shape)}")
    _validate(keys, rows, where, present, NAME_STACKED)
    if not on_cuda(keys, NAME_STACKED):
        return hll_registers_stacked_plain(keys, rows, where, present)
    width, n = keys.shape
    if width > 65535:
        raise ValueError(f"{NAME_STACKED}: takes at most 65,535 sessions, got {width}")
    out = torch.empty((width, REGISTERS), dtype=torch.int32, device=keys.device)
    _launch([(keys, where, present, None, out)], rows, n, width, NAME_STACKED)
    count_launch(NAME_STACKED)
    return out


def _validate_columns(columns: Sequence[HllColumn], rows: torch.Tensor) -> None:
    if not columns:
        raise ValueError(f"{NAME_COLUMNS}: takes at least one column")
    if rows.dim() != 1:
        raise ValueError(f"{NAME_COLUMNS}: rows must have one dimension, got "
                         f"{tuple(rows.shape)}")
    shape = rows.shape
    _check(rows, NAME_COLUMNS, "rows", torch.bool, shape, rows)
    for c, col in enumerate(columns):
        _check(col.keys, NAME_COLUMNS, f"column {c} keys", torch.uint16, shape, rows)
        _check(col.present, NAME_COLUMNS, f"column {c} present", torch.bool, shape, rows)
        if col.where is not None:
            _check(col.where, NAME_COLUMNS, f"column {c} where", torch.bool, shape, rows)
        if col.prev is not None:
            _check(col.prev, NAME_COLUMNS, f"column {c} prev", torch.int32, (REGISTERS,), rows)


def hll_registers_columns(columns: Sequence[HllColumn], rows: torch.Tensor) -> torch.Tensor:
    """int32[C, 512]: row c is column c's registers after the batch,
    ``max(prev, the batch's registers)`` (the batch's alone where ``prev``
    is None), for every column of a battery in one launch (one per
    :data:`MAX_COLUMNS` columns). ``rows`` is the batch's row mask, shared
    by the columns. Nothing is written in place: the rows are views of one
    new tensor."""
    _validate_columns(columns, rows)
    if not on_cuda(rows, NAME_COLUMNS):
        return hll_registers_columns_plain(columns, rows)
    out = torch.empty((len(columns), REGISTERS), dtype=torch.int32, device=rows.device)
    for start in range(0, len(columns), MAX_COLUMNS):
        part = columns[start:start + MAX_COLUMNS]
        _launch([(c.keys, c.where, c.present, c.prev, out[start + i])
                 for i, c in enumerate(part)], rows, rows.shape[0], 1, NAME_COLUMNS)
        count_launch(NAME_COLUMNS)
    return out


def hll_registers_plain(
    keys: torch.Tensor,
    rows: torch.Tensor,
    where: Optional[torch.Tensor],
    present: torch.Tensor,
) -> torch.Tensor:
    """The same function as the kernel in plain PyTorch: the stacked plain
    version over one session."""
    return hll_registers_stacked_plain(
        keys[None], rows[None], None if where is None else where[None], present[None])[0]


def hll_registers_stacked_plain(
    keys: torch.Tensor,
    rows: torch.Tensor,
    where: Optional[torch.Tensor],
    present: torch.Tensor,
) -> torch.Tensor:
    """The stacked kernel's function in plain PyTorch: one scatter max
    along the register axis for all W sessions. PyTorch on the CPU has no
    ``>>`` for uint16, so keys widen to int32."""
    valid = rows & present
    if where is not None:
        valid = valid & where
    k = torch.where(valid, keys.to(torch.int32), 0)
    out = torch.zeros((keys.shape[0], REGISTERS), dtype=torch.int32, device=keys.device)
    return out.scatter_reduce_(1, (k >> 6).to(torch.int64), k & 63, "amax")


def hll_registers_columns_plain(columns: Sequence[HllColumn],
                                rows: torch.Tensor) -> torch.Tensor:
    """The battery entry's function in plain PyTorch: each column's batch
    registers (:func:`hll_registers_plain`), then the max with its
    previous registers."""
    out = torch.stack([hll_registers_plain(c.keys, rows, c.where, c.present) for c in columns])
    for c, col in enumerate(columns):
        if col.prev is not None:
            out[c] = torch.maximum(out[c], col.prev)
    return out
