"""K1 ``scan_reduce``: all scalar reductions of one batch in one launch.

Replaces the fused per-batch update of the JAX reference
(``PackedScanProgram.fused_update``, deequ_tpu/runners/engine.py:366, over
the ``update`` functions of deequ_tpu/analyzers/simple.py, DataType's
``:779`` included). The CUDA source is ``csrc/scan_reduce.cu``;
:func:`scan_reduce_plain` is the same function in plain PyTorch.

A :class:`Slot` describes one reduction: the rows counted are ``rows &
where``, the rows selected are those & ``sel``, and a moments slot also
reduces ``vals`` over the selected rows. A class-count slot counts the
counted rows by their int32 code in ``vals`` (the five type classes of
DataType). A co-moment slot reads two float value arrays, ``vals`` and
``vals2``, over the rows ``rows & where & sel & sel2`` (both columns
present) and gives Correlation's batch state: n, the two means and the
centred co-moments (deequ_tpu/analyzers/simple.py:661). Analyzers that need
the same reduction (Mean, Sum, Minimum, Maximum and StandardDeviation of one
column under one filter) share one slot.

:func:`scan_reduce_stacked` is the same reduction over W sessions' batches
in one launch (the streaming service's coalesced fold; it replaces the
reference's ``PackedScanProgram.call_with_slots_stacked``,
deequ_tpu/runners/engine.py:501): every array is ``[W, n]`` and session
w's outputs equal a one-batch launch over its batch bit for bit.

The wrapper hands the kernel the slot table's distinct arrays
(:func:`stage_plan`: a mask or column several slots share is read once)
and the rows of a block's chunk (:func:`chunk_rows`: from the batch's
rows and the table's bytes a row, never from the number of sessions).

A launch's accumulator type is that of its float value arrays (all of
one type), else the process's ``config.ACC_DTYPE`` (:func:`acc_dtype`):
float64 values give float64 outputs and int64 counts
(``scan_reduce_launch``), float32 values (the reference's 32-bit
accumulator mode, ``DEEQU_TPU_NO_X64``) float32 outputs and int32 counts
(``scan_reduce_launch_f32``, counted under ``scan_reduce_f32`` and
``scan_reduce_stacked_f32``). The plain versions take the same types.
"""

from __future__ import annotations

import ctypes
import functools
import math
import threading
from dataclasses import dataclass
from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from ..ops.order import masked_max, masked_min
from . import (build, check_status, check_tensor, count_launch, entry_name, on_cuda,
               stream_handle)

NAME = "scan_reduce"
#: the stacked entry's launch-count name
NAME_STACKED = "scan_reduce_stacked"
KIND_COUNTS = 0
KIND_MOMENTS = 1
KIND_CLASSES = 2
KIND_COMOMENTS = 3
#: slots per launch; equals SR_MAX_SLOTS in csrc/scan_reduce.cu
MAX_SLOTS = 64
#: classes of a class-count slot; equals SR_CLASSES
NUM_CLASSES = 5
#: columns of the count output: matches, count, then the class counts
I_MATCHES, I_COUNT, I_CLASS0 = 0, 1, 2
I_WIDTH = I_CLASS0 + NUM_CLASSES
#: columns of the float output
F_SUM, F_MIN, F_MAX, F_MEAN, F_M2 = 0, 1, 2, 3, 4
#: the same five columns of a co-moment slot: the two means and the
#: co-moments about them (its n is the matches column)
F_XAVG, F_YAVG, F_CK, F_XMK, F_YMK = 0, 1, 2, 3, 4


@dataclass(frozen=True)
class Slot:
    kind: int
    where: Optional[torch.Tensor] = None  # bool[n] where-filter
    sel: Optional[torch.Tensor] = None    # bool[n] presence / predicate
    vals: Optional[torch.Tensor] = None   # float[n] or int32[n] (lengths, codes)
    vals2: Optional[torch.Tensor] = None  # float[n]: a co-moment slot's second column
    sel2: Optional[torch.Tensor] = None   # bool[n]: the second column's presence


class Partials(NamedTuple):
    """One slot's batch partials: 0-d views into the launch's outputs (the
    counts int64 and the rest float64, or int32 and float32 for a float32
    launch)."""

    matches: torch.Tensor  # rows & where & sel
    count: torch.Tensor    # rows & where
    total: torch.Tensor    # sum of selected values
    min: torch.Tensor      # NaN-largest order (NaN if none)
    max: torch.Tensor      # NaN propagates (-inf if none)
    mean: torch.Tensor     # batch mean (0 if none)
    m2: torch.Tensor       # sum of squares about the batch mean
    classes: torch.Tensor  # [5]: counted rows by class code (0 unless class slot)


def partials(out_i: torch.Tensor, out_f: torch.Tensor, slot: int) -> Partials:
    """A slot's partials from a launch's outputs: ``[S, 7]`` and ``[S, 5]``,
    or a stacked launch's ``[W, S, 7]`` and ``[W, S, 5]``, whose partials
    then carry the session axis in front."""
    return Partials(
        out_i[..., slot, I_MATCHES], out_i[..., slot, I_COUNT], out_f[..., slot, F_SUM],
        out_f[..., slot, F_MIN], out_f[..., slot, F_MAX], out_f[..., slot, F_MEAN],
        out_f[..., slot, F_M2], out_i[..., slot, I_CLASS0:I_WIDTH],
    )


def comoments(p: Partials) -> Tuple[torch.Tensor, ...]:
    """A co-moment slot's batch state (n, x_avg, y_avg, ck, x_mk, y_mk),
    n in the partials' float type, read from its :class:`Partials`."""
    return (p.matches.to(p.total.dtype), p.total, p.min, p.max, p.mean, p.m2)


#: distinct arrays a launch stages (the row mask and five a slot); equals
#: SR_MAX_ARRAYS in csrc/scan_reduce.cu
MAX_ARRAYS = 1 + 5 * MAX_SLOTS
#: rows of a block's chunk, largest first: the kernel's instances
CHUNK_ROWS = (512, 256, 128)
#: shared memory a block's staged chunk may take before a smaller chunk is
#: chosen (six or seven blocks an SM at the largest)
STAGE_BYTES = 32 * 1024
#: a batch with the rows for it spreads over at least this many chunks
MIN_CHUNKS = 8
#: int32 and float columns of a chunk partial; equals SR_PWIDTH
PARTIAL_WIDTH = 7
#: a slot's absent array; equals SR_NONE
NONE = 0xFFFF


class StagePlan(NamedTuple):
    """A slot table as the kernel reads it: the table's distinct arrays
    (the row mask first, then each array where a slot first names it, in
    slot order and ``where, sel, vals, vals2, sel2`` order within a slot),
    and per slot ``(kind, vals_i32, where, sel, vals, vals2, sel2)`` with
    each array as its index in that list (:data:`NONE`: absent)."""

    arrays: Tuple[torch.Tensor, ...]
    slots: Tuple[Tuple[int, ...], ...]
    sizes: Tuple[int, ...]  # each array's bytes a row

    @property
    def row_bytes(self) -> int:
        """Bytes a row of the distinct arrays (a staged row)."""
        return sum(self.sizes)


def stage_plan(slots: Sequence[Slot], rows: torch.Tensor) -> StagePlan:
    """The distinct arrays of ``slots`` over ``rows`` and each slot's
    indices into them. Two slot arrays are one when they are the same
    memory (data pointer and dtype; the wrapper has checked that every
    array is a contiguous tensor of the rows' shape)."""
    by_object = {id(rows): 0}
    by_memory = {(rows.data_ptr(), rows.dtype): 0}
    arrays = [rows]
    table = []
    for slot in slots:
        entry = [slot.kind, 0]
        for t in (slot.where, slot.sel, slot.vals, slot.vals2, slot.sel2):
            if t is None:
                entry.append(NONE)
                continue
            i = by_object.get(id(t))
            if i is None:
                key = (t.data_ptr(), t.dtype)
                i = by_memory.get(key)
                if i is None:
                    i = by_memory[key] = len(arrays)
                    arrays.append(t)
                by_object[id(t)] = i
            entry.append(i)
        if slot.vals is not None and slot.vals.dtype == torch.int32:
            entry[1] = 1
        table.append(tuple(entry))
    return StagePlan(tuple(arrays), tuple(table), tuple(t.element_size() for t in arrays))


def chunk_rows(n: int, row_bytes: int) -> int:
    """Rows of a block's chunk for batches of ``n`` rows whose distinct
    arrays take ``row_bytes`` a row: the largest of :data:`CHUNK_ROWS`
    whose staged chunk fits :data:`STAGE_BYTES` and that still leaves
    :data:`MIN_CHUNKS` chunks to a batch of ``n`` rows (the smallest
    chunk else). It depends on the batch and the table, never on the
    number of sessions of a stacked launch: each session is cut and folded
    as a launch over it alone."""
    for chunk in CHUNK_ROWS:
        if chunk * row_bytes <= STAGE_BYTES and MIN_CHUNKS * chunk <= n:
            return chunk
    fits = [c for c in CHUNK_ROWS if c * row_bytes <= STAGE_BYTES]
    return fits[-1] if fits else CHUNK_ROWS[-1]


def blocks_per_session(n: int, row_bytes: int) -> int:
    """Blocks (chunks) a session of ``n`` rows spreads over."""
    return max(1, -(-n // chunk_rows(n, row_bytes)))


class _Table(ctypes.Structure):
    # mirrors struct SrTable in csrc/scan_reduce.cu; a slot is six uint16
    # words: kind | vals_i32 << 8, then the five array indices
    _fields_ = [
        ("ptr", ctypes.c_uint64 * MAX_ARRAYS),
        ("at", ctypes.c_uint16 * (MAX_ARRAYS + 1)),
        ("slot", ctypes.c_uint16 * (6 * MAX_SLOTS)),
        ("n_arrays", ctypes.c_int32),
        ("n_slots", ctypes.c_int32),
    ]


class _TableBuffer(threading.local):
    """One reused table a thread fills for its launches (a launch copies
    the table into its parameters): the arrays' pointers every launch, the
    rest only when the layout differs from the last launch's."""

    def __init__(self):
        self.table = _Table()
        self.ptr = np.frombuffer(self.table, np.uint64, MAX_ARRAYS, _Table.ptr.offset)
        self.layout = None

    def fill(self, plan: StagePlan) -> None:
        self.ptr[:len(plan.arrays)] = [t.data_ptr() for t in plan.arrays]
        key = (plan.slots, plan.sizes)
        if key != self.layout:
            ctypes.memmove(ctypes.addressof(self.table) + _Table.at.offset, _packed(key),
                           ctypes.sizeof(_Table) - _Table.at.offset)
            self.layout = key


@functools.lru_cache(maxsize=256)
def _packed(layout) -> bytes:
    """The table's fields after the pointers for a layout (``(slots,
    sizes)`` of a :class:`StagePlan`), as the kernel reads them."""
    slots, sizes = layout
    table = _Table()
    at = np.frombuffer(table, np.uint16, MAX_ARRAYS + 1, _Table.at.offset)
    at[:len(sizes) + 1] = np.cumsum((0,) + sizes)
    words = np.frombuffer(table, np.uint16, 6 * MAX_SLOTS, _Table.slot.offset).reshape(-1, 6)
    entries = np.array(slots, dtype=np.uint16).reshape(-1, 7)
    words[:len(slots), 0] = entries[:, 0] | (entries[:, 1] << 8)
    words[:len(slots), 1:] = entries[:, 2:]
    table.n_arrays, table.n_slots = len(sizes), len(slots)
    return ctypes.string_at(ctypes.addressof(table) + _Table.at.offset,
                            ctypes.sizeof(_Table) - _Table.at.offset)


_TABLES = _TableBuffer()


def _lib() -> ctypes.CDLL:
    lib = build.load(NAME)
    if not getattr(lib, "_deequ_bound", False):
        for fn in ("scan_reduce_max_slots", "scan_reduce_max_arrays", "scan_reduce_int_width",
                   "scan_reduce_table_bytes", "scan_reduce_partial_width"):
            getattr(lib, fn).restype = ctypes.c_int
            getattr(lib, fn).argtypes = []
        for entry in (lib.scan_reduce_launch, lib.scan_reduce_launch_f32):
            entry.restype = ctypes.c_int
            entry.argtypes = [
                ctypes.POINTER(_Table), ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_void_p,
            ]
        if (lib.scan_reduce_max_slots() != MAX_SLOTS
                or lib.scan_reduce_max_arrays() != MAX_ARRAYS
                or lib.scan_reduce_int_width() != I_WIDTH
                or lib.scan_reduce_table_bytes() != ctypes.sizeof(_Table)
                or lib.scan_reduce_partial_width() != PARTIAL_WIDTH):
            raise build.KernelLaunchError(
                "scan_reduce library and wrapper disagree on the slot layout")
        lib._deequ_bound = True
    return lib


#: the accumulator types a launch takes, and the count type of each
COUNT_DTYPES = {torch.float64: torch.int64, torch.float32: torch.int32}


def acc_dtype(slots: Sequence[Slot]) -> torch.dtype:
    """The launch's accumulator type: that of the slots' float value
    arrays, else the process's ``config.ACC_DTYPE``. Float arrays of two
    types, or of another float type, raise ``TypeError``."""
    found = {t.dtype for slot in slots for t in (slot.vals, slot.vals2)
             if t is not None and t.dtype != torch.int32}
    if not found:
        from ..config import ACC_DTYPE

        return ACC_DTYPE
    if len(found) > 1 or not found <= set(COUNT_DTYPES):
        raise TypeError(f"{NAME}: value arrays must all be float64 or all float32, "
                        f"got {sorted(map(str, found))}")
    return found.pop()


def _validate(slots: Sequence[Slot], rows: torch.Tensor, name: str, dims: int) -> torch.dtype:
    """Check the slot table against ``rows``: ``dims`` is 1 for one batch
    (every array ``[n]``) and 2 for stacked sessions (every array
    ``[W, n]``). An array several slots share is checked once for each
    dtype it is used as. Returns the launch's accumulator type."""
    if not slots or len(slots) > MAX_SLOTS:
        raise ValueError(f"{name}: takes 1 to {MAX_SLOTS} slots, got {len(slots)}")
    if rows.dim() != dims or (dims == 2 and rows.shape[0] < 1):
        raise ValueError(f"{name}: rows must have {dims} dimension(s), got {tuple(rows.shape)}")
    shape = rows.shape
    device = rows.device
    checked = set()

    def check(t: torch.Tensor, what: str, dtype: torch.dtype) -> None:
        key = (id(t), dtype)
        if key in checked:
            return
        if not (t.dtype == dtype and t.shape == shape and t.device == device
                and t.is_contiguous()):
            check_tensor(t, name, what, dtype, tuple(shape), device)
        checked.add(key)

    fdtype = acc_dtype(slots)
    check(rows, "rows", torch.bool)
    for i, slot in enumerate(slots):
        kind = slot.kind
        if kind not in (KIND_COUNTS, KIND_MOMENTS, KIND_CLASSES, KIND_COMOMENTS):
            raise ValueError(f"{name}: slot {i} has unknown kind {kind}")
        if (slot.vals2 is not None or slot.sel2 is not None) != (kind == KIND_COMOMENTS):
            raise ValueError(f"{name}: only a co-moment slot takes vals2 and sel2 (slot {i})")
        for what in ("where", "sel", "sel2"):
            mask = getattr(slot, what)
            if mask is not None:
                check(mask, f"slot {i} {what}", torch.bool)
        if kind == KIND_MOMENTS:
            if slot.vals is None:
                raise ValueError(f"{name}: moments slot {i} has no values")
            dtype = torch.int32 if slot.vals.dtype == torch.int32 else fdtype
            check(slot.vals, f"slot {i} vals", dtype)
        elif kind == KIND_CLASSES:
            if slot.vals is None or slot.sel is not None:
                raise ValueError(f"{name}: class-count slot {i} takes codes and no selection")
            check(slot.vals, f"slot {i} codes", torch.int32)
        elif kind == KIND_COMOMENTS:
            if slot.vals is None or slot.vals2 is None:
                raise ValueError(f"{name}: co-moment slot {i} needs two value columns")
            check(slot.vals, f"slot {i} vals", fdtype)
            check(slot.vals2, f"slot {i} vals2", fdtype)
    return fdtype


def _launch(slots: Sequence[Slot], rows: torch.Tensor, width: int, n: int,
            fdtype: torch.dtype) -> Tuple[torch.Tensor, torch.Tensor]:
    """One launch over ``width`` sessions of ``n`` rows (``rows`` and every
    array ``[width, n]``, or ``[n]`` when ``width`` is 1), accumulating in
    ``fdtype``; outputs ``[width, S, 7]`` counts and ``[width, S, 5]``
    floats."""
    lib = _lib()
    plan = stage_plan(slots, rows)
    s = len(slots)
    buf = _TABLES
    buf.fill(plan)
    chunk = chunk_rows(n, plan.row_bytes)
    parts = width * s * PARTIAL_WIDTH * blocks_per_session(n, plan.row_bytes)
    # one allocation of elements of the outputs' width: the outputs
    # (counts, floats), then the partials' float and int32 columns
    wide = fdtype == torch.float64
    size = 8 if wide else 4
    out = torch.empty(width * s * (I_WIDTH + 5) + parts + ((parts + 1) // 2 if wide else parts),
                      dtype=COUNT_DTYPES[fdtype], device=rows.device)
    out_i = out[:width * s * I_WIDTH].view(width, s, I_WIDTH)
    out_f = out[width * s * I_WIDTH:width * s * (I_WIDTH + 5)].view(fdtype)
    part_f = out.data_ptr() + size * width * s * (I_WIDTH + 5)
    entry = lib.scan_reduce_launch if wide else lib.scan_reduce_launch_f32
    status = entry(
        buf.table, n, width, chunk, part_f + size * parts, part_f, out_i.data_ptr(),
        out_f.data_ptr(), stream_handle(rows.device),
    )
    check_status(NAME, status)
    return out_i, out_f.view(width, s, 5)


def scan_reduce(slots: Sequence[Slot], rows: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Reduce every slot over one batch. Returns ``(out_i, out_f)``:
    counts [S, 7] (matches, count, five class counts) and floats [S, 5]
    (sum, min, max, mean, m2; for a co-moment slot x_avg, y_avg, ck, x_mk,
    y_mk), int64 and float64 or, for float32 values, int32 and float32
    (:func:`acc_dtype`). CPU tensors take :func:`scan_reduce_plain`;
    CUDA tensors launch the kernel."""
    fdtype = _validate(slots, rows, NAME, 1)
    if not on_cuda(rows, NAME):
        return scan_reduce_plain(slots, rows)
    out_i, out_f = _launch(slots, rows, 1, rows.shape[0], fdtype)
    count_launch(entry_name(NAME, fdtype))
    return out_i[0], out_f[0]


def scan_reduce_stacked(slots: Sequence[Slot], rows: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Reduce every slot over each of W sessions' batches in one launch:
    ``rows`` and every array of the slot table are ``[W, n]``, session w's
    batch in row w. Returns counts [W, S, 7] and floats [W, S, 5] in the
    types of :func:`scan_reduce`; row w equals :func:`scan_reduce` over
    session w's batch bit for bit (the kernel cuts and folds each session
    as a launch over it alone). CPU tensors take
    :func:`scan_reduce_stacked_plain`; CUDA tensors launch the kernel."""
    fdtype = _validate(slots, rows, NAME_STACKED, 2)
    if not on_cuda(rows, NAME_STACKED):
        return scan_reduce_stacked_plain(slots, rows)
    out = _launch(slots, rows, rows.shape[0], rows.shape[1], fdtype)
    count_launch(entry_name(NAME_STACKED, fdtype))
    return out


def _one_session(slot: Slot) -> Slot:
    """A one-batch slot as a slot of one session (every array ``[1, n]``)."""
    return Slot(slot.kind, *(None if t is None else t[None]
                             for t in (slot.where, slot.sel, slot.vals, slot.vals2, slot.sel2)))


def scan_reduce_plain(slots: Sequence[Slot], rows: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The same function as the kernel in plain PyTorch: the stacked plain
    version over one session. Counts, min and max agree with the kernel bit
    for bit; sums, means and M2 agree to rounding (the two add in
    different orders)."""
    out_i, out_f = scan_reduce_stacked_plain([_one_session(slot) for slot in slots], rows[None])
    return out_i[0], out_f[0]


def scan_reduce_stacked_plain(slots: Sequence[Slot], rows: torch.Tensor
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The stacked kernel's function in plain PyTorch, one slot at a time,
    each reduced over the last axis of its ``[W, n]`` arrays for all W
    sessions at once, in the kernel's types (:func:`acc_dtype`)."""
    device = rows.device
    width = rows.shape[0]
    fdtype = acc_dtype(slots)
    idtype = COUNT_DTYPES[fdtype]
    out_i = torch.zeros((width, len(slots), I_WIDTH), dtype=idtype, device=device)
    out_f = torch.empty((width, len(slots), 5), dtype=fdtype, device=device)
    for s, slot in enumerate(slots):
        base = rows if slot.where is None else rows & slot.where
        out_i[:, s, I_COUNT] = base.sum(dim=-1, dtype=idtype)
        if slot.kind == KIND_CLASSES:
            classes = torch.arange(NUM_CLASSES, dtype=torch.int32, device=device)
            hits = (slot.vals[..., None] == classes) & base[..., None]
            out_i[:, s, I_CLASS0:I_WIDTH] = hits.sum(dim=-2, dtype=idtype)
            out_i[:, s, I_MATCHES] = out_i[:, s, I_CLASS0:I_WIDTH].sum(dim=-1, dtype=idtype)
        else:
            sel = base if slot.sel is None else base & slot.sel
            if slot.sel2 is not None:
                sel = sel & slot.sel2
            matches = sel.sum(dim=-1, dtype=idtype)
            out_i[:, s, I_MATCHES] = matches
        if slot.kind == KIND_MOMENTS:
            out_f[:, s] = _moments_plain(slot.vals, sel, matches, fdtype)
        elif slot.kind == KIND_COMOMENTS:
            out_f[:, s] = _comoments_plain(slot.vals, slot.vals2, sel, matches)
        else:
            out_f[:, s] = torch.tensor(
                [0.0, math.nan, -math.inf, 0.0, 0.0], dtype=fdtype, device=device
            )
    return out_i, out_f


def _moments_plain(vals: torch.Tensor, sel: torch.Tensor, n: torch.Tensor,
                   fdtype: torch.dtype) -> torch.Tensor:
    """(sum, min, max, mean, m2) over the last axis in ``fdtype``:
    ``[W, 5]``."""
    v = vals.to(fdtype)
    zero = torch.zeros(n.shape, dtype=fdtype, device=v.device)
    nan = torch.full(n.shape, math.nan, dtype=fdtype, device=v.device)
    if v.shape[-1] == 0:
        return torch.stack([zero, nan, -torch.full_like(zero, math.inf), zero, zero], dim=-1)
    total = torch.where(sel, v, 0.0).sum(dim=-1)
    # min: NaN skipped, NaN when nothing is left; max: NaN propagates
    nonnan = sel & ~torch.isnan(v)
    mn = torch.where(nonnan.any(dim=-1), masked_min(v, nonnan), nan)
    mx = masked_max(v, sel)
    nf = n.to(fdtype)
    mean = torch.where(n > 0, total / torch.clamp(nf, min=1.0), zero)
    centered = torch.where(sel, v - mean[..., None], 0.0)
    m2 = torch.where(n > 0, (centered * centered).sum(dim=-1), zero)
    return torch.stack([total, mn, mx, mean, m2], dim=-1)


def _comoments_plain(x: torch.Tensor, y: torch.Tensor, sel: torch.Tensor,
                     n: torch.Tensor) -> torch.Tensor:
    """(x_avg, y_avg, ck, x_mk, y_mk) of the selected rows over the last
    axis, centred on the batch's own means (the reference's
    ``Correlation.update``); all 0 when no row is selected. ``[W, 5]``."""
    zero = torch.zeros(n.shape, dtype=x.dtype, device=x.device)
    nf = n.to(x.dtype)
    safe_n = torch.where(n > 0, nf, torch.ones_like(nf))
    x_avg = torch.where(sel, x, 0.0).sum(dim=-1) / safe_n
    y_avg = torch.where(sel, y, 0.0).sum(dim=-1) / safe_n
    xc = torch.where(sel, x - x_avg[..., None], 0.0)
    yc = torch.where(sel, y - y_avg[..., None], 0.0)
    return torch.stack([
        torch.where(n > 0, x_avg, zero), torch.where(n > 0, y_avg, zero),
        (xc * yc).sum(dim=-1), (xc * xc).sum(dim=-1), (yc * yc).sum(dim=-1),
    ], dim=-1)
