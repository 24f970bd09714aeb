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
DataType). A co-moment slot reads two float64 value arrays, ``vals`` and
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
"""

from __future__ import annotations

import ctypes
import math
from dataclasses import dataclass
from typing import NamedTuple, Optional, Sequence, Tuple

import torch

from ..ops.order import masked_max, masked_min
from . import build, check_status, check_tensor, count_launch, on_cuda, stream_handle

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
#: columns of the int64 output: matches, count, then the class counts
I_MATCHES, I_COUNT, I_CLASS0 = 0, 1, 2
I_WIDTH = I_CLASS0 + NUM_CLASSES
#: columns of the float64 output
F_SUM, F_MIN, F_MAX, F_MEAN, F_M2 = 0, 1, 2, 3, 4
#: the same five columns of a co-moment slot: the two means and the
#: co-moments about them (its n is the matches column)
F_XAVG, F_YAVG, F_CK, F_XMK, F_YMK = 0, 1, 2, 3, 4


@dataclass(frozen=True)
class Slot:
    kind: int
    where: Optional[torch.Tensor] = None  # bool[n] where-filter
    sel: Optional[torch.Tensor] = None    # bool[n] presence / predicate
    vals: Optional[torch.Tensor] = None   # float64[n] or int32[n] (lengths, codes)
    vals2: Optional[torch.Tensor] = None  # float64[n]: a co-moment slot's second column
    sel2: Optional[torch.Tensor] = None   # bool[n]: the second column's presence


class Partials(NamedTuple):
    """One slot's batch partials: 0-d views into the launch's outputs."""

    matches: torch.Tensor  # int64: rows & where & sel
    count: torch.Tensor    # int64: rows & where
    total: torch.Tensor    # float64 sum of selected values
    min: torch.Tensor      # float64, NaN-largest order (NaN if none)
    max: torch.Tensor      # float64, NaN propagates (-inf if none)
    mean: torch.Tensor     # float64 batch mean (0 if none)
    m2: torch.Tensor       # float64 sum of squares about the batch mean
    classes: torch.Tensor  # int64[5]: counted rows by class code (0 unless class slot)


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
    n as float64, read from its :class:`Partials`."""
    return (p.matches.to(torch.float64), p.total, p.min, p.max, p.mean, p.m2)


class _SlotStruct(ctypes.Structure):
    # mirrors struct SrSlot in csrc/scan_reduce.cu
    _fields_ = [
        ("kind", ctypes.c_int32),
        ("vals_i32", ctypes.c_int32),
        ("vals", ctypes.c_void_p),
        ("where", ctypes.c_void_p),
        ("sel", ctypes.c_void_p),
        ("vals2", ctypes.c_void_p),
        ("sel2", ctypes.c_void_p),
    ]


def _lib() -> ctypes.CDLL:
    lib = build.load(NAME)
    if not getattr(lib, "_deequ_bound", False):
        lib.scan_reduce_max_slots.restype = ctypes.c_int
        lib.scan_reduce_max_slots.argtypes = []
        lib.scan_reduce_int_width.restype = ctypes.c_int
        lib.scan_reduce_int_width.argtypes = []
        lib.scan_reduce_num_blocks.restype = ctypes.c_int
        lib.scan_reduce_num_blocks.argtypes = [ctypes.c_longlong]
        lib.scan_reduce_stacked_launch.restype = ctypes.c_int
        lib.scan_reduce_stacked_launch.argtypes = [
            ctypes.POINTER(_SlotStruct), ctypes.c_int, ctypes.c_void_p,
            ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ]
        if lib.scan_reduce_max_slots() != MAX_SLOTS or lib.scan_reduce_int_width() != I_WIDTH:
            raise RuntimeError("scan_reduce library and wrapper disagree on the slot layout")
        lib._deequ_bound = True
    return lib


def _validate(slots: Sequence[Slot], rows: torch.Tensor, name: str, dims: int) -> None:
    """Check the slot table against ``rows``: ``dims`` is 1 for one batch
    (every array ``[n]``) and 2 for stacked sessions (every array
    ``[W, n]``)."""
    if not slots or len(slots) > MAX_SLOTS:
        raise ValueError(f"{name}: takes 1 to {MAX_SLOTS} slots, got {len(slots)}")
    if rows.dim() != dims or (dims == 2 and rows.shape[0] < 1):
        raise ValueError(f"{name}: rows must have {dims} dimension(s), got {tuple(rows.shape)}")
    shape = tuple(rows.shape)
    check_tensor(rows, name, "rows", torch.bool, shape, rows.device)
    for i, slot in enumerate(slots):
        if slot.kind not in (KIND_COUNTS, KIND_MOMENTS, KIND_CLASSES, KIND_COMOMENTS):
            raise ValueError(f"{name}: slot {i} has unknown kind {slot.kind}")
        if (slot.vals2 is not None or slot.sel2 is not None) != (slot.kind == KIND_COMOMENTS):
            raise ValueError(f"{name}: only a co-moment slot takes vals2 and sel2 (slot {i})")
        for what in ("where", "sel", "sel2"):
            mask = getattr(slot, what)
            if mask is not None:
                check_tensor(mask, name, f"slot {i} {what}", torch.bool, shape, rows.device)
        if slot.kind == KIND_MOMENTS:
            if slot.vals is None:
                raise ValueError(f"{name}: moments slot {i} has no values")
            dtype = torch.int32 if slot.vals.dtype == torch.int32 else torch.float64
            check_tensor(slot.vals, name, f"slot {i} vals", dtype, shape, rows.device)
        if slot.kind == KIND_CLASSES:
            if slot.vals is None or slot.sel is not None:
                raise ValueError(f"{name}: class-count slot {i} takes codes and no selection")
            check_tensor(slot.vals, name, f"slot {i} codes", torch.int32, shape, rows.device)
        if slot.kind == KIND_COMOMENTS:
            if slot.vals is None or slot.vals2 is None:
                raise ValueError(f"{name}: co-moment slot {i} needs two value columns")
            check_tensor(slot.vals, name, f"slot {i} vals", torch.float64, shape, rows.device)
            check_tensor(slot.vals2, name, f"slot {i} vals2", torch.float64, shape, rows.device)


def _launch(slots: Sequence[Slot], rows: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """One launch over ``rows`` ``[W, n]`` and a table of ``[W, n]``
    arrays; outputs ``[W, S, 7]`` and ``[W, S, 5]``."""
    lib = _lib()
    device = rows.device
    width, n = rows.shape
    s = len(slots)
    table = (_SlotStruct * s)(*[
        _SlotStruct(
            slot.kind,
            int(slot.vals is not None and slot.vals.dtype == torch.int32),
            None if slot.vals is None else slot.vals.data_ptr(),
            None if slot.where is None else slot.where.data_ptr(),
            None if slot.sel is None else slot.sel.data_ptr(),
            None if slot.vals2 is None else slot.vals2.data_ptr(),
            None if slot.sel2 is None else slot.sel2.data_ptr(),
        )
        for slot in slots
    ])
    blocks = lib.scan_reduce_num_blocks(n)
    part_i = torch.empty(width * blocks * s * I_WIDTH, dtype=torch.int64, device=device)
    part_f = torch.empty(width * blocks * s * 5, dtype=torch.float64, device=device)
    out_i = torch.empty((width, s, I_WIDTH), dtype=torch.int64, device=device)
    out_f = torch.empty((width, s, 5), dtype=torch.float64, device=device)
    status = lib.scan_reduce_stacked_launch(
        table, s, rows.data_ptr(), n, width, part_i.data_ptr(), part_f.data_ptr(),
        out_i.data_ptr(), out_f.data_ptr(), stream_handle(device),
    )
    check_status(NAME, status)
    return out_i, out_f


def scan_reduce(slots: Sequence[Slot], rows: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Reduce every slot over one batch. Returns ``(out_i, out_f)``:
    int64[S, 7] (matches, count, five class counts) and float64[S, 5]
    (sum, min, max, mean, m2; for a co-moment slot x_avg, y_avg, ck, x_mk,
    y_mk). CPU tensors take :func:`scan_reduce_plain`;
    CUDA tensors launch the kernel."""
    _validate(slots, rows, NAME, 1)
    if not on_cuda(rows, NAME):
        return scan_reduce_plain(slots, rows)
    out_i, out_f = _launch([_one_session(slot) for slot in slots], rows[None])
    count_launch(NAME)
    return out_i[0], out_f[0]


def scan_reduce_stacked(slots: Sequence[Slot], rows: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Reduce every slot over each of W sessions' batches in one launch:
    ``rows`` and every array of the slot table are ``[W, n]``, session w's
    batch in row w. Returns int64[W, S, 7] and float64[W, S, 5]; row w
    equals :func:`scan_reduce` over session w's batch bit for bit (the
    kernel partitions and folds each session as a launch over it alone).
    CPU tensors take :func:`scan_reduce_stacked_plain`; CUDA tensors launch
    the kernel."""
    _validate(slots, rows, NAME_STACKED, 2)
    if not on_cuda(rows, NAME_STACKED):
        return scan_reduce_stacked_plain(slots, rows)
    out = _launch(slots, rows)
    count_launch(NAME_STACKED)
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
    sessions at once."""
    device = rows.device
    width = rows.shape[0]
    out_i = torch.zeros((width, len(slots), I_WIDTH), dtype=torch.int64, device=device)
    out_f = torch.empty((width, len(slots), 5), dtype=torch.float64, device=device)
    for s, slot in enumerate(slots):
        base = rows if slot.where is None else rows & slot.where
        out_i[:, s, I_COUNT] = base.sum(dim=-1, dtype=torch.int64)
        if slot.kind == KIND_CLASSES:
            classes = torch.arange(NUM_CLASSES, dtype=torch.int32, device=device)
            hits = (slot.vals[..., None] == classes) & base[..., None]
            out_i[:, s, I_CLASS0:I_WIDTH] = hits.sum(dim=-2, dtype=torch.int64)
            out_i[:, s, I_MATCHES] = out_i[:, s, I_CLASS0:I_WIDTH].sum(dim=-1)
        else:
            sel = base if slot.sel is None else base & slot.sel
            if slot.sel2 is not None:
                sel = sel & slot.sel2
            matches = sel.sum(dim=-1, dtype=torch.int64)
            out_i[:, s, I_MATCHES] = matches
        if slot.kind == KIND_MOMENTS:
            out_f[:, s] = _moments_plain(slot.vals, sel, matches)
        elif slot.kind == KIND_COMOMENTS:
            out_f[:, s] = _comoments_plain(slot.vals, slot.vals2, sel, matches)
        else:
            out_f[:, s] = torch.tensor(
                [0.0, math.nan, -math.inf, 0.0, 0.0], dtype=torch.float64, device=device
            )
    return out_i, out_f


def _moments_plain(vals: torch.Tensor, sel: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """(sum, min, max, mean, m2) over the last axis: ``[W, 5]``."""
    v = vals.to(torch.float64)
    zero = torch.zeros(n.shape, dtype=torch.float64, device=v.device)
    nan = torch.full(n.shape, math.nan, dtype=torch.float64, device=v.device)
    if v.shape[-1] == 0:
        return torch.stack([zero, nan, -torch.full_like(zero, math.inf), zero, zero], dim=-1)
    total = torch.where(sel, v, 0.0).sum(dim=-1)
    # min: NaN skipped, NaN when nothing is left; max: NaN propagates
    nonnan = sel & ~torch.isnan(v)
    mn = torch.where(nonnan.any(dim=-1), masked_min(v, nonnan), nan)
    mx = masked_max(v, sel)
    nf = n.to(torch.float64)
    mean = torch.where(n > 0, total / torch.clamp(nf, min=1.0), zero)
    centered = torch.where(sel, v - mean[..., None], 0.0)
    m2 = torch.where(n > 0, (centered * centered).sum(dim=-1), zero)
    return torch.stack([total, mn, mx, mean, m2], dim=-1)


def _comoments_plain(x: torch.Tensor, y: torch.Tensor, sel: torch.Tensor,
                     n: torch.Tensor) -> torch.Tensor:
    """(x_avg, y_avg, ck, x_mk, y_mk) of the selected rows over the last
    axis, centred on the batch's own means (the reference's
    ``Correlation.update``); all 0 when no row is selected. ``[W, 5]``."""
    zero = torch.zeros(n.shape, dtype=torch.float64, device=x.device)
    nf = n.to(torch.float64)
    safe_n = torch.where(n > 0, nf, torch.ones_like(nf))
    x_avg = torch.where(sel, x, 0.0).sum(dim=-1) / safe_n
    y_avg = torch.where(sel, y, 0.0).sum(dim=-1) / safe_n
    xc = torch.where(sel, x - x_avg[..., None], 0.0)
    yc = torch.where(sel, y - y_avg[..., None], 0.0)
    return torch.stack([
        torch.where(n > 0, x_avg, zero), torch.where(n > 0, y_avg, zero),
        (xc * yc).sum(dim=-1), (xc * xc).sum(dim=-1), (yc * yc).sum(dim=-1),
    ], dim=-1)
