"""K8 ``state_fold``: fold N same-shape analyzer states left to right with
each state's merge, for every analyzer of a call, in one launch.

Two entry points of one CUDA kernel (``csrc/state_fold.cu``):

- :func:`state_fold` replaces ``merge_states_batched`` of the JAX reference
  (deequ_tpu/analyzers/base.py:273, a ``lax.scan`` of ``analyzer.merge``
  over stacked states): the refresh of persisted states.
- :func:`state_fold_carry` replaces the host ingest tier's fold
  (``_ingest_program`` / ``make_flagged_ingest_body``,
  deequ_tpu/runners/engine.py:1760,1787): a chunk of host partials folded
  into the device-resident carry, in place.

:func:`state_fold_plain` and :func:`state_fold_carry_plain` are the same
functions in plain PyTorch, built on the merge rules of
``analyzers/states.py`` that the states' own ``merge`` uses.

The states arrive packed per dtype into row-major matrices, one row a
state: float64 ``[N, Wf]``, int64 ``[N, Wi]`` and int32 ``[N, Wr]``. A
:class:`FoldSlot` names a merge kind and the columns it owns in its dtype's
matrix; every column belongs to exactly one slot. The result is one row of
each matrix: the fold of its N rows, starting from row 0.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import List, Sequence, Tuple

import torch

from . import build, check_status, count_launch, on_cuda, stream_handle

NAME = "state_fold"
#: the launch count of the carry entry
CARRY_NAME = "state_fold_carry"
#: slots per launch; equals SF_MAX_SLOTS in csrc/state_fold.cu
MAX_SLOTS = 256

#: merge kinds (csrc/state_fold.cu); the elementwise ones fold ``length``
#: columns, the moment kinds a fixed group of float64 columns
ADD_I64, ADD_F64, MIN, MAX, MOMENTS, COMOMENTS, MAX_I32 = range(7)
#: float64 columns of a moments / co-moments group
GROUP_WIDTH = {MOMENTS: 3, COMOMENTS: 6}
#: the matrix each kind reads: 0 float64, 1 int64, 2 int32
KIND_MATRIX = {ADD_I64: 1, ADD_F64: 0, MIN: 0, MAX: 0, MOMENTS: 0, COMOMENTS: 0, MAX_I32: 2}


@dataclass(frozen=True)
class FoldSlot:
    kind: int
    offset: int      # first column in its dtype's matrix
    length: int = 1  # columns of an elementwise slot (1 for the moment kinds)

    @property
    def width(self) -> int:
        return GROUP_WIDTH.get(self.kind, self.length)


class _SlotStruct(ctypes.Structure):
    # mirrors struct SfSlot in csrc/state_fold.cu
    _fields_ = [
        ("kind", ctypes.c_int32),
        ("offset", ctypes.c_int32),
        ("length", ctypes.c_int32),
    ]


def _lib() -> ctypes.CDLL:
    lib = build.load(NAME)
    if not getattr(lib, "_deequ_bound", False):
        lib.state_fold_max_slots.restype = ctypes.c_int
        lib.state_fold_max_slots.argtypes = []
        args = [
            ctypes.POINTER(_SlotStruct), ctypes.c_int, ctypes.c_longlong,
            ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
            ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p,
        ]
        for entry in (lib.state_fold_launch, lib.state_fold_carry_launch):
            entry.restype = ctypes.c_int
            entry.argtypes = args
        if lib.state_fold_max_slots() != MAX_SLOTS:
            raise RuntimeError("state_fold library and wrapper disagree on the slot table")
        lib._deequ_bound = True
    return lib


def _validate(f64: torch.Tensor, i64: torch.Tensor, i32: torch.Tensor,
              slots: Sequence[FoldSlot]) -> None:
    mats = (f64, i64, i32)
    for mat, dtype in zip(mats, (torch.float64, torch.int64, torch.int32)):
        if mat.dtype != dtype or mat.dim() != 2:
            raise TypeError(f"{NAME}: expected a 2-D {dtype} matrix, got {mat.dtype} "
                            f"{tuple(mat.shape)}")
        if mat.device != f64.device or not mat.is_contiguous():
            raise ValueError(f"{NAME}: the matrices must be contiguous on one device")
        if mat.shape[0] != f64.shape[0]:
            raise ValueError(f"{NAME}: the matrices hold different numbers of states")
    if f64.shape[0] < 1:
        raise ValueError(f"{NAME}: takes at least one state")
    _check_slots(mats, slots)


def _check_slots(mats: Sequence[torch.Tensor], slots: Sequence[FoldSlot]) -> None:
    """Every column of the three matrices (their last dimension) belongs
    to exactly one slot: each matrix's slots, sorted by offset, tile it."""
    if not slots:
        raise ValueError(f"{NAME}: takes at least one slot")
    spans: List[List[Tuple[int, int]]] = [[] for _ in mats]
    for slot in slots:
        if slot.kind not in KIND_MATRIX or slot.length < 1:
            raise ValueError(f"{NAME}: bad slot {slot}")
        width = mats[KIND_MATRIX[slot.kind]].shape[-1]
        if slot.offset < 0 or slot.offset + slot.width > width:
            raise ValueError(f"{NAME}: slot {slot} runs past its matrix")
        spans[KIND_MATRIX[slot.kind]].append((slot.offset, slot.offset + slot.width))
    for mat, span in zip(mats, spans):
        end = 0
        for lo, hi in sorted(span):
            if lo != end:
                raise ValueError(f"{NAME}: every column must belong to exactly one slot")
            end = hi
        if end != mat.shape[-1]:
            raise ValueError(f"{NAME}: every column must belong to exactly one slot")


def state_fold(f64: torch.Tensor, i64: torch.Tensor, i32: torch.Tensor,
               slots: Sequence[FoldSlot]) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The fold of the N packed states: float64 ``[Wf]``, int64 ``[Wi]`` and
    int32 ``[Wr]``. CPU tensors take :func:`state_fold_plain`; CUDA tensors
    launch the kernel, once per ``MAX_SLOTS`` slots."""
    _validate(f64, i64, i32, slots)
    if not on_cuda(f64, NAME):
        return state_fold_plain(f64, i64, i32, slots)
    lib = _lib()
    device = f64.device
    n = f64.shape[0]
    out_f = torch.empty(f64.shape[1], dtype=torch.float64, device=device)
    out_i = torch.empty(i64.shape[1], dtype=torch.int64, device=device)
    out_r = torch.empty(i32.shape[1], dtype=torch.int32, device=device)

    def ptr(t: torch.Tensor):
        return t.data_ptr() if t.numel() else None

    for start in range(0, len(slots), MAX_SLOTS):
        chunk = slots[start:start + MAX_SLOTS]
        table = (_SlotStruct * len(chunk))(*[_SlotStruct(s.kind, s.offset, s.length)
                                              for s in chunk])
        status = lib.state_fold_launch(
            table, len(chunk), n, ptr(f64), f64.shape[1], ptr(i64), i64.shape[1],
            ptr(i32), i32.shape[1], ptr(out_f), ptr(out_i), ptr(out_r), stream_handle(device),
        )
        check_status(NAME, status)
        count_launch(NAME)
    return out_f, out_i, out_r


def state_fold_carry(carry: Sequence[torch.Tensor], parts: Sequence[torch.Tensor],
                     slots: Sequence[FoldSlot]) -> None:
    """Fold the B partial rows ``parts`` (float64 ``[B, Wf]``, int64
    ``[B, Wi]``, int32 ``[B, Wr]``) into the packed ``carry`` (float64
    ``[Wf]``, int64 ``[Wi]``, int32 ``[Wr]``) in order, in place: the
    carry becomes the fold of [carry; parts]. CPU tensors take
    :func:`state_fold_carry_plain`; CUDA tensors launch the kernel, once
    per ``MAX_SLOTS`` slots."""
    _validate_carry(carry, parts, slots)
    if not on_cuda(carry[0], NAME):
        state_fold_carry_plain(carry, parts, slots)
        return
    lib = _lib()
    device = carry[0].device

    def ptr(t: torch.Tensor):
        return t.data_ptr() if t.numel() else None

    (cf, ci, cr), (pf, pi, pr) = carry, parts
    for start in range(0, len(slots), MAX_SLOTS):
        chunk = slots[start:start + MAX_SLOTS]
        table = (_SlotStruct * len(chunk))(*[_SlotStruct(s.kind, s.offset, s.length)
                                              for s in chunk])
        status = lib.state_fold_carry_launch(
            table, len(chunk), pf.shape[0], ptr(cf), cf.shape[0], ptr(ci), ci.shape[0],
            ptr(cr), cr.shape[0], ptr(pf), ptr(pi), ptr(pr), stream_handle(device),
        )
        check_status(NAME, status)
        count_launch(CARRY_NAME)


def _validate_carry(carry: Sequence[torch.Tensor], parts: Sequence[torch.Tensor],
                    slots: Sequence[FoldSlot]) -> None:
    if len(carry) != 3 or len(parts) != 3:
        raise ValueError(f"{NAME}: the carry and the parts are three matrices each")
    device = carry[0].device
    for row, mat, dtype in zip(carry, parts, (torch.float64, torch.int64, torch.int32)):
        if row.dtype != dtype or mat.dtype != dtype or row.dim() != 1 or mat.dim() != 2:
            raise TypeError(f"{NAME}: expected a {dtype} row and a 2-D {dtype} matrix, got "
                            f"{row.dtype} {tuple(row.shape)} and {mat.dtype} {tuple(mat.shape)}")
        if row.device != device or mat.device != device:
            raise ValueError(f"{NAME}: the carry and the parts must lie on one device")
        if not (row.is_contiguous() and mat.is_contiguous()):
            raise ValueError(f"{NAME}: the carry and the parts must be contiguous")
        if mat.shape[1] != row.shape[0] or mat.shape[0] != parts[0].shape[0]:
            raise ValueError(f"{NAME}: the parts must be [B, W] beside a carry of W columns")
    if parts[0].shape[0] < 1:
        raise ValueError(f"{NAME}: takes at least one partial")
    _check_slots(carry, slots)


def state_fold_carry_plain(carry: Sequence[torch.Tensor], parts: Sequence[torch.Tensor],
                           slots: Sequence[FoldSlot]) -> None:
    """The same function as the carry entry in plain PyTorch: the plain
    fold of [carry; parts], copied into the carry."""
    stacked = [torch.cat([row[None], mat]) for row, mat in zip(carry, parts)]
    for row, out in zip(carry, state_fold_plain(*stacked, slots)):
        row.copy_(out)


def state_fold_plain(f64: torch.Tensor, i64: torch.Tensor, i32: torch.Tensor,
                     slots: Sequence[FoldSlot]) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The same function as the kernel in plain PyTorch: per kind, the
    columns of all its slots fold together, state after state, with the
    rules of ``analyzers/states.py`` (the same rounding step by step, so
    the kernel agrees bit for bit)."""
    from ..analyzers.states import merge_comoments, merge_moments
    from ..ops.order import max_nan, min_nan_largest

    mats = (f64, i64, i32)
    outs = [m[0].clone() for m in mats]
    by_kind: dict = {}
    for slot in slots:
        cols = list(range(slot.offset, slot.offset + slot.width))
        by_kind.setdefault(slot.kind, []).append(cols)
    n = f64.shape[0]
    for kind, groups in by_kind.items():
        mat = mats[KIND_MATRIX[kind]]
        if kind in GROUP_WIDTH:
            # [N, G, width]: the groups of this kind, folded side by side
            idx = torch.tensor(groups, dtype=torch.int64, device=mat.device)
            stacked = mat[:, idx]
            rule = merge_moments if kind == MOMENTS else merge_comoments
            acc = list(stacked[0].unbind(-1))
            for i in range(1, n):
                acc = rule(acc, list(stacked[i].unbind(-1)))
            outs[0][idx] = torch.stack(acc, dim=-1)
            continue
        idx = torch.tensor([c for cols in groups for c in cols], dtype=torch.int64,
                           device=mat.device)
        cols = mat[:, idx]
        acc = cols[0]
        for i in range(1, n):
            if kind in (ADD_I64, ADD_F64):
                acc = acc + cols[i]
            elif kind == MIN:
                acc = min_nan_largest(acc, cols[i])
            elif kind == MAX:
                acc = max_nan(acc, cols[i])
            else:
                acc = torch.maximum(acc, cols[i])
        outs[KIND_MATRIX[kind]][idx] = acc
    return outs[0], outs[1], outs[2]


def fold_bytes(f64: torch.Tensor, i64: torch.Tensor, i32: torch.Tensor) -> int:
    """Bytes the fold must move: every state read once, one row written."""
    total = 0
    for mat in (f64, i64, i32):
        total += mat.numel() * mat.element_size() + mat.shape[1] * mat.element_size()
    return total

