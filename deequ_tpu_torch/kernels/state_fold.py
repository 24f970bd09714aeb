"""K8 ``state_fold``: fold N same-shape analyzer states left to right with
each state's merge, for every analyzer of a call, in one launch.

Four entry points of one set of merge rules (``csrc/state_fold.cu``):

- :func:`state_fold` replaces ``merge_states_batched`` of the JAX reference
  (deequ_tpu/analyzers/base.py:273, a ``lax.scan`` of ``analyzer.merge``
  over stacked states): the refresh of persisted states.
- :func:`state_fold_carry` replaces the host ingest tier's fold
  (``_ingest_program`` / ``make_flagged_ingest_body``,
  deequ_tpu/runners/engine.py:1760,1787): a chunk of host partials folded
  into the device-resident carry, in place.
- :func:`state_fold_carry_stacked` replaces ``sharded_ingest_fold``
  (deequ_tpu/parallel/__init__.py:171): n_dev carries, each folding its
  own slice of a chunk's partials under the chunk's flags; the carry entry
  is its one-shard case, the same kernel body.
- :func:`state_fold_butterfly` replaces ``collective_merge_states``
  (deequ_tpu/parallel/__init__.py:266) on one device: every shard's local
  fold, then the XOR rounds (or the ordered gather fold), in one launch.

The ``*_plain`` functions are the same functions in plain PyTorch, built
on the merge rules of ``analyzers/states.py`` that the states' own
``merge`` uses.

The states arrive packed per dtype into row-major matrices, one row a
state: float64 ``[N, Wf]``, int64 ``[N, Wi]`` and int32 ``[N, Wr]``. A
:class:`FoldSlot` names a merge kind and the columns it owns in its dtype's
matrix; every column belongs to exactly one slot. The result is one row of
each matrix: the fold of its N rows, starting from row 0.

In the reference's 32-bit accumulator mode (``DEEQU_TPU_NO_X64``) the
first two matrices are float32 and int32 (:func:`matrix_dtypes`): the
float matrix's dtype picks the kernel's ``_f32`` entries, counted under
``state_fold_f32``, ``state_fold_carry_f32``, ``state_fold_carry_stacked_f32``
and ``state_fold_butterfly_f32``. The kinds keep their names (ADD_I64 adds
the count matrix, ADD_F64 the float one).
"""

from __future__ import annotations

import ctypes
import functools
import threading
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from . import build, check_status, count_launch, entry_name, on_cuda, stream_handle

NAME = "state_fold"
#: the launch counts of the carry entry and the mesh's two entries
CARRY_NAME = "state_fold_carry"
CARRY_STACKED_NAME = "state_fold_carry_stacked"
BUTTERFLY_NAME = "state_fold_butterfly"
#: columns of an elementwise work item of the fold; equals SF_SPAN in
#: csrc/state_fold.cu
SPAN = 256
#: shards a butterfly launch takes; equals SF_MAX_SHARDS
MAX_SHARDS = 1024

#: merge kinds (csrc/state_fold.cu); the elementwise ones fold ``length``
#: columns, the moment kinds a fixed group of float64 columns
ADD_I64, ADD_F64, MIN, MAX, MOMENTS, COMOMENTS, MAX_I32 = range(7)
#: float64 columns of a moments / co-moments group
GROUP_WIDTH = {MOMENTS: 3, COMOMENTS: 6}
#: the matrix each kind reads: 0 floats, 1 counts, 2 int32
KIND_MATRIX = {ADD_I64: 1, ADD_F64: 0, MIN: 0, MAX: 0, MOMENTS: 0, COMOMENTS: 0, MAX_I32: 2}


def matrix_dtypes(float_dtype: torch.dtype) -> Tuple[torch.dtype, torch.dtype, torch.dtype]:
    """The three matrices' dtypes beside a float matrix of ``float_dtype``:
    float64, int64, int32, or float32, int32, int32 (the 32-bit
    accumulator mode). Any other float type raises ``TypeError``."""
    if float_dtype == torch.float64:
        return torch.float64, torch.int64, torch.int32
    if float_dtype == torch.float32:
        return torch.float32, torch.int32, torch.int32
    raise TypeError(f"{NAME}: the float matrix must be float64 or float32, got {float_dtype}")


def _entry(lib, name: str, float_dtype: torch.dtype):
    """The C entry ``name``, or its ``_f32`` twin for float32 matrices."""
    return getattr(lib, name + ("_f32" if float_dtype == torch.float32 else ""))


@dataclass(frozen=True)
class FoldSlot:
    kind: int
    offset: int      # first column in its dtype's matrix
    length: int = 1  # columns of an elementwise slot (1 for the moment kinds)

    @property
    def width(self) -> int:
        return GROUP_WIDTH.get(self.kind, self.length)


def butterfly_span(n_dev: int) -> int:
    """Columns of a butterfly work item over ``n_dev`` shards: a block's
    ``n_dev * span`` accumulators fit its 256 threads twice over (four
    times at 1,024 shards). Equals ``state_fold_butterfly_span``."""
    return max(1, min(SPAN, 512 // max(1, n_dev)))


class FoldPlan:
    """The kernel's work list for one slot layout: items ``(kind, offset,
    cols)``, each an elementwise slot's span of at most ``span`` columns or
    one moments / co-moments group (``cols`` 1). Built once per layout
    (:func:`fold_plan`); the items go to each device once per span."""

    def __init__(self, slots: Tuple[FoldSlot, ...]):
        self.slots = slots
        self._items: Dict[int, List[Tuple[int, int, int]]] = {}
        self._on_device: Dict[Tuple[torch.device, int], torch.Tensor] = {}

    def items(self, span: int = SPAN) -> List[Tuple[int, int, int]]:
        got = self._items.get(span)
        if got is None:
            got = []
            for s in self.slots:
                if s.kind in GROUP_WIDTH:
                    got.append((s.kind, s.offset, 1))
                    continue
                for lo in range(0, s.length, span):
                    got.append((s.kind, s.offset + lo, min(span, s.length - lo)))
            self._items[span] = got
        return got

    def device_items(self, device: torch.device, span: int = SPAN) -> torch.Tensor:
        """The items as an int32 ``[n, 3]`` tensor on ``device``."""
        key = (device, span)
        got = self._on_device.get(key)
        if got is None:
            got = torch.tensor(self.items(span), dtype=torch.int32).to(device)
            self._on_device[key] = got
        return got


_PLANS: Dict[Tuple, FoldPlan] = {}
_PLANS_LOCK = threading.Lock()
#: layouts kept at most; the oldest goes first
_MAX_PLANS = 256


def fold_plan(slots: Sequence[FoldSlot], widths: Tuple[int, int, int]) -> FoldPlan:
    """The plan of ``slots`` over matrices of ``widths`` (float64, int64,
    int32 columns): checked and built at the first call with this layout
    (every column belongs to exactly one slot, else ``ValueError``), the
    same object at every later call."""
    key = (tuple(slots), tuple(widths))
    plan = _PLANS.get(key)
    if plan is None:
        _check_slots(key[1], key[0])
        plan = FoldPlan(key[0])
        with _PLANS_LOCK:
            if len(_PLANS) >= _MAX_PLANS:
                _PLANS.pop(next(iter(_PLANS)))
            plan = _PLANS.setdefault(key, plan)
    return plan


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = build.load(NAME)
    for query in (lib.state_fold_span, lib.state_fold_max_shards):
        query.restype = ctypes.c_int
        query.argtypes = []
    lib.state_fold_butterfly_span.restype = ctypes.c_int
    lib.state_fold_butterfly_span.argtypes = [ctypes.c_int]
    p, i, n = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    for suffix in ("", "_f32"):
        for name in ("state_fold_launch", "state_fold_carry_launch"):
            entry = getattr(lib, name + suffix)
            entry.restype = ctypes.c_int
            entry.argtypes = [p, i, n, p, i, p, i, p, i, p, p, p, p]
        entry = getattr(lib, "state_fold_carry_stacked_launch" + suffix)
        entry.restype = ctypes.c_int
        entry.argtypes = [p, i, i, n, p, i, p, i, p, i, p, p, p, p, p]
        entry = getattr(lib, "state_fold_butterfly_launch" + suffix)
        entry.restype = ctypes.c_int
        entry.argtypes = [p, i, i, i, p, i, p, i, p, i, p, p, p, p]
    if (lib.state_fold_span() != SPAN or lib.state_fold_max_shards() != MAX_SHARDS
            or any(lib.state_fold_butterfly_span(n) != butterfly_span(n)
                   for n in (1, 2, 3, 8, 100, 513, MAX_SHARDS))):
        raise build.KernelLaunchError("state_fold library and wrapper disagree on its limits")
    return lib


def _ptr(t: torch.Tensor):
    return t.data_ptr() if t.numel() else None


def _validate(f64: torch.Tensor, i64: torch.Tensor, i32: torch.Tensor,
              slots: Sequence[FoldSlot]) -> FoldPlan:
    mats = (f64, i64, i32)
    for mat, dtype in zip(mats, matrix_dtypes(f64.dtype)):
        if mat.dtype != dtype or mat.dim() != 2:
            raise TypeError(f"{NAME}: expected a 2-D {dtype} matrix, got {mat.dtype} "
                            f"{tuple(mat.shape)}")
        if mat.device != f64.device or not mat.is_contiguous():
            raise ValueError(f"{NAME}: the matrices must be contiguous on one device")
        if mat.shape[0] != f64.shape[0]:
            raise ValueError(f"{NAME}: the matrices hold different numbers of states")
    if f64.shape[0] < 1:
        raise ValueError(f"{NAME}: takes at least one state")
    return fold_plan(slots, (f64.shape[1], i64.shape[1], i32.shape[1]))


def _check_slots(widths: Sequence[int], slots: Sequence[FoldSlot]) -> None:
    """Every column of the three matrices (``widths`` columns each) belongs
    to exactly one slot: each matrix's slots, sorted by offset, tile it."""
    if not slots:
        raise ValueError(f"{NAME}: takes at least one slot")
    spans: List[List[Tuple[int, int]]] = [[] for _ in widths]
    for slot in slots:
        if slot.kind not in KIND_MATRIX or slot.length < 1:
            raise ValueError(f"{NAME}: bad slot {slot}")
        width = widths[KIND_MATRIX[slot.kind]]
        if slot.offset < 0 or slot.offset + slot.width > width:
            raise ValueError(f"{NAME}: slot {slot} runs past its matrix")
        spans[KIND_MATRIX[slot.kind]].append((slot.offset, slot.offset + slot.width))
    for width, span in zip(widths, spans):
        end = 0
        for lo, hi in sorted(span):
            if lo != end:
                raise ValueError(f"{NAME}: every column must belong to exactly one slot")
            end = hi
        if end != width:
            raise ValueError(f"{NAME}: every column must belong to exactly one slot")


def state_fold(f64: torch.Tensor, i64: torch.Tensor, i32: torch.Tensor,
               slots: Sequence[FoldSlot]) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The fold of the N packed states: float64 ``[Wf]``, int64 ``[Wi]`` and
    int32 ``[Wr]`` (float32, int32, int32 in the 32-bit mode). CPU tensors
    take :func:`state_fold_plain`; CUDA tensors launch the kernel once."""
    plan = _validate(f64, i64, i32, slots)
    if not on_cuda(f64, NAME):
        return state_fold_plain(f64, i64, i32, slots)
    device = f64.device
    items = plan.device_items(device)
    out_f = torch.empty(f64.shape[1], dtype=f64.dtype, device=device)
    out_i = torch.empty(i64.shape[1], dtype=i64.dtype, device=device)
    out_r = torch.empty(i32.shape[1], dtype=torch.int32, device=device)
    status = _entry(_lib(), "state_fold_launch", f64.dtype)(
        items.data_ptr(), items.shape[0], f64.shape[0], _ptr(f64), f64.shape[1], _ptr(i64),
        i64.shape[1], _ptr(i32), i32.shape[1], _ptr(out_f), _ptr(out_i), _ptr(out_r),
        stream_handle(device),
    )
    check_status(NAME, status)
    count_launch(entry_name(NAME, f64.dtype))
    return out_f, out_i, out_r


def state_fold_carry(carry: Sequence[torch.Tensor], parts: Sequence[torch.Tensor],
                     slots: Sequence[FoldSlot]) -> None:
    """Fold the B partial rows ``parts`` (float64 ``[B, Wf]``, int64
    ``[B, Wi]``, int32 ``[B, Wr]``; float32, int32, int32 in the 32-bit
    mode) into the packed ``carry`` (float64 ``[Wf]``, int64 ``[Wi]``,
    int32 ``[Wr]``) in order, in place: the carry becomes the fold of
    [carry; parts]. CPU tensors take :func:`state_fold_carry_plain`; CUDA
    tensors launch the kernel once."""
    plan = _validate_carry(carry, parts, slots)
    if not on_cuda(carry[0], NAME):
        state_fold_carry_plain(carry, parts, slots)
        return
    device = carry[0].device
    items = plan.device_items(device)
    (cf, ci, cr), (pf, pi, pr) = carry, parts
    status = _entry(_lib(), "state_fold_carry_launch", cf.dtype)(
        items.data_ptr(), items.shape[0], pf.shape[0], _ptr(cf), cf.shape[0], _ptr(ci),
        ci.shape[0], _ptr(cr), cr.shape[0], _ptr(pf), _ptr(pi), _ptr(pr), stream_handle(device),
    )
    check_status(NAME, status)
    count_launch(entry_name(CARRY_NAME, cf.dtype))


def _validate_carry(carry: Sequence[torch.Tensor], parts: Sequence[torch.Tensor],
                    slots: Sequence[FoldSlot]) -> FoldPlan:
    if len(carry) != 3 or len(parts) != 3:
        raise ValueError(f"{NAME}: the carry and the parts are three matrices each")
    device = carry[0].device
    for row, mat, dtype in zip(carry, parts, matrix_dtypes(carry[0].dtype)):
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
    return fold_plan(slots, tuple(row.shape[0] for row in carry))


def state_fold_carry_plain(carry: Sequence[torch.Tensor], parts: Sequence[torch.Tensor],
                           slots: Sequence[FoldSlot]) -> None:
    """The same function as the carry entry in plain PyTorch: the plain
    fold of [carry; parts], copied into the carry."""
    stacked = [torch.cat([row[None], mat]) for row, mat in zip(carry, parts)]
    for row, out in zip(carry, state_fold_plain(*stacked, slots)):
        row.copy_(out)


def state_fold_carry_stacked(carry: Sequence[torch.Tensor], parts: Sequence[torch.Tensor],
                             slots: Sequence[FoldSlot],
                             flags: Optional[torch.Tensor] = None) -> None:
    """Fold a chunk into n shards' carries in place: ``carry`` holds one
    packed row per shard (float64 ``[n, Wf]``, int64 ``[n, Wi]``, int32
    ``[n, Wr]``; float32, int32, int32 in the 32-bit mode), ``parts`` the
    chunk's ``n * B`` partial rows, shard s
    owning rows ``s*B .. s*B+B-1``; each shard's carry becomes the fold of
    [carry; its rows whose ``flags`` entry (bool ``[n * B]``) is set, all
    of them when None], in order. CPU tensors take
    :func:`state_fold_carry_stacked_plain`; CUDA tensors launch the kernel
    once (``blockIdx.y`` the shard)."""
    plan = _validate_carry_stacked(carry, parts, slots, flags)
    if not on_cuda(carry[0], NAME):
        state_fold_carry_stacked_plain(carry, parts, slots, flags)
        return
    device = carry[0].device
    items = plan.device_items(device)
    n = carry[0].shape[0]
    (cf, ci, cr), (pf, pi, pr) = carry, parts
    status = _entry(_lib(), "state_fold_carry_stacked_launch", cf.dtype)(
        items.data_ptr(), items.shape[0], n, pf.shape[0] // n, _ptr(cf), cf.shape[1], _ptr(ci),
        ci.shape[1], _ptr(cr), cr.shape[1], _ptr(pf), _ptr(pi), _ptr(pr),
        None if flags is None else flags.view(torch.uint8).data_ptr(), stream_handle(device),
    )
    check_status(CARRY_STACKED_NAME, status)
    count_launch(entry_name(CARRY_STACKED_NAME, cf.dtype))


def _validate_carry_stacked(carry, parts, slots, flags) -> FoldPlan:
    if len(carry) != 3 or len(parts) != 3:
        raise ValueError(f"{NAME}: the carries and the parts are three matrices each")
    device = carry[0].device
    n = carry[0].shape[0] if carry[0].dim() == 2 else 0
    for rows, mat, dtype in zip(carry, parts, matrix_dtypes(carry[0].dtype)):
        if rows.dtype != dtype or mat.dtype != dtype or rows.dim() != 2 or mat.dim() != 2:
            raise TypeError(f"{NAME}: expected 2-D {dtype} carries and parts, got "
                            f"{rows.dtype} {tuple(rows.shape)} and {mat.dtype} "
                            f"{tuple(mat.shape)}")
        if rows.device != device or mat.device != device:
            raise ValueError(f"{NAME}: the carries and the parts must lie on one device")
        if not (rows.is_contiguous() and mat.is_contiguous()):
            raise ValueError(f"{NAME}: the carries and the parts must be contiguous")
        if rows.shape[0] != n or mat.shape[1] != rows.shape[1] or mat.shape[0] != parts[0].shape[0]:
            raise ValueError(f"{NAME}: the parts must be [n * B, W] beside carries [n, W]")
    if n < 1 or parts[0].shape[0] < n or parts[0].shape[0] % n:
        raise ValueError(f"{NAME}: every shard takes the same number (>= 1) of partials")
    if n > 65535:
        raise ValueError(f"{NAME}: at most 65535 shards a launch")
    if flags is not None and (flags.dtype != torch.bool or flags.shape != (parts[0].shape[0],)
                              or flags.device != device or not flags.is_contiguous()):
        raise ValueError(f"{NAME}: flags must be a contiguous bool [n * B] on {device}")
    return fold_plan(slots, tuple(rows.shape[1] for rows in carry))


def state_fold_carry_stacked_plain(carry: Sequence[torch.Tensor], parts: Sequence[torch.Tensor],
                                   slots: Sequence[FoldSlot],
                                   flags: Optional[torch.Tensor] = None) -> None:
    """The same function as the stacked carry entry in plain PyTorch: per
    shard, the carry entry's plain version over its flagged rows."""
    n = carry[0].shape[0]
    b = parts[0].shape[0] // n
    for s in range(n):
        keep = slice(s * b, (s + 1) * b)
        rows = [p[keep] for p in parts]
        if flags is not None:
            mask = flags[keep]
            if not bool(mask.any()):
                continue
            rows = [r[mask] for r in rows]
        state_fold_carry_plain([c[s] for c in carry], rows, slots)


def state_fold_butterfly(f64: torch.Tensor, i64: torch.Tensor, i32: torch.Tensor,
                         slots: Sequence[FoldSlot], n_dev: int
                         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The collective merge of ``n_dev * k`` packed states on one device:
    shard s owns rows ``s*k .. s*k+k-1`` and folds them first; then, for a
    power-of-two ``n_dev``, log2(n_dev) rounds of ``acc[s] = merge(acc[s],
    acc[s ^ shift])``, else every shard folds all accumulators in shard
    order. Returns every shard's final row (float64 ``[n_dev, Wf]``, int64
    ``[n_dev, Wi]``, int32 ``[n_dev, Wr]``; float32, int32, int32 in the
    32-bit mode); row 0 is the merge. CPU tensors take
    :func:`state_fold_butterfly_plain`; CUDA tensors launch the kernel
    once."""
    plan = _validate(f64, i64, i32, slots)
    n_dev = int(n_dev)
    if not 1 <= n_dev <= MAX_SHARDS or f64.shape[0] % n_dev:
        raise ValueError(f"{NAME}: {f64.shape[0]} states do not split over {n_dev} shards "
                         f"(1 <= n_dev <= {MAX_SHARDS})")
    if not on_cuda(f64, NAME):
        return state_fold_butterfly_plain(f64, i64, i32, slots, n_dev)
    device = f64.device
    items = plan.device_items(device, butterfly_span(n_dev))
    k = f64.shape[0] // n_dev
    outs = [torch.empty((n_dev, m.shape[1]), dtype=m.dtype, device=device)
            for m in (f64, i64, i32)]
    status = _entry(_lib(), "state_fold_butterfly_launch", f64.dtype)(
        items.data_ptr(), items.shape[0], n_dev, k, _ptr(f64), f64.shape[1], _ptr(i64),
        i64.shape[1], _ptr(i32), i32.shape[1], *(_ptr(t) for t in outs), stream_handle(device),
    )
    check_status(BUTTERFLY_NAME, status)
    count_launch(entry_name(BUTTERFLY_NAME, f64.dtype))
    return outs[0], outs[1], outs[2]


def state_fold_butterfly_plain(f64: torch.Tensor, i64: torch.Tensor, i32: torch.Tensor,
                               slots: Sequence[FoldSlot], n_dev: int
                               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The same function as the butterfly entry in plain PyTorch: the
    schedule spelled out with :func:`state_fold_plain` (the local folds,
    then one two-row fold per shard and round, or one ordered fold)."""
    k = f64.shape[0] // n_dev
    mats = (f64, i64, i32)
    acc = [state_fold_plain(*(m[s * k:(s + 1) * k] for m in mats), slots) for s in range(n_dev)]
    if n_dev > 1 and n_dev & (n_dev - 1) == 0:
        shift = 1
        while shift < n_dev:
            acc = [state_fold_plain(*(torch.stack([a, b]) for a, b in
                                      zip(acc[s], acc[s ^ shift])), slots)
                   for s in range(n_dev)]
            shift <<= 1
    elif n_dev > 1:
        acc = [state_fold_plain(*(torch.stack(col) for col in zip(*acc)), slots)] * n_dev
    out = [torch.stack(col) for col in zip(*acc)]
    return out[0], out[1], out[2]


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

