"""K5 ``kll_compact``: append to a KLL sketch's levels and run the
compaction cascade, in one thread block per sketch.

Replaces the state algebra of the JAX reference's KLL
(deequ_tpu/ops/kll.py: ``_append_level`` :111, ``_make_compact_level``
:147, ``_compact_cascade`` :182, ``_compact_cascade_from`` :204) and the
host ingest tier's ``kll_ingest_sampled`` (:284). The CUDA source is
``csrc/kll_compact.cu``; :func:`kll_compact_update_plain`,
:func:`kll_compact_merge_plain` and :func:`kll_compact_ingest_plain` are
the same functions in plain PyTorch.

A sketch travels as its seven tensors in the reference's leaf order
(items, sizes, parity, ticks, count, g_min, g_max). The update and merge
entries return new tensors and leave their inputs as they were (the kernel
works in place on a copy); the ingest entry updates a stack of sketches in
place.
"""

from __future__ import annotations

import ctypes
from typing import Sequence, Tuple

import torch

from ..ops.order import max_nan, min_nan_largest
from . import build, check_status, count_launch, on_cuda, stream_handle
from .kll_sample import Sample, stable_sort

NAME = "kll_compact"
#: the launch count of the ingest entry
INGEST_NAME = "kll_compact_ingest"
#: levels the kernel takes at most; equals KC_MAX_LEVELS
MAX_LEVELS = 64

Leaves = Tuple[torch.Tensor, ...]
_DTYPES = (torch.float32, torch.int32, torch.int32, torch.int32, torch.int64,
           torch.float64, torch.float64)


def _lib() -> ctypes.CDLL:
    lib = build.load(NAME)
    if not getattr(lib, "_deequ_bound", False):
        lib.kll_compact_scratch.restype = ctypes.c_longlong
        lib.kll_compact_scratch.argtypes = [ctypes.c_int]
        lib.kll_compact_update_launch.restype = ctypes.c_int
        lib.kll_compact_update_launch.argtypes = (
            [ctypes.c_void_p] * 7 + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 5
        )
        lib.kll_compact_merge_launch.restype = ctypes.c_int
        lib.kll_compact_merge_launch.argtypes = (
            [ctypes.c_void_p] * 14 + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 2
        )
        lib.kll_compact_ingest_launch.restype = ctypes.c_int
        lib.kll_compact_ingest_launch.argtypes = (
            [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 + [ctypes.c_void_p] * 8
        )
        lib._deequ_bound = True
    return lib


def _check_state(state: Sequence[torch.Tensor], k: int, what: str) -> None:
    if len(state) != len(_DTYPES):
        raise ValueError(f"{NAME}: {what} has {len(state)} leaves, expected 7")
    items = state[0]
    device = items.device
    for i, (leaf, dtype) in enumerate(zip(state, _DTYPES)):
        if leaf.dtype != dtype or leaf.device != device or not leaf.is_contiguous():
            raise TypeError(f"{NAME}: {what} leaf {i} must be contiguous {dtype} on {device}")
    if items.dim() != 2 or not 2 <= items.shape[0] <= MAX_LEVELS:
        raise ValueError(f"{NAME}: {what} items must be [L, C] with 2 <= L <= {MAX_LEVELS}")
    levels = items.shape[0]
    if state[1].shape != (levels,) or state[2].shape != (levels,):
        raise ValueError(f"{NAME}: {what} sizes and parity must have shape ({levels},)")
    if any(leaf.numel() != 1 for leaf in state[3:]):
        raise ValueError(f"{NAME}: {what} scalars must hold one value each")
    if k < 1:
        raise ValueError(f"{NAME}: sketch size must be positive, got {k}")


def _copy(state: Sequence[torch.Tensor]) -> Leaves:
    return tuple(leaf.clone() for leaf in state)


def _scratch(lib, items: torch.Tensor) -> torch.Tensor:
    entries = lib.kll_compact_scratch(items.shape[1])
    return torch.empty(entries, dtype=torch.int64, device=items.device) if entries else None


def kll_compact_update(state: Sequence[torch.Tensor], sample: Sample, k: int) -> Leaves:
    """The sketch after appending K4's ``sample`` at its level and running
    the cascade up from there."""
    _check_state(state, k, "state")
    items = state[0]
    samples, meta, minmax = sample
    device = items.device
    if (samples.dtype != torch.float32 or meta.dtype != torch.int32 or minmax.dtype != torch.float64
            or meta.numel() != 3 or minmax.numel() != 2
            or any(t.device != device for t in sample)):
        raise TypeError(f"{NAME}: the sample must be K4's outputs on {device}")
    if not on_cuda(items, NAME):
        return kll_compact_update_plain(state, sample, k)
    lib = _lib()
    out = _copy(state)
    scratch = _scratch(lib, items)
    status = lib.kll_compact_update_launch(
        *(leaf.data_ptr() for leaf in out), items.shape[0], items.shape[1], k,
        samples.data_ptr(), meta.data_ptr(), minmax.data_ptr(),
        None if scratch is None else scratch.data_ptr(), stream_handle(device),
    )
    check_status(NAME, status)
    count_launch(NAME)
    return out


def kll_compact_merge(a: Sequence[torch.Tensor], b: Sequence[torch.Tensor], k: int) -> Leaves:
    """The semigroup sum of two sketches of size ``k``: every level of
    ``b`` appended to ``a``'s, parities XORed, one full cascade."""
    _check_state(a, k, "a")
    _check_state(b, k, "b")
    if a[0].shape != b[0].shape or a[0].device != b[0].device:
        raise ValueError(f"{NAME}: cannot merge sketches of shapes {tuple(a[0].shape)} "
                         f"and {tuple(b[0].shape)}")
    items = a[0]
    if not on_cuda(items, NAME):
        return kll_compact_merge_plain(a, b, k)
    lib = _lib()
    out = _copy(a)
    scratch = _scratch(lib, items)
    status = lib.kll_compact_merge_launch(
        *(leaf.data_ptr() for leaf in out), *(leaf.data_ptr() for leaf in b),
        items.shape[0], items.shape[1], k,
        None if scratch is None else scratch.data_ptr(), stream_handle(items.device),
    )
    check_status(NAME, status)
    count_launch(NAME)
    return out


#: dtypes of a host sample's six fields: items [S, B, C], m, h, nv, min, max
_SAMPLE_DTYPES = (torch.float64, torch.int32, torch.int32, torch.int64, torch.float64,
                  torch.float64)


def _check_ingest(sketches: Sequence[torch.Tensor], samples: Sequence[torch.Tensor],
                  k: int) -> None:
    if len(sketches) != len(_DTYPES) or len(samples) != len(_SAMPLE_DTYPES):
        raise ValueError(f"{NAME}: ingest takes 7 stacked sketch leaves and 6 sample fields")
    items = sketches[0]
    device = items.device
    for i, (leaf, dtype) in enumerate(zip((*sketches, *samples), (*_DTYPES, *_SAMPLE_DTYPES))):
        if leaf.dtype != dtype or leaf.device != device or not leaf.is_contiguous():
            raise TypeError(f"{NAME}: ingest input {i} must be contiguous {dtype} on {device}")
    if items.dim() != 3 or not 2 <= items.shape[1] <= MAX_LEVELS:
        raise ValueError(f"{NAME}: stacked items must be [S, L, C] with 2 <= L <= {MAX_LEVELS}")
    s, levels, c = items.shape
    if sketches[1].shape != (s, levels) or sketches[2].shape != (s, levels):
        raise ValueError(f"{NAME}: stacked sizes and parity must have shape ({s}, {levels})")
    if any(leaf.shape != (s,) for leaf in sketches[3:]):
        raise ValueError(f"{NAME}: stacked scalars must have shape ({s},)")
    b = samples[0].shape[1] if samples[0].dim() == 3 else -1
    if samples[0].shape != (s, b, c) or b < 1:
        raise ValueError(f"{NAME}: sample items must be [S, B, C] = [{s}, B >= 1, {c}]")
    if any(f.shape != (s, b) for f in samples[1:]):
        raise ValueError(f"{NAME}: sample fields must have shape ({s}, {b})")
    if k < 1:
        raise ValueError(f"{NAME}: sketch size must be positive, got {k}")


def kll_compact_ingest(sketches: Sequence[torch.Tensor], samples: Sequence[torch.Tensor],
                       k: int) -> None:
    """Fold B host samples into each of S stacked sketches of size ``k``,
    in order, in place (the reference's ``kll_ingest_sampled`` once per
    sample). ``sketches``: the seven leaves with a leading sketch axis
    (items ``[S, L, C]``, sizes and parity ``[S, L]``, the scalars
    ``[S]``); ``samples``: items ``[S, B, C]`` float64 (ascending, +inf
    past ``m``), m and h ``[S, B]`` int32, nv ``[S, B]`` int64, min and
    max ``[S, B]`` float64. One block per sketch."""
    _check_ingest(sketches, samples, k)
    items = sketches[0]
    if not on_cuda(items, NAME):
        kll_compact_ingest_plain(sketches, samples, k)
        return
    lib = _lib()
    s, levels, c = items.shape
    entries = lib.kll_compact_scratch(c)
    scratch = (torch.empty(s * entries, dtype=torch.int64, device=items.device)
               if entries else None)
    status = lib.kll_compact_ingest_launch(
        *(leaf.data_ptr() for leaf in sketches), s, levels, c, k, samples[0].shape[1],
        *(f.data_ptr() for f in samples),
        None if scratch is None else scratch.data_ptr(), stream_handle(items.device),
    )
    check_status(NAME, status)
    count_launch(INGEST_NAME)


# ---------------------------------------------------------------------------
# plain versions: the same layout, level by level on the host's control flow
# ---------------------------------------------------------------------------

#: float32's largest finite value: host samples clip to it before rounding
FLT_MAX = float(torch.finfo(torch.float32).max)


def _append(items: torch.Tensor, sizes: list, level: int, values: torch.Tensor, m: int) -> None:
    size = sizes[level]
    written = max(0, min(m, items.shape[1] - size))
    items[level, size:size + written] = values[:written]
    sizes[level] = size + written


def _compact(items: torch.Tensor, sizes: list, parity: list, level: int) -> None:
    n = sizes[level]
    buf = stable_sort(items[level, :n])
    n2 = n - (n & 1)
    off = parity[level]
    emitted = buf[off:off + n2:2]
    tail = buf[n2:n]
    items[level] = float("inf")
    items[level, :tail.shape[0]] = tail
    sizes[level] = n - n2
    parity[level] = 1 - off
    _append(items, sizes, level + 1, emitted, emitted.shape[0])


def _finish(items, sizes, parity, ticks, count, g_min, g_max) -> Leaves:
    device = items.device
    return (
        items,
        torch.tensor(sizes, dtype=torch.int32, device=device),
        torch.tensor(parity, dtype=torch.int32, device=device),
        ticks, count, g_min, g_max,
    )


def _wrap_int32(x: int) -> int:
    return (x + (1 << 31)) % (1 << 32) - (1 << 31)


def kll_compact_update_plain(state: Sequence[torch.Tensor], sample: Sample, k: int) -> Leaves:
    items, sizes_t, parity_t, ticks, count, g_min, g_max = state
    items = items.clone()
    sizes, parity = sizes_t.tolist(), parity_t.tolist()
    m, h, n = (int(x) for x in sample.meta.tolist())
    levels = items.shape[0]
    h = min(h, levels - 1)
    _append(items, sizes, h, sample.samples, m)
    level = h
    while level < levels - 1 and sizes[level] > k:
        _compact(items, sizes, parity, level)
        level += 1
    return _finish(
        items, sizes, parity,
        torch.full_like(ticks, _wrap_int32(int(ticks) + 1)),
        count + n,
        min_nan_largest(g_min, sample.minmax[0].reshape(g_min.shape)),
        max_nan(g_max, sample.minmax[1].reshape(g_max.shape)),
    )


def kll_compact_merge_plain(a: Sequence[torch.Tensor], b: Sequence[torch.Tensor], k: int) -> Leaves:
    items = a[0].clone()
    sizes = a[1].tolist()
    parity = [x ^ y for x, y in zip(a[2].tolist(), b[2].tolist())]
    b_sizes = b[1].tolist()
    levels = items.shape[0]
    for level in range(levels):
        _append(items, sizes, level, b[0][level], b_sizes[level])
    for level in range(levels - 1):
        if sizes[level] > k:
            _compact(items, sizes, parity, level)
    return _finish(
        items, sizes, parity,
        torch.full_like(a[3], _wrap_int32(int(a[3]) + int(b[3]))),
        a[4] + b[4], min_nan_largest(a[5], b[5]), max_nan(a[6], b[6]),
    )


def kll_compact_ingest_plain(sketches: Sequence[torch.Tensor], samples: Sequence[torch.Tensor],
                             k: int) -> None:
    items_all, sizes_all, parity_all, ticks, count, g_min, g_max = sketches
    s_items, s_m, s_h, s_nv, s_min, s_max = samples
    levels = items_all.shape[1]
    for s in range(items_all.shape[0]):
        items = items_all[s]
        sizes, parity = sizes_all[s].tolist(), parity_all[s].tolist()
        for b in range(s_items.shape[1]):
            h = max(0, min(int(s_h[s, b]), levels - 1))
            values = s_items[s, b].clamp(-FLT_MAX, FLT_MAX).to(torch.float32)
            _append(items, sizes, h, values, int(s_m[s, b]))
            level = h
            while level < levels - 1 and sizes[level] > k:
                _compact(items, sizes, parity, level)
                level += 1
            ticks[s] = _wrap_int32(int(ticks[s]) + 1)
            count[s] += s_nv[s, b]
            g_min[s] = min_nan_largest(g_min[s], s_min[s, b])
            g_max[s] = max_nan(g_max[s], s_max[s, b])
        sizes_all[s] = torch.tensor(sizes, dtype=torch.int32)
        parity_all[s] = torch.tensor(parity, dtype=torch.int32)
