"""K7 ``freq_compact``: sort-merge compaction of (key, count) pairs into a
table of at most ``out_size`` sorted unique keys with summed counts.

Replaces ``freq_compact`` of the JAX reference (deequ_tpu/ops/__init__.py:
33) as ``FrequencyTableState.compacted`` and ``.merge``
(deequ_tpu/analyzers/states.py:112,190) call it. The CUDA source is
``csrc/freq_compact.cu``; :func:`freq_compact_plain` is the reference's
function in plain PyTorch.

Keys are uint64 values held in int64 tensors. Sorting them as unsigned
means sorting ``key ^ INT64_MIN`` as signed: the sentinel (-1 as an int64)
then sorts last, as it does in the reference.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch

from ..ops.hashing import FREQ_KEY_SENTINEL_I64
from . import build, check_status, check_tensor, count_launch, on_cuda, stream_handle

NAME = "freq_compact"
INT64_MIN = -(1 << 63)


class Compacted(NamedTuple):
    """A compaction's outputs; the scalars are 0-d int64 tensors on the
    inputs' device."""

    keys: torch.Tensor       # int64[out_size]: ascending (unsigned), sentinel past n_unique
    counts: torch.Tensor     # int64[out_size]: summed counts, 0 past n_unique
    n_unique: torch.Tensor   # distinct real keys of the input (may exceed out_size)
    kept_rows: torch.Tensor  # summed counts of the kept keys
    total_rows: torch.Tensor  # summed counts of all keys


def _lib() -> ctypes.CDLL:
    lib = build.load(NAME)
    if not getattr(lib, "_deequ_bound", False):
        lib.freq_compact_scratch_words.restype = ctypes.c_longlong
        lib.freq_compact_scratch_words.argtypes = [ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int]
        lib.freq_compact_launch.restype = ctypes.c_int
        lib.freq_compact_launch.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
            ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ]
        lib._deequ_bound = True
    return lib


def freq_compact(table_keys: torch.Tensor, table_counts: torch.Tensor,
                 other_keys: torch.Tensor, other_counts: Optional[torch.Tensor],
                 out_size: int) -> Compacted:
    """Compact a sorted table with either a second sorted table
    (``other_counts`` given: a state merge) or a raw key buffer
    (``other_counts`` None: each key counts 1 unless it is the sentinel;
    the buffer is sorted first). A table is ascending in unsigned order,
    sentinel-padded, its sentinel entries with count 0. CPU tensors take
    :func:`freq_compact_plain` on the concatenated pairs; CUDA tensors
    launch the kernel."""
    device = table_keys.device
    na = table_keys.shape[0] if table_keys.dim() == 1 else -1
    nb = other_keys.shape[0] if other_keys.dim() == 1 else -1
    check_tensor(table_keys, NAME, "table keys", torch.int64, na, device)
    check_tensor(table_counts, NAME, "table counts", torch.int64, na, device)
    check_tensor(other_keys, NAME, "other keys", torch.int64, nb, device)
    if other_counts is not None:
        check_tensor(other_counts, NAME, "other counts", torch.int64, nb, device)
    if out_size < 1:
        raise ValueError(f"{NAME}: out_size must be positive, got {out_size}")
    if not on_cuda(table_keys, NAME):
        if other_counts is None:
            other_counts = (other_keys != FREQ_KEY_SENTINEL_I64).to(torch.int64)
        return freq_compact_plain(
            torch.cat([table_keys, other_keys]), torch.cat([table_counts, other_counts]), out_size
        )
    lib = _lib()
    words = lib.freq_compact_scratch_words(na, nb, int(other_counts is None))
    scratch = torch.empty(max(words, 1), dtype=torch.int64, device=device)
    out_keys = torch.empty(out_size, dtype=torch.int64, device=device)
    out_counts = torch.empty(out_size, dtype=torch.int64, device=device)
    meta = torch.empty(4, dtype=torch.int64, device=device)
    status = lib.freq_compact_launch(
        table_keys.data_ptr(), table_counts.data_ptr(), na,
        other_keys.data_ptr(), None if other_counts is None else other_counts.data_ptr(), nb,
        out_size, out_keys.data_ptr(), out_counts.data_ptr(), meta.data_ptr(),
        scratch.data_ptr(), stream_handle(device),
    )
    check_status(NAME, status)
    count_launch(NAME)
    return Compacted(out_keys, out_counts, meta[0], meta[1], meta[2])


def freq_compact_plain(keys: torch.Tensor, counts: torch.Tensor, out_size: int) -> Compacted:
    """The reference's ``freq_compact`` in plain PyTorch: sort the pairs by
    unsigned key, mark run starts, and read each of the first ``out_size``
    runs' key and count sum off cumulative sums. Sentinel entries carry
    count 0 and real keys counts of at least 1."""
    device = keys.device
    n = keys.shape[0]
    zero = torch.zeros((), dtype=torch.int64, device=device)
    if n == 0:
        return Compacted(torch.full((out_size,), FREQ_KEY_SENTINEL_I64, device=device),
                         torch.zeros(out_size, dtype=torch.int64, device=device), zero, zero, zero)
    order = torch.argsort(keys ^ INT64_MIN, stable=True)
    k, c = keys[order], counts[order]
    is_start = torch.ones(n, dtype=torch.bool, device=device)
    is_start[1:] = k[1:] != k[:-1]
    is_start &= k != FREQ_KEY_SENTINEL_I64
    ranks = torch.cumsum(is_start.to(torch.int64), 0)
    n_unique = ranks[-1]
    tot = torch.cumsum(c, 0)
    target = torch.arange(1, out_size + 1, dtype=torch.int64, device=device)
    pos = torch.searchsorted(ranks, target, side="left").clamp(0, n - 1)
    pos_next = torch.searchsorted(ranks, target + 1, side="left")
    valid = target <= n_unique
    out_keys = torch.where(valid, k[pos], FREQ_KEY_SENTINEL_I64)
    seg_end = tot[(pos_next - 1).clamp(0, n - 1)]
    seg_end = torch.where(pos_next >= n, tot[n - 1], seg_end)
    seg_begin = torch.where(pos > 0, tot[(pos - 1).clamp(min=0)], zero)
    out_counts = torch.where(valid, seg_end - seg_begin, zero)
    return Compacted(out_keys, out_counts, n_unique, out_counts.sum(), tot[n - 1])
