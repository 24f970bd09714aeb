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
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Sequence

import torch

from ..ops.hashing import FREQ_KEY_SENTINEL_I64, splitmix64_torch, xxhash64_u64_torch
from . import build, check_status, check_tensor, count_launch, on_cuda, stream_handle

NAME = "freq_keys"
#: SplitMix64 of an integral or boolean value, or a uint64 hash taken as is
KIND_NUM = 0
KIND_HASH = 1
#: columns per launch; equals FK_MAX_COLS in csrc/freq_keys.cu
MAX_COLUMNS = 8

#: value dtypes the kernel reads, by its dtype codes (FK_I8 .. FK_F64)
_DTYPE_CODES = {
    torch.int8: 0, torch.uint8: 1, torch.int16: 2, torch.int32: 3,
    torch.int64: 4, torch.float64: 5,
}


class KeyColumn(NamedTuple):
    """One column of a group key: ``values`` are integers of at most 64
    bits or float64 0/1 (booleans) for :data:`KIND_NUM`, the int64 bits of
    the host's xxhash64 for :data:`KIND_HASH`; ``mask`` marks present rows."""

    kind: int
    values: torch.Tensor
    mask: torch.Tensor


class _ColumnStruct(ctypes.Structure):
    # mirrors struct FkColumn in csrc/freq_keys.cu
    _fields_ = [
        ("kind", ctypes.c_int32),
        ("dtype", ctypes.c_int32),
        ("values", ctypes.c_void_p),
        ("mask", ctypes.c_void_p),
    ]


def _lib() -> ctypes.CDLL:
    lib = build.load(NAME)
    if not getattr(lib, "_deequ_bound", False):
        lib.freq_keys_max_columns.restype = ctypes.c_int
        lib.freq_keys_max_columns.argtypes = []
        lib.freq_keys_launch.restype = ctypes.c_int
        lib.freq_keys_launch.argtypes = [
            ctypes.POINTER(_ColumnStruct), ctypes.c_int, ctypes.c_void_p,
            ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ]
        if lib.freq_keys_max_columns() != MAX_COLUMNS:
            raise RuntimeError("freq_keys library and wrapper disagree on MAX_COLUMNS")
        lib._deequ_bound = True
    return lib


def _validate(columns: Sequence[KeyColumn], rows: torch.Tensor, out: torch.Tensor,
              offset: int) -> int:
    if not columns or len(columns) > MAX_COLUMNS:
        raise ValueError(f"{NAME}: takes 1 to {MAX_COLUMNS} columns, got {len(columns)}")
    n = rows.shape[0] if rows.dim() == 1 else -1
    device = rows.device
    check_tensor(rows, NAME, "rows", torch.bool, n, device)
    for i, col in enumerate(columns):
        check_tensor(col.mask, NAME, f"column {i} mask", torch.bool, n, device)
        if col.kind == KIND_HASH:
            check_tensor(col.values, NAME, f"column {i} hashes", torch.int64, n, device)
        elif col.kind == KIND_NUM:
            if col.values.dtype not in _DTYPE_CODES:
                raise TypeError(f"{NAME}: column {i} values of {col.values.dtype} are not taken")
            check_tensor(col.values, NAME, f"column {i} values", col.values.dtype, n, device)
        else:
            raise ValueError(f"{NAME}: column {i} has unknown kind {col.kind}")
    if out.dim() != 1 or out.dtype != torch.int64 or out.device != device:
        raise ValueError(f"{NAME}: out must be a 1-D int64 tensor on {device}")
    if not out.is_contiguous():
        raise ValueError(f"{NAME}: out must be contiguous")
    if offset < 0 or offset + n > out.shape[0]:
        raise ValueError(f"{NAME}: {n} keys at offset {offset} overrun {out.shape[0]} entries")
    return n


def freq_keys(columns: Sequence[KeyColumn], rows: torch.Tensor, out: torch.Tensor,
              offset: int) -> torch.Tensor:
    """Write the batch's keys into ``out[offset:offset + n]`` (the sentinel
    for invalid rows and for valid rows whose key is the sentinel); returns
    int64[2]: (valid rows keyed as the sentinel, valid rows). CPU tensors
    take :func:`freq_keys_plain`; CUDA tensors launch the kernel."""
    n = _validate(columns, rows, out, offset)
    if not on_cuda(rows, NAME):
        return freq_keys_plain(columns, rows, out, offset)
    lib = _lib()
    table = (_ColumnStruct * len(columns))(*[
        _ColumnStruct(col.kind, _DTYPE_CODES[col.values.dtype], col.values.data_ptr(),
                      col.mask.data_ptr())
        for col in columns
    ])
    counts = torch.empty(2, dtype=torch.int64, device=rows.device)
    status = lib.freq_keys_launch(
        table, len(columns), rows.data_ptr(), n,
        out.data_ptr() + offset * out.element_size(), counts.data_ptr(),
        stream_handle(rows.device),
    )
    check_status(NAME, status)
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
