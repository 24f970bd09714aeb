"""K3 ``dict_code_counts``: exact per-code counts of a dictionary column.

Replaces ``DeviceFrequencyScan.update`` of the JAX reference
(deequ_tpu/analyzers/grouping.py:660). The CUDA source is
``csrc/dict_code_counts.cu``; :func:`dict_code_counts_plain` is the same
function in plain PyTorch.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from . import build, check_status, check_tensor, count_launch, on_cuda, stream_handle

NAME = "dict_code_counts"
#: dictionaries up to this size count in shared memory; equals
#: DCC_SHARED_MAX_K in csrc/dict_code_counts.cu
SHARED_MAX_K = 32768


def _lib() -> ctypes.CDLL:
    lib = build.load(NAME)
    if not getattr(lib, "_deequ_bound", False):
        lib.dict_code_counts_shared_max_k.restype = ctypes.c_int
        lib.dict_code_counts_shared_max_k.argtypes = []
        lib.dict_code_counts_launch.restype = ctypes.c_int
        lib.dict_code_counts_launch.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p,
        ]
        if lib.dict_code_counts_shared_max_k() != SHARED_MAX_K:
            raise RuntimeError("dict_code_counts library and wrapper disagree on SHARED_MAX_K")
        lib._deequ_bound = True
    return lib


def dict_code_counts(
    codes: torch.Tensor, rows: torch.Tensor, present: torch.Tensor, num_categories: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(counts, num_rows)``: int64[K] rows per code among valid, present
    rows with a code in [0, K), and the int64 count of all valid rows."""
    n = codes.shape[0] if codes.dim() == 1 else -1
    device = codes.device
    check_tensor(codes, NAME, "codes", torch.int32, n, device)
    check_tensor(rows, NAME, "rows", torch.bool, n, device)
    check_tensor(present, NAME, "present", torch.bool, n, device)
    k = int(num_categories)
    if k < 0 or k > (1 << 31) - 1:
        raise ValueError(f"{NAME}: bad dictionary size {k}")
    if not on_cuda(codes, NAME):
        return dict_code_counts_plain(codes, rows, present, k)
    lib = _lib()
    counts = torch.zeros(k, dtype=torch.int64, device=device)
    num_rows = torch.zeros(1, dtype=torch.int64, device=device)
    status = lib.dict_code_counts_launch(
        codes.data_ptr(), rows.data_ptr(), present.data_ptr(), n, k,
        counts.data_ptr(), num_rows.data_ptr(), stream_handle(device),
    )
    check_status(NAME, status)
    count_launch(NAME)
    return counts, num_rows[0]


def dict_code_counts_plain(
    codes: torch.Tensor, rows: torch.Tensor, present: torch.Tensor, num_categories: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The same function as the kernel in plain PyTorch (a bincount with
    one sentinel bin that is dropped)."""
    k = int(num_categories)
    valid = rows & present & (codes >= 0) & (codes < k)
    keys = torch.where(valid, codes, k).to(torch.int64)
    counts = torch.bincount(keys, minlength=k + 1)[:k]
    return counts, rows.sum(dtype=torch.int64)
