"""K3 ``dict_code_counts``: exact per-code counts of a dictionary column.

Replaces ``DeviceFrequencyScan.update`` of the JAX reference
(deequ_tpu/analyzers/grouping.py:660). The CUDA source is
``csrc/dict_code_counts.cu``; :func:`dict_code_counts_plain` is the same
function in plain PyTorch.

The kernel counts in one of three ways, which :func:`plan_path` picks from
the dictionary's size and the shared memory one block of the card may opt
in to: one histogram a block in shared memory (``"shared"``), half the
bins in each block of a two-block cluster (``"cluster"``, up to
:data:`CLUSTER_MAX_K` codes), or adds into device memory (``"global"``).

The kernel counts in int64. The wrapper returns the counts in the process's
``config.COUNT_DTYPE``: int64, or int32 in the reference's 32-bit
accumulator mode (``DEEQU_TPU_NO_X64``), cast from the kernel's int64 output
on the device (exact below 2^31, as the batch's rows are).
"""

from __future__ import annotations

import ctypes
import threading
from typing import Dict, Tuple

import torch

from . import build, check_status, check_tensor, count_launch, on_cuda, stream_handle

NAME = "dict_code_counts"
PATHS = ("shared", "cluster", "global")
#: the cluster path's largest dictionary; equals DCC_CLUSTER_MAX_K
CLUSTER_MAX_K = 1 << 16
#: blocks of a cluster, each holding a share of the bins; equals DCC_CLUSTER
CLUSTER_SIZE = 2
#: shared memory a block keeps beside its histogram (its row count), bytes
STATIC_SHARED_BYTES = 64

_LIMITS: Dict[int, int] = {}
_LIMITS_LOCK = threading.Lock()


def _bins(k: int) -> int:
    """uint32 bins a histogram of ``k`` codes takes (a multiple of 4)."""
    return (k + 3) & ~3


def shared_max_k(limit_bytes: int) -> int:
    """The largest dictionary one block counts in shared memory, given the
    bytes a block may opt in to (``cudaDevAttrMaxSharedMemoryPerBlockOptin``)."""
    return max(0, (limit_bytes - STATIC_SHARED_BYTES) // 16 * 4)


def plan_path(k: int, limit_bytes: int) -> str:
    """The kernel's path for ``k`` codes on a card whose blocks may opt in
    to ``limit_bytes`` of shared memory."""
    if k <= shared_max_k(limit_bytes):
        return "shared"
    half = _bins(-(-k // CLUSTER_SIZE))
    if k <= CLUSTER_MAX_K and 4 * half <= limit_bytes - STATIC_SHARED_BYTES:
        return "cluster"
    return "global"


def _lib() -> ctypes.CDLL:
    lib = build.load(NAME)
    if not getattr(lib, "_deequ_bound", False):
        lib.dict_code_counts_shared_limit.restype = ctypes.c_int
        lib.dict_code_counts_shared_limit.argtypes = [ctypes.POINTER(ctypes.c_int)]
        for fn in ("dict_code_counts_cluster_max_k", "dict_code_counts_cluster_size"):
            getattr(lib, fn).restype = ctypes.c_int
            getattr(lib, fn).argtypes = []
        lib.dict_code_counts_launch.restype = ctypes.c_int
        lib.dict_code_counts_launch.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
            ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
        ]
        if (lib.dict_code_counts_cluster_max_k() != CLUSTER_MAX_K
                or lib.dict_code_counts_cluster_size() != CLUSTER_SIZE):
            raise build.KernelLaunchError(
                "dict_code_counts library and wrapper disagree on the cluster path")
        lib._deequ_bound = True
    return lib


def shared_limit(device: torch.device) -> int:
    """The shared memory one block may opt in to on ``device``, bytes (read
    from the card once per device)."""
    index = device.index if device.index is not None else torch.cuda.current_device()
    with _LIMITS_LOCK:
        limit = _LIMITS.get(index)
        if limit is None:
            value = ctypes.c_int(0)
            with torch.cuda.device(index):
                check_status(NAME, _lib().dict_code_counts_shared_limit(ctypes.byref(value)))
            limit = _LIMITS[index] = value.value
        return limit


def dict_code_counts(
    codes: torch.Tensor, rows: torch.Tensor, present: torch.Tensor, num_categories: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(counts, num_rows)``: [K] rows per code among valid, present rows
    with a code in [0, K), and the count of all valid rows, both of
    ``config.COUNT_DTYPE``."""
    from ..config import COUNT_DTYPE

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
    path = PATHS.index(plan_path(k, shared_limit(device)))
    # the counts and num_rows in one buffer, zeroed by the launch
    out = torch.empty(k + 1, dtype=torch.int64, device=device)
    status = lib.dict_code_counts_launch(
        codes.data_ptr(), rows.data_ptr(), present.data_ptr(), n, k, path, out.data_ptr(),
        stream_handle(device),
    )
    check_status(NAME, status)
    count_launch(NAME)
    if COUNT_DTYPE != torch.int64:
        out = out.to(COUNT_DTYPE)
    return out[:k], out[k]


def dict_code_counts_plain(
    codes: torch.Tensor, rows: torch.Tensor, present: torch.Tensor, num_categories: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The same function as the kernel in plain PyTorch (a bincount with
    one sentinel bin that is dropped), in ``config.COUNT_DTYPE``."""
    from ..config import COUNT_DTYPE

    k = int(num_categories)
    valid = rows & present & (codes >= 0) & (codes < k)
    keys = torch.where(valid, codes, k).to(torch.int64)
    counts = torch.bincount(keys, minlength=k + 1)[:k]
    return counts.to(COUNT_DTYPE), rows.sum(dtype=COUNT_DTYPE)
