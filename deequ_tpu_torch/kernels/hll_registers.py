"""K2 ``hll_registers``: HLL++ register maxima of one batch.

Replaces ``ApproxCountDistinct.update`` of the JAX reference
(deequ_tpu/analyzers/sketches.py:277, over ``chunked_key_fold``,
deequ_tpu/ops/__init__.py:9). The CUDA source is ``csrc/hll_registers.cu``;
:func:`hll_registers_plain` is the same function in plain PyTorch.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import build, check_status, check_tensor, count_launch, on_cuda, stream_handle

NAME = "hll_registers"
REGISTERS = 512


def _lib() -> ctypes.CDLL:
    lib = build.load(NAME)
    if not getattr(lib, "_deequ_bound", False):
        lib.hll_registers_launch.restype = ctypes.c_int
        lib.hll_registers_launch.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p,
        ]
        lib._deequ_bound = True
    return lib


def hll_registers(
    keys: torch.Tensor,
    rows: torch.Tensor,
    where: Optional[torch.Tensor],
    present: torch.Tensor,
) -> torch.Tensor:
    """int32[512] registers of the batch: for each register, the largest
    rank among valid rows (``rows & where & present``) whose packed key
    ``(register << 6) | rank`` names it; 0 where no valid row does."""
    n = keys.shape[0] if keys.dim() == 1 else -1
    device = keys.device
    check_tensor(keys, NAME, "keys", torch.uint16, n, device)
    check_tensor(rows, NAME, "rows", torch.bool, n, device)
    check_tensor(present, NAME, "present", torch.bool, n, device)
    if where is not None:
        check_tensor(where, NAME, "where", torch.bool, n, device)
    if not on_cuda(keys, NAME):
        return hll_registers_plain(keys, rows, where, present)
    lib = _lib()
    out = torch.zeros(REGISTERS, dtype=torch.int32, device=device)
    status = lib.hll_registers_launch(
        keys.data_ptr(), rows.data_ptr(),
        None if where is None else where.data_ptr(), present.data_ptr(),
        n, out.data_ptr(), stream_handle(device),
    )
    check_status(NAME, status)
    count_launch(NAME)
    return out


def hll_registers_plain(
    keys: torch.Tensor,
    rows: torch.Tensor,
    where: Optional[torch.Tensor],
    present: torch.Tensor,
) -> torch.Tensor:
    """The same function as the kernel in plain PyTorch (a scatter max).
    PyTorch on the CPU has no ``>>`` for uint16, so keys widen to int32."""
    valid = rows & present
    if where is not None:
        valid = valid & where
    k = torch.where(valid, keys.to(torch.int32), 0)
    out = torch.zeros(REGISTERS, dtype=torch.int32, device=keys.device)
    return out.scatter_reduce_(0, (k >> 6).to(torch.int64), k & 63, "amax")
