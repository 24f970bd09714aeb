"""K2 ``hll_registers``: HLL++ register maxima of one batch.

Replaces ``ApproxCountDistinct.update`` of the JAX reference
(deequ_tpu/analyzers/sketches.py:277, over ``chunked_key_fold``,
deequ_tpu/ops/__init__.py:9). The CUDA source is ``csrc/hll_registers.cu``;
:func:`hll_registers_plain` is the same function in plain PyTorch.
:func:`hll_registers_stacked` runs W sessions' batches in one launch (the
streaming service's coalesced fold, replacing the HLL update inside the
reference's ``PackedScanProgram.call_with_slots_stacked``,
deequ_tpu/runners/engine.py:501).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import build, check_status, check_tensor, count_launch, on_cuda, stream_handle

NAME = "hll_registers"
#: the stacked entry's launch-count name
NAME_STACKED = "hll_registers_stacked"
REGISTERS = 512


def _lib() -> ctypes.CDLL:
    lib = build.load(NAME)
    if not getattr(lib, "_deequ_bound", False):
        lib.hll_registers_stacked_launch.restype = ctypes.c_int
        lib.hll_registers_stacked_launch.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
        ]
        lib._deequ_bound = True
    return lib


def _validate(keys, rows, where, present, name: str) -> None:
    shape, device = tuple(keys.shape), keys.device
    check_tensor(keys, name, "keys", torch.uint16, shape, device)
    check_tensor(rows, name, "rows", torch.bool, shape, device)
    check_tensor(present, name, "present", torch.bool, shape, device)
    if where is not None:
        check_tensor(where, name, "where", torch.bool, shape, device)


def _launch(keys, rows, where, present) -> torch.Tensor:
    """One launch over ``[W, n]`` inputs; int32[W, 512] registers."""
    lib = _lib()
    width, n = keys.shape
    out = torch.zeros((width, REGISTERS), dtype=torch.int32, device=keys.device)
    status = lib.hll_registers_stacked_launch(
        keys.data_ptr(), rows.data_ptr(),
        None if where is None else where.data_ptr(), present.data_ptr(),
        n, width, out.data_ptr(), stream_handle(keys.device),
    )
    check_status(NAME, status)
    return out


def hll_registers(
    keys: torch.Tensor,
    rows: torch.Tensor,
    where: Optional[torch.Tensor],
    present: torch.Tensor,
) -> torch.Tensor:
    """int32[512] registers of the batch: for each register, the largest
    rank among valid rows (``rows & where & present``) whose packed key
    ``(register << 6) | rank`` names it; 0 where no valid row does."""
    if keys.dim() != 1:
        raise ValueError(f"{NAME}: keys must have one dimension, got {tuple(keys.shape)}")
    _validate(keys, rows, where, present, NAME)
    if not on_cuda(keys, NAME):
        return hll_registers_plain(keys, rows, where, present)
    out = _launch(keys[None], rows[None], None if where is None else where[None], present[None])
    count_launch(NAME)
    return out[0]


def hll_registers_stacked(
    keys: torch.Tensor,
    rows: torch.Tensor,
    where: Optional[torch.Tensor],
    present: torch.Tensor,
) -> torch.Tensor:
    """int32[W, 512]: :func:`hll_registers` of each of W sessions' batches
    in one launch (every input ``[W, n]``, session w in row w). Max is
    exact and order-free, so row w equals the one-batch registers bit for
    bit."""
    if keys.dim() != 2 or keys.shape[0] < 1:
        raise ValueError(f"{NAME_STACKED}: keys must be [W, n], got {tuple(keys.shape)}")
    _validate(keys, rows, where, present, NAME_STACKED)
    if not on_cuda(keys, NAME_STACKED):
        return hll_registers_stacked_plain(keys, rows, where, present)
    out = _launch(keys, rows, where, present)
    count_launch(NAME_STACKED)
    return out


def hll_registers_plain(
    keys: torch.Tensor,
    rows: torch.Tensor,
    where: Optional[torch.Tensor],
    present: torch.Tensor,
) -> torch.Tensor:
    """The same function as the kernel in plain PyTorch: the stacked plain
    version over one session."""
    return hll_registers_stacked_plain(
        keys[None], rows[None], None if where is None else where[None], present[None])[0]


def hll_registers_stacked_plain(
    keys: torch.Tensor,
    rows: torch.Tensor,
    where: Optional[torch.Tensor],
    present: torch.Tensor,
) -> torch.Tensor:
    """The stacked kernel's function in plain PyTorch: one scatter max
    along the register axis for all W sessions. PyTorch on the CPU has no
    ``>>`` for uint16, so keys widen to int32."""
    valid = rows & present
    if where is not None:
        valid = valid & where
    k = torch.where(valid, keys.to(torch.int32), 0)
    out = torch.zeros((keys.shape[0], REGISTERS), dtype=torch.int32, device=keys.device)
    return out.scatter_reduce_(1, (k >> 6).to(torch.int64), k & 63, "amax")
