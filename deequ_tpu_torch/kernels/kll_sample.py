"""K4 ``kll_sample``: the batch pre-collapse of the KLL update.

Replaces the row work of ``kll_update`` in the JAX reference
(deequ_tpu/ops/kll.py:233-266). The CUDA source is ``csrc/kll_sample.cu``;
:func:`kll_sample_plain` is the same function in plain PyTorch. Its outputs
stay on the device and feed K5 (``kll_compact``) directly.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch

from ..ops.order import masked_max, masked_min
from . import build, check_status, check_tensor, count_launch, on_cuda, stream_handle

NAME = "kll_sample"
#: items per block of a radix pass; equals KS_TILE in csrc/kll_sample.cu
TILE = 4096
RADIX = 256
#: the largest finite float32, the bound the values are clipped to
F32_MAX = float(torch.finfo(torch.float32).max)
#: multiplier of the update counter in the sample offset (Knuth's hash)
OFFSET_MULTIPLIER = 2654435761


class Sample(NamedTuple):
    """K4's device outputs for one batch."""

    samples: torch.Tensor  # float32[k], +inf past m
    meta: torch.Tensor     # int32[3]: m items picked, level h, n kept values
    minmax: torch.Tensor   # float64[2]: min and max of the kept values


def _lib() -> ctypes.CDLL:
    lib = build.load(NAME)
    if not getattr(lib, "_deequ_bound", False):
        lib.kll_sample_tile.restype = ctypes.c_int
        lib.kll_sample_tile.argtypes = []
        lib.kll_sample_launch.restype = ctypes.c_int
        lib.kll_sample_launch.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ]
        if lib.kll_sample_tile() != TILE:
            raise RuntimeError("kll_sample library and wrapper disagree on TILE")
        lib._deequ_bound = True
    return lib


def kll_sample(
    values: torch.Tensor,
    rows: torch.Tensor,
    where: Optional[torch.Tensor],
    present: Optional[torch.Tensor],
    ticks: torch.Tensor,
    k: int,
) -> Sample:
    """Pre-collapse one batch for a sketch of size ``k`` whose update
    counter is ``ticks`` (int32, 0-d). The kept values are those of rows
    ``rows & where & present`` that are not NaN. CPU tensors take
    :func:`kll_sample_plain`; CUDA tensors launch the kernel."""
    n = values.shape[0] if values.dim() == 1 else -1
    device = values.device
    check_tensor(values, NAME, "values", torch.float64, n, device)
    check_tensor(rows, NAME, "rows", torch.bool, n, device)
    for what, mask in (("where", where), ("present", present)):
        if mask is not None:
            check_tensor(mask, NAME, what, torch.bool, n, device)
    if ticks.dtype != torch.int32 or ticks.numel() != 1 or ticks.device != device:
        raise ValueError(f"{NAME}: ticks must be one int32 on {device}")
    if k < 1:
        raise ValueError(f"{NAME}: sketch size must be positive, got {k}")
    if n >= 1 << 31:
        raise ValueError(f"{NAME}: takes fewer than 2^31 rows, got {n}")
    if not on_cuda(values, NAME):
        return kll_sample_plain(values, rows, where, present, ticks, k)
    lib = _lib()
    tiles = -(-n // TILE)
    scratch = torch.empty(4 * n, dtype=torch.int32, device=device)
    hist = torch.empty(max(RADIX * tiles, 1), dtype=torch.int32, device=device)
    count = torch.empty(1, dtype=torch.int32, device=device)
    order_mm = torch.empty(2, dtype=torch.int64, device=device)
    out = Sample(
        torch.empty(k, dtype=torch.float32, device=device),
        torch.empty(3, dtype=torch.int32, device=device),
        torch.empty(2, dtype=torch.float64, device=device),
    )
    status = lib.kll_sample_launch(
        values.data_ptr(), rows.data_ptr(),
        None if where is None else where.data_ptr(),
        None if present is None else present.data_ptr(),
        n, k, ticks.data_ptr(), scratch.data_ptr(), hist.data_ptr(),
        count.data_ptr(), order_mm.data_ptr(), out.samples.data_ptr(),
        out.meta.data_ptr(), out.minmax.data_ptr(), stream_handle(device),
    )
    check_status(NAME, status)
    count_launch(NAME)
    return out


def sort_key(x: torch.Tensor) -> torch.Tensor:
    """The values as sort keys in which -0.0 and +0.0 are equal: a stable
    sort on them keeps zeros in input order, as the reference's sort does
    (torch's own float order on CUDA does not promise that)."""
    return torch.where(x == 0, torch.zeros_like(x), x)


def stable_sort(x: torch.Tensor) -> torch.Tensor:
    """``x`` sorted ascending, stably, with signed zeros equal."""
    return x[torch.sort(sort_key(x), stable=True).indices]


def sample_level(n: int, k: int) -> int:
    """h: the least h with n <= k * 2^h (0 for n <= k), which the
    reference computes as ceil(log2(float32(ceil(n / k))))."""
    return (max(-(-n // k), 1) - 1).bit_length()


def sample_offset(ticks: int, h: int) -> int:
    """First picked position: a hash of the update counter, mod 2^h."""
    r = ((ticks & 0xFFFFFFFF) * OFFSET_MULTIPLIER & 0xFFFFFFFF) >> 7
    return r % (1 << h)


def kll_sample_plain(
    values: torch.Tensor,
    rows: torch.Tensor,
    where: Optional[torch.Tensor],
    present: Optional[torch.Tensor],
    ticks: torch.Tensor,
    k: int,
) -> Sample:
    """The same function as the kernel in plain PyTorch, bit for bit. It
    reads n and the counter on the host, which the kernel never does."""
    device = values.device
    keep = rows.clone()
    for mask in (where, present):
        if mask is not None:
            keep &= mask
    keep &= ~torch.isnan(values)
    n = int(keep.sum())
    inf = float("inf")
    minmax = torch.stack([masked_min(values, keep), masked_max(values, keep)])
    items = torch.where(keep, values.clamp(-F32_MAX, F32_MAX), inf).to(torch.float32)
    h = sample_level(n, k)
    stride = 1 << h
    offset = sample_offset(int(ticks), h)
    pos = offset + torch.arange(k, dtype=torch.int64, device=device) * stride
    picked = pos < n
    samples = torch.full((k,), inf, dtype=torch.float32, device=device)
    if n:
        sv = stable_sort(items)
        samples = torch.where(picked, sv[pos.clamp(max=items.shape[0] - 1)], samples)
    m = int(picked.sum())
    meta = torch.tensor([m, h, n], dtype=torch.int32, device=device)
    return Sample(samples, meta, minmax)
