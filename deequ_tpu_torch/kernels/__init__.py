"""Hand-written CUDA kernels of the scan, one module per kernel.

Each module holds the kernel's wrapper, its plain PyTorch version and the
``ctypes`` binding of its library (built by :mod:`.build` from
``csrc/<name>.cu`` for ``sm_90a``). A wrapper runs the plain version for
tensors on the CPU and launches the kernel for tensors on a CUDA device, on
PyTorch's current stream; there is no fallback between the two.

Every wrapper adds one to its launch count where it launches its kernel,
so a run can show that its main path went through the kernels. The host
ingest tier's entries of ``state_fold`` and ``kll_compact`` count under
``state_fold_carry`` and ``kll_compact_ingest``, and the streaming
service's stacked entries of ``scan_reduce`` and ``hll_registers`` (one
launch for a group of sessions) under ``scan_reduce_stacked`` and
``hll_registers_stacked``, K2's battery entry (every HLL column of a
battery's batch in one launch) under ``hll_registers_columns``, and the
mesh's entries of ``state_fold`` and
``kll_compact`` (the collective merge, the sharded host-tier fold) under
``state_fold_butterfly``, ``state_fold_carry_stacked`` and
``kll_compact_merge_stacked``. An entry's float32 instantiation (the
reference's 32-bit accumulator mode, ``DEEQU_TPU_NO_X64``) counts under its
name with ``_f32`` after it. The counts are safe to bump from the
service's worker threads."""

from __future__ import annotations

import threading
from typing import Dict, Optional, Tuple, Union

import torch

#: the launch counts of the float32 entries: the name of the float64
#: entry with ``_f32`` after it (:func:`entry_name`)
F32_ENTRIES = (
    "scan_reduce_f32", "scan_reduce_stacked_f32", "kll_sample_f32", "kll_compact_f32",
    "kll_compact_ingest_f32", "kll_compact_merge_stacked_f32", "state_fold_f32",
    "state_fold_carry_f32", "state_fold_carry_stacked_f32", "state_fold_butterfly_f32",
)

KERNEL_NAMES = (
    "scan_reduce", "hll_registers", "dict_code_counts", "kll_sample", "kll_compact",
    "freq_keys", "freq_compact", "state_fold",
    # the host ingest tier's entries of two of them, counted apart
    "state_fold_carry", "kll_compact_ingest",
    # the streaming service's stacked (coalesced) entries, counted apart
    "scan_reduce_stacked", "hll_registers_stacked",
    # K2's battery entry (every HLL column of a battery in one launch)
    "hll_registers_columns",
    # the mesh's entries of K8 and K5 (the collective merge, the sharded
    # host-tier fold), counted apart
    "state_fold_butterfly", "state_fold_carry_stacked", "kll_compact_merge_stacked",
    # the float32 entries (the 32-bit accumulator mode, DEEQU_TPU_NO_X64):
    # each entry above that reads or writes accumulators, counted apart
    *F32_ENTRIES,
)

_LAUNCHES: Dict[str, int] = {name: 0 for name in KERNEL_NAMES}
_LAUNCHES_LOCK = threading.Lock()


def launch_counts() -> Dict[str, int]:
    """Kernel launches since the last :func:`reset_launch_counts`."""
    with _LAUNCHES_LOCK:
        return dict(_LAUNCHES)


def reset_launch_counts() -> None:
    with _LAUNCHES_LOCK:
        for name in _LAUNCHES:
            _LAUNCHES[name] = 0


def count_launch(name: str) -> None:
    with _LAUNCHES_LOCK:
        _LAUNCHES[name] += 1


def entry_name(name: str, dtype: torch.dtype) -> str:
    """The launch-count name of an entry whose accumulators are ``dtype``:
    ``name`` for float64, ``name + "_f32"`` for float32."""
    return name + "_f32" if dtype == torch.float32 else name


def check_status(name: str, status: int) -> None:
    """Raise :class:`~.build.KernelLaunchError` when a C entry point
    reports a CUDA error (its ``cudaGetLastError()`` after the launch)."""
    if status != 0:
        from .build import KernelLaunchError

        raise KernelLaunchError(f"CUDA kernel {name} failed to launch: cudaError {status}")


def on_cuda(t: torch.Tensor, name: str) -> bool:
    """True for a CUDA tensor, False for a CPU one; raises for any other
    device, which no kernel of this package takes."""
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"{name}: unsupported device {t.device}")


def check_tensor(t: torch.Tensor, name: str, what: str, dtype: torch.dtype,
                 n: Union[int, Tuple[int, ...]], device: torch.device) -> None:
    """Validate an input of ``n`` elements (or of shape ``n``, a tuple)
    before its pointer goes to a kernel."""
    shape = n if isinstance(n, tuple) else (n,)
    if t.dtype != dtype:
        raise TypeError(f"{name}: {what} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name}: {what} must have shape {shape}, got {tuple(t.shape)}")
    if t.device != device:
        raise ValueError(f"{name}: {what} is on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: {what} must be contiguous")


def stream_handle(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


_SM_COUNTS: Dict[int, int] = {}


def sm_count(device: torch.device) -> int:
    """The number of SMs of ``device``'s card (read once a card), for
    sizing a launch to one wave."""
    index = device.index if device.index is not None else torch.cuda.current_device()
    sms = _SM_COUNTS.get(index)
    if sms is None:
        sms = _SM_COUNTS[index] = torch.cuda.get_device_properties(index).multi_processor_count
    return sms


#: per (kernel, device, stream): a kernel's scratch, zero between launches
_WORKSPACES: Dict[Tuple[str, Optional[int], int], torch.Tensor] = {}
_WORKSPACES_LOCK = threading.Lock()


def stream_workspace(name: str, device: torch.device, stream: int, numel: int,
                     dtype: torch.dtype) -> torch.Tensor:
    """Kernel ``name``'s scratch on one stream, at least ``numel`` elements,
    zeroed when made. The kernels that take one leave it zeroed at the end
    of every launch, and launches on one stream run in order, so it is
    never zeroed again: no launch needs a memset. Streams get their own,
    so launches on two streams never share one."""
    key = (name, device.index, stream)
    with _WORKSPACES_LOCK:
        ws = _WORKSPACES.get(key)
        if ws is None or ws.numel() < numel:
            ws = _WORKSPACES[key] = torch.zeros(numel, dtype=dtype, device=device)
        return ws
