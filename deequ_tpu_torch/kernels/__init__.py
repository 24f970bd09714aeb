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
``hll_registers_stacked``. The counts are safe to bump from the service's
worker threads."""

from __future__ import annotations

import threading
from typing import Dict, Tuple, Union

import torch

KERNEL_NAMES = (
    "scan_reduce", "hll_registers", "dict_code_counts", "kll_sample", "kll_compact",
    "freq_keys", "freq_compact", "state_fold",
    # the host ingest tier's entries of two of them, counted apart
    "state_fold_carry", "kll_compact_ingest",
    # the streaming service's stacked (coalesced) entries, counted apart
    "scan_reduce_stacked", "hll_registers_stacked",
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


def check_status(name: str, status: int) -> None:
    """Raise when a C entry point reports a CUDA error (its
    ``cudaGetLastError()`` after the launch)."""
    if status != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: cudaError {status}")


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
