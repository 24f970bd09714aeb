"""Hand-written CUDA kernels of the scan, one module per kernel.

Each module holds the kernel's wrapper, its plain PyTorch version and the
``ctypes`` binding of its library (built by :mod:`.build` from
``csrc/<name>.cu`` for ``sm_90a``). A wrapper runs the plain version for
tensors on the CPU and launches the kernel for tensors on a CUDA device, on
PyTorch's current stream; there is no fallback between the two.

Every wrapper adds one to its launch count where it launches its kernel,
so a run can show that its main path went through the kernels. The host
ingest tier's entries of ``state_fold`` and ``kll_compact`` count under
``state_fold_carry`` and ``kll_compact_ingest``."""

from __future__ import annotations

from typing import Dict

import torch

KERNEL_NAMES = (
    "scan_reduce", "hll_registers", "dict_code_counts", "kll_sample", "kll_compact",
    "freq_keys", "freq_compact", "state_fold",
    # the host ingest tier's entries of two of them, counted apart
    "state_fold_carry", "kll_compact_ingest",
)

_LAUNCHES: Dict[str, int] = {name: 0 for name in KERNEL_NAMES}


def launch_counts() -> Dict[str, int]:
    """Kernel launches since the last :func:`reset_launch_counts`."""
    return dict(_LAUNCHES)


def reset_launch_counts() -> None:
    for name in _LAUNCHES:
        _LAUNCHES[name] = 0


def count_launch(name: str) -> None:
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
                 n: int, device: torch.device) -> None:
    """Validate a 1-D input of ``n`` elements before its pointer goes to a
    kernel."""
    if t.dtype != dtype:
        raise TypeError(f"{name}: {what} must be {dtype}, got {t.dtype}")
    if t.dim() != 1 or t.shape[0] != n:
        raise ValueError(f"{name}: {what} must have shape ({n},), got {tuple(t.shape)}")
    if t.device != device:
        raise ValueError(f"{name}: {what} is on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: {what} must be contiguous")


def stream_handle(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream
