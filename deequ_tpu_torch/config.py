"""Device resolution and numeric defaults of the PyTorch/CUDA port.

Every entry point takes ``device=`` and defaults to ``"cuda"``. Without a
card, and unless the caller asked for the CPU explicitly, resolution
raises: a verification run never carries on quietly on the CPU. On the CPU
the kernel wrappers run their plain PyTorch versions (see
``deequ_tpu_torch/kernels``).

The reference (deequ) computes in JVM doubles, so accumulators are float64
and counters int64, which holds the +-1e-6 metric parity target.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

#: dtype of floating-point accumulator states (sums, moments, ...)
ACC_DTYPE = torch.float64
#: dtype of integer counters
COUNT_DTYPE = torch.int64

#: default number of rows per device batch
DEFAULT_BATCH_SIZE = 1 << 20

#: dictionary sizes up to this ride the device frequency scan (kernel
#: ``dict_code_counts``); grouping over larger dictionaries is outside this
#: port's slice
DEVICE_FREQ_MAX_CARDINALITY = 1 << 16

DEFAULT_DEVICE = "cuda"

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """The device a run executes on: ``cuda`` unless the caller names
    another. Raises when CUDA is asked for (explicitly or by default) and
    no card is visible — there is no fallback to the CPU."""
    dev = torch.device(DEFAULT_DEVICE if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "deequ_tpu_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run the plain PyTorch versions "
            "of the kernels on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    return dev


def synchronize(device: Optional[torch.device]) -> None:
    """Wait for the work queued on ``device`` (no-op on the CPU)."""
    if device is not None and device.type == "cuda":
        torch.cuda.current_stream(device).synchronize()
