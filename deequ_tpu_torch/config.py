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
#: ``dict_code_counts``) when grouped; larger dictionaries take the device
#: frequency table
DEVICE_FREQ_MAX_CARDINALITY = 1 << 16

#: the device frequency table (kernels ``freq_keys`` and ``freq_compact``):
#: distinct-group capacity per grouping set (rounded up to a power of two,
#: capped at the row count), and the raw key buffer's cap in entries. Runs
#: whose padded rows fit the buffer keep every key there ("resident") and
#: never compact in the pass. ``do_analysis_run`` and the builders take
#: both as ``freq_table_slots`` and ``freq_buffer_entries``.
DEFAULT_FREQ_TABLE_SLOTS = 1 << 22
DEFAULT_FREQ_BUFFER_ENTRIES = 1 << 25

#: the cardinality probe that sends small grouping sets to the host
#: group-by: the largest product of per-column distinct counts it routes
#: to the host, the rows of each of its head, middle and tail slices, and
#: the row count at or below which it never routes to the host
FREQ_HOST_ROUTE_MAX_DISTINCT = 1 << 15
FREQ_PROBE_ROWS = 1 << 16
FREQ_HOST_ROUTE_MIN_ROWS = 1 << 21

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
