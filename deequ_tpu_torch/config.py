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

#: the constants above are the static defaults of the tuning registry
#: (``tuning/knobs.py``), which the runner and the grouping router read
#: through: env override > tuned value > static default. Their env
#: overrides: DEEQU_TPU_DEVICE_FREQ_MAX_CARDINALITY,
#: DEEQU_TPU_FREQ_TABLE_SLOTS, DEEQU_TPU_FREQ_BUFFER_ENTRIES,
#: DEEQU_TPU_FREQ_HOST_ROUTE_MAX_DISTINCT, DEEQU_TPU_FREQ_PROBE_ROWS and
#: DEEQU_TPU_FREQ_HOST_ROUTE_MIN_ROWS. Two switches: "0" turns the device
#: frequency table off (every grouping set that is not a small dictionary
#: column takes the host group-by), and "0" turns the cardinality probe off
#: (no set is routed to the host group-by for looking small).
DEVICE_FREQ_ENV = "DEEQU_TPU_DEVICE_FREQ"
FREQ_HOST_ROUTE_ENV = "DEEQU_TPU_FREQ_HOST_ROUTE"

# The self-tuning plane (``deequ_tpu_torch.tuning``: calibration, substrate
# profiles, the online controller), under the reference's env names:

#: "0" disables the whole plane: no profile load, no controller, every
#: knob its env override or static default (default on)
AUTOTUNE_ENV = "DEEQU_TPU_AUTOTUNE"
#: directory of the checksummed per-substrate profiles (default: a
#: ``deequ_tpu_tuning`` directory beside ``DEEQU_TPU_COMPILE_CACHE``'s
#: default); corrupt or stale files are quarantined into ``.quarantine/``
TUNING_PROFILE_DIR_ENV = "DEEQU_TPU_TUNING_PROFILE_DIR"
#: fraction of eligible folds routed under a candidate while a shadow
#: experiment runs (default 0.05, capped at 0.5; 0 starves candidates)
TUNING_SHADOW_FRACTION_ENV = "DEEQU_TPU_TUNING_SHADOW_FRACTION"
#: measured folds each experiment arm needs before a verdict (default 32)
TUNING_MIN_SAMPLES_ENV = "DEEQU_TPU_TUNING_MIN_SAMPLES"
#: the promotion band, and how far below the static rate the floor
#: guardrail lets the live rate fall before it demotes (default 0.25)
TUNING_BAND_ENV = "DEEQU_TPU_TUNING_BAND"

# The cluster tier (``deequ_tpu_torch.cluster`` and
# ``repository/lease.py``), under the reference's names and env names. All
# five parse via the warn-once ``utils.env_number``: unparseable or
# out-of-range values log once and keep the default.

#: virtual nodes per host on the front tier's consistent-hash ring
#: (default 64; minimum 1); a membership change re-homes ~1/N of the keys
CLUSTER_VNODES_ENV = "DEEQU_TPU_CLUSTER_VNODES"
#: seconds between a worker's heartbeat writes into the shared membership
#: directory (default 0.5; minimum 0.05)
CLUSTER_HEARTBEAT_ENV = "DEEQU_TPU_CLUSTER_HEARTBEAT_S"
#: seconds without a beat before the front tier declares a host lost and
#: recovers its sessions (default 3.0; minimum 0.1)
CLUSTER_HOST_TTL_ENV = "DEEQU_TPU_CLUSTER_HOST_TTL_S"
#: seconds a compaction lease stays valid without renewal (default 30.0;
#: minimum 0.1)
CLUSTER_LEASE_TTL_ENV = "DEEQU_TPU_CLUSTER_LEASE_TTL_S"
#: payloads a session's loss-replay journal may hold before the front tier
#: force-flushes the session to the partition store (default 256; minimum 1)
CLUSTER_JOURNAL_MAX_FOLDS_ENV = "DEEQU_TPU_CLUSTER_JOURNAL_MAX_FOLDS"

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
