"""Device resolution and numeric defaults of the PyTorch/CUDA port.

Every entry point takes ``device=`` and defaults to ``"cuda"``. Without a
card, and unless the caller asked for the CPU explicitly, resolution
raises: a verification run never carries on quietly on the CPU. On the CPU
the kernel wrappers run their plain PyTorch versions (see
``deequ_tpu_torch/kernels``).

The reference (deequ) computes in JVM doubles, so accumulators are float64
and counters int64, which holds the +-1e-6 metric parity target.
``DEEQU_TPU_NO_X64=1`` set before import opts out, as it does in the JAX
reference: accumulators are then float32 and counters int32 everywhere the
reference gives them those types (plain float32 sums, no compensated
summation, as in the reference). The mode is read once, when this module
is imported, and holds for the process.
"""

from __future__ import annotations

import os
from typing import Optional, Union

import torch

#: "1" (any non-empty value) before import: 32-bit accumulators. The
#: numeric features then cross to the device as float32 (rounded to
#: nearest from the host's float64), the kernels take their float32 entries
#: (K1 scan_reduce, K4 kll_sample, K5 kll_compact's scalars, K8
#: state_fold) and states hold float32 sums and moments and int32 counts;
#: the device frequency table (uint64 keys) is off, and grouping sets take
#: the dictionary scan or the host group-by. Persisted states carry their
#: leaves' dtypes (the v2 blob's digest hashes them).
NO_X64_ENV = "DEEQU_TPU_NO_X64"
_X64 = not os.environ.get(NO_X64_ENV)

#: dtype of floating-point accumulator states (sums, moments, ...)
ACC_DTYPE = torch.float64 if _X64 else torch.float32
#: dtype of integer counters
COUNT_DTYPE = torch.int64 if _X64 else torch.int32


def x64_enabled() -> bool:
    """Whether accumulators are 64-bit: False when ``DEEQU_TPU_NO_X64``
    was set when this module was imported (the counterpart of the
    reference's ``jax.config.jax_enable_x64``)."""
    return _X64

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

# Engine placement, the host tier, the feature cache and profiling
# (implemented in ``runners/engine.py``, ``runners/analysis_runner.py``,
# ``native/lib.py`` and ``data/__init__.py``; documented here with the
# other operator-facing switches, as the reference's ``config.py`` does):
#
# - DEEQU_TPU_PLACEMENT: the ingest tier when a run names none: "auto"
#   (probe the feed link), "host" or "device".
# - DEEQU_TPU_HOST_TIER_WORKERS: the host tier's pool of partial workers
#   (0 or unset: every core; a bad value warns once and keeps that). The
#   states are the same at every pool size.
# - DEEQU_TPU_DEVICE_FEATURE_CACHE: the device feature cache's budget in GB
#   of the run device's memory; unset or "0" is off (the default). A
#   repeated device-tier pass over the same table then builds and copies
#   nothing; whole least-recently-used tables are evicted.
# - DEEQU_TPU_PROFILE_DIR: a directory receiving a ``torch.profiler``
#   Chrome trace of every pass (CPU and CUDA activity); unset is off.
# - DEEQU_TPU_NO_NATIVE: "1" runs every host kernel's numpy version
#   (``native/plain.py``) instead of the C++ library; read when
#   ``deequ_tpu_torch.native.lib`` is imported.
# - DEEQU_TPU_ADAPTIVE_DICT_ENCODE: "0" turns off the ingest-time
#   dictionary encoding of low-cardinality string columns.
#
# Three knobs of the reference drive XLA and have no counterpart here:
# DEEQU_TPU_NO_COMPILE_CACHE (XLA's persistent compile cache; the port's
# kernels are built once into ``kernels/_build``), DEEQU_TPU_SCAN_BUNDLE
# (bundling XLA programs; the port launches one kernel a battery) and
# DEEQU_TPU_SLIM_FETCH (the JAX state fetch; the port's ``fetch_states``).
# DEEQU_TPU_NO_X64 (the 32-bit accumulators) is ``NO_X64_ENV`` above.

# ---------------------------------------------------------------------------
# Ingestion plane (implemented in ``ingest/prefetch.py``). Both follow the
# warn-and-fallback convention: an unparseable value warns once and keeps
# the default.
#
# - DEEQU_TPU_PREFETCH_DEPTH: staged batches in the device tier's feed
#   pipeline, a knob of the tuning registry (``tuning/knobs.py``). The
#   port's static default is 0, the serial loop with no feed thread (the
#   reference's is 2); at depth >= 1 a feed thread builds each batch's
#   features while the launching thread copies and launches. The states
#   are the same at every depth.
# - DEEQU_TPU_FEED_STALL_S: seconds the launching thread tolerates a
#   SILENT feed thread before declaring it wedged with a typed
#   FeedStallError (default 120; <= 0 disables). A tripped deadline fails
#   the pass over to the host tier exactly like a thrown device fault. At
#   depth 0 there is no feed thread, so nothing can stall.
# ---------------------------------------------------------------------------

# ---------------------------------------------------------------------------
# Cross-session fold coalescing + tiny-delta host fast path (implemented in
# ``service/coalesce.py``). All follow the warn-and-fallback convention.
#
# - DEEQU_TPU_COALESCE: "0" disables the whole coalescing plane: every
#   streaming ingest takes exactly the serial fold path (the escape hatch;
#   default on).
# - DEEQU_TPU_COALESCE_MAX_WIDTH: max sessions stacked into one coalesced
#   launch (default 16), a knob of the tuning registry.
# - DEEQU_TPU_FAST_PATH_MAX_ROWS: fixed row ceiling for the host fast
#   path, a knob of the tuning registry. Default -1 = route from the
#   MEASURED per-analyzer-class crossover (host rates observed on every
#   fast fold against the device's fixed cost observed on every coalesced
#   launch); 0 forces every eligible fold onto the coalesced device path.
# ---------------------------------------------------------------------------

# ---------------------------------------------------------------------------
# Fleet scheduler (implemented in ``service/fleet.py``).
#
# - DEEQU_TPU_FLEET: "0" disables fleet scheduling entirely (single-table
#   routing, the service path without a fleet); unset = ON exactly when
#   the visible CUDA cards are more than one. Unlike the reference, where
#   "1" forces the fleet on even on the CPU backend, "1" here forces it on
#   only when the service's device table holds more than one shard (a
#   ``fleet_devices=N`` table or a multi-card one); over a table of one
#   shard it warns once and the fleet stays off. Any other value warns
#   once and keeps the default policy. When on, every tenant's batch scans
#   shard across that tenant's DISJOINT slice of the device table.
# - DEEQU_TPU_FLEET_STREAM_MIN_ROWS: minimum micro-batch rows before a
#   streaming fold shards over the tenant's slice (default 65536; 0
#   shards every eligible fold), a knob of the tuning registry.
# ---------------------------------------------------------------------------

# ---------------------------------------------------------------------------
# Partition-aware incremental verification (implemented in
# ``repository/partition_store.py`` and ``runners/incremental.py``).
#
# - DEEQU_TPU_PARTITION_STORE: root path (local, or any URI
#   ``deequ_tpu_torch.io`` opens: s3://, gs://, memory://) of the
#   service-default PartitionStateStore. When set, VerificationService
#   plans incremental runs against it and streaming sessions flush their
#   cumulative states into it as a partition on close. Unset = no default
#   store (pass one explicitly).
# - DEEQU_TPU_PARTITION_WINDOW_MONTHS: default listing window, in month
#   buckets, for partition listings with no explicit window (0 =
#   unlimited, the default). The store's directory layout is
#   time-partitioned (YYYY-MM buckets for date-named partitions), so this
#   knob bounds the default walk for dropped-partition detection on very
#   old stores. Unparseable values warn once and keep the default.
# ---------------------------------------------------------------------------

# ---------------------------------------------------------------------------
# Fleet watch, the standing fleet-scale anomaly plane (implemented in
# ``service/fleetwatch.py``). All three follow the warn-and-fallback
# convention via the shared ``utils`` parsers.
#
# - DEEQU_TPU_FLEETWATCH: "0" detaches the standing watch from scheduler
#   harvests (an explicit FleetWatch.harvest_now() still scores); default
#   on. When attached, every completed job of a WATCHED tenant triggers one
#   debounced scoring pass over every watched tenant's metric history.
# - DEEQU_TPU_FLEETWATCH_WINDOW_MONTHS: metric-history window each harvest
#   scores, in month buckets (default 12; 0 = unbounded).
# - DEEQU_TPU_FLEETWATCH_BUNDLE: maximum series stacked into one batched
#   detect_batch call (default 16384; larger fleets chunk).
# ---------------------------------------------------------------------------

# ---------------------------------------------------------------------------
# Tenant isolation plane (``service/catalog.py`` and ``ingest/rowgate.py``).
# All three parse via the shared warn-once ``utils.env_number``:
# unparseable or out-of-range values log once and keep the default.
#
# - DEEQU_TPU_CATALOG_HOT_TTL_S: seconds a catalog-opened session may sit
#   idle in the HOT tier before the plane's sweep() closes it back to COLD
#   (default 300.0; minimum 0.0). Cold tenants cost one registry row, not
#   a session.
# - DEEQU_TPU_CATALOG_POLL_S: debounce on the fold-boundary version poll
#   of a hot tenant's catalog document (default 2.0; minimum 0.0). A
#   catalog edit becomes effective within one poll interval at the next
#   fold boundary, with no restart; 0 polls every fold.
# - DEEQU_TPU_ROWGATE_QUARANTINE_MAX_ROWS: total rows a quarantine sidecar
#   retains per (tenant, dataset) before further rejects are counted but
#   dropped (default 100000; minimum 0).
# ---------------------------------------------------------------------------

# ---------------------------------------------------------------------------
# Host group-by spill tier (implemented in ``analyzers/grouping.py``'s host
# accumulator). All three follow the warn-and-fallback convention via
# ``utils.env_number`` / ``env_flag``.
#
# - DEEQU_TPU_MAX_FREQUENCY_ENTRIES: host frequency-table entry budget
#   before the accumulator spills to disk (0 = unbounded, the default).
# - DEEQU_TPU_FREQUENCY_SPILL: "0" disables the disk spill tier (the
#   budget then degrades the analyzer instead of spilling).
# - DEEQU_TPU_FREQUENCY_SPILL_PARTITIONS: hash partitions of the spill
#   store's disk layout (default 64; minimum 1).
# ---------------------------------------------------------------------------

# ---------------------------------------------------------------------------
# Deterministic fault injection (implemented in ``reliability/faults.py``;
# ``tools/torch_chaos_soak.py`` drives these).
#
# - DEEQU_TPU_FAULTS: JSON list of FaultSpec dicts arming a process-wide
#   fault plan. Deliberately NOT warn-and-fallback: a chaos plan that does
#   not parse must raise, not silently run the drill fault-free.
# - DEEQU_TPU_FAULT_SEED: rng seed for p-based fault specs (default 0).
#   Same raise-loudly contract as the plan: a bad seed would silently
#   change the drill's deterministic fault sequence.
# ---------------------------------------------------------------------------

# ---------------------------------------------------------------------------
# Scan watchdog and elastic mesh (implemented in ``reliability/watchdog.py``,
# ``parallel/elastic.py`` and ``parallel/health.py``).
#
# - DEEQU_TPU_SCAN_DEADLINE_S: per-pass watchdog deadline in seconds.
#   Unset = derive from the measured per-batch rate of completed passes on
#   the same tier (a 10x multiple with a 30 s floor; none until a first
#   rate exists; rates are kept apart for the card and for a CPU run). Any
#   value <= 0 disables the watchdog; an unparseable one warns once and
#   keeps the derived deadline. A pass exceeding its deadline is cancelled
#   with a typed ScanStallError and fails over to the other tier exactly
#   like a thrown device fault; a failover pass always has a deadline (the
#   failed tier's, or the floor).
# - DEEQU_TPU_MESH_LADDER: comma-separated descending device counts the
#   re-shard ladder walks after a shard loss (default "8,4,2,1");
#   unparseable values warn once and keep the default. When no rung fits
#   the survivors, the fold drops to host mode with the salvaged states,
#   except on a mesh whose shards all lie on one card: there
#   MeshExhaustedError escapes and the run fails.
# - DEEQU_TPU_SHARD_HEARTBEAT_S: seconds between heartbeat probes of a live
#   mesh fold, and each probe's per-shard deadline (default 5.0; <= 0
#   disables the periodic heartbeat). A shard missing its heartbeat is
#   declared lost exactly like a thrown ShardLossError.
# ---------------------------------------------------------------------------

# ---------------------------------------------------------------------------
# Tracing / flight recorder (implemented in ``observability/``).
#
# - DEEQU_TPU_TRACE: span tracing. Default ON ("1"/unset); "0" disables
#   entirely; a float in (0, 1) samples that fraction of root traces
#   deterministically (unparseable values warn once and keep the default).
# - DEEQU_TPU_TRACE_RING: capacity of the flight-recorder ring of recent
#   finished spans (default 4096, floor 16): what /trace serves and what
#   typed-failure post-mortem dumps snapshot.
# - DEEQU_TPU_TRACE_JOURNAL: directory receiving this process's span
#   JOURNAL (``spans-<host>.jsonl``, one span per line as it finishes):
#   the per-host half of a cross-process merged trace. Unset = no journal.
# - DEEQU_TPU_TRACE_HOST: the host label stamped on this process's journal
#   filename and header (default ``pid<pid>``).
# - DEEQU_TPU_FLIGHT_DIR: directory receiving the flight-record JSONL
#   artifacts dumped on typed failures. Unset = a per-process temporary
#   directory.
# ---------------------------------------------------------------------------

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
