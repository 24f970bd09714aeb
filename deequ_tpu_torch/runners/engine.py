"""The shared scan: one pass over the data, every analyzer fed per batch.

A pass runs on one of two ingest tiers (``placement``), as the JAX
reference's ``ScanEngine`` does (deequ_tpu/runners/engine.py:1893, 2223):

- ``"device"``: per batch the engine builds the host features
  (``features.py``), copies them to the device, launches the kernels and
  folds the batch partials into the analyzers' states on the device.
- ``"host"``: a thread pool computes each batch's partial states on the
  host (``host_partial``, from the native library's block passes), and the
  device folds them in batch order, in chunks of 32: one ``state_fold``
  carry launch for every state but the KLL sketches and one
  ``kll_compact`` ingest launch per shape of sketch. The device traffic is
  the partials, independent of the rows.
- ``"auto"`` (the default) probes the host-to-device link once per process
  and takes the host tier below 500 MB/s.

Per pass the states come to the host once. The streaming service's
coalesced fold (:func:`fold_sessions_coalesced`) folds W sessions'
single batches with one stacked launch per kernel.

``sharding`` (a :class:`~deequ_tpu_torch.parallel.Mesh`) runs the pass
row-sharded over the mesh's shards on either tier (the reference's
``ScanEngine(sharding=mesh)``): the batch size rounds up to
``mesh_batch_quantum``; on the device tier each batch splits into the
shards' contiguous slices (:meth:`BundledScanProgram.call_sharded`); on
the host tier each shard folds its slice of every chunk of partials into
its own states through the elastic fold (``parallel.elastic``), which
survives the loss of shards, and the pass ends in the collective merge.
An ingest checkpointer (``checkpointer=``, ``reliability.checkpoint``)
makes a pass resumable on every tier.

A pass runs under the scan watchdog (``reliability.watchdog``) once a
deadline applies: past it the pass is abandoned with a typed
``ScanStallError``, and its engine's cancel event stops it at the next
batch boundary (no launch, fold, checkpoint or fault probe after it). The
device tier's batches come through the feed pipeline (``ingest.prefetch``):
at ``DEEQU_TPU_PREFETCH_DEPTH`` >= 1 a feed thread builds the next
batches' features while the launching thread copies this batch's to the
card and launches its kernels. A CUDA error at the wait after the kernels
raises as a ``KernelLaunchError`` (:func:`wait_kernels`). The runner wraps each pass in the reliability layer
(``reliability.isolation``): analyzer isolation, the device-to-host tier
failover, OOM batch bisection and the pass-level re-shard of a mesh.
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
import warnings
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..analyzers.base import (
    HostBatchContext,
    ScanShareableAnalyzer,
    SlotSpec,
    fold_layout,
    pack_states,
    resolve_slot,
    unpack_states,
)
from ..analyzers.sketches import ApproxCountDistinct
from ..analyzers.states import FrequencyTableState, leaves as state_leaves, with_leaves
from ..config import DEFAULT_BATCH_SIZE, DeviceLike, synchronize
from ..data import Dataset
from ..kernels.kll_compact import kll_compact_ingest
from ..kernels.scan_reduce import MAX_SLOTS, partials, scan_reduce, scan_reduce_stacked
from ..kernels.state_fold import state_fold_carry
from ..ops.kll import KLLSketchState
from ..reliability.faults import fault_point
from ..utils import BoundedLRU
from .features import FeatureBuilder


#: the reliability layer's counters, also tallied for the whole process: the
#: failovers, bisections, re-runs, stalls and shard losses of every
#: :class:`RunMonitor`, the service's fold monitors included
RECOVERY_COUNTERS = ("device_failovers", "batch_bisections", "isolation_reruns", "stalls",
                     "device_stalls", "shard_losses", "mesh_reshards")
_RECOVERIES: Dict[str, Any] = {}
_RECOVERIES_LOCK = threading.Lock()


def reset_recovery_counts() -> None:
    """Set the process's recovery tally to 0 (a drive does so before the
    runs it then shows needed none)."""
    with _RECOVERIES_LOCK:
        _RECOVERIES.clear()
        _RECOVERIES.update({name: 0 for name in RECOVERY_COUNTERS}, degraded=[])


def recovery_counts() -> Dict[str, Any]:
    """The recoveries of every run since :func:`reset_recovery_counts`:
    each of :data:`RECOVERY_COUNTERS` and ``degraded``, the degradations in
    the order they were noted."""
    with _RECOVERIES_LOCK:
        return {**_RECOVERIES, "degraded": list(_RECOVERIES["degraded"])}


reset_recovery_counts()


@dataclass
class RunMonitor:
    """Counts execution events and records per-phase wall time
    (``phase_seconds``), so a run's cost is attributable without external
    tooling. Phases: ``feature_build`` (host features, split by feature
    kind under ``feature_build.<kind>``; at a feed depth >= 1 summed from
    the feed thread), ``feed_wait`` (at a feed depth >= 1: the launching
    thread's wait for the feed thread's next batch), ``host_to_device``
    (copies and the wait for them), ``kernels`` (launches, state folds
    and the wait for them),
    ``host_accumulators`` (the host group-by's and the other host
    accumulators' batch folds),
    ``state_fetch`` (the device-to-host copy of the states); on the host
    tier ``host_partials`` (the pool's partial states, summed over its
    threads) and ``ingest_fold`` (stacking, copies and fold launches, ending
    in a synchronise); the runner adds ``drain`` (device frequency tables
    to counts) and ``metric_derivation``. ``device_freq_sets`` counts the
    grouping sets given a device frequency table, ``freq_overflow_fallbacks``
    those whose table dropped groups and re-ran on the host. ``placement``
    is the tier of the last pass, ``feed_bandwidth_mbps`` the link probe's
    reading where ``"auto"`` probed, ``ingest_folds`` the host tier's chunk
    folds and ``pattern_routes`` how the pass's pattern matches ran
    (``"pcre2"`` or Python's ``"re"``).

    The streaming service reads the rest: ``device_updates`` (batches the
    device tier folded), ``fast_path_folds`` and ``coalesced_folds`` (its
    two coalescing routes), ``cost_by_analyzer`` (seconds by analyzer
    repr: each batch's ``kernels`` time on the device tier and each
    chunk's ``ingest_fold`` time on the host tier, split evenly over the
    pass's battery, as the reference splits a bundle's dispatch time over
    its slots; exported per tenant, and a verification result's
    ``cost_by_analyzer``), and the reliability counters its scheduler
    harvests from the reliability layer: ``device_failovers`` (passes
    failed over to the host tier), ``batch_bisections`` (OOM batch
    halvings), ``isolation_reruns`` (battery bisection re-passes),
    ``stalls`` and ``device_stalls`` (watchdog deadlines, every tier and
    the device's), and ``degraded`` (the degradations, once each). A run
    over a mesh counts ``shard_losses``, ``mesh_reshards`` (in-pass and
    pass-level) and ``salvaged_states`` and notes its re-shards in
    ``degraded``. These are also tallied for the whole process
    (:func:`recovery_counts`). Every counter and phase is safe to bump from
    the feed and watchdog threads.

    Resumable ingest and incremental runs: ``checkpoint_saves`` (phase
    ``checkpoint``), ``resumed_at_batch`` (the batch a resumed pass
    re-entered at, None for a fresh one), the delta planner's
    ``partitions_scanned`` / ``partitions_reused`` /
    ``partitions_invalidated`` / ``partitions_dropped``, the partitions a
    merge took from the rollup cache (``partitions_rolled_up``) and the
    corrupt payloads quarantined or discarded (``corrupt_quarantined``)."""

    passes: int = 0
    batches: int = 0
    device_updates: int = 0
    fast_path_folds: int = 0
    coalesced_folds: int = 0
    device: Optional[str] = None
    device_freq_sets: int = 0
    freq_overflow_fallbacks: int = 0
    placement: Optional[str] = None
    feed_bandwidth_mbps: Optional[float] = None
    ingest_folds: int = 0
    pattern_routes: Dict[str, int] = field(default_factory=dict)
    phase_seconds: Dict[str, float] = field(default_factory=dict)
    cost_by_analyzer: Dict[str, float] = field(default_factory=dict)
    device_failovers: int = 0
    batch_bisections: int = 0
    isolation_reruns: int = 0
    stalls: int = 0
    device_stalls: int = 0
    degraded: List[str] = field(default_factory=list)
    #: mesh shards declared lost mid-pass, the re-shards one ladder rung
    #: down (the drop to host mode counts too), and the surviving shards'
    #: states salvaged into a canonical merge (``parallel.elastic``)
    shard_losses: int = 0
    mesh_reshards: int = 0
    salvaged_states: int = 0
    checkpoint_saves: int = 0
    resumed_at_batch: Optional[int] = None
    partitions_scanned: int = 0
    partitions_reused: int = 0
    partitions_invalidated: int = 0
    partitions_dropped: int = 0
    partitions_rolled_up: int = 0
    corrupt_quarantined: int = 0
    #: streaming folds sharded over a fleet sub-mesh
    #: (``service.coalesce``'s mesh fold)
    fleet_mesh_folds: int = 0
    _lock: Any = field(default_factory=threading.Lock, repr=False, compare=False)

    #: the counters :meth:`merge_from` adds up
    _COUNTERS = (
        "passes", "batches", "device_updates", "fast_path_folds", "coalesced_folds",
        "device_freq_sets", "freq_overflow_fallbacks", "ingest_folds",
        "device_failovers", "batch_bisections", "isolation_reruns", "stalls",
        "device_stalls", "shard_losses", "mesh_reshards", "salvaged_states",
        "checkpoint_saves", "partitions_scanned", "partitions_reused",
        "partitions_invalidated", "partitions_dropped", "partitions_rolled_up",
        "corrupt_quarantined", "fleet_mesh_folds",
    )

    def add_phase_time(self, phase: str, seconds: float) -> None:
        with self._lock:
            self.phase_seconds[phase] = self.phase_seconds.get(phase, 0.0) + seconds

    def bump(self, field_name: str, by: int = 1) -> None:
        """Locked counter increment (``+=`` on a dataclass int is not
        atomic across the service's worker threads)."""
        with self._lock:
            setattr(self, field_name, getattr(self, field_name) + by)
        if field_name in RECOVERY_COUNTERS:
            with _RECOVERIES_LOCK:
                _RECOVERIES[field_name] += by

    def attribute(self, keys: Sequence[str], seconds: float) -> None:
        """Split ``seconds`` evenly over ``keys`` in ``cost_by_analyzer``."""
        if not keys:
            return
        share = seconds / len(keys)
        with self._lock:
            for key in keys:
                self.cost_by_analyzer[key] = self.cost_by_analyzer.get(key, 0.0) + share

    def note_degraded(self, tag: str) -> None:
        """Record a degradation (``"mesh:8->4"``, ``"mesh:host"``) once."""
        with self._lock:
            if tag in self.degraded:
                return
            self.degraded.append(tag)
        with _RECOVERIES_LOCK:
            _RECOVERIES["degraded"].append(tag)

    def merge_from(self, other: "RunMonitor") -> None:
        """Absorb another monitor's counters and phase times: the service
        records a fold's costs into a fold-local monitor while the fold
        runs inside another job's launch, and the fold's own job absorbs
        them here once."""
        with other._lock:
            # a snapshot under the other monitor's lock: its pass may still
            # be adding phases from a feed or watchdog thread
            counters = {name: getattr(other, name) for name in self._COUNTERS}
            phases = dict(other.phase_seconds)
            costs = dict(other.cost_by_analyzer)
            degraded = list(other.degraded)
        with self._lock:
            for name, value in counters.items():
                setattr(self, name, getattr(self, name) + value)
            for phase, seconds in phases.items():
                self.phase_seconds[phase] = self.phase_seconds.get(phase, 0.0) + seconds
            for key, seconds in costs.items():
                self.cost_by_analyzer[key] = self.cost_by_analyzer.get(key, 0.0) + seconds
            self.degraded.extend(degraded)
            if other.placement is not None:
                self.placement = other.placement
            if other.device is not None:
                self.device = other.device
            if other.resumed_at_batch is not None:
                self.resumed_at_batch = other.resumed_at_batch

    def timed(self, phase: str) -> "_PhaseTimer":
        return _PhaseTimer(self, phase)


class _PhaseTimer:
    def __init__(self, monitor: RunMonitor, phase: str):
        self.monitor = monitor
        self.phase = phase

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.seconds = time.perf_counter() - self.t0
        self.monitor.add_phase_time(self.phase, self.seconds)
        return False


class BundledScanProgram:
    """The per-batch update of a battery. Analyzers whose update is a
    scalar reduction share ``scan_reduce`` launches: their slots are
    deduplicated and cut into bundles of at most ``MAX_SLOTS``, one launch
    per bundle per batch (for the usual battery, one launch in all). The
    HLL analyzers share one ``hll_registers_columns`` launch a batch, with
    their states folded in. The other analyzers (dictionary counts, KLL
    sketches, frequency tables) launch their own kernels.

    ``feature_keys`` lists the feature arrays the battery reads, ``rows``
    first, in order of first use, and ``layout`` is the battery's launch
    structure written over their positions: the slot table of each
    bundle, each analyzer's slot, and the positions each kernel-of-its-own
    analyzer reads. Two batteries with equal layouts (and equal analyzer
    signatures) stack position by position into one coalesced launch
    (:func:`fold_sessions_coalesced`); equal per-analyzer signatures alone
    do not suffice, since slots deduplicate (Mean("a") and Sum("a") share
    one, Mean("a") and Sum("b") do not). ``executed_widths`` holds the mesh
    widths (1: no mesh) at which the battery has launched in this process
    (:meth:`mark_executed`): the service's warmth."""

    def __init__(self, analyzers: Sequence[ScanShareableAnalyzer]):
        self.analyzers = tuple(analyzers)
        #: the mesh widths (1: no mesh) at which the battery has launched
        self.executed_widths: set = set()
        slot_index: Dict[SlotSpec, int] = {}
        #: per analyzer: its slot's index, or None for a kernel of its own
        self.slot_of: List[Optional[int]] = []
        for a in self.analyzers:
            spec = a.scan_slot()
            if spec is None:
                self.slot_of.append(None)
            else:
                self.slot_of.append(slot_index.setdefault(spec, len(slot_index)))
        specs = list(slot_index)
        self.bundles: List[List[SlotSpec]] = [
            specs[i:i + MAX_SLOTS] for i in range(0, len(specs), MAX_SLOTS)
        ]
        #: positions of the HLL analyzers, which update in one launch
        self.hll_of: List[int] = [i for i, a in enumerate(self.analyzers)
                                  if isinstance(a, ApproxCountDistinct)]
        position: Dict[str, int] = {"rows": 0}

        def at(key: Optional[str]) -> Optional[int]:
            return None if key is None else position.setdefault(key, len(position))

        self.layout = (
            tuple(tuple((spec[0],) + tuple(at(k) for k in spec[1:]) for spec in bundle)
                  for bundle in self.bundles),
            tuple(self.slot_of),
            tuple(None if slot is not None else tuple(at(f.key) for f in a.feature_specs())
                  for a, slot in zip(self.analyzers, self.slot_of)),
        )
        self.feature_keys: List[str] = list(position)

    def init_states(self, device) -> List[Any]:
        return [a.init_state(device) for a in self.analyzers]

    def mark_executed(self, width: int = 1) -> None:
        """The battery launched, on one device (``width`` 1) or sharded over
        a mesh of ``width`` shards (:meth:`call_sharded`): warm from now on
        at that width, under its own key and under the battery a user's
        checks name, which lacks the frequency scans the runner adds for
        grouping sets at run time (the router's warmth key,
        :func:`fused_program_is_cached`). A launch at one width says
        nothing of another: the sharded path runs other kernel entries."""
        if width in self.executed_widths:
            return
        self.executed_widths.add(width)
        from ..analyzers.grouping import DeviceFrequencyScan, DeviceFrequencyTableScan

        named = tuple(a for a in self.analyzers
                      if not isinstance(a, (DeviceFrequencyScan, DeviceFrequencyTableScan)))
        _WARM_BATTERIES[named if width == 1 else (named, ("__mesh__", width))] = True

    def __call__(self, states: Sequence[Any], features: Dict[str, torch.Tensor]) -> List[Any]:
        rows = features["rows"]
        outs = [
            scan_reduce([resolve_slot(spec, features) for spec in bundle], rows)
            for bundle in self.bundles
        ]
        hll = dict(zip(self.hll_of, ApproxCountDistinct.update_columns(
            [self.analyzers[i] for i in self.hll_of], [states[i] for i in self.hll_of],
            features))) if self.hll_of else {}
        new_states = []
        for i, (a, state, slot) in enumerate(zip(self.analyzers, states, self.slot_of)):
            if i in hll:
                new_states.append(hll[i])
            elif slot is None:
                new_states.append(a.update(state, features))
            else:
                out_i, out_f = outs[slot // MAX_SLOTS]
                new_states.append(a.fold_slot(state, partials(out_i, out_f, slot % MAX_SLOTS)))
        return new_states

    def call_sharded(self, states: Sequence[Any], features: Dict[str, torch.Tensor],
                     mesh) -> List[Any]:
        """:meth:`__call__` over a mesh (the reference's GSPMD
        ``sharded_update``, deequ_tpu/parallel/__init__.py:146): the
        batch's rows split into ``mesh.size`` contiguous slices; per card,
        one ``scan_reduce_stacked`` launch per bundle and one stacked launch
        per HLL analyzer, the shard the stacked axis; each such analyzer's
        shard states fold into its state in shard order, on ``mesh.home``
        (one ``state_fold`` launch for all). The other analyzers (KLL,
        dictionary counts, frequency tables) update on the whole batch, as
        the reference's program reads them as global arrays, so they equal
        the unsharded run's. ``states`` and ``features`` lie on
        ``mesh.home``."""
        from ..analyzers.base import _fold_launch
        from ..parallel import _is_stacked_kernel, shard_features

        n = mesh.size
        home = mesh.home
        sharded = shard_features(features, mesh)
        # per analyzer on the shard route: its n shard states, in order
        shards: List[Optional[List[Any]]] = [None] * len(self.analyzers)
        routed = [slot is not None or _is_stacked_kernel(a)
                  for a, slot in zip(self.analyzers, self.slot_of)]
        for device, positions in mesh.groups():
            if len(positions) == n and device == home:
                sub = sharded
            else:
                idx = torch.tensor(positions, device=home)
                sub = {k: v.index_select(0, idx).to(device) for k, v in sharded.items()
                       if v.dim() == 2}
            width = len(positions)
            outs = [scan_reduce_stacked([resolve_slot(spec, sub) for spec in bundle],
                                        sub["rows"])
                    for bundle in self.bundles]
            for i, (a, slot) in enumerate(zip(self.analyzers, self.slot_of)):
                if not routed[i]:
                    continue
                if slot is None:
                    got = a.update_stacked(sub, width, device)
                else:
                    out_i, out_f = outs[slot // MAX_SLOTS]
                    stacked = a.fold_slot(a.init_state(device),
                                          partials(out_i, out_f, slot % MAX_SLOTS))
                    got = [with_leaves(stacked, [leaf[w] for leaf in state_leaves(stacked)])
                           for w in range(width)]
                if shards[i] is None:
                    shards[i] = [None] * n
                for pos, st in zip(positions, got):
                    shards[i][pos] = st if device == home else with_leaves(
                        st, [leaf.to(home) for leaf in state_leaves(st)])
        jobs = [(i, [states[i]] + shards[i]) for i in range(len(self.analyzers)) if routed[i]]
        new_states = list(states)
        if jobs:
            for (i, _), st in zip(jobs, _fold_launch(jobs, fold_layout(), home)):
                new_states[i] = st
        for i, (a, state) in enumerate(zip(self.analyzers, states)):
            if not routed[i]:
                new_states[i] = a.update(state, features)
        return new_states


def to_device(features: Dict[str, np.ndarray], device: torch.device) -> Dict[str, torch.Tensor]:
    """Host feature arrays as tensors on ``device`` (zero-copy on the CPU)."""
    out = {}
    with warnings.catch_warnings():
        # zero-copy views of Arrow buffers are read-only; no kernel or plain
        # version writes to its inputs
        warnings.filterwarnings("ignore", message="The given NumPy array is not writable")
        for key, arr in features.items():
            t = torch.from_numpy(np.ascontiguousarray(arr))
            out[key] = t if device.type == "cpu" else t.to(device)
    return out


#: leaves of at least this many elements are copied to the host on their
#: own, not packed (packing copies them once more on the device)
FETCH_ALONE_ELEMENTS = 1 << 20


def _fetch_leaves(state) -> List[torch.Tensor]:
    leaves = state_leaves(state)
    if isinstance(state, FrequencyTableState):
        # only the filled part of the key buffer is ever read (the drain
        # reads buf[:buf_fill])
        leaves[3] = leaves[3][:state.fill]
    return leaves


def fetch_tensors(tensors: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """Bring tensors to the host: small ones with one copy per dtype
    (packed into one flat buffer per dtype on the device, copied and split
    back), large ones with a copy each. The copies wait for the stream
    that wrote the tensors."""
    host: List[Optional[torch.Tensor]] = [None] * len(tensors)
    by_dtype: Dict[torch.dtype, List[int]] = {}
    for i, t in enumerate(tensors):
        if t.numel() >= FETCH_ALONE_ELEMENTS:
            host[i] = t.cpu()
        else:
            by_dtype.setdefault(t.dtype, []).append(i)
    for idx in by_dtype.values():
        flat = torch.cat([tensors[i].reshape(-1) for i in idx]).cpu()
        offset = 0
        for i in idx:
            numel = tensors[i].numel()
            host[i] = flat[offset:offset + numel].reshape(tensors[i].shape)
            offset += numel
    return host


def fetch_states(states: Sequence[Any]) -> List[Any]:
    """Bring every state to the host with :func:`fetch_tensors` (a
    frequency table's filled key buffer only). Static fields (a sketch's
    size) stay as they are."""
    host = fetch_tensors([leaf for s in states for leaf in _fetch_leaves(s)])
    out = []
    pos = 0
    for s in states:
        n = len(state_leaves(s))
        out.append(with_leaves(s, host[pos:pos + n]))
        pos += n
    return out


#: the host-to-device bandwidth (MB/s) below which host partials beat
#: streaming the batches' features to the device (the reference's
#: threshold, deequ_tpu/runners/engine.py:1474)
FEED_BANDWIDTH_THRESHOLD_MBPS = 500.0
#: env var naming the default ingest tier when a caller passes none (the
#: reference's knob; "auto" when unset)
PLACEMENT_ENV = "DEEQU_TPU_PLACEMENT"
#: host partials folded per device launch (the reference's _INGEST_CHUNK)
INGEST_CHUNK = 32
PLACEMENTS = ("auto", "host", "device")

_FEED_PROBES: Dict[str, Tuple[float, float]] = {}


def _probe_feed(device: torch.device) -> Tuple[float, float]:
    """(bandwidth MB/s, round-trip latency s) of the link between the host
    and ``device``, measured once per process: an untimed warm-up, the best
    of three round trips of 4 KiB (the latency) and of 1 MiB, less the
    latency (the reference's probe, deequ_tpu/runners/engine.py:1477)."""
    key = str(device)
    probe = _FEED_PROBES.get(key)
    if probe is None:
        arr = torch.zeros(1 << 17, dtype=torch.float64)
        tiny = torch.zeros(512, dtype=torch.float64)
        arr.to(device).cpu()  # warm-up
        latency = float("inf")
        for _ in range(3):
            t0 = time.perf_counter()
            tiny.to(device).cpu()
            latency = min(latency, time.perf_counter() - t0)
        best = 0.0
        for _ in range(3):
            t0 = time.perf_counter()
            arr.to(device).cpu()
            transfer = max(time.perf_counter() - t0 - latency, 1e-9)
            best = max(best, 2 * arr.numel() * arr.element_size() / transfer / 1e6)
        probe = _FEED_PROBES[key] = (best, latency)
    return probe


def probe_feed_bandwidth(device: torch.device) -> float:
    """Measured host-to-device round-trip bandwidth in MB/s, cached per
    process and device; a CPU "device" has no link and reads +inf."""
    if device.type == "cpu":
        return float("inf")
    return _probe_feed(device)[0]


def probe_feed_latency(device: torch.device) -> float:
    """Round-trip latency of the host-to-device link in seconds (0 on the
    CPU)."""
    if device.type == "cpu":
        return 0.0
    return _probe_feed(device)[1]


def resolve_scan_placement(scan_analyzers: Sequence[ScanShareableAnalyzer],
                           placement: Optional[str], device: torch.device,
                           monitor: Optional[RunMonitor] = None) -> str:
    """The ingest tier of a pass (the reference's
    ``resolve_scan_placement``, deequ_tpu/runners/engine.py:1521), shared
    by the engine and the runner's gate for the device frequency tables:

    - a battery with any analyzer without a host partial streams to the
      device whatever the placement;
    - ``"host"`` and ``"device"`` are honoured otherwise;
    - ``"auto"`` probes the link: below ``FEED_BANDWIDTH_THRESHOLD_MBPS``
      the host tier wins. On the CPU there is no link, and the pass streams
      to the "device";
    - None reads ``DEEQU_TPU_PLACEMENT``, else ``"auto"``."""
    effective = default_placement(placement)
    if effective not in PLACEMENTS:
        raise ValueError(f"placement must be one of {PLACEMENTS}, got {placement!r}")
    if not scan_analyzers or not all(a.supports_host_partial for a in scan_analyzers):
        return "device"
    if effective == "host":
        return "host"
    if effective == "auto" and device.type != "cpu":
        bw = probe_feed_bandwidth(device)
        if monitor is not None:
            monitor.feed_bandwidth_mbps = bw
        if bw < FEED_BANDWIDTH_THRESHOLD_MBPS:
            return "host"
    return "device"


def default_placement(placement: Optional[str]) -> str:
    """``placement``, or ``DEEQU_TPU_PLACEMENT`` when None, else "auto"."""
    from ..utils import env_str

    return placement or env_str(PLACEMENT_ENV, "auto")


def stack_samples(samples: Sequence[Sequence[Tuple]], width: int,
                  to_device: Callable[[torch.Tensor], torch.Tensor]) -> List[torch.Tensor]:
    """``kll_compact_ingest``'s six sample fields for S sketches' B host
    samples each (``samples[s][b] = (items, m, h, nv, min, max)``), stacked
    on the host into one buffer per dtype (items, min and max float64; m
    and h int32; nv int64), each moved by ``to_device`` once."""
    s, b = len(samples), len(samples[0])
    n_items = s * b * width
    f64 = np.empty(n_items + 2 * s * b, dtype=np.float64)
    items = f64[:n_items].reshape(s, b, width)
    mins = f64[n_items:n_items + s * b].reshape(s, b)
    maxs = f64[n_items + s * b:].reshape(s, b)
    i32 = np.empty((2, s, b), dtype=np.int32)
    nv = np.empty((s, b), dtype=np.int64)
    for si, row in enumerate(samples):
        for bi, (its, m, h, n, mn, mx) in enumerate(row):
            items[si, bi] = its
            i32[0, si, bi], i32[1, si, bi] = m, h
            nv[si, bi], mins[si, bi], maxs[si, bi] = n, mn, mx
    d_f64 = to_device(torch.from_numpy(f64))
    d_i32 = to_device(torch.from_numpy(i32))
    return [d_f64[:n_items].view(s, b, width), d_i32[0], d_i32[1],
            to_device(torch.from_numpy(nv)), d_f64[n_items:n_items + s * b].view(s, b),
            d_f64[n_items + s * b:].view(s, b)]


class HostIngest:
    """The device half of the host tier: the battery's states, resident on
    the device for the whole pass, and the chunk folds into them.

    - Every state but a KLL sketch lives packed in ``state_fold``'s layout,
      one row per dtype (the carry). A batch's partials pack into the same
      layout on the pool's threads (:meth:`pack`); a chunk stacks them into
      ``[B, W]`` matrices, copies each once through pinned memory and folds
      them into the carry with one carry launch.
    - KLL sketches of one shape live stacked (items ``[S, L, 4k]``, ...);
      a chunk stacks their host samples likewise, copies them once per
      dtype and folds them with one ``kll_compact`` ingest launch.
    """

    def __init__(self, analyzers: Sequence[ScanShareableAnalyzer], device: torch.device):
        self.analyzers = list(analyzers)
        self.device = device
        init = [a.init_state(device) for a in self.analyzers]
        self.sketch_of = [isinstance(s, KLLSketchState) for s in init]
        self.layout = fold_layout()
        self.jobs = [[s] for s, kll in zip(init, self.sketch_of) if not kll]
        self.carry: List[torch.Tensor] = []
        if self.jobs:
            mats, self.slots, self.places = pack_states(self.jobs, self.layout)
            self.carry = [m[0].contiguous().to(device) for m in mats]
        #: per sketch shape (k, levels, width): the analyzers' positions
        #: and the stacked sketches
        self.sketch_groups: Dict[Tuple[int, int, int], Tuple[List[int], List[torch.Tensor]]] = {}
        for i, (s, kll) in enumerate(zip(init, self.sketch_of)):
            if kll:
                key = (s.sketch_size, *s.items.shape)
                self.sketch_groups.setdefault(key, ([], []))[0].append(i)
        for key, (idx, stacked) in self.sketch_groups.items():
            leaves = [init[i].tensors() for i in idx]
            stacked.extend(torch.stack(list(col)).contiguous() for col in zip(*leaves))

    def seed(self, states: Sequence[Any]) -> None:
        """Start the carry and the stacked sketches from ``states`` (a
        resumed checkpoint's, in battery order) in place of the identity."""
        if self.jobs:
            jobs = [[s] for s, kll in zip(states, self.sketch_of) if not kll]
            self.carry = [m[0].contiguous().to(self.device) for m in
                          pack_states(jobs, self.layout)[0]]
        for idx, stacked in self.sketch_groups.values():
            cols = zip(*[states[i].tensors() for i in idx])
            stacked[:] = [torch.stack([t.to(self.device, ref.dtype) for t in col]).contiguous()
                          for col, ref in zip(cols, list(stacked))]

    def pack(self, partials: Sequence[Any]) -> Tuple[List[torch.Tensor], List[Any]]:
        """One batch's partials as three packed host rows (float64, int64,
        int32) and its KLL samples."""
        rows: List[torch.Tensor] = []
        if self.jobs:
            parts = [[p] for p, kll in zip(partials, self.sketch_of) if not kll]
            mats = pack_states(parts, self.layout)[0]
            rows = [m[0] for m in mats]
        return rows, [p for p, kll in zip(partials, self.sketch_of) if kll]

    def _to_device(self, host: torch.Tensor) -> torch.Tensor:
        if self.device.type == "cpu":
            return host
        return host.pin_memory().to(self.device, non_blocking=True)

    def fold(self, chunk: Sequence[Tuple[List[torch.Tensor], List[Any]]]) -> None:
        """Fold a chunk of packed partials, in batch order."""
        if self.jobs:
            parts = [self._to_device(torch.stack([rows[d] for rows, _ in chunk]))
                     for d in range(3)]
            state_fold_carry(self.carry, parts, self.slots)
        positions = [i for i, kll in enumerate(self.sketch_of) if kll]
        for (k, _levels, width), (idx, stacked) in self.sketch_groups.items():
            at = [positions.index(i) for i in idx]
            samples = [[kll[j] for _, kll in chunk] for j in at]  # [S][B] samples
            kll_compact_ingest(stacked, stack_samples(samples, width, self._to_device), k)

    def states(self) -> List[Any]:
        """The analyzers' states on the device, in battery order (views of
        the carry and of the stacked sketches)."""
        out: List[Any] = [None] * len(self.analyzers)
        if self.jobs:
            folded = iter(unpack_states(self.jobs, self.places, self.carry))
            for i, kll in enumerate(self.sketch_of):
                if not kll:
                    out[i] = next(folded)
        for (k, _levels, _width), (idx, stacked) in self.sketch_groups.items():
            for si, i in enumerate(idx):
                out[i] = KLLSketchState(*(leaf[si] for leaf in stacked), sketch_size=k)
        return out


class ScanEngine:
    """One shared pass of the scan analyzers over a dataset on ``device``,
    on the ingest tier ``placement`` resolves to; with ``sharding`` (a
    mesh) row-sharded over its shards, on ``sharding.home``."""

    def __init__(
        self,
        scan_analyzers: Sequence[ScanShareableAnalyzer],
        device: torch.device,
        monitor: Optional[RunMonitor] = None,
        placement: Optional[str] = None,
        sharding: Optional[Any] = None,
    ):
        self.scan_analyzers = list(scan_analyzers)
        self.mesh = sharding
        self.device = device if sharding is None else sharding.home
        self.monitor = monitor or RunMonitor()
        self.placement = placement
        self.builder = FeatureBuilder(
            [s for a in self.scan_analyzers for s in a.feature_specs()]
        )
        self.program = _fused_program(tuple(self.scan_analyzers))
        #: the battery's keys in ``RunMonitor.cost_by_analyzer``
        self.cost_keys = [repr(a) for a in self.scan_analyzers]
        #: set when the watchdog abandons this engine's pass: the pass stops
        #: at its next batch boundary
        self._cancelled = threading.Event()

    def required_columns(self) -> List[str]:
        return self.builder.required_columns

    def run(
        self,
        data: Dataset,
        batch_size: Optional[int] = None,
        columns: Optional[Sequence[str]] = None,
        host_accumulators: Optional[Dict[Any, Any]] = None,
        host_update_fns: Optional[Dict[Any, Callable[[Any, Any], Any]]] = None,
        checkpointer: Optional[Any] = None,
    ) -> List[Any]:
        """Fold every batch into the analyzers' states; returns the states
        on the host, in analyzer order. ``host_accumulators`` (key -> state)
        fold each batch on the host in the same pass, through
        ``host_update_fns[key](state, batch)``; the dict is updated in
        place. ``checkpointer`` (a
        :class:`~deequ_tpu_torch.reliability.IngestCheckpointer`) persists
        the pass's states every ``checkpointer.every`` batches (on the host
        tier at the first chunk boundary past that, the mesh's states
        merged), and a pass over data of the same shape then restarts from
        its last checkpoint with the batch indices it had; a checkpointed
        pass rounds its batch size to the re-shard ladder's quantum, mesh or
        not, so its checkpoints resume on any mesh shape and on the plain
        host tier (the reference's ``ScanEngine.run``,
        deequ_tpu/runners/engine.py:2015-2075).

        The pass runs under the scan watchdog once a deadline applies
        (``DEEQU_TPU_SCAN_DEADLINE_S``, or one derived from the rates of
        this process's earlier passes on the tier): on a thread of its own,
        with this engine's device current, abandoned with a typed
        ``ScanStallError`` past its deadline (the reference's
        ``ScanEngine.run``, deequ_tpu/runners/engine.py:1933-2005). Only
        completed, representative passes teach the rate tracker."""
        from ..observability import trace as _trace
        from ..reliability.watchdog import (
            in_failover_pass,
            rate_key,
            rate_tracker,
            run_with_deadline,
            scan_deadline_s,
        )

        monitor = self.monitor
        host_states = host_accumulators if host_accumulators is not None else {}
        if not self.scan_analyzers and not host_states:
            monitor.bump("passes")
            monitor.device = str(self.device)
            return []
        bs = effective_batch_size(batch_size, self.mesh, checkpointed=checkpointer is not None)
        tier = resolve_scan_placement(self.scan_analyzers, self.placement, self.device, monitor)
        n_rows = max(1, int(data.num_rows))
        n_batches = max(1, -(-n_rows // bs))
        key = rate_key(tier, self.device)
        failed_tier = rate_key("device", self.device) if in_failover_pass() else None
        deadline = scan_deadline_s(n_rows, key, failed_tier)
        if deadline is not None and self.device.type == "cuda":
            # nvcc at first use can outlast any deadline: build the stale
            # kernels before the clock starts (once a process)
            from ..kernels.build import ensure_built

            ensure_built()
        warm = getattr(_WARM_RUN, "active", False)

        def body() -> List[Any]:
            return self._run_inner(data, bs, tier, columns, host_states, host_update_fns,
                                   checkpointer)

        batches_before = monitor.batches
        t0 = time.perf_counter()
        with _trace.span("engine_pass", kind="engine", tier=tier, rows=n_rows,
                         batches=n_batches, analyzers=len(self.scan_analyzers)):
            if deadline is None:
                states = body()
            else:
                states = run_with_deadline(body, deadline, monitor, tier, device=self.device,
                                           on_stall=self._cancelled.set)
        # only COMPLETED, representative passes teach the rate tracker: not a
        # background warm's 1-row sample, and only the batches this pass
        # folded (a resume skips the rest); a delta above the pass's own
        # batch count means another pass shared the monitor meanwhile
        if not warm:
            folded = monitor.batches - batches_before
            if 0 < folded <= n_batches:
                rate_tracker().observe(key, min(folded * bs, n_rows), time.perf_counter() - t0)
        return states

    def _run_inner(self, data: Dataset, bs: int, tier: str, columns, host_states,
                   host_update_fns, checkpointer) -> List[Any]:
        from ..native import pattern_routes

        monitor = self.monitor
        monitor.bump("passes")
        monitor.device = str(self.device)
        monitor.placement = tier
        for a in self.scan_analyzers:
            # one probe per analyzer per pass: the site through which a
            # drill pins "exactly the faulty analyzer degrades"
            with self._live():
                fault_point("analyzer", tag=repr(a))
        ckpt = None
        if checkpointer is not None:
            ckpt = _PassCheckpoint(checkpointer, bs, data, self.scan_analyzers, host_states,
                                   monitor)
        routes = pattern_routes()
        try:
            if tier == "host" and self.mesh is not None:
                states = self._run_host_tier_mesh(data, bs, columns, host_states,
                                                  host_update_fns, ckpt)
            elif tier == "host":
                states = self._run_host_tier(data, bs, columns, host_states, host_update_fns,
                                             ckpt)
            else:
                states = self._run_device_tier(data, bs, columns, host_states,
                                               host_update_fns, ckpt)
            if ckpt is not None:
                self._check_cancelled()
                ckpt.complete()
            return states
        finally:
            if not self._cancelled.is_set():
                for route, n in pattern_routes().items():
                    if n > routes[route]:
                        monitor.pattern_routes[route] = (
                            monitor.pattern_routes.get(route, 0) + n - routes[route])

    def _check_cancelled(self) -> None:
        """Stop an abandoned pass (the watchdog gave up on it and the
        caller has moved on: nothing it folds from here on is read)."""
        if self._cancelled.is_set():
            raise _PassAbandoned()

    @contextlib.contextmanager
    def _live(self):
        """Around a fault probe of the pass: never probed once the pass is
        abandoned, and a probe that held the pass past its deadline (an
        injected stall) stops it at once."""
        self._check_cancelled()
        yield
        self._check_cancelled()

    def _attribute(self, seconds: float) -> None:
        if not self._cancelled.is_set():
            self.monitor.attribute(self.cost_keys, seconds)

    def _fetch_pass_states(self, states: Sequence[Any]) -> List[Any]:
        """The pass's states to the host (phase ``state_fetch``)."""
        with self._live():
            fault_point("state_fetch")
        with self.monitor.timed("state_fetch"):
            return fetch_states(states)

    def _run_device_tier(self, data: Dataset, bs: int, columns, host_states,
                         host_update_fns, ckpt: Optional["_PassCheckpoint"] = None) -> List[Any]:
        """The device tier: per batch the features reach the device and the
        battery's kernels fold them into the states there. The batches come
        through the feed pipeline (:class:`_DeviceFeed` under
        ``ingest.prefetch.PrefetchingBatchIterator``) at the depth decided
        here, once: at depth 0, and for a one-batch pass, this thread builds
        each batch's features itself, as the serial loop always did; at
        depth >= 1 a feed thread builds the next batches' features while
        this thread copies the current one to the device and launches. Both
        depths give the same states bit for bit: the same batches reach the
        same kernels in the same order."""
        from ..ingest.prefetch import PrefetchingBatchIterator, prefetch_depth, staging_depth

        monitor = self.monitor
        states = self.program.init_states(self.device)
        start = 0
        if ckpt is not None and ckpt.resume is not None:
            start = ckpt.start
            states = ckpt.resumed_states(states, self.device)
        n_batches = max(1, -(-int(data.num_rows) // bs))
        depth = staging_depth(n_batches - start)
        depth = prefetch_depth() if depth is None else depth
        feed = _DeviceFeed(self, data.batches(bs, columns=columns, start_batch=start), start)
        with PrefetchingBatchIterator(feed.produce, depth=depth,
                                      stop=self._cancelled) as staged:
            while True:
                t0 = time.perf_counter()
                item = next(staged, None)
                if depth > 0:
                    monitor.add_phase_time("feed_wait", time.perf_counter() - t0)
                if item is None:
                    break
                index, batch, host_features = item
                self._check_cancelled()
                if self.scan_analyzers:
                    features = feed.place(index, host_features)
                    with self._live():
                        fault_point("device_update", tag=str(index + 1))
                    with monitor.timed("kernels") as timer:
                        if self.mesh is None:
                            states = self.program(states, features)
                        else:
                            states = self.program.call_sharded(states, features, self.mesh)
                        wait_kernels(self.device)
                    self._attribute(timer.seconds)
                    monitor.bump("device_updates")
                    self.program.mark_executed(1 if self.mesh is None else self.mesh.size)
                if host_states:
                    with monitor.timed("host_accumulators"):
                        for key, fn in host_update_fns.items():
                            host_states[key] = fn(host_states[key], batch)
                monitor.bump("batches")
                if ckpt is not None and (index + 1) % ckpt.every == 0:
                    self._check_cancelled()
                    ckpt.save(index + 1, states)
        self._check_cancelled()
        if not self.scan_analyzers:
            return []
        return self._fetch_pass_states(states)

    def _host_pipeline(self, data: Dataset, bs: int, columns, host_states, host_update_fns,
                       chunk: int, compute_partial, fold, start: int = 0, host_start: int = 0,
                       after_fold: Optional[Callable[[int, int], None]] = None) -> None:
        """The host tier's pipeline (the reference's ``_run_host_tier``,
        deequ_tpu/runners/engine.py:2223): a pool of ``os.cpu_count()``
        threads computes each batch's partial (``compute_partial(index,
        batch)``), at most ``workers + chunk`` batches in flight; the
        partials fold in submission order (the KLL sampler's offset keys on
        the batch index) through ``fold(partials, first_index)`` in chunks
        of ``chunk``, the last chunk holding what is left. Host accumulators
        fold each batch on the submitting thread meanwhile. A resumed pass
        starts at batch ``start`` (a chunk boundary), its host accumulators
        at ``host_start``; ``after_fold(folded, submitted)`` runs after each
        full chunk's fold (the checkpoints)."""
        monitor = self.monitor
        workers = os.cpu_count() or 1
        window = workers + chunk
        pending: deque = deque()
        buffer: List[Any] = []
        folded = start
        submitted = start

        def drain_one() -> None:
            nonlocal folded
            buffer.append(pending.popleft().result())
            if len(buffer) == chunk:
                fold(list(buffer), folded)
                folded += chunk
                buffer.clear()
                if after_fold is not None:
                    after_fold(folded, submitted)

        with ThreadPoolExecutor(max_workers=workers) as pool:
            for index, batch in enumerate(
                data.batches(bs, columns=columns, pad_to_batch_size=False, start_batch=start),
                start,
            ):
                self._check_cancelled()
                monitor.bump("batches")
                pending.append(pool.submit(compute_partial, index, batch))
                submitted = index + 1
                if host_states and index >= host_start:
                    with monitor.timed("host_accumulators"):
                        for key, fn in host_update_fns.items():
                            host_states[key] = fn(host_states[key], batch)
                while len(pending) > window:
                    drain_one()
            while pending:
                drain_one()
        if buffer:
            fold(list(buffer), folded)
        self._check_cancelled()

    def _run_host_tier(self, data: Dataset, bs: int, columns, host_states,
                       host_update_fns, ckpt: Optional["_PassCheckpoint"] = None) -> List[Any]:
        """The host ingest tier on one device: :meth:`_host_pipeline` in
        chunks of 32, each chunk one fold into the carry."""
        monitor = self.monitor
        analyzers = self.scan_analyzers
        ingest = HostIngest(analyzers, self.device)
        start = host_start = 0
        if ckpt is not None and ckpt.resume is not None:
            start, host_start = ckpt.start, ckpt.host_start
            ingest.seed(ckpt.resumed_states(ingest.states(), self.device))
        # one token per pass: host partials may skip what an earlier batch
        # of the SAME pass contributed (the HLL dictionary memo), never
        # across passes
        run_token = object()

        def compute_partial(index: int, batch) -> Tuple[List[torch.Tensor], List[Any]]:
            with self._live():
                fault_point("host_partial", tag=str(index))
            t0 = time.perf_counter()
            ctx = HostBatchContext(batch, batch_index=index, run_token=run_token)
            packed = ingest.pack([a.host_partial(ctx) for a in analyzers])
            monitor.add_phase_time("host_partials", time.perf_counter() - t0)
            return packed

        def fold(chunk, first: int) -> None:
            with self._live():
                fault_point("ingest_fold")
            with monitor.timed("ingest_fold") as timer:
                ingest.fold(chunk)
                wait_kernels(self.device)
            self._attribute(timer.seconds)
            monitor.bump("ingest_folds")

        def after_fold(folded: int, submitted: int) -> None:
            self._check_cancelled()
            if ckpt.due(folded):
                ckpt.save(folded, ingest.states(), host_batch_index=submitted)

        self._host_pipeline(data, bs, columns, host_states, host_update_fns, INGEST_CHUNK,
                            compute_partial, fold, start, host_start,
                            after_fold if ckpt is not None else None)
        return self._fetch_pass_states(ingest.states())

    def _run_host_tier_mesh(self, data: Dataset, bs: int, columns, host_states,
                            host_update_fns, ckpt: Optional["_PassCheckpoint"] = None
                            ) -> List[Any]:
        """The host tier over a mesh (the reference's ``_run_host_tier`` with a
        mesh, deequ_tpu/runners/engine.py:2248-2264, 2480-2550):
        :meth:`_host_pipeline` computes each batch's partials as on one
        device; a chunk holds
        ``local_chunk = max(1, 32 // n)`` partials per shard, shard s folding
        the chunk's slice ``[s * local_chunk, (s + 1) * local_chunk)`` into
        its own states (``ElasticMeshFold.fold``: ``state_fold_carry_stacked``,
        ``kll_compact_ingest`` over every shard's sketches); the last chunk is
        padded with flagged-off partials. Batches lost with dead shards are
        recomputed (with a fresh memo token) and re-folded, then the pass ends
        in the collective merge (``ElasticMeshFold.finish``). Checkpoints
        hold the shards' merged (canonical) states, which a resume seeds
        into shard 0 of whatever mesh it runs on (``ElasticMeshFold.seed``)."""
        from ..observability import trace as _trace
        from ..parallel import ElasticMeshFold
        from ..parallel.dcn import stack_partials

        monitor = self.monitor
        analyzers = self.scan_analyzers
        mesh = self.mesh
        local_chunk = max(1, INGEST_CHUNK // mesh.size)
        chunk = local_chunk * mesh.size
        elastic = ElasticMeshFold(analyzers, mesh, monitor=monitor)
        start = host_start = 0
        if ckpt is not None and ckpt.resume is not None:
            start, host_start = ckpt.start, ckpt.host_start
            home = mesh.home
            elastic.seed(tuple(ckpt.resumed_states(
                [a.init_state(home) for a in analyzers], home)), start)
        run_token = object()

        def compute_partial(index: int, batch, token=None) -> Tuple:
            with self._live():
                fault_point("host_partial", tag=str(index))
            t0 = time.perf_counter()
            ctx = HostBatchContext(batch, batch_index=index,
                                   run_token=run_token if token is None else token)
            partial = tuple(a.host_partial(ctx) for a in analyzers)
            monitor.add_phase_time("host_partials", time.perf_counter() - t0)
            return partial

        def fold(group: List[Tuple], indices: List[int]) -> None:
            n_real = len(group)
            group = group + [group[0]] * (chunk - n_real)
            flags = np.zeros(chunk, dtype=bool)
            flags[:n_real] = True
            with self._live():
                fault_point("ingest_fold")
            with monitor.timed("ingest_fold") as timer:
                elastic.fold(stack_partials(analyzers, group), flags, indices)
                wait_kernels(elastic.mesh.home if not elastic.host_mode else None)
            self._attribute(timer.seconds)
            monitor.bump("ingest_folds")

        def after_fold(folded: int, submitted: int) -> None:
            self._check_cancelled()
            # a shard loss leaves batches awaiting replay, which the merge
            # does not cover yet: no checkpoint until they are back
            if not ckpt.due(folded) or elastic.pending_replay:
                return
            canonical = elastic.canonical()
            if not elastic.pending_replay:
                ckpt.save(folded, list(canonical), host_batch_index=submitted)

        self._host_pipeline(
            data, bs, columns, host_states, host_update_fns, chunk, compute_partial,
            lambda group, first: fold(group, list(range(first, first + len(group)))),
            start, host_start, after_fold if ckpt is not None else None)

        def replay_pending() -> None:
            # a fresh memo token per round: the pass token's cross-batch skip
            # (the HLL dictionary memo) may have credited an entry to a batch
            # the dead shard owned
            todo = set(elastic.take_lost_batches())
            _trace.add_event("mesh_replay", batches=len(todo))
            token = object()
            group: List[Tuple] = []
            indices: List[int] = []
            last = max(todo)
            for index, batch in enumerate(
                data.batches(bs, columns=columns, pad_to_batch_size=False)
            ):
                if index > last:
                    break
                self._check_cancelled()
                if index not in todo:
                    continue
                group.append(compute_partial(index, batch, token))
                indices.append(index)
                if len(group) == chunk:
                    fold(group, indices)
                    group, indices = [], []
            if group:
                fold(group, indices)

        while True:
            while elastic.pending_replay:
                replay_pending()
            with monitor.timed("collective_merge"):
                states = elastic.finish()
                wait_kernels(None if elastic.host_mode else elastic.mesh.home)
            if not elastic.pending_replay:
                break
        return self._fetch_pass_states(states)


class _PassAbandoned(Exception):
    """Raised inside a pass the watchdog abandoned, at its next batch
    boundary: the caller already failed over, and nothing the pass folds
    is read."""


#: per-thread flag of a background warm's run (a 1-row sample that must
#: not teach the watchdog's rate tracker)
_WARM_RUN = threading.local()


class _DeviceFeed:
    """The device tier's feed: :meth:`produce` returns the next ``(index,
    batch, host features)`` or None at the end (on the feed thread at a
    depth >= 1, phase ``feature_build``), and :meth:`place` copies a
    batch's features to the device on the launching thread and waits for
    the copy (phase ``host_to_device``; on the CPU the features are views
    of the host arrays)."""

    def __init__(self, engine: "ScanEngine", batches, start: int):
        self.engine = engine
        self.batches = batches
        self.index = start

    def produce(self):
        engine = self.engine
        if engine._cancelled.is_set():
            return None
        try:
            batch = next(self.batches)
        except StopIteration:
            return None
        index = self.index
        self.index += 1
        if not engine.scan_analyzers:
            return index, batch, None
        kinds: Dict[str, float] = {}
        with engine.monitor.timed("feature_build"):
            host_features = engine.builder.build(batch, kinds)
        for phase, seconds in kinds.items():
            engine.monitor.add_phase_time(phase, seconds)
        return index, batch, host_features

    def place(self, index: int, host_features: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        """The batch's features on the device."""
        engine = self.engine
        with engine._live():
            fault_point("device_feed", tag=str(index))
        with engine.monitor.timed("host_to_device"):
            features = to_device(host_features, engine.device)
            synchronize(engine.device)
        return features


def wait_kernels(device: Optional[torch.device]) -> None:
    """Wait for the kernels just launched on ``device``. Torch reports a
    kernel's CUDA error (an illegal address, a failed assert) at this wait,
    not at the launch, and everything queued before the launches was
    waited for already: so a CUDA error here is the kernels' own, and
    raises as a ``KernelLaunchError``, which no recovery absorbs."""
    try:
        synchronize(device)
    except RuntimeError as exc:
        from ..reliability.isolation import as_kernel_error, classify_failure

        if classify_failure(exc) not in ("kernel", "device"):
            raise
        error = as_kernel_error(exc)
        if error is exc:
            raise
        raise error from exc


def effective_batch_size(batch_size: Optional[int] = None, mesh=None,
                         checkpointed: bool = False) -> int:
    """The rows per batch of a pass (every batch of the device tier is
    padded to it); over a mesh, or with an ingest checkpointer, rounded up
    to ``mesh_batch_quantum``, so every batch splits evenly over the shards
    and keeps its boundaries when the mesh shrinks a rung, and a checkpoint
    pins the same batch size on any mesh shape and without one
    (deequ_tpu/runners/engine.py:2021-2033)."""
    bs = int(batch_size or DEFAULT_BATCH_SIZE)
    if mesh is not None or checkpointed:
        from ..parallel import mesh_batch_quantum

        q = mesh_batch_quantum(1 if mesh is None else mesh.size)
        bs = -(-bs // q) * q
    return bs


class _PassCheckpoint:
    """A pass's side of its ingest checkpointer: the epoch that fences
    earlier passes, the resume point (``start``, the first batch the pass
    folds; ``host_start``, the host accumulators'), and the saves."""

    def __init__(self, checkpointer, bs: int, data: Dataset, analyzers: Sequence[Any],
                 host_states: Dict[Any, Any], monitor: RunMonitor):
        self.checkpointer = checkpointer
        self.every = checkpointer.every
        self.bs = bs
        self.num_rows = int(data.num_rows)
        self.analyzers = list(analyzers)
        self.host_states = host_states
        self.monitor = monitor
        self.epoch = checkpointer.begin_run()
        self.resume = checkpointer.load(bs, self.num_rows, self.analyzers, list(host_states),
                                        monitor=monitor)
        self.start = self.host_start = 0
        if self.resume is not None:
            self.start = self.resume.batch_index
            self.host_start = self.resume.host_batch_index
            monitor.resumed_at_batch = self.start
            host_states.update(self.resume.host_states)
        self.saved = self.start

    def resumed_states(self, templates: Sequence[Any], device: torch.device) -> List[Any]:
        """The checkpoint's scan states as copies on ``device``, each leaf in
        its template's dtype (a loaded state lies on the CPU)."""
        return [with_leaves(s, [leaf.to(device=device, dtype=t.dtype, copy=True)
                                for leaf, t in zip(state_leaves(s), state_leaves(tmpl))])
                for s, tmpl in zip(self.resume.scan_states, templates)]

    def due(self, folded: int) -> bool:
        return folded - self.saved >= self.every

    def save(self, folded: int, states: Sequence[Any],
             host_batch_index: Optional[int] = None) -> None:
        with self.monitor.timed("checkpoint"):
            self.checkpointer.save(folded, self.bs, self.num_rows, self.analyzers,
                                   fetch_states(states), self.host_states,
                                   host_batch_index=host_batch_index, epoch=self.epoch)
        self.monitor.bump("checkpoint_saves")
        self.saved = folded

    def complete(self) -> None:
        self.checkpointer.complete(self.epoch)


# ---------------------------------------------------------------------------
# The streaming service's hooks: battery programs, warmth, the coalesced fold
# ---------------------------------------------------------------------------

#: battery -> its BundledScanProgram (analyzers are frozen dataclasses, so
#: equal batteries share one program and its ``executed_widths`` warmth);
#: LRU-bounded so a service cycling through many batteries does not grow
_PROGRAM_CACHE = BoundedLRU(256)
_PROGRAM_CACHE_LOCK = threading.Lock()
#: the batteries (without run-time frequency scans) of programs that have
#: launched in this process
_WARM_BATTERIES = BoundedLRU(256)
_SCAN_SIG_CACHE = BoundedLRU(4096)


def _fused_program(battery: Tuple[ScanShareableAnalyzer, ...]) -> BundledScanProgram:
    """The cached program of this exact battery (built under a lock, so one
    instance per battery carries its warmth)."""
    with _PROGRAM_CACHE_LOCK:
        program = _PROGRAM_CACHE.get(battery)
        if program is None:
            # fault site: the port's counterpart of the reference's fused
            # program build (its "compile")
            fault_point("compile", tag=str(len(battery)))
            program = BundledScanProgram(battery)
            _PROGRAM_CACHE[battery] = program
        return program


def _deduped_battery(analyzers) -> Tuple[ScanShareableAnalyzer, ...]:
    """The scan-shareable subset, deduplicated in first-encounter order
    (the runner's own normalization), so warmth keys match real runs."""
    return tuple(dict.fromkeys(a for a in analyzers if isinstance(a, ScanShareableAnalyzer)))


def _scan_signature(a: ScanShareableAnalyzer) -> Tuple:
    """What an analyzer's device update is, independent of its columns:
    its class, its state's class and leaf shapes and dtypes (a sketch's
    size), the kinds of its features and the pattern in which its feature
    keys repeat (a where-filter equal to a predicate collapses positions).
    Sessions whose batteries agree on every analyzer's signature, and on
    the battery's layout, can fold in one stacked launch."""
    sig = _SCAN_SIG_CACHE.get(a)
    if sig is None:
        state = a.init_state(torch.device("cpu"))
        keys = [spec.key for spec in a.feature_specs()]
        sig = (
            type(a), type(state),
            tuple((tuple(t.shape), t.dtype) for t in state_leaves(state)),
            tuple(spec.kind for spec in a.feature_specs()),
            tuple(keys.index(k) for k in keys),
        )
        _SCAN_SIG_CACHE[a] = sig
    return sig


def mesh_width(mesh) -> int:
    """The shard count of a mesh-like value: a
    :class:`~deequ_tpu_torch.parallel.Mesh`, a fleet
    :class:`~deequ_tpu_torch.service.fleet.SubMeshLease`, an int, or None
    (1)."""
    if mesh is None:
        return 1
    if isinstance(mesh, int):
        return mesh
    n = getattr(mesh, "n_dev", None)
    if n is not None:
        return int(n)
    return int(getattr(mesh, "size", 1))


def fused_program_is_cached(analyzers: Sequence[ScanShareableAnalyzer], mesh=None) -> bool:
    """Whether this battery's program, or a program of it with the
    frequency scans a run added for its grouping sets, has launched in
    this process (its kernels are then built and loaded): the service's
    warmth. Over a ``mesh`` of more than one shard (a mesh, a lease or a
    shard count), only a launch of the sharded path at that width counts
    (the reference keys its programs by the mesh's devices,
    deequ_tpu/runners/engine.py:919)."""
    battery = _deduped_battery(analyzers)
    width = mesh_width(mesh)
    program = _PROGRAM_CACHE.get(battery)
    key = battery if width == 1 else (battery, ("__mesh__", width))
    return (program is not None and width in program.executed_widths) or bool(
        _WARM_BATTERIES.get(key))


def detached_warm_sample(data: Dataset) -> Dataset:
    """A 1-row deep copy of the dataset for a background warm: a zero-copy
    slice would keep the parent table's buffers alive while the warm sits
    queued. The IPC round trip copies the row and each dictionary
    column's dictionary."""
    import pyarrow as pa

    head = data.arrow.slice(0, 1)
    sink = pa.BufferOutputStream()
    with pa.ipc.new_stream(sink, head.schema) as writer:
        writer.write_table(head)
    table = pa.ipc.open_stream(sink.getvalue()).read_all()
    return Dataset(table, probe_encoding=False)


def warm_fused_program(
    analyzers: Sequence[Any],
    data: Dataset,
    batch_size: Optional[int] = None,
    device: DeviceLike = None,
    mesh=None,
) -> None:
    """Make a battery warm ahead of its first production run: run the real
    device-tier pipeline over the first row of ``data`` on ``device`` (or
    sharded over ``mesh``, whose width it then warms), building the
    kernels (``nvcc`` compiles them at first use) and launching each
    once."""
    from .analysis_runner import AnalysisRunner

    sample = Dataset(data.arrow.slice(0, 1), probe_encoding=False)
    _WARM_RUN.active = True
    try:
        AnalysisRunner.do_analysis_run(
            sample, list(analyzers), batch_size=batch_size or DEFAULT_BATCH_SIZE,
            placement="device", device=device, sharding=mesh,
        )
    finally:
        _WARM_RUN.active = False


def _stack_to_device(arrays: Sequence[np.ndarray], device: torch.device) -> torch.Tensor:
    """W sessions' arrays of one feature as one ``[W, n]`` tensor on
    ``device``: written row by row into one pinned host buffer and copied
    once."""
    if device.type == "cpu":
        return torch.from_numpy(np.stack(arrays))
    first = torch.from_numpy(np.ascontiguousarray(arrays[0]))
    buf = torch.empty((len(arrays), first.shape[0]), dtype=first.dtype, pin_memory=True)
    buf[0].copy_(first)
    for w in range(1, len(arrays)):
        buf[w].copy_(torch.from_numpy(np.ascontiguousarray(arrays[w])))
    return buf.to(device, non_blocking=True)


def fold_sessions_coalesced(
    programs: Sequence[BundledScanProgram],
    features_list: Sequence[Dict[str, np.ndarray]],
    device: torch.device,
    monitor: Optional[RunMonitor] = None,
) -> List[List[Any]]:
    """Fold W sessions' single padded batches with one stacked launch per
    kernel: the streaming service's coalesced device fold (the reference's
    ``fold_sessions_coalesced``, deequ_tpu/runners/engine.py:818, over
    ``init_carry_stacked`` :490, ``call_with_slots_stacked`` :501 and
    ``unpack_stacked_final`` :514).

    ``programs[w]`` is session w's battery program and ``features_list[w]``
    its host features; every program has the first one's layout and
    analyzer signatures (the coalesce key guarantees it), so the features
    stack by position: each array of the layout becomes one ``[W, n]``
    tensor, copied to ``device`` once through pinned memory. Then, per
    slot bundle, one ``scan_reduce_stacked`` launch; per HLL analyzer one
    ``hll_registers_stacked`` launch; per KLL analyzer one ``kll_sample``
    and one ``kll_compact`` launch per session, on its row (stacking them
    is later work). Each slot analyzer folds its slot's ``[W]`` partials
    into a fresh state on ``device`` with its ``fold_slot`` (elementwise,
    so each session's leaves are the serial fold's bit for bit), and every
    state comes back in one fetch (one copy per dtype), split per session
    on the host: session w's states equal a one-batch device-tier pass
    over its batch bit for bit. W is launched as it is, not padded (a CUDA
    launch takes any grid).

    Returns per session its host states in battery order. ``monitor``
    records the group's ``host_to_device``, ``kernels`` and
    ``state_fetch`` seconds."""
    template = programs[0]
    width = len(features_list)
    mon = monitor if monitor is not None else RunMonitor()
    with mon.timed("host_to_device"):
        stacked = {
            key: _stack_to_device(
                [feats[prog.feature_keys[p]] for prog, feats in zip(programs, features_list)],
                device)
            for p, key in enumerate(template.feature_keys)
        }
    with mon.timed("kernels"):
        rows = stacked["rows"]
        outs = [
            scan_reduce_stacked([resolve_slot(spec, stacked) for spec in bundle], rows)
            for bundle in template.bundles
        ]
        # per analyzer, its W sessions' states: a list of W states (a
        # kernel of its own) or one state whose leaves carry the session
        # axis in front (a slot)
        folded: List[Any] = []
        for a, slot in zip(template.analyzers, template.slot_of):
            if slot is None:
                folded.append(a.update_stacked(stacked, width, device))
            else:
                out_i, out_f = outs[slot // MAX_SLOTS]
                folded.append(a.fold_slot(a.init_state(device),
                                          partials(out_i, out_f, slot % MAX_SLOTS)))
        wait_kernels(device)
    with mon.timed("state_fetch"):
        leaves = [[leaf for st in f for leaf in state_leaves(st)] if isinstance(f, list)
                  else state_leaves(f) for f in folded]
        host = fetch_tensors([leaf for ls in leaves for leaf in ls])
    per_analyzer: List[List[Any]] = []
    pos = 0
    for f, ls in zip(folded, leaves):
        got = host[pos:pos + len(ls)]
        pos += len(ls)
        if isinstance(f, list):
            n = len(ls) // width
            per_analyzer.append([with_leaves(st, got[w * n:(w + 1) * n])
                                 for w, st in enumerate(f)])
        else:
            per_analyzer.append([with_leaves(f, [leaf[w] for leaf in got])
                                 for w in range(width)])
    for program in programs:
        program.mark_executed()
    return [[states[w] for states in per_analyzer] for w in range(width)]
