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
The reliability wrapper, the watchdog and checkpoints are not part of the
port; any other device failure raises.
"""

from __future__ import annotations

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
from ..utils import BoundedLRU
from .features import FeatureBuilder


@dataclass
class RunMonitor:
    """Counts execution events and records per-phase wall time
    (``phase_seconds``), so a run's cost is attributable without external
    tooling. Phases: ``feature_build`` (host features, split by feature
    kind under ``feature_build.<kind>``), ``host_to_device`` (copies),
    ``kernels`` (launches, state folds and the wait for them),
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
    harvests (``device_failovers``, ``batch_bisections``,
    ``isolation_reruns``, ``stalls``, ``device_stalls``, ``degraded``),
    which stay 0 and empty: the port has no reliability wrapper. A run
    over a mesh counts ``shard_losses``, ``mesh_reshards`` and
    ``salvaged_states`` and notes its re-shards in ``degraded``."""

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
    _lock: Any = field(default_factory=threading.Lock, repr=False, compare=False)

    #: the counters :meth:`merge_from` adds up
    _COUNTERS = (
        "passes", "batches", "device_updates", "fast_path_folds", "coalesced_folds",
        "device_freq_sets", "freq_overflow_fallbacks", "ingest_folds",
        "device_failovers", "batch_bisections", "isolation_reruns", "stalls",
        "device_stalls", "shard_losses", "mesh_reshards", "salvaged_states",
    )

    def add_phase_time(self, phase: str, seconds: float) -> None:
        with self._lock:
            self.phase_seconds[phase] = self.phase_seconds.get(phase, 0.0) + seconds

    def bump(self, field_name: str, by: int = 1) -> None:
        """Locked counter increment (``+=`` on a dataclass int is not
        atomic across the service's worker threads)."""
        with self._lock:
            setattr(self, field_name, getattr(self, field_name) + by)

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
            if tag not in self.degraded:
                self.degraded.append(tag)

    def merge_from(self, other: "RunMonitor") -> None:
        """Absorb another monitor's counters and phase times: the service
        records a fold's costs into a fold-local monitor while the fold
        runs inside another job's launch, and the fold's own job absorbs
        them here once."""
        with self._lock:
            for name in self._COUNTERS:
                setattr(self, name, getattr(self, name) + getattr(other, name))
            for phase, seconds in other.phase_seconds.items():
                self.phase_seconds[phase] = self.phase_seconds.get(phase, 0.0) + seconds
            for key, seconds in other.cost_by_analyzer.items():
                self.cost_by_analyzer[key] = self.cost_by_analyzer.get(key, 0.0) + seconds
            self.degraded.extend(other.degraded)
            if other.placement is not None:
                self.placement = other.placement
            if other.device is not None:
                self.device = other.device

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
    one, Mean("a") and Sum("b") do not). ``executed`` turns True once the
    battery has launched in this process: the service's warmth."""

    def __init__(self, analyzers: Sequence[ScanShareableAnalyzer]):
        self.analyzers = tuple(analyzers)
        self.executed = False
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

    def required_columns(self) -> List[str]:
        return self.builder.required_columns

    def run(
        self,
        data: Dataset,
        batch_size: Optional[int] = None,
        columns: Optional[Sequence[str]] = None,
        host_accumulators: Optional[Dict[Any, Any]] = None,
        host_update_fns: Optional[Dict[Any, Callable[[Any, Any], Any]]] = None,
    ) -> List[Any]:
        """Fold every batch into the analyzers' states; returns the states
        on the host, in analyzer order. ``host_accumulators`` (key -> state)
        fold each batch on the host in the same pass, through
        ``host_update_fns[key](state, batch)``; the dict is updated in
        place."""
        from ..native import pattern_routes

        monitor = self.monitor
        host_states = host_accumulators if host_accumulators is not None else {}
        monitor.passes += 1
        monitor.device = str(self.device)
        if not self.scan_analyzers and not host_states:
            return []
        bs = effective_batch_size(batch_size, self.mesh)
        tier = resolve_scan_placement(self.scan_analyzers, self.placement, self.device, monitor)
        monitor.placement = tier
        routes = pattern_routes()
        try:
            if tier == "host" and self.mesh is not None:
                return self._run_host_tier_mesh(data, bs, columns, host_states,
                                                host_update_fns)
            if tier == "host":
                return self._run_host_tier(data, bs, columns, host_states, host_update_fns)
            return self._run_device_tier(data, bs, columns, host_states, host_update_fns)
        finally:
            for route, n in pattern_routes().items():
                if n > routes[route]:
                    monitor.pattern_routes[route] = (
                        monitor.pattern_routes.get(route, 0) + n - routes[route])

    def _run_device_tier(self, data: Dataset, bs: int, columns, host_states,
                         host_update_fns) -> List[Any]:
        monitor = self.monitor
        states = self.program.init_states(self.device)
        for batch in data.batches(bs, columns=columns):
            if self.scan_analyzers:
                with monitor.timed("feature_build"):
                    host_features = self.builder.build(batch, monitor.phase_seconds)
                with monitor.timed("host_to_device"):
                    features = to_device(host_features, self.device)
                    synchronize(self.device)
                with monitor.timed("kernels") as timer:
                    if self.mesh is None:
                        states = self.program(states, features)
                    else:
                        states = self.program.call_sharded(states, features, self.mesh)
                    synchronize(self.device)
                monitor.attribute(self.cost_keys, timer.seconds)
                monitor.bump("device_updates")
                self.program.executed = True
            if host_states:
                with monitor.timed("host_accumulators"):
                    for key, fn in host_update_fns.items():
                        host_states[key] = fn(host_states[key], batch)
            monitor.batches += 1
        if not self.scan_analyzers:
            return []
        with monitor.timed("state_fetch"):
            return fetch_states(states)

    def _host_pipeline(self, data: Dataset, bs: int, columns, host_states, host_update_fns,
                       chunk: int, compute_partial, fold) -> None:
        """The host tier's pipeline (the reference's ``_run_host_tier``,
        deequ_tpu/runners/engine.py:2223): a pool of ``os.cpu_count()``
        threads computes each batch's partial (``compute_partial(index,
        batch)``), at most ``workers + chunk`` batches in flight; the
        partials fold in submission order (the KLL sampler's offset keys on
        the batch index) through ``fold(partials, first_index)`` in chunks
        of ``chunk``, the last chunk holding what is left. Host accumulators
        fold each batch on the submitting thread meanwhile."""
        monitor = self.monitor
        workers = os.cpu_count() or 1
        window = workers + chunk
        pending: deque = deque()
        buffer: List[Any] = []
        folded = 0

        def drain_one() -> None:
            nonlocal folded
            buffer.append(pending.popleft().result())
            if len(buffer) == chunk:
                fold(list(buffer), folded)
                folded += chunk
                buffer.clear()

        with ThreadPoolExecutor(max_workers=workers) as pool:
            for index, batch in enumerate(
                data.batches(bs, columns=columns, pad_to_batch_size=False)
            ):
                monitor.batches += 1
                pending.append(pool.submit(compute_partial, index, batch))
                if host_states:
                    with monitor.timed("host_accumulators"):
                        for key, fn in host_update_fns.items():
                            host_states[key] = fn(host_states[key], batch)
                while len(pending) > window:
                    drain_one()
            while pending:
                drain_one()
        if buffer:
            fold(list(buffer), folded)

    def _run_host_tier(self, data: Dataset, bs: int, columns, host_states,
                       host_update_fns) -> List[Any]:
        """The host ingest tier on one device: :meth:`_host_pipeline` in
        chunks of 32, each chunk one fold into the carry."""
        monitor = self.monitor
        analyzers = self.scan_analyzers
        ingest = HostIngest(analyzers, self.device)
        # one token per pass: host partials may skip what an earlier batch
        # of the SAME pass contributed (the HLL dictionary memo), never
        # across passes
        run_token = object()

        def compute_partial(index: int, batch) -> Tuple[List[torch.Tensor], List[Any]]:
            t0 = time.perf_counter()
            ctx = HostBatchContext(batch, batch_index=index, run_token=run_token)
            packed = ingest.pack([a.host_partial(ctx) for a in analyzers])
            monitor.add_phase_time("host_partials", time.perf_counter() - t0)
            return packed

        def fold(chunk, first: int) -> None:
            with monitor.timed("ingest_fold") as timer:
                ingest.fold(chunk)
                synchronize(self.device)
            monitor.attribute(self.cost_keys, timer.seconds)
            monitor.ingest_folds += 1

        self._host_pipeline(data, bs, columns, host_states, host_update_fns, INGEST_CHUNK,
                            compute_partial, fold)
        with monitor.timed("state_fetch"):
            return fetch_states(ingest.states())

    def _run_host_tier_mesh(self, data: Dataset, bs: int, columns, host_states,
                            host_update_fns) -> List[Any]:
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
        in the collective merge (``ElasticMeshFold.finish``)."""
        from ..observability import trace as _trace
        from ..parallel import ElasticMeshFold
        from ..parallel.dcn import stack_partials

        monitor = self.monitor
        analyzers = self.scan_analyzers
        mesh = self.mesh
        local_chunk = max(1, INGEST_CHUNK // mesh.size)
        chunk = local_chunk * mesh.size
        elastic = ElasticMeshFold(analyzers, mesh, monitor=monitor)
        run_token = object()

        def compute_partial(index: int, batch, token=None) -> Tuple:
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
            with monitor.timed("ingest_fold") as timer:
                elastic.fold(stack_partials(analyzers, group), flags, indices)
                synchronize(elastic.mesh.home if not elastic.host_mode else None)
            monitor.attribute(self.cost_keys, timer.seconds)
            monitor.ingest_folds += 1

        self._host_pipeline(
            data, bs, columns, host_states, host_update_fns, chunk, compute_partial,
            lambda group, first: fold(group, list(range(first, first + len(group)))))

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
                synchronize(None if elastic.host_mode else elastic.mesh.home)
            if not elastic.pending_replay:
                break
        with monitor.timed("state_fetch"):
            return fetch_states(states)


def effective_batch_size(batch_size: Optional[int] = None, mesh=None) -> int:
    """The rows per batch of a pass (every batch of the device tier is
    padded to it); over a mesh, rounded up to ``mesh_batch_quantum``, so
    every batch splits evenly over the shards and keeps its boundaries
    when the mesh shrinks a rung (deequ_tpu/runners/engine.py:2021)."""
    bs = int(batch_size or DEFAULT_BATCH_SIZE)
    if mesh is not None:
        from ..parallel import mesh_batch_quantum

        q = mesh_batch_quantum(mesh.size)
        bs = -(-bs // q) * q
    return bs


# ---------------------------------------------------------------------------
# The streaming service's hooks: battery programs, warmth, the coalesced fold
# ---------------------------------------------------------------------------

#: battery -> its BundledScanProgram (analyzers are frozen dataclasses, so
#: equal batteries share one program and its ``executed`` warmth flag);
#: LRU-bounded so a service cycling through many batteries does not grow
_PROGRAM_CACHE = BoundedLRU(256)
_PROGRAM_CACHE_LOCK = threading.Lock()
_SCAN_SIG_CACHE = BoundedLRU(4096)


def _fused_program(battery: Tuple[ScanShareableAnalyzer, ...]) -> BundledScanProgram:
    """The cached program of this exact battery (built under a lock, so one
    instance per battery carries its warmth)."""
    with _PROGRAM_CACHE_LOCK:
        program = _PROGRAM_CACHE.get(battery)
        if program is None:
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


def fused_program_is_cached(analyzers: Sequence[ScanShareableAnalyzer]) -> bool:
    """Whether this battery's program has launched in this process (its
    kernels are then built and loaded): the service's warmth."""
    program = _PROGRAM_CACHE.get(_deduped_battery(analyzers))
    return program is not None and program.executed


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
) -> None:
    """Make a battery warm ahead of its first production run: run the real
    device-tier pipeline over the first row of ``data`` on ``device``,
    building the kernels (``nvcc`` compiles them at first use) and
    launching each once."""
    from .analysis_runner import AnalysisRunner

    sample = Dataset(data.arrow.slice(0, 1), probe_encoding=False)
    AnalysisRunner.do_analysis_run(
        sample, list(analyzers), batch_size=batch_size or DEFAULT_BATCH_SIZE,
        placement="device", device=device,
    )


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
        synchronize(device)
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
        program.executed = True
    return [[states[w] for states in per_analyzer] for w in range(width)]
