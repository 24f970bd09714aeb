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

Per pass the states come to the host once. The reliability wrapper, the
watchdog, checkpoints, the mesh, the elastic fold and the coalesced path
are not part of the port, and a device failure raises.
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
from ..analyzers.states import FrequencyTableState, leaves as state_leaves, with_leaves
from ..config import DEFAULT_BATCH_SIZE, synchronize
from ..data import Dataset
from ..kernels.kll_compact import kll_compact_ingest
from ..kernels.scan_reduce import MAX_SLOTS, partials, scan_reduce
from ..kernels.state_fold import state_fold_carry
from ..ops.kll import KLLSketchState
from .features import FeatureBuilder


@dataclass
class RunMonitor:
    """Counts execution events and records per-phase wall time
    (``phase_seconds``), so a run's cost is attributable without external
    tooling. Phases: ``feature_build`` (host features, split by feature
    kind under ``feature_build.<kind>``), ``host_to_device`` (copies),
    ``kernels`` (launches, state folds and the wait for them),
    ``host_accumulators`` (the host group-by's batch folds),
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
    (``"pcre2"`` or Python's ``"re"``)."""

    passes: int = 0
    batches: int = 0
    device: Optional[str] = None
    device_freq_sets: int = 0
    freq_overflow_fallbacks: int = 0
    placement: Optional[str] = None
    feed_bandwidth_mbps: Optional[float] = None
    ingest_folds: int = 0
    pattern_routes: Dict[str, int] = field(default_factory=dict)
    phase_seconds: Dict[str, float] = field(default_factory=dict)
    _lock: Any = field(default_factory=threading.Lock, repr=False, compare=False)

    def add_phase_time(self, phase: str, seconds: float) -> None:
        with self._lock:
            self.phase_seconds[phase] = self.phase_seconds.get(phase, 0.0) + seconds

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
        self.monitor.add_phase_time(self.phase, time.perf_counter() - self.t0)
        return False


class BundledScanProgram:
    """The per-batch update of a battery. Analyzers whose update is a
    scalar reduction share ``scan_reduce`` launches: their slots are
    deduplicated and cut into bundles of at most ``MAX_SLOTS``, one launch
    per bundle per batch (for the usual battery, one launch in all). The
    other analyzers (HLL, dictionary counts) launch their own kernel."""

    def __init__(self, analyzers: Sequence[ScanShareableAnalyzer]):
        self.analyzers = tuple(analyzers)
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

    def init_states(self, device) -> List[Any]:
        return [a.init_state(device) for a in self.analyzers]

    def __call__(self, states: Sequence[Any], features: Dict[str, torch.Tensor]) -> List[Any]:
        rows = features["rows"]
        outs = [
            scan_reduce([resolve_slot(spec, features) for spec in bundle], rows)
            for bundle in self.bundles
        ]
        new_states = []
        for a, state, slot in zip(self.analyzers, states, self.slot_of):
            if slot is None:
                new_states.append(a.update(state, features))
            else:
                out_i, out_f = outs[slot // MAX_SLOTS]
                new_states.append(a.fold_slot(state, partials(out_i, out_f, slot % MAX_SLOTS)))
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


def fetch_states(states: Sequence[Any]) -> List[Any]:
    """Bring every state to the host: small leaves with one copy per leaf
    dtype (packed into one flat buffer per dtype on the device, copied and
    split back), large ones (a frequency table, its filled key buffer) with
    a copy each. Static fields (a sketch's size) stay as they are."""
    leaves = [leaf for s in states for leaf in _fetch_leaves(s)]
    host: List[Optional[torch.Tensor]] = [None] * len(leaves)
    by_dtype: Dict[torch.dtype, List[int]] = {}
    for i, leaf in enumerate(leaves):
        if leaf.numel() >= FETCH_ALONE_ELEMENTS:
            host[i] = leaf.cpu()
        else:
            by_dtype.setdefault(leaf.dtype, []).append(i)
    for idx in by_dtype.values():
        flat = torch.cat([leaves[i].reshape(-1) for i in idx]).cpu()
        offset = 0
        for i in idx:
            numel = leaves[i].numel()
            host[i] = flat[offset:offset + numel].reshape(leaves[i].shape)
            offset += numel
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
    - ``"auto"`` (or None) probes the link: below
      ``FEED_BANDWIDTH_THRESHOLD_MBPS`` the host tier wins. On the CPU there
      is no link, and the pass streams to the "device"."""
    effective = placement or "auto"
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
    on the ingest tier ``placement`` resolves to."""

    def __init__(
        self,
        scan_analyzers: Sequence[ScanShareableAnalyzer],
        device: torch.device,
        monitor: Optional[RunMonitor] = None,
        placement: Optional[str] = None,
    ):
        self.scan_analyzers = list(scan_analyzers)
        self.device = device
        self.monitor = monitor or RunMonitor()
        self.placement = placement
        self.builder = FeatureBuilder(
            [s for a in self.scan_analyzers for s in a.feature_specs()]
        )
        self.program = BundledScanProgram(self.scan_analyzers)

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
        bs = effective_batch_size(batch_size)
        tier = resolve_scan_placement(self.scan_analyzers, self.placement, self.device, monitor)
        monitor.placement = tier
        routes = pattern_routes()
        try:
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
                with monitor.timed("kernels"):
                    states = self.program(states, features)
                    synchronize(self.device)
            if host_states:
                with monitor.timed("host_accumulators"):
                    for key, fn in host_update_fns.items():
                        host_states[key] = fn(host_states[key], batch)
            monitor.batches += 1
        if not self.scan_analyzers:
            return []
        with monitor.timed("state_fetch"):
            return fetch_states(states)

    def _run_host_tier(self, data: Dataset, bs: int, columns, host_states,
                       host_update_fns) -> List[Any]:
        """The host ingest tier (the reference's ``_run_host_tier``,
        deequ_tpu/runners/engine.py:2223, on one device): a pool of
        ``os.cpu_count()`` threads computes each batch's partials, at most
        ``workers + 32`` batches in flight; the partials fold in submission
        order (the KLL sampler's offset keys on the batch index) in chunks
        of 32, the last chunk holding what is left. Host accumulators fold
        each batch on the submitting thread meanwhile."""
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

        def fold(chunk) -> None:
            with monitor.timed("ingest_fold"):
                ingest.fold(chunk)
                synchronize(self.device)
            monitor.ingest_folds += 1

        workers = os.cpu_count() or 1
        window = workers + INGEST_CHUNK
        pending: deque = deque()
        buffer: List[Any] = []

        def drain_one() -> None:
            buffer.append(pending.popleft().result())
            if len(buffer) == INGEST_CHUNK:
                fold(buffer)
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
            fold(buffer)
        with monitor.timed("state_fetch"):
            return fetch_states(ingest.states())


def effective_batch_size(batch_size: Optional[int] = None) -> int:
    """The rows per batch of a pass (every batch is padded to it)."""
    return int(batch_size or DEFAULT_BATCH_SIZE)
