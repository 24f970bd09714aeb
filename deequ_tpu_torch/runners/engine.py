"""The shared scan: one pass over the data, every analyzer fed per batch.

Per batch the engine builds the host features (``features.py``), copies
them to the device, launches the kernels and folds the batch partials into
the analyzers' states with a few tensor ops on the device. Per pass it
fetches all states to the host once. This ports the device pass of the JAX
reference's ``ScanEngine.run`` (deequ_tpu/runners/engine.py:1893): the
reliability wrapper, the watchdog, checkpoints, the mesh and the coalesced
path are not part of the port, and a device failure raises.
"""

from __future__ import annotations

import time
import warnings
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from ..analyzers.base import ScanShareableAnalyzer, SlotSpec, resolve_slot
from ..analyzers.states import FrequencyTableState, leaves as state_leaves, with_leaves
from ..config import DEFAULT_BATCH_SIZE, synchronize
from ..data import Dataset
from ..kernels.scan_reduce import MAX_SLOTS, partials, scan_reduce
from .features import FeatureBuilder


@dataclass
class RunMonitor:
    """Counts execution events and records per-phase wall time
    (``phase_seconds``), so a run's cost is attributable without external
    tooling. Phases: ``feature_build`` (host features, split by feature
    kind under ``feature_build.<kind>``), ``host_to_device`` (copies),
    ``kernels`` (launches, state folds and the wait for them),
    ``host_accumulators`` (the host group-by's batch folds),
    ``state_fetch`` (the device-to-host copy of the states); the runner
    adds ``drain`` (device frequency tables to counts) and
    ``metric_derivation``. ``device_freq_sets`` counts the grouping sets
    given a device frequency table, ``freq_overflow_fallbacks`` those whose
    table dropped groups and re-ran on the host."""

    passes: int = 0
    batches: int = 0
    device: Optional[str] = None
    device_freq_sets: int = 0
    freq_overflow_fallbacks: int = 0
    phase_seconds: Dict[str, float] = field(default_factory=dict)

    def add_phase_time(self, phase: str, seconds: float) -> None:
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


class ScanEngine:
    """One shared pass of the scan analyzers over a dataset on ``device``."""

    def __init__(
        self,
        scan_analyzers: Sequence[ScanShareableAnalyzer],
        device: torch.device,
        monitor: Optional[RunMonitor] = None,
    ):
        self.scan_analyzers = list(scan_analyzers)
        self.device = device
        self.monitor = monitor or RunMonitor()
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
        monitor = self.monitor
        host_states = host_accumulators if host_accumulators is not None else {}
        monitor.passes += 1
        monitor.device = str(self.device)
        if not self.scan_analyzers and not host_states:
            return []
        bs = effective_batch_size(batch_size)
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


def effective_batch_size(batch_size: Optional[int] = None) -> int:
    """The rows per batch of a pass (every batch is padded to it)."""
    return int(batch_size or DEFAULT_BATCH_SIZE)
