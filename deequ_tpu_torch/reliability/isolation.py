"""Analyzer isolation and tier failover for the shared pass (the
reference's ``deequ_tpu/reliability/isolation.py``, ported).

The shared pass makes every analyzer ride ONE pass, which also makes every
failure a battery-wide one: one bad value or one device fault would kill
all N analyzers' metrics at once, where the reference degrades per
analyzer (Spark aggregates are independent expressions,
`AnalysisRunner.scala:320-323`). This module restores that contract:

- **Tier ladder** (:func:`_attempt_tiered`): a device infrastructure
  failure (a CUDA error, a lost device, a watchdog stall, a feed stall)
  re-runs the SAME battery on the host ingest tier, fresh states, no
  device residue; an OOM first halves the batch size (smaller padded
  batches shrink the live features) before falling back; a shard loss
  that escaped the engine re-runs the whole pass on a mesh rebuilt over
  the surviving devices, one rung down. Every hop is recorded on the
  RunMonitor so the service's placement router learns to keep the
  battery off the sick tier.
- **Battery bisection** (:func:`run_scan_resilient`): a failure that
  survives the tier ladder is attributed by bisecting the battery and
  re-running partitions (log2(N) extra passes in the worst case) until
  the faulty analyzers are alone in their partitions and degrade to typed
  ``Failure`` metrics while everyone else completes.
- **Host-accumulator knockout**: host accumulators (host group-by tables,
  host histograms, the exact quantile mode) fold outside the kernels, so
  each update is guarded and the first error knocks only that
  accumulator out for the rest of the pass.

A fault of the package's own kernels (``kernels.build.KernelError``: a
kernel that fails to build or load, one whose launch reports a CUDA error,
a wrapper that disagrees with its library) is neither a device fault nor
an analyzer fault: it raises out of the run at once, never failed over to
the host tier and never bisected into ``Failure`` metrics, so no fallback
hides a kernel. A CUDA error that poisons the context (an illegal
address, a device-side assert, a misaligned address, a launch failure) is
how a broken kernel shows itself when torch reports it at the wait after
the launches, so it classifies as ``"kernel"`` too and raises as a
``KernelLaunchError``: the host tier's folds (``state_fold``'s carry
entry, ``kll_compact``'s ingest entry) run on the same card and could
not take over from it anyway. A pass that fails over to the host tier
after a stall or a device fault runs under a deadline of its own
(``reliability.watchdog.failover_pass``), so it never hangs.

Interrupts (``KeyboardInterrupt`` and other non-``Exception``
``BaseException``) pass through every layer: an operator's ^C or a
preemption must abort the run, not degrade it; resumable ingest
checkpoints are the recovery for those.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

from ..observability import record_failure
from ..observability import trace as _trace
from .checkpoint import _host_ident
from .watchdog import failover_pass

_logger = logging.getLogger(__name__)

#: batch-size floor below which OOM bisection gives up (padding dominates)
_MIN_BISECT_BATCH = 1 << 10

#: OOM bisections per attempt before the tier ladder falls through to host
_MAX_OOM_BISECTIONS = 3


def classify_failure(exc: BaseException) -> str:
    """``"kernel"`` | ``"mesh"`` | ``"oom"`` | ``"device"`` | ``"data"``:
    what recovery applies.

    Typed exceptions of the package's taxonomy classify directly
    (:class:`CorruptStateError` is ``"data"``: a corrupt payload reproduces
    on any tier; :class:`ShardLossError` is ``"mesh"``: re-shard over the
    survivors before the host-tier failover; :class:`DeviceOOMException`
    is ``"oom"``; every other ``DeviceFailureException``, the watchdog's
    :class:`ScanStallError` and the feed's :class:`FeedStallError`
    included, is ``"device"``). The card's own errors classify by torch's
    types and texts, not by XLA status phrases: ``torch.OutOfMemoryError``
    (``torch.cuda.OutOfMemoryError``) and a ``RuntimeError`` whose text
    carries "CUDA error: out of memory" (the form in which a hand-written
    kernel's scratch allocation fails) are ``"oom"``; an error that
    poisons the context (an illegal address or instruction, a device-side
    assert, a misaligned address, a launch failure: what a broken kernel
    gives) is ``"kernel"``; any other "CUDA error" or "cudaError" is
    ``"device"``. A fault of the package's own kernels
    (``kernels.build.KernelError``: a build, a load or a launch that
    failed, a wrapper that disagrees with its library) is ``"kernel"``,
    which no recovery takes: it raises out of the run. Anything else is a
    data or analyzer failure: re-running it elsewhere would fail the same
    way, so only bisection helps."""
    import torch

    from ..exceptions import (
        CorruptStateError,
        DeviceFailureException,
        DeviceOOMException,
        ShardLossError,
    )
    from ..kernels.build import KernelError

    if isinstance(exc, KernelError):
        return "kernel"
    if isinstance(exc, CorruptStateError):
        return "data"
    if isinstance(exc, ShardLossError):
        return "mesh"
    if isinstance(exc, DeviceOOMException):
        return "oom"
    if isinstance(exc, DeviceFailureException):
        return "device"
    oom_types = tuple(t for t in (getattr(torch, "OutOfMemoryError", None),
                                  getattr(torch.cuda, "OutOfMemoryError", None))
                      if isinstance(t, type))
    if oom_types and isinstance(exc, oom_types):
        return "oom"
    if not isinstance(exc, RuntimeError):
        return "data"
    message = str(exc)
    if "CUDA error: out of memory" in message:
        return "oom"
    if any(marker in message for marker in _KERNEL_MARKERS):
        return "kernel"
    if any(marker in message for marker in _DEVICE_MARKERS):
        return "device"
    return "data"


#: texts of a CUDA runtime error (torch's "CUDA error: ...", the runtime's
#: own error names)
_DEVICE_MARKERS = ("CUDA error", "cudaError")

#: texts of the CUDA errors that poison the context, the ones a faulty
#: kernel raises (``cudaErrorIllegalAddress``, ``cudaErrorAssert``,
#: ``cudaErrorMisalignedAddress``, ``cudaErrorLaunchFailure``,
#: ``cudaErrorIllegalInstruction``)
_KERNEL_MARKERS = ("illegal memory access", "illegal address", "device-side assert",
                   "misaligned address", "unspecified launch failure", "illegal instruction")


def as_kernel_error(exc: BaseException) -> BaseException:
    """``exc`` as the typed fault of the package's kernels it classifies
    as: a ``KernelError`` as it is, a raw CUDA error that poisons the
    context as a ``KernelLaunchError`` chained to it."""
    from ..kernels.build import KernelError, KernelLaunchError

    if isinstance(exc, KernelError):
        return exc
    error = KernelLaunchError(f"a kernel failed on the device: {type(exc).__name__}: {exc}")
    error.__cause__ = exc
    return error


@dataclass
class ResilientScanOutcome:
    """Per-analyzer results of a resilient scan: disjoint success states
    and typed errors, plus the host accumulator states/errors."""

    states: Dict[Any, Any] = field(default_factory=dict)
    errors: Dict[Any, BaseException] = field(default_factory=dict)
    host_states: Dict[Any, Any] = field(default_factory=dict)
    host_errors: Dict[Any, BaseException] = field(default_factory=dict)


def _guard_host_updates(
    host_updates: Dict[Any, Callable],
    host_errors: Dict[Any, BaseException],
    monitor,
) -> Dict[Any, Callable]:
    """Wrap each accumulator's update fn so one raising accumulator is
    knocked out (typed Failure later) without touching the others or the
    device battery."""

    def make(key, fn):
        def guarded(state, batch):
            if key in host_errors:
                return state
            try:
                return fn(state, batch)
            except Exception as exc:  # noqa: BLE001 - degrade only this key
                if classify_failure(exc) == "kernel":
                    raise
                host_errors[key] = exc
                # named the reference's way (a grouping set's table is
                # ("__grouping__", columns) there)
                monitor.note_degraded(f"host:{_host_ident(key)}")
                _logger.warning(
                    "host accumulator %s knocked out: %s", key, exc
                )
                return state

        return guarded

    return {key: make(key, fn) for key, fn in host_updates.items()}


def run_scan_resilient(
    run_pass: Callable,
    battery: Sequence[Any],
    make_host_states: Callable[[], Tuple[Dict[Any, Any], Dict[Any, Callable]]],
    monitor,
    *,
    batch_size: int,
    placement: Optional[str],
    sharding: Optional[Any] = None,
    device: Optional[Any] = None,
) -> ResilientScanOutcome:
    """Run the shared pass with isolation + failover.

    ``run_pass(analyzers, host_states, host_updates, placement, batch_size)
    -> (states, host_states)`` executes one engine pass (the runner owns
    engine construction); ``make_host_states() -> (states, update_fns)``
    builds FRESH host accumulators — retries must never refold into
    partially-updated state. ``sharding`` (the pass's mesh, if any) lets
    the tier ladder rebuild a DEGRADED mesh when a shard loss escapes the
    engine's in-pass recovery: a mesh-sharded ``run_pass`` must then also
    accept a ``sharding=`` keyword override (only ever passed after a
    mesh failure, so mesh-free callers keep their simpler signature).
    ``device`` is the pass's device: an OOM's retry releases its cache.
    """
    outcome = ResilientScanOutcome()
    host_keys = list(make_host_states()[0])
    progress = {"host_done": not host_keys, "bisecting": False}

    def attempt(part: Tuple, with_host: bool):
        if with_host:
            host_states, host_updates = make_host_states()
            # keep already-knocked-out keys dead across retries: their
            # first error is the typed result, and refolding a partially
            # poisoned accumulator would just re-raise
            host_updates = _guard_host_updates(
                host_updates, outcome.host_errors, monitor
            )
        else:
            host_states, host_updates = {}, {}
        states, folded = _attempt_tiered(
            run_pass, part, host_states, host_updates,
            monitor, batch_size=batch_size, placement=placement,
            sharding=sharding, device=device,
        )
        return states, folded

    def degrade(part: Tuple, exc: BaseException) -> None:
        for analyzer in part:
            outcome.errors[analyzer] = exc
            monitor.note_degraded(repr(analyzer))
        if part:
            _trace.add_event(
                "analyzers_degraded", count=len(part),
                analyzers=[repr(a) for a in part[:8]],
                error=f"{type(exc).__name__}: {str(exc)[:200]}",
            )

    def run_partition(part: Tuple):
        """Run one partition, bisecting on failure. Returns (fully_failed,
        signature): fully_failed means EVERY member degraded, and
        ``signature`` identifies the failure when they all failed alike."""
        try:
            states, folded = attempt(part, with_host=not progress["host_done"])
        except Exception as exc:  # noqa: BLE001 - typed degradation below
            if classify_failure(exc) == "kernel":
                raise  # a faulty kernel fails the run
            signature = (type(exc), str(exc))
            if len(part) <= 1:
                if part:
                    degrade(part, exc)
                    _logger.warning(
                        "analyzer %r isolated as faulty: %s", part[0], exc
                    )
                else:
                    # a host-only pass failed outright: every accumulator
                    # that hasn't already got a more specific error shares
                    # the pass failure
                    for key in host_keys:
                        outcome.host_errors.setdefault(key, exc)
                    progress["host_done"] = True
                return True, signature
            if not progress["bisecting"]:
                progress["bisecting"] = True
                _logger.warning(
                    "fused battery of %d analyzers failed (%s: %s); "
                    "bisecting to isolate", len(part), type(exc).__name__, exc,
                )
            _trace.add_event(
                "isolation_bisect", partition=len(part),
                error=f"{type(exc).__name__}: {str(exc)[:200]}",
            )
            monitor.bump("isolation_reruns")
            mid = len(part) // 2
            left, right = part[:mid], part[mid:]
            failed_left, sig_left = run_partition(left)
            if failed_left and len(left) > 1 and sig_left == signature:
                # the left subtree (more than one member) reproduced the
                # parent failure WHOLESALE: this is a pass-level fault
                # (corrupt input, dead tier) no bisection can isolate —
                # bisecting the right half would burn ~2x its size in
                # identical full-data re-passes. A single faulty analyzer
                # never trips this: its clean siblings succeed, so no >1
                # subtree fully fails.
                _logger.warning(
                    "partition of %d reproduced the same failure wholesale; "
                    "degrading the remaining %d analyzers without further "
                    "re-passes", len(left), len(right),
                )
                degrade(right, exc)
                return True, signature
            failed_right, sig_right = run_partition(right)
            return (
                failed_left and failed_right
                and sig_left == sig_right == signature,
                signature,
            )
        for analyzer, state in zip(part, states):
            outcome.states[analyzer] = state
        if not progress["host_done"]:
            outcome.host_states = folded
            progress["host_done"] = True
        return False, None

    battery = tuple(battery)
    if battery or host_keys:
        run_partition(battery)
    if not progress["host_done"]:
        # every battery partition failed before any pass completed with the
        # accumulators attached — give them one dedicated battery-free pass
        try:
            _, folded = attempt((), with_host=True)
            outcome.host_states = folded
        except Exception as exc:  # noqa: BLE001
            if classify_failure(exc) == "kernel":
                raise
            for key in host_keys:
                outcome.host_errors.setdefault(key, exc)
    # a knocked-out accumulator's folded state is partial garbage: drop it
    for key in outcome.host_errors:
        outcome.host_states.pop(key, None)
    return outcome


def _attempt_tiered(
    run_pass: Callable,
    part: Tuple,
    host_states: Dict[Any, Any],
    host_updates: Dict[Any, Callable],
    monitor,
    *,
    batch_size: int,
    placement: Optional[str],
    sharding: Optional[Any] = None,
    device: Optional[Any] = None,
):
    """One partition through the tier ladder: mesh re-shard for escaped
    shard losses, then device (as placed) with OOM batch bisection, then
    host-tier failover for device-infrastructure failures when every
    member supports host partials."""
    bs = batch_size
    placement_now = placement
    oom_left = _MAX_OOM_BISECTIONS
    mesh_now = sharding
    mesh_overridden = False
    failed_over = False
    host_capable = bool(part) and all(
        getattr(a, "supports_host_partial", False) for a in part
    )
    while True:
        try:
            kwargs = {"placement": placement_now, "batch_size": bs}
            if mesh_overridden:
                kwargs["sharding"] = mesh_now
            # a failover pass runs under a deadline even before its tier
            # has a measured rate
            with failover_pass(failed_over):
                return run_pass(part, dict(host_states), host_updates, **kwargs)
        except Exception as exc:  # noqa: BLE001 - ladder decides
            kind = classify_failure(exc)
            if kind == "kernel":
                error = as_kernel_error(exc)
                if error is exc:
                    raise
                raise error from exc
            if kind == "mesh":
                smaller = _degraded_mesh(mesh_now, exc)
                if smaller is not None:
                    # re-shard BEFORE host failover: the pass re-runs whole
                    # on a mesh rebuilt over the surviving devices — the
                    # mesh analog of the device->host hop, one rung at a
                    # time (8->4->2->1), host only when the ladder is out
                    monitor.bump("mesh_reshards")
                    monitor.note_degraded("mesh:pass_reshard")
                    record_failure(exc)
                    _trace.add_event(
                        "mesh_reshard",
                        from_devices=mesh_now.size,
                        to_devices=smaller.size,
                        scope="pass",
                    )
                    _logger.warning(
                        "mesh pass failed with a shard loss (%s); re-running "
                        "the whole pass on a %d-shard degraded mesh",
                        exc, smaller.size,
                    )
                    mesh_now = smaller
                    mesh_overridden = True
                    host_states = _refresh_host_states(host_states, monitor)
                    continue
                # no smaller mesh possible: drop the (broken) mesh and
                # treat like a thrown device fault (tier failover below)
                mesh_now = None
                mesh_overridden = True
                kind = "device"
            if kind == "oom" and oom_left > 0 and _oom_bisection_futile(part, bs):
                # halving the batch shrinks the live FEATURE buffers but
                # never a device frequency table's fixed
                # (slots + buffer) footprint — when the tables dominate
                # the partition's device memory, bisection re-passes are
                # pure waste; fall through to failover/battery-bisection
                # (which isolates the table scans so the runner's host
                # accumulator fallback takes the set)
                oom_left = 0
                _logger.warning(
                    "device OOM with frequency-table states dominating the "
                    "footprint; skipping futile batch bisection"
                )
            if (
                kind == "oom"
                and oom_left > 0
                and bs // 2 >= _MIN_BISECT_BATCH
                and placement_now != "host"
            ):
                oom_left -= 1
                bs //= 2
                monitor.bump("batch_bisections")
                record_failure(exc)
                _trace.add_event("oom_bisect", batch_size=bs)
                _logger.warning(
                    "device OOM (%s); bisecting batch size to %d", exc, bs
                )
                # host accumulators refold from scratch on the retry: the
                # failed pass left them partially updated
                host_states = _refresh_host_states(host_states, monitor)
                _release_device_memory(device)
                continue
            if kind in ("oom", "device") and placement_now != "host" and host_capable:
                monitor.bump("device_failovers")
                monitor.note_degraded(f"tier:device->{kind}")
                # the typed failure event + flight-recorder dump, then the
                # failover hop itself — a degraded run's trace shows the
                # failed device pass, the exception, and the host re-pass
                # as one connected tree
                record_failure(exc)
                _trace.add_event(
                    "device_failover", to="host", kind=kind,
                    analyzers=len(part),
                )
                _logger.warning(
                    "device tier failed (%s: %s); failing battery of %d "
                    "over to the host ingest tier",
                    type(exc).__name__, exc, len(part),
                )
                placement_now = "host"
                failed_over = True
                host_states = _refresh_host_states(host_states, monitor)
                continue
            raise


def _release_device_memory(device) -> None:
    """Before an OOM's retry at half the batch: collect what the failed
    pass left in reference cycles and hand the cached blocks of the pass's
    card back (``torch.cuda.empty_cache`` on that device), so the smaller
    batch finds the memory the larger one held."""
    import gc

    import torch

    gc.collect()
    if getattr(device, "type", None) == "cuda":
        with torch.cuda.device(device):
            torch.cuda.empty_cache()


def _oom_bisection_futile(part: Tuple, batch_size: int) -> bool:
    """Whether an OOM cannot be relieved by halving the batch: the
    partition's device frequency TABLES (sorted table + key buffer, sized
    by ``slots``/``buffer_entries``, not by the batch) already outweigh the
    reclaimable per-batch feature bytes (~8 B per row per analyzer, all of
    which a halving could at best free)."""
    from ..analyzers.grouping import DeviceFrequencyTableScan

    tables = [a for a in part if isinstance(a, DeviceFrequencyTableScan)]
    if not tables:
        return False
    table_bytes = sum(
        24 * a.slots + 8 * a.buffer_entries for a in tables
    )
    reclaimable = 8 * batch_size * max(1, len(part))
    return table_bytes > reclaimable


def _degraded_mesh(mesh, exc):
    """A mesh rebuilt over ``exc``'s surviving devices at the next ladder
    rung STRICTLY below the current size, or None when no smaller mesh is
    possible (one shard, no rung fits, no mesh to begin with)."""
    if mesh is None:
        return None
    from ..parallel import make_mesh
    from ..parallel.elastic import mesh_ladder, next_rung

    devices = list(mesh.devices)
    survivors = getattr(exc, "survivors", None)
    if survivors is None:
        lost = set(getattr(exc, "lost", ()) or (0,))
        survivors = [d for i, d in enumerate(devices) if i not in lost]
    if not survivors:
        return None
    rung = next_rung(
        [r for r in mesh_ladder() if r < len(devices)], len(survivors)
    )
    if rung is None:
        return None
    return make_mesh(devices=survivors[:rung])


def _refresh_host_states(host_states: Dict[Any, Any], monitor) -> Dict[Any, Any]:
    """Fresh identity states for the accumulators a failed pass partially
    updated (same keys; host group-by tables re-empty, ``host_init``
    re-runs)."""
    from ..analyzers.base import Analyzer
    from ..analyzers.grouping import FrequenciesAndNumRows

    fresh: Dict[Any, Any] = {}
    for key, state in host_states.items():
        if isinstance(state, FrequenciesAndNumRows):
            state.close()
            fresh[key] = FrequenciesAndNumRows.empty(list(state.group_columns))
        elif isinstance(key, Analyzer) and hasattr(key, "host_init"):
            fresh[key] = key.host_init()
        else:
            fresh[key] = state
    return fresh
