"""Cache-aware placement: route jobs where their kernels are warm (the
reference's ``deequ_tpu/service/placement.py``, ported).

A battery's program is cached per process, keyed by its analyzer tuple
(``runners/engine.py _fused_program``). On this package's device a battery
is WARM once its kernels have been built (``nvcc`` at first use) and it
has launched once in this process; CUDA kernels do not compile per shape,
so warmth is not per batch size here, unlike XLA's. The router:

- answers "auto" (None) when the battery is warm;
- answers "host" for a cold battery, so a cold run completes on the host
  ingest tier while a background warmer builds and launches the kernels
  off the request path (with ``background_warm=False`` only the first
  job is sheltered and the next takes the device's inline build);
- raises, for every later job of a battery whose background warm failed,
  the warm's error (a kernel that does not build or launch): the battery
  is never served from the host tier in its place;
- answers "host" for the next ``SUSPECT_PROBATION_RUNS`` jobs of a battery
  whose run recorded a device-tier failure (a failover, an OOM bisection,
  a device stall, a shard loss: the scheduler's harvest calls
  :meth:`PlacementRouter.note_device_failure`), then lets it try the
  device again;
- remembers which WORKER ran each signature so the scheduler can prefer
  handing a battery back to the thread that ran it.
"""

from __future__ import annotations

import logging
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Optional, Sequence, Set, Tuple

_logger = logging.getLogger(__name__)

from ..analyzers.base import Analyzer, ScanShareableAnalyzer
from .metrics import ServiceMetrics

#: a battery signature: the deduped scan-shareable analyzer tuple (the key
#: of the engine's program cache), qualified by the batch size
Signature = Tuple[Any, ...]


def battery_signature(analyzers: Sequence[Analyzer]) -> Signature:
    """The deduped scan-shareable subset in first-encounter order — the
    fused battery `do_analysis_run` will build from these analyzers,
    normalized by the ENGINE's own helper so warmth keys can never drift
    from program-cache keys.

    This is the warmth KEY, not necessarily the exact battery a run
    launches: data-dependent device-frequency scans join at run time and
    precondition failures drop analyzers, so the engine's program-cache
    key can differ. The router therefore also counts a signature warm once
    a job carrying it has RUN on the device tier, rather than trusting
    cache introspection alone."""
    from ..runners.engine import _deduped_battery

    return _deduped_battery(analyzers)


def shape_qualified_signature(analyzers: Sequence[Analyzer], batch_size: int) -> Tuple:
    """``battery_signature`` plus the padded batch size: the job's warmth
    and affinity key. An EMPTY battery (grouping or host-only checks) stays
    the empty signature — there is nothing to warm."""
    battery = battery_signature(analyzers)
    if not battery:
        return ()
    return battery + (("__batch__", int(batch_size)),)


def make_warm_fn(
    router: "PlacementRouter",
    analyzers: Sequence[Analyzer],
    data,
    batch_size: int,
) -> Optional[Callable[[], None]]:
    """The warm closure a submitter hands the scheduler: ``None`` when the
    battery is already warm; otherwise a thunk that runs the battery's
    device-tier pipeline on the router's device over a DETACHED 1-row
    sample (so the queued closure never pins the job's dataset), building
    and launching its kernels."""
    signature = shape_qualified_signature(analyzers, batch_size)
    if not signature or router.is_warm(signature):
        return None
    from ..runners.engine import detached_warm_sample, warm_fused_program

    sample = detached_warm_sample(data)
    device = router.device

    def warm():
        warm_fused_program(analyzers, data=sample, batch_size=batch_size, device=device)

    return warm


class PlacementRouter:
    def __init__(
        self,
        metrics: Optional[ServiceMetrics] = None,
        device=None,
        background_warm: bool = True,
    ):
        self.metrics = metrics or ServiceMetrics()
        #: the device the service runs on; warms run there
        self.device = device
        from ..utils import BoundedLRU

        self._lock = threading.Lock()
        #: worker affinity per signature — bounded like every other
        #: long-lived structure here, so churned-out batteries' analyzer
        #: tuples don't stay pinned in host memory forever
        self._workers_by_sig = BoundedLRU(256)
        #: warmth evidence from completed device runs/warms. Bounded to the
        #: same order as the engine's program cache (256): when the LRU
        #: there evicts a battery, this record ages out around the same
        #: churn, so an evicted battery eventually reads cold again and
        #: re-warms in the background instead of stalling a request
        self._ran = BoundedLRU(256)
        #: signatures with a warm currently IN FLIGHT (dedup only — every
        #: terminal path discards, so a cold battery can always re-warm)
        self._warming: Set[Signature] = set()
        #: signature -> the exception its background warm raised: decide()
        #: raises it for every later job of the battery
        self._warm_failed = BoundedLRU(256)
        #: signature -> remaining host-tier probation runs after a
        #: device-tier failure on that battery (failover evidence the
        #: scheduler harvests from the RunMonitor). While positive, decide()
        #: answers "host" outright: the battery keeps completing next to
        #: the data instead of re-hitting a sick device; the countdown then
        #: re-admits it to the device tier
        self._device_suspect = BoundedLRU(256)
        self._warmer: Optional[ThreadPoolExecutor] = (
            ThreadPoolExecutor(max_workers=1, thread_name_prefix="deequ-warmer")
            if background_warm
            else None
        )
        self.metrics.describe(
            "deequ_service_placement_cache_hits_total",
            "Jobs whose battery was warm (its kernels built and launched).",
        )
        self.metrics.describe(
            "deequ_service_placement_cache_misses_total",
            "Jobs whose battery was cold: routed to the host tier while the "
            "kernels build and launch in the background.",
        )
        self.metrics.describe(
            "deequ_service_programs_warmed_total",
            "Background warms that completed (built and launched the "
            "battery's kernels).",
        )
        self.metrics.describe(
            "deequ_service_warm_failures_total",
            "Background warms that raised; every later job of the battery "
            "fails with the warm's error.",
        )
        self.metrics.describe(
            "deequ_service_device_failures_total",
            "Jobs whose engine run recorded a device-tier failure "
            "(failover, OOM bisection, a device stall or a shard loss); the "
            "battery enters host-tier probation.",
        )
        self.metrics.describe(
            "deequ_service_suspect_host_routes_total",
            "Placement decisions answered 'host' because the battery was "
            "on device-failure probation.",
        )

    def is_warm(self, signature: Signature) -> bool:
        """Side-effect-free warmth probe (no counters, no warm scheduling):
        warm when a run of this signature completed on the device tier or
        a warm finished (``note_ran``), or when the battery's program has
        launched in this process (``fused_program_is_cached``: its kernels
        are built, and a CUDA kernel serves every batch size)."""
        if not signature:
            return True
        if self._ran.get(signature):
            return True
        from ..runners.engine import fused_program_is_cached

        battery = tuple(a for a in signature if isinstance(a, ScanShareableAnalyzer))
        return fused_program_is_cached(battery)

    def decide(
        self,
        signature: Signature,
        warm: Optional[Callable[[], None]] = None,
    ) -> Optional[str]:
        """Placement for a job with this battery: ``None`` (engine default /
        auto) when warm, ``"host"`` when cold. A cold decision also enqueues
        a background warm (``warm``, a 1-row device-tier run over the job's
        own data that builds and launches the battery's kernels), so the
        cold window closes after one build regardless of arrival rate.

        A battery on device-failure probation (:meth:`note_device_failure`)
        answers "host" for its next ``SUSPECT_PROBATION_RUNS`` decisions.

        Raises :class:`~deequ_tpu_torch.exceptions.DeviceFailureException`
        from the warm's error once the battery's warm has failed."""
        from ..observability import trace as _trace

        if not signature:
            return None
        with self._lock:
            probation = self._device_suspect.get(signature)
            if probation:
                # the battery recently took a device-tier fault: serve it
                # from the host tier for the rest of its probation, then
                # let it try the device again
                self._device_suspect[signature] = probation - 1
                self.metrics.inc("deequ_service_suspect_host_routes_total")
                _trace.add_event(
                    "placement_routed", decision="host", reason="probation",
                    probation_left=probation - 1,
                )
                return "host"
        failure = self._warm_failed.get(signature)
        if failure is not None:
            from ..exceptions import DeviceFailureException

            raise DeviceFailureException(
                f"the battery's kernels failed to build or launch on {self.device}: "
                f"{type(failure).__name__}: {failure}"
            ) from failure
        if self.is_warm(signature):  # .get inside refreshes LRU recency
            self.metrics.inc("deequ_service_placement_cache_hits_total")
            _trace.add_event("placement_routed", decision="auto", reason="warm")
            return None
        self.metrics.inc("deequ_service_placement_cache_misses_total")
        _trace.add_event(
            "placement_routed", decision="host", reason="cold",
            background_warm=warm is not None and self._warmer is not None,
        )
        if warm is not None and self._warmer is not None:
            self._warm_in_background(signature, warm)
        elif self._warmer is None:
            # background warming is off entirely: shelter THIS job on the
            # host tier, then let the next one take the device tier's
            # inline build — permanently host-routing the battery would
            # make the device path unreachable forever
            self._ran[signature] = True
        # else: a warm-capable service raced warmth eviction between submit
        # (is_warm said hot, so no warm_fn was built) and pickup — run on
        # the host tier now WITHOUT faking warmth; the next submission sees
        # cold and builds a real warm_fn
        return "host"

    def _warm_in_background(
        self, signature: Signature, warm: Callable[[], None]
    ) -> None:
        with self._lock:
            if signature in self._warming:
                return
            self._warming.add(signature)

        def run_warm():
            try:
                warm()
                # the warm ran the REAL pipeline (full analyzer list,
                # production batch shape) on the device tier: that is
                # warmth evidence in its own right, and it covers batteries
                # whose program key drifts from the signature (run-time
                # device-frequency scans)
                self._ran[signature] = True
                self.metrics.inc("deequ_service_programs_warmed_total")
            except Exception as exc:  # noqa: BLE001 - stored, and raised
                # by decide() for every later job of the battery: a kernel
                # that does not build or launch fails its jobs
                _logger.warning(
                    "background warm failed for battery of %d analyzers",
                    len(signature), exc_info=True,
                )
                self._warm_failed[signature] = exc
                self.metrics.inc("deequ_service_warm_failures_total")
            finally:
                # _warming is an in-flight marker, never a permanent claim:
                # a battery that goes cold again (warmth aged out, program
                # evicted) must always be able to re-warm
                with self._lock:
                    self._warming.discard(signature)

        try:
            self._warmer.submit(run_warm)
        except RuntimeError:
            # executor already shut down (service closing with jobs still
            # draining): warming is advisory — never let it kill the
            # worker that asked for a placement
            with self._lock:
                self._warming.discard(signature)

    #: decisions a battery spends on the host tier after a device failure
    #: before it may try the device again
    SUSPECT_PROBATION_RUNS = 8

    def note_device_failure(self, signature: Signature) -> None:
        """The engine recorded a device-tier failure (a failover to the host
        tier, an OOM bisection, a device stall, a shard loss) running this
        battery: the scheduler harvests it from the job's RunMonitor. Routes
        the battery to the host tier for the next
        :data:`SUSPECT_PROBATION_RUNS` decisions and drops its warmth
        claim (the program that was resident is suspect)."""
        if not signature:
            return
        with self._lock:
            self._device_suspect[signature] = self.SUSPECT_PROBATION_RUNS
        self._ran.pop(signature, None)
        self.metrics.inc("deequ_service_device_failures_total")

    # -- worker affinity -----------------------------------------------------

    def note_ran(
        self,
        signature: Signature,
        worker_id: int,
        placement: Optional[str] = None,
    ) -> None:
        """Record that ``worker_id`` executed ``signature``. Only a run
        whose EXECUTED placement was the device tier counts as warmth
        evidence (it built and launched the battery's kernels, run-time
        augmentations included) — a host-tier run launches none of them,
        and treating it as warm would send the next job straight into the
        cold build. Worker affinity records either way."""
        if not signature:
            return
        if placement == "device":
            self._ran[signature] = True
        with self._lock:
            workers = self._workers_by_sig.get(signature)
            if workers is None:
                workers = set()
                self._workers_by_sig[signature] = workers
            workers.add(worker_id)

    def preferred_workers(self, signature: Signature) -> Set[int]:
        with self._lock:
            return set(self._workers_by_sig.get(signature) or ())

    def close(self) -> None:
        if self._warmer is not None:
            # cancel queued warms: each may be a kernel build (nvcc), and
            # the executor's non-daemon threads would block
            # interpreter exit until every one finished
            self._warmer.shutdown(wait=False, cancel_futures=True)
