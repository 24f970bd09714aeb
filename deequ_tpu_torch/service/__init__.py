"""Continuous verification service: the layer between
``VerificationSuite.run()`` and callers (the reference's
``deequ_tpu/service/``, its core ported).

One :class:`VerificationService` hosts:

- a multi-tenant **job scheduler** (`scheduler.JobScheduler`): bounded
  admission with typed load shedding, priority classes, per-job deadlines,
  retry-with-backoff on transient failures;
- **streaming micro-batch sessions** (`streaming.StreamingSession`):
  per-(tenant, dataset) incremental verification over persisted algebraic
  states, checks evaluated on every merge;
- **cross-session fold coalescing** (`coalesce.FoldCoalescer`): tiny folds
  merge on the host, the rest of a group of sessions folds in one stacked
  launch per kernel on the device;
- **cache-aware placement** (`placement.PlacementRouter`): batteries whose
  kernels are warm run on the device tier, cold ones on the host tier while
  their kernels build in the background;
- an **export plane** (`metrics.ServiceMetrics` / `MetricsExporter`):
  Prometheus text and JSON snapshots fed from each run's RunMonitor.

Every run and fold of a service goes to its ``device`` (``"cuda"`` unless
the caller names another; without a card, construction raises unless the
caller passes ``device="cpu"``).

Usage::

    service = VerificationService(workers=4, max_queue_depth=128)
    handle = service.submit_verification(data, [check], tenant="team-a")
    result = handle.result(timeout=60)

    session = service.session("team-a", "clickstream", [check])
    session.ingest(micro_batch)          # checks evaluated on the merge

    print(service.prometheus_text())
    service.close()

Not ported: the mesh and the fleet scheduler (ROADMAP A5), the tenant
catalog, the fleet watch and the tuning controller (A6), partition stores
and partitioned verification (A3); each raises naming its item.
"""

from __future__ import annotations

import threading
from typing import Any, Dict, Optional, Sequence, Tuple

from ..analyzers import Analyzer
from ..checks import Check
from ..config import DeviceLike, resolve_device
from ..data import Dataset
from ..exceptions import SchemaDriftError
from .coalesce import CrossoverRouter, FoldCoalescer
from .drift import DriftReport, SchemaContract
from .errors import (
    JobFailed,
    JobTimeout,
    ServiceClosed,
    ServiceError,
    ServiceOverloaded,
    SessionClosed,
    TransientFailure,
)
from .metrics import MetricsExporter, ServiceMetrics
from .placement import PlacementRouter, battery_signature, shape_qualified_signature
from .scheduler import JobContext, JobHandle, JobScheduler, Priority
from .streaming import StreamingSession, session_key

__all__ = [
    "VerificationService",
    "JobScheduler", "JobHandle", "JobContext", "Priority",
    "StreamingSession",
    "PlacementRouter", "battery_signature", "shape_qualified_signature",
    "ServiceMetrics", "MetricsExporter",
    "FoldCoalescer", "CrossoverRouter",
    "ServiceError", "ServiceOverloaded", "JobTimeout", "JobFailed",
    "TransientFailure", "SessionClosed", "ServiceClosed",
    "SchemaContract", "DriftReport", "SchemaDriftError",
]


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not part of deequ_tpu_torch's service yet (ROADMAP {item})"
    )


class VerificationService:
    """The orchestration facade of the service plane."""

    def __init__(
        self,
        workers: int = 4,
        max_queue_depth: int = 128,
        *,
        device: DeviceLike = None,
        state_root: Optional[str] = None,
        background_warm: bool = True,
        metrics: Optional[ServiceMetrics] = None,
        mesh=None,
        fleet: Optional[bool] = None,
        partition_store=None,
        catalog=None,
    ):
        if mesh is not None:
            raise _not_ported("a device mesh", "A5")
        if fleet:
            raise _not_ported("the fleet scheduler", "A5")
        if partition_store is not None:
            raise _not_ported("a partition store", "A3")
        if catalog is not None:
            raise _not_ported("the tenant catalog", "A6")
        #: every run and fold of this service goes to this device
        self.device = resolve_device(device)
        self.metrics = metrics or ServiceMetrics()
        self.router = PlacementRouter(
            self.metrics, device=self.device, background_warm=background_warm
        )
        self.scheduler = JobScheduler(
            workers=workers,
            max_queue_depth=max_queue_depth,
            metrics=self.metrics,
            router=self.router,
        )
        self.state_root = state_root
        #: cross-session fold coalescing + tiny-delta host fast path
        #: (DEEQU_TPU_COALESCE=0 bypasses it per ingest, exactly
        #: reproducing the serial path)
        self.coalescer = FoldCoalescer(self)
        #: the self-tuning controller is not ported: every knob reads its
        #: env override or static default, as the reference's does under
        #: DEEQU_TPU_AUTOTUNE=0
        self.tuning_controller = None
        self._sessions: Dict[Tuple[str, str], StreamingSession] = {}
        self._sessions_lock = threading.Lock()
        self._exporter: Optional[MetricsExporter] = None

        def open_sessions() -> int:
            with self._sessions_lock:  # a scrape must not race session()
                return sum(1 for s in self._sessions.values() if not s.closed)

        self.metrics.set_gauge_fn(
            "deequ_service_open_sessions", open_sessions,
            "Streaming sessions currently accepting micro-batches.",
        )
        from .streaming import describe_streaming_series

        describe_streaming_series(self.metrics)

    # -- one-shot jobs -------------------------------------------------------

    def submit_verification(
        self,
        data: Dataset,
        checks: Sequence[Check],
        *,
        required_analyzers: Sequence[Analyzer] = (),
        tenant: str = "default",
        priority: Priority = Priority.NORMAL,
        deadline_s: Optional[float] = None,
        max_retries: int = 2,
        retry_on: Tuple[type, ...] = (),
        batch_size: Optional[int] = None,
        metrics_repository: Optional[Any] = None,
        save_or_append_results_with_key: Optional[Any] = None,
    ) -> JobHandle:
        """Queue one verification run; returns immediately with a
        :class:`JobHandle` (or raises :class:`ServiceOverloaded`)."""
        from ..runners.analysis_runner import collect_required_analyzers
        from ..verification import VerificationSuite
        from .placement import make_warm_fn
        from .streaming import _session_batch_size

        # materialize BEFORE collecting: a one-shot iterable would be
        # consumed by the signature walk and the job would verify nothing
        checks = list(checks)
        required = list(required_analyzers)
        analyzers = collect_required_analyzers(checks, required)
        # the streaming ingests' sizing rule (power-of-two bucket clamped
        # to the engine default), so warmth keys match the dispatched size
        effective_bs = _session_batch_size(int(data.num_rows), batch_size)

        def run(ctx: JobContext):
            return VerificationSuite.do_verification_run(
                data,
                checks,
                required,
                metrics_repository=metrics_repository,
                save_or_append_results_with_key=save_or_append_results_with_key,
                batch_size=effective_bs,
                monitor=ctx.monitor,
                device=self.device,
                placement=ctx.placement,
            )

        return self.scheduler.submit(
            run,
            tenant=tenant,
            priority=priority,
            deadline_s=deadline_s,
            max_retries=max_retries,
            retry_on=retry_on,
            signature=shape_qualified_signature(analyzers, effective_bs),
            warm_fn=make_warm_fn(self.router, analyzers, data, effective_bs),
        )

    def verify(self, data: Dataset, checks: Sequence[Check], **kw):
        """Blocking convenience: submit + wait for the result."""
        timeout = kw.pop("timeout", None)
        return self.submit_verification(data, checks, **kw).result(timeout)

    def submit_partitioned_verification(self, *args, **kwargs):
        raise _not_ported("partition-aware incremental verification", "A3")

    def verify_partitioned(self, *args, **kwargs):
        raise _not_ported("partition-aware incremental verification", "A3")

    def watch_metrics(self, *args, **kwargs):
        raise _not_ported("the fleet watch", "A6")

    # -- streaming sessions --------------------------------------------------

    def session(
        self, tenant: str, dataset: str, checks: Sequence[Check] = (), **kw
    ) -> StreamingSession:
        """Get-or-create the streaming session for (tenant, dataset). On
        first creation, ``checks`` (and any StreamingSession kwargs) define
        the session; later calls return the live session unchanged."""
        key = session_key(tenant, dataset)
        with self._sessions_lock:
            existing = self._sessions.get(key)
            if existing is not None and not existing.closed:
                return existing
            if existing is not None and not checks and not kw:
                # a bare get of a CLOSED session must not silently
                # recreate it with zero checks and empty state
                raise SessionClosed(tenant, dataset)
            if "state_provider" not in kw and self.state_root is not None:
                from urllib.parse import quote

                from ..analyzers.state_provider import FileSystemStateProvider

                # the reference's layout: each component quoted (a "/"
                # inside a name cannot alias another pair's namespace) and
                # prefixed (an EMPTY component still names a segment)
                kw["state_provider"] = FileSystemStateProvider(
                    self.state_root,
                    namespace=f"t-{quote(tenant, safe='')}/"
                    f"d-{quote(dataset, safe='')}",
                )
            session = StreamingSession(self, tenant, dataset, checks, **kw)
            self._sessions[key] = session
            return session

    def get_session(
        self, tenant: str, dataset: str, include_closed: bool = False
    ) -> Optional[StreamingSession]:
        """The LIVE session for (tenant, dataset), or None — a pure lookup,
        never a create. ``include_closed=True`` also returns a CLOSED
        session."""
        with self._sessions_lock:
            session = self._sessions.get(session_key(tenant, dataset))
            if session is None or (session.closed and not include_closed):
                return None
            return session

    # -- export plane --------------------------------------------------------

    def prometheus_text(self) -> str:
        return self.metrics.prometheus_text()

    def json_snapshot(self) -> Dict[str, Any]:
        return self.metrics.json_snapshot()

    def start_exporter(self, host: str = "127.0.0.1", port: int = 0) -> MetricsExporter:
        """Serve ``/metrics``, ``/metrics.json`` and ``/trace`` over HTTP."""
        if self._exporter is not None:
            if host != self._exporter.host or port not in (0, self._exporter.port):
                raise ValueError(
                    f"metrics exporter already bound to "
                    f"{self._exporter.host}:{self._exporter.port}; cannot "
                    f"rebind to {host}:{port}"
                )
            return self._exporter
        self._exporter = MetricsExporter(self.metrics, host=host, port=port)
        return self._exporter

    # -- lifecycle -----------------------------------------------------------

    def close(self, wait: bool = True, timeout: Optional[float] = None) -> None:
        # drain FIRST: already-admitted folds must complete (shutdown's
        # "workers drain every pending job" contract)
        self.scheduler.shutdown(wait=wait, timeout=timeout)
        # with wait=False (or an expired timeout) folds may still be queued
        # or running: leave the sessions open so the workers finish them
        if self.scheduler.idle():
            with self._sessions_lock:
                for session in self._sessions.values():
                    session.close()
        if self._exporter is not None:
            self._exporter.close()
            self._exporter = None

    def __enter__(self) -> "VerificationService":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
