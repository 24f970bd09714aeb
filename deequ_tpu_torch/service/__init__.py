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
  Prometheus text and JSON snapshots fed from each run's RunMonitor, the
  unified ``/statusz`` ops snapshot (`statusz`) and the Arrow IPC ingest
  frontend (``POST /ingest/v1/<tenant>/<dataset>``,
  `deequ_tpu_torch.ingest.endpoint`);
- the **tenant plane**: a catalog of per-tenant suite documents
  (`catalog.TenantCatalog`, bound by `catalog.CatalogPlane`: sessions with
  their row gates, quotas and watches materialize from documents on first
  ingest and hot-reload at fold boundaries), per-tenant admission quotas
  (`scheduler.TenantQuota`), and the standing anomaly watch over the
  tenants' metric histories (`fleetwatch.FleetWatch`).

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

Partition-aware incremental verification: ``partition_store=`` (a
:class:`~deequ_tpu_torch.repository.PartitionStateStore`, a path, or None
for ``DEEQU_TPU_PARTITION_STORE``) backs
:meth:`VerificationService.submit_partitioned_verification`, and streaming
sessions flush their states into it as partitions when they close.

Not ported: the mesh and the fleet scheduler (ROADMAP A5b), which raise
naming their item, and the tuning controller (A6): every knob reads its
env override or static default.
"""

from __future__ import annotations

import threading
from typing import Any, Dict, Optional, Sequence, Tuple

from ..analyzers import Analyzer
from ..checks import Check
from ..config import DeviceLike, resolve_device
from ..data import Dataset
from ..exceptions import SchemaDriftError
from .catalog import CatalogError, CatalogPlane, TenantCatalog, TenantDocument
from .coalesce import CrossoverRouter, FoldCoalescer
from .drift import DriftReport, SchemaContract
from .errors import (
    JobFailed,
    JobTimeout,
    QuotaExceeded,
    ServiceClosed,
    ServiceError,
    ServiceOverloaded,
    SessionClosed,
    TransientFailure,
)
from .fleetwatch import (
    FLEETWATCH_ENV,
    FleetWatch,
    HarvestReport,
    WatchSpec,
    fleetwatch_enabled,
)
from .metrics import MetricsExporter, ServiceMetrics
from .placement import PlacementRouter, battery_signature, shape_qualified_signature
from .scheduler import JobContext, JobHandle, JobScheduler, Priority, TenantQuota
from .statusz import StatuszRegistry
from .streaming import StreamingSession, session_key

__all__ = [
    "VerificationService",
    "JobScheduler", "JobHandle", "JobContext", "Priority",
    "StreamingSession",
    "PlacementRouter", "battery_signature", "shape_qualified_signature",
    "ServiceMetrics", "MetricsExporter",
    "FoldCoalescer", "CrossoverRouter",
    "FleetWatch", "HarvestReport", "WatchSpec", "fleetwatch_enabled",
    "FLEETWATCH_ENV",
    "ServiceError", "ServiceOverloaded", "JobTimeout", "JobFailed",
    "TransientFailure", "SessionClosed", "ServiceClosed",
    "SchemaContract", "DriftReport", "SchemaDriftError",
    "TenantCatalog", "TenantDocument", "CatalogPlane", "CatalogError",
    "TenantQuota", "QuotaExceeded",
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
            raise _not_ported("a device mesh", "A5b")
        if fleet:
            raise _not_ported("the fleet scheduler", "A5b")
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
        # the store incremental verification diffs against; sessions flush
        # into it on close
        from ..repository.partition_store import (
            PartitionStateStore,
            default_partition_store,
        )

        if partition_store is None:
            self.partition_store = default_partition_store()
        elif isinstance(partition_store, str):
            self.partition_store = PartitionStateStore(partition_store)
        else:
            self.partition_store = partition_store
        #: cross-session fold coalescing + tiny-delta host fast path
        #: (DEEQU_TPU_COALESCE=0 bypasses it per ingest, exactly
        #: reproducing the serial path)
        self.coalescer = FoldCoalescer(self)
        #: the standing fleet-scale anomaly watch: every scheduler harvest
        #: of a WATCHED tenant re-scores the fleet's metric histories in
        #: batched detect_batch calls and surfaces anomalies on the export
        #: plane (DEEQU_TPU_FLEETWATCH=0 detaches the trigger; explicit
        #: harvest_now() always works)
        self.fleetwatch = FleetWatch(self)
        self.fleetwatch.attach()
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
        # the tenant plane's declarative frontend: a catalog of per-tenant
        # suite DOCUMENTS (checks, row gate, quotas, watches, drift and
        # priority policy), bound to this service by a CatalogPlane that
        # materializes sessions from documents on first ingest and
        # hot-reloads them at fold boundaries. A TenantCatalog or a root
        # path; None = no catalog (sessions are built programmatically).
        self.catalog_plane = None
        if catalog is not None:
            if isinstance(catalog, str):
                catalog = TenantCatalog(catalog, metrics=self.metrics)
            self.catalog_plane = CatalogPlane(self, catalog)
        #: the unified ops snapshot (/statusz): one section per plane, read
        #: through to the live planes at snapshot time
        self.statusz = StatuszRegistry()
        self._register_statusz_planes()

    def _register_statusz_planes(self) -> None:
        """Register the six REQUIRED_PLANES sections of the /statusz
        document (the reference's, deequ_tpu/service/__init__.py:226-325)
        against this service's live planes, plus one section each for the
        mesh and the fleet scheduler, which say that they are not ported.
        Sections read through to the planes at snapshot time — never
        cached."""

        def scheduler_section():
            return {
                "queue_depth": self.scheduler.pending(),
                "active_jobs": self.scheduler._active,
                "workers": len(self.scheduler._workers),
                "shed_total": self.metrics.counter_value("deequ_service_jobs_shed_total"),
                "quota_shed_total": self.metrics.counter_value(
                    "deequ_service_quota_shed_total"),
                "ingest_shed_total": self.metrics.counter_value(
                    "deequ_service_ingest_shed_total"),
            }

        def tuning_section():
            # no controller: every knob is its env override or static default
            from ..tuning import knobs

            return {"enabled": False,
                    "static_knobs": {name: knobs.value(name) for name in sorted(knobs.REGISTRY)}}

        def catalog_section():
            plane = self.catalog_plane
            if plane is None:
                return {"enabled": False}
            catalog = plane.catalog
            return {
                "enabled": True,
                "tenant_versions": {
                    tenant: catalog.current_version(tenant) for tenant in catalog.tenants()
                },
            }

        def partition_store_section():
            store = self.partition_store
            if store is None:
                return {"attached": False}
            from ..repository.partition_store import partition_quarantined_total

            section = {
                "attached": True,
                "path": getattr(store, "path", None),
                "quarantined_total": partition_quarantined_total(),
            }
            # compaction lag lives on the metrics-HISTORY repositories; the
            # long-lived ones the service knows are the fleet watch's
            lags = {}
            with self.fleetwatch._lock:
                repos = {f"{t}/{d}": w.repository
                         for (t, d), w in self.fleetwatch._watches.items()}
            for key, repo in sorted(repos.items()):
                lag_fn = getattr(repo, "compaction_lag", None)
                if callable(lag_fn):
                    try:
                        lags[key] = lag_fn()
                    except Exception:  # noqa: BLE001 - one sick repo must
                        # not blank the whole section
                        lags[key] = {"error": "unreadable"}
            section["compaction_lag"] = lags
            section["max_loose_entries"] = max(
                (lag.get("max_loose", 0) for lag in lags.values()
                 if isinstance(lag, dict) and "max_loose" in lag),
                default=0,
            )
            return section

        def not_ported(what: str, item: str):
            return lambda: {"attached": False, "ported": False,
                            "detail": f"{what} is not ported (ROADMAP {item})"}

        self.statusz.register("scheduler", scheduler_section)
        self.statusz.register("tuning", tuning_section)
        self.statusz.register("cluster", not_ported("the cluster plane", "A6"))
        self.statusz.register("catalog", catalog_section)
        self.statusz.register("fleetwatch", self.fleetwatch.statusz_section)
        self.statusz.register("partition_store", partition_store_section)
        self.statusz.register("mesh", not_ported("the service's device mesh", "A5b"))
        self.statusz.register("fleet", not_ported("the fleet scheduler", "A5b"))

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

    def submit_partitioned_verification(
        self,
        dataset_name: str,
        partitions,
        checks: Sequence[Check],
        *,
        checksums=None,
        required_analyzers: Sequence[Analyzer] = (),
        tenant: str = "default",
        priority: Priority = Priority.NORMAL,
        deadline_s: Optional[float] = None,
        max_retries: int = 0,
        batch_size: Optional[int] = None,
        store=None,
        metrics_repository: Optional[Any] = None,
        save_or_append_results_with_key: Optional[Any] = None,
        delete_dropped: bool = False,
    ) -> JobHandle:
        """Queue one incremental verification run against the service's
        partition store (or ``store``): the delta planner diffs
        ``partitions`` against it, scans only new or changed partitions on
        the service's device and checks the merge of stored and fresh
        states (``VerificationSuite.verify_partitioned``). The job's
        partition counters go to the export plane per tenant
        (``deequ_service_partitions_*_total``). ``max_retries`` defaults to
        0: a scan persists states and commits manifests as it goes, so a
        re-run after a partial failure re-plans and reuses what committed."""
        from ..verification import VerificationSuite

        target = store if store is not None else self.partition_store
        if target is None:
            raise ValueError(
                "no partition store: pass store=, construct the service with "
                "partition_store=, or set DEEQU_TPU_PARTITION_STORE"
            )
        checks = list(checks)
        required = list(required_analyzers)

        def run(ctx: JobContext):
            return VerificationSuite.verify_partitioned(
                target, dataset_name, partitions, checks, required, checksums=checksums,
                batch_size=batch_size, monitor=ctx.monitor, placement=ctx.placement,
                metrics_repository=metrics_repository,
                save_or_append_results_with_key=save_or_append_results_with_key,
                delete_dropped=delete_dropped, device=self.device,
            )

        return self.scheduler.submit(run, tenant=tenant, priority=priority,
                                     deadline_s=deadline_s, max_retries=max_retries)

    def verify_partitioned(self, dataset_name: str, partitions, checks: Sequence[Check], **kw):
        """Blocking convenience of :meth:`submit_partitioned_verification`."""
        timeout = kw.pop("timeout", None)
        return self.submit_partitioned_verification(dataset_name, partitions, checks,
                                                    **kw).result(timeout)

    def watch_metrics(
        self,
        tenant: str,
        repository: Any,
        analyzers,
        strategy: Any = None,
        dataset: str = "default",
        tags: Optional[Dict[str, str]] = None,
    ):
        """Register a standing anomaly watch over ``tenant``'s committed
        metric history (see `service.fleetwatch`): on every scheduler
        harvest the fleet watch re-scores every watched series in batched
        ``detect_batch`` calls and surfaces anomalies as
        ``deequ_service_anomaly_*`` export series plus trace-correlated
        flight dumps."""
        return self.fleetwatch.watch(
            tenant, repository, analyzers, strategy=strategy, dataset=dataset, tags=tags,
        )

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

    def start_exporter(
        self, host: str = "127.0.0.1", port: int = 0, ingest: bool = True
    ) -> MetricsExporter:
        """Serve the HTTP plane: ``/metrics``, ``/metrics.json``, ``/trace``
        and the unified ``/statusz`` ops snapshot, and (with
        ``ingest=True``, the default) the Arrow IPC ingest frontend at
        ``POST /ingest/v1/<tenant>/<dataset>`` bound to this service's
        streaming sessions. The handler threads only decode frames and
        submit folds; the folds run on the scheduler's workers."""
        if self._exporter is not None:
            if host != self._exporter.host or port not in (0, self._exporter.port):
                raise ValueError(
                    f"metrics exporter already bound to "
                    f"{self._exporter.host}:{self._exporter.port}; cannot "
                    f"rebind to {host}:{port}"
                )
            return self._exporter
        endpoint = None
        if ingest:
            from ..ingest import IngestEndpoint

            endpoint = IngestEndpoint(self)
        self._exporter = MetricsExporter(
            self.metrics, host=host, port=port, ingest=endpoint,
            statusz=self.statusz.snapshot,
        )
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
