"""One cluster worker: a :class:`~deequ_tpu_torch.service.VerificationService`
plus the cluster-facing session protocol the front tier drives (the
reference's ``deequ_tpu/cluster/worker.py``).

A worker is a whole single-host service plane (its scheduler, coalescer,
placement router, metrics exporter and, optionally, HTTP ingest endpoint)
made clusterable by three capabilities layered here:

- **open / ingest / flush** against sessions addressed by (tenant,
  dataset): what the front tier routes to the ring-chosen host;
- **release**: flush the session's cumulative algebraic states (and its
  checksummed schema contract) into the SHARED partition store, then close
  it: the first half of a legal migration (sessions move hosts only at
  fold boundaries);
- **adopt**: re-open a session from the flushed partition's states
  (:class:`AdoptedStates`), so the new host resumes from the exact
  cumulative states and contract the old host committed: the second half
  of a migration, and
  the recovery path after a host loss (salvage from the store, then the
  front tier replays the folds the flush missed).

Workers also heartbeat the shared membership directory so the front tier
can tell a live host from a dead one. A worker runs where its service
runs: it takes the service's ``device`` and adds no default of its own.
Every fold of an adopted session merges into the states adopted from the
flushed partition, on the card through the service's state fold (K8).
"""

from __future__ import annotations

from contextlib import contextmanager
from typing import Any, Optional, Sequence

from ..analyzers.state_provider import InMemoryStateProvider, StateLoader, StatePersister
from ..observability import trace as _trace
from .membership import HeartbeatMembership


class AdoptedStates(StateLoader, StatePersister):
    """The state provider of an adopted session: it reads the flushed
    partition's states until the session persists its own, and keeps those
    with the session. The partition itself stays at the last flush until
    the session flushes again, so a host loss replays the journal onto
    exactly the states the journal started from. (The reference's adopted
    session persists every fold into the partition's directory, and a loss
    after an adoption then replays folds the partition already holds.)
    ``path`` is the partition's, so the schema contract flushed beside the
    states loads with them."""

    def __init__(self, partition) -> None:
        self.partition = partition
        self.path = getattr(partition, "path", None)
        self._own = InMemoryStateProvider()

    def load(self, analyzer):
        state = self._own.load(analyzer)
        return state if state is not None else self.partition.load(analyzer)

    def persist(self, analyzer, state) -> None:
        self._own.persist(analyzer, state)


def session_partition(tenant: str) -> str:
    """The partition a (tenant, dataset) session flushes into. It must
    match ``StreamingSession._flush_to_partition_locked``'s default, so
    that adoption reads exactly what release wrote."""
    return f"session-{tenant}"


class LocalWorker:
    """In-process worker: wraps a service the front tier can route to.

    The same protocol an HTTP-fronted worker speaks
    (``tools/torch_cluster_soak.py`` drives remote workers through the
    ingest endpoint); in-process it is plain method calls, which is what
    the tests and the drills compose."""

    def __init__(self, host_id: str, service, membership: Optional[HeartbeatMembership] = None) -> None:
        self.host_id = str(host_id)
        self.service = service
        self.membership = membership
        if membership is not None and not membership.host_id:
            membership.host_id = self.host_id
        # a cluster-attached worker owns the truth about ITS half of the
        # cluster plane: its per-host view (membership, owned sessions)
        # replaces the service's detached /statusz section; ring ownership
        # lives on the front tier
        statusz = getattr(service, "statusz", None)
        if statusz is not None:
            statusz.register("cluster", self._statusz_section)

    def _statusz_section(self) -> dict:
        section: dict = {"attached": True, "host": self.host_id}
        if self.membership is not None:
            try:
                section["members"] = sorted(self.membership.members())
            except Exception as exc:  # noqa: BLE001 - a torn membership
                # directory must not blank the section
                section["members_error"] = f"{type(exc).__name__}: {exc}"
        sessions = getattr(self.service, "_sessions", {})
        lock = getattr(self.service, "_sessions_lock", None)
        if lock is not None:
            with lock:
                section["sessions"] = sorted(
                    f"{t}/{d}" for (t, d), s in sessions.items() if not s.closed
                )
        return section

    # -- lifecycle -------------------------------------------------------

    def start(self) -> None:
        if self.membership is not None:
            self.membership.start()

    def close(self, **kw) -> None:
        if self.membership is not None:
            self.membership.stop()
        self.service.close(**kw)

    # -- tracing ---------------------------------------------------------

    @contextmanager
    def _span(self, name: str, trace_ctx: Optional[str], **attrs: Any):
        """The worker-side span of one protocol call, attached for the
        body. ``trace_ctx`` is a serialized
        :data:`~deequ_tpu_torch.observability.trace.TRACE_HEADER` value
        from the front tier: extracting it parents this span under the
        FRONT's trace (one trace_id across the hop); without it the span
        joins this thread's context (an in-process front) or starts a new
        root. These spans are what a SIGKILLed worker leaves behind in its
        span journal."""
        parent = "auto" if trace_ctx is None else _trace.extract(trace_ctx)
        sp = _trace.start_span(name, kind="cluster", attrs={"host": self.host_id, **attrs},
                               parent=parent)
        with _trace.attach(sp):
            try:
                yield sp
            except BaseException as exc:
                if sp is not _trace.NULL:
                    sp.set_attr("error", f"{type(exc).__name__}: {exc}")
                sp.finish("error")
                raise
            else:
                sp.finish()

    # -- session protocol ------------------------------------------------

    def open_session(self, tenant: str, dataset: str, checks: Sequence[Any] = (),
                     trace_ctx: Optional[str] = None, **kw):
        with self._span("worker_open", trace_ctx, tenant=tenant, dataset=dataset):
            return self.service.session(tenant, dataset, checks, **kw)

    def ingest(self, tenant: str, dataset: str, data, trace_ctx: Optional[str] = None, **kw):
        with self._span("worker_ingest", trace_ctx, tenant=tenant, dataset=dataset):
            session = self.service.get_session(tenant, dataset)
            if session is None:
                raise KeyError(f"no live session {tenant}/{dataset} on host {self.host_id}")
            return session.ingest(data, **kw)

    def flush(self, tenant: str, dataset: str, partition: Optional[str] = None,
              trace_ctx: Optional[str] = None) -> Optional[str]:
        """Flush the session's cumulative states and contract into the
        shared partition store (a fold boundary). Returns the partition
        name, or None when the session never folded."""
        with self._span("worker_flush", trace_ctx, tenant=tenant, dataset=dataset):
            session = self.service.get_session(tenant, dataset)
            if session is None:
                return None
            return session.flush_to_partition(partition=partition)

    def release(self, tenant: str, dataset: str, trace_ctx: Optional[str] = None) -> Optional[str]:
        """Flush, then CLOSE the session: the outbound half of a
        migration. After release the states live in the partition store
        and this host serves 410 for the session."""
        with self._span("worker_release", trace_ctx, tenant=tenant, dataset=dataset):
            session = self.service.get_session(tenant, dataset)
            if session is None:
                return None
            name = session.flush_to_partition()
            session.close()
            return name

    def adopt_session(self, tenant: str, dataset: str, checks: Sequence[Any] = (),
                      partition: Optional[str] = None, trace_ctx: Optional[str] = None, **kw):
        """Re-open a migrated or lost session from the shared partition
        store: the new session's states start as the flushed partition's
        (:class:`AdoptedStates`), so it resumes from the committed
        cumulative states and re-loads the checksummed schema contract
        beside them (drift policies fire identically after the move). A session that never
        flushed adopts an EMPTY provider, which is right: the front tier
        then replays every journaled fold."""
        name = partition or session_partition(tenant)
        with self._span("worker_adopt", trace_ctx, tenant=tenant, dataset=dataset,
                        partition=name):
            store = getattr(self.service, "partition_store", None)
            if store is None:
                raise ValueError(f"host {self.host_id} has no partition store to adopt from")
            kw.setdefault("state_provider", AdoptedStates(store.provider(dataset, name)))
            session = self.service.session(tenant, dataset, checks, **kw)
            if session._schema is None:
                manifest = store.get(dataset, name)
                if manifest is not None and manifest.schema:
                    from ..data import ColumnKind, ColumnSchema, Schema

                    # the flushed manifest carries the schema the states
                    # were folded under: restoring it lets the adopted
                    # session serve state-only queries (current()) BEFORE
                    # its first fold here, and keeps the committed row
                    # total cumulative across the migration
                    session._schema = Schema([ColumnSchema(n, ColumnKind(k))
                                              for n, k in manifest.schema])
                    session.rows_ingested = int(manifest.num_rows)
            return session

    def session_stats(self, tenant: str, dataset: str) -> dict:
        session = self.service.get_session(tenant, dataset)
        if session is None:
            return {}
        return {
            "host": self.host_id,
            "batches": session.batches_ingested,
            "rows": session.rows_ingested,
            "bytes": session.bytes_ingested,
        }
