"""Front tier: consistent-hash session routing, legal migration and
host-loss recovery over a set of workers (the reference's
``deequ_tpu/cluster/front.py``).

The ring (:class:`~deequ_tpu_torch.cluster.ring.HashRing`) is the only
routing authority: a session key ``tenant/dataset`` always belongs to
``ring.route(key)``. When a membership change moves a key's arc, the front
tier performs the LEGAL move: sessions migrate only at fold boundaries, as
flush-on-old / adopt-on-new through the shared partition store, carrying
the cumulative algebraic states AND the checksummed schema contract. Two
flavours:

- **graceful** (triggered by ring changes): the old host flushes and
  closes first, so the partition store holds everything and nothing
  replays;
- **loss** (:meth:`FrontTier.handle_host_loss`, triggered by missed
  heartbeats or a typed :class:`~deequ_tpu_torch.exceptions.HostLossError`):
  the dead host flushed LAST at some earlier boundary, so the survivor
  adopts the store's states and the front tier replays its per-session
  fold journal (every payload accepted since the last flush) into the
  adopted session. Algebraic states make replay exact: salvage plus replay
  equals the lost session, fold for fold.

Every routing decision, migration, loss and replay bumps a typed
``deequ_service_cluster_*`` counter (described in
:func:`~deequ_tpu_torch.cluster.describe_cluster_series`), so a drill can
PROVE recovery happened rather than infer it from timing.
"""

from __future__ import annotations

import threading
from typing import Any, Dict, List, Optional, Sequence, Tuple

from ..config import CLUSTER_JOURNAL_MAX_FOLDS_ENV
from ..exceptions import HostLossError
from ..observability import trace as _trace
from ..utils import env_number
from .membership import HeartbeatMembership
from .ring import HashRing
from .worker import LocalWorker, session_partition

#: folds a session's replay journal may hold before the front tier
#: FORCE-FLUSHES the session to the partition store (clearing the
#: journal): the journal exists to replay the window since the last flush,
#: and a producer that never calls flush() would otherwise grow it one
#: payload per fold for the session's whole life. Minimum 1.
DEFAULT_CLUSTER_JOURNAL_MAX_FOLDS = 256


def cluster_journal_max_folds() -> int:
    return int(env_number(CLUSTER_JOURNAL_MAX_FOLDS_ENV, DEFAULT_CLUSTER_JOURNAL_MAX_FOLDS,
                          int, minimum=1))


def _key(tenant: str, dataset: str) -> Tuple[str, str]:
    return (str(tenant), str(dataset))


def _ring_key(key: Tuple[str, str]) -> str:
    return f"{key[0]}/{key[1]}"


class FrontTier:
    """Routes session traffic to ring-chosen workers; owns migration and
    recovery. Thread-safe: one re-entrant lock serializes membership
    changes, placements and journals (the ingest forward itself runs
    outside the lock: the target session serializes its own folds)."""

    def __init__(self, metrics=None, membership: Optional[HeartbeatMembership] = None,
                 vnodes: Optional[int] = None) -> None:
        from ..service.metrics import ServiceMetrics
        from . import describe_cluster_series

        self.ring = HashRing(vnodes=vnodes)
        self.workers: Dict[str, LocalWorker] = {}
        self.membership = membership
        self.metrics = metrics if metrics is not None else ServiceMetrics()
        describe_cluster_series(self.metrics)
        self._lock = threading.RLock()
        #: key -> (checks, session kwargs): what re-creates the session
        #: anywhere (the schema contract travels through the store)
        self._specs: Dict[Tuple[str, str], Tuple[tuple, dict]] = {}
        #: key -> host holding the live session
        self._placements: Dict[Tuple[str, str], str] = {}
        #: key -> payloads accepted since the last flush: the replay log
        #: that makes loss recovery exact (cleared at every flush, so it
        #: holds one fold window; bounded by a force-flush at
        #: DEEQU_TPU_CLUSTER_JOURNAL_MAX_FOLDS)
        self._journal: Dict[Tuple[str, str], List[Any]] = {}
        self._journal_max_folds = cluster_journal_max_folds()

    # -- membership ------------------------------------------------------

    def _count_moves(self, before: HashRing) -> Dict[str, Tuple[str, str]]:
        """The placed keys the last ring change re-homed, counted."""
        moved = self.ring.moved_keys([_ring_key(k) for k in self._placements], before)
        if moved:
            self.metrics.inc("deequ_service_cluster_ring_moves_total", len(moved))
        return moved

    def add_worker(self, worker: LocalWorker) -> None:
        """Join ``worker``; keys whose arc re-homes onto it migrate
        gracefully (flush on the old host, adopt on the new)."""
        with self._lock:
            before = self.ring.snapshot()
            self.ring.add_host(worker.host_id)
            self.workers[worker.host_id] = worker
            worker.start()
            moved = self._count_moves(before)
            for key in list(self._placements):
                if _ring_key(key) in moved:
                    self._migrate_locked(key, self.ring.route(_ring_key(key)))

    def remove_worker(self, host: str) -> None:
        """Gracefully drain ``host``: its sessions migrate to the ring's
        survivors (flushed first, nothing replays), then it leaves."""
        with self._lock:
            worker = self.workers.get(host)
            if worker is None:
                return
            before = self.ring.snapshot()
            self.ring.remove_host(host)
            self._count_moves(before)
            for key, placed in list(self._placements.items()):
                if placed == host:
                    self._migrate_locked(key, self.ring.route(_ring_key(key)))
            del self.workers[host]
            worker.close()

    def check_membership(self) -> List[str]:
        """One health sweep: scan the heartbeats and recover every host
        the TTL (or an injected ``host_loss`` fault) declares dead.
        Returns the hosts recovered in this sweep."""
        if self.membership is None:
            return []
        _alive, lost = self.membership.scan()
        handled = []
        for host in lost:
            if host in self.workers:
                self.handle_host_loss(host)
                handled.append(host)
            self.membership.retire(host)
        return handled

    # -- session plane ---------------------------------------------------

    def route(self, tenant: str, dataset: str) -> str:
        """The ring-chosen host of a session key."""
        host = self.ring.route(_ring_key(_key(tenant, dataset)))
        self.metrics.inc("deequ_service_cluster_routes_total")
        return host

    def open_session(self, tenant: str, dataset: str, checks: Sequence[Any] = (), **kw) -> str:
        """Create the session on its ring-chosen host and remember its
        spec, so that migration and recovery can re-create it elsewhere.
        Returns the host it was placed on."""
        key = _key(tenant, dataset)
        with self._lock, _trace.span("cluster_open", kind="cluster",
                                     session=_ring_key(key)) as sp:
            host = self.route(tenant, dataset)
            if sp is not _trace.NULL:
                sp.set_attr("target", host)
            self._specs[key] = (tuple(checks), dict(kw))
            self.workers[host].open_session(tenant, dataset, checks, trace_ctx=_trace.inject(), **kw)
            self._placements[key] = host
            self._journal.setdefault(key, [])
            return host

    def ingest(self, tenant: str, dataset: str, data, **kw):
        """Forward one micro-batch to the session's host (migrating first
        if the ring re-homed the key) and journal the payload for loss
        replay. A journal that reaches
        ``DEEQU_TPU_CLUSTER_JOURNAL_MAX_FOLDS`` payloads force-flushes the
        session AFTER this fold commits."""
        key = _key(tenant, dataset)
        with _trace.span("cluster_ingest", kind="cluster", session=_ring_key(key)) as sp:
            with self._lock:
                if key not in self._placements:
                    raise KeyError(f"unknown session {tenant}/{dataset}: open it via "
                                   "the front tier first")
                owner = self.route(tenant, dataset)
                if owner != self._placements[key]:
                    self._migrate_locked(key, owner)
                worker = self.workers[self._placements[key]]
                if sp is not _trace.NULL:
                    sp.set_attr("target", self._placements[key])
                journal = self._journal.setdefault(key, [])
                journal.append(data)
                force_flush = len(journal) >= self._journal_max_folds
            result = worker.ingest(tenant, dataset, data, trace_ctx=_trace.inject(sp), **kw)
        if force_flush:
            # flush only AFTER the worker committed this fold: flushing
            # first would clear a journal entry whose fold has not reached
            # the session yet, and a host loss in that window would replay
            # nothing and lose the payload
            self.flush(tenant, dataset)
            self.metrics.inc("deequ_service_cluster_journal_flushes_total")
        return result

    def flush(self, tenant: str, dataset: str) -> Optional[str]:
        """A fold boundary: flush the session's cumulative states and
        contract to the partition store and clear its replay journal
        (everything journaled is now durably committed)."""
        key = _key(tenant, dataset)
        with self._lock, _trace.span("cluster_flush", kind="cluster", session=_ring_key(key)):
            host = self._placements.get(key)
            if host is None:
                return None
            name = self.workers[host].flush(tenant, dataset, trace_ctx=_trace.inject())
            if name is not None:
                self._journal[key] = []
            return name

    def flush_all(self) -> None:
        with self._lock:
            for tenant, dataset in list(self._placements):
                self.flush(tenant, dataset)

    # -- migration and recovery ------------------------------------------

    def _migrate_locked(self, key: Tuple[str, str], new_host: str) -> None:
        """A graceful move at a fold boundary: release (flush and close)
        on the old host, adopt from the store on the new one. The flush
        captures every journaled fold, so the journal clears."""
        tenant, dataset = key
        old_host = self._placements.get(key)
        if old_host == new_host:
            return
        checks, kw = self._specs.get(key, ((), {}))
        with _trace.span("cluster_migrate", kind="cluster", session=_ring_key(key),
                         source=old_host or "", target=new_host):
            partition = None
            if old_host is not None and old_host in self.workers:
                partition = self.workers[old_host].release(tenant, dataset,
                                                           trace_ctx=_trace.inject())
            self.workers[new_host].adopt_session(
                tenant, dataset, checks, partition=partition or session_partition(tenant),
                trace_ctx=_trace.inject(), **dict(kw),
            )
            self._placements[key] = new_host
            if partition is not None:
                self._journal[key] = []
            self.metrics.inc("deequ_service_cluster_migrations_total")

    def handle_host_loss(self, host: str) -> List[Tuple[str, str]]:
        """Recover every session placed on a DEAD host: re-hash its ring
        range to the survivors, adopt each session from its last flushed
        partition and replay the journaled folds the flush missed. Returns
        the recovered keys. Raises :class:`HostLossError` when no survivor
        is left to adopt onto."""
        with self._lock, _trace.span("cluster_host_loss", kind="cluster", host=host):
            self.metrics.inc("deequ_service_cluster_host_losses_total")
            before = self.ring.snapshot()
            self.ring.remove_host(host)
            self.workers.pop(host, None)
            if not self.workers:
                raise HostLossError(host, site="cluster_front",
                                    detail="no surviving workers to recover onto")
            self._count_moves(before)
            recovered = []
            for key, placed in list(self._placements.items()):
                if placed != host:
                    continue
                tenant, dataset = key
                new_host = self.ring.route(_ring_key(key))
                checks, kw = self._specs.get(key, ((), {}))
                # adopt the LAST FLUSHED states (and contract) from the
                # shared store: the dead host cannot flush again, so no
                # fold can commit twice...
                self.workers[new_host].adopt_session(tenant, dataset, checks,
                                                     trace_ctx=_trace.inject(), **dict(kw))
                # ...and replay the journal, every payload accepted since
                # that flush, so no fold is lost either
                replayed = 0
                for payload in self._journal.get(key, []):
                    self.workers[new_host].ingest(tenant, dataset, payload,
                                                  trace_ctx=_trace.inject())
                    replayed += 1
                self._placements[key] = new_host
                self.metrics.inc("deequ_service_cluster_sessions_recovered_total")
                if replayed:
                    self.metrics.inc("deequ_service_cluster_replayed_folds_total", replayed)
                _trace.add_event("cluster_session_recovered", session=_ring_key(key),
                                 source=host, target=new_host, replayed=replayed)
                recovered.append(key)
            if self.membership is not None:
                self.membership.retire(host)
            return recovered

    def placement(self, tenant: str, dataset: str) -> Optional[str]:
        return self._placements.get(_key(tenant, dataset))

    def close(self) -> None:
        with self._lock:
            for worker in self.workers.values():
                worker.close()
            self.workers.clear()
