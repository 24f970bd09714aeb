"""Multi-tenant job scheduler: bounded queue, priorities, deadlines, retry,
per-tenant quotas, fleet leases and harvest listeners (copied from the
reference's ``deequ_tpu/service/scheduler.py``).

The reference deequ runs as one-shot batch jobs; a service hosting repeated
verification (the production mode of Schelter et al., VLDB 2018) needs an
admission-controlled queue between callers and the engine. Design points:

- **Bounded admission.** `submit` sheds with a typed
  :class:`ServiceOverloaded` once `max_queue_depth` jobs are pending —
  queueing unboundedly only converts an overload into a deadline storm.
  Retries of already-admitted jobs re-enter without re-admission, so the
  bound can transiently exceed by the number of jobs concurrently
  CLAIMED by workers (at most ``workers * _PICK_BATCH``): a pickup frees
  queue slots that new admissions may take before a claimed job's retry
  re-enters the delayed queue. Formally, with P = pending, A = claimed,
  every transition preserves ``P + A <= max_queue_depth + workers *
  _PICK_BATCH`` — submit requires ``P < max_queue_depth``, pickup moves
  P->A, a retry moves A->P — so sampled pending never exceeds that sum
  (pinned by the soak test).
- **Priority classes.** The ready list stays sorted by (priority,
  submission sequence): strict priority, FIFO within a class.
- **Deadlines.** Per-job wall-clock budgets, checked when a worker picks
  the job up (queued past its deadline -> typed :class:`JobTimeout`
  without wasting a run) and again at completion.
- **Typed retry with backoff.** :class:`TransientFailure` (and any
  `retry_on` types the caller registers) re-enqueues with exponential
  backoff until the retry budget or the deadline runs out; everything
  else fails fast as :class:`JobFailed`.
- **Per-tenant quotas.** :class:`TenantQuota` budgets (rows/s and bytes/s
  token buckets charged at the streaming admission edge, a share of the
  queue enforced in :meth:`JobScheduler.submit`) shed one tenant's flood
  as ITS OWN typed :class:`QuotaExceeded`; tenants without a quota are
  unthrottled.
- **Cache-aware pickup.** Workers prefer ready jobs whose battery they
  have run before (see `placement.PlacementRouter`), falling back to the
  global head — soft affinity without starvation.

Workers are threads: every heavy phase of a run (native kernels, numpy,
pyarrow, kernel launches) releases the GIL, so N workers genuinely overlap
N jobs' host work. Each worker launches on its thread's current CUDA
stream.
"""

from __future__ import annotations

import bisect
import enum
import heapq
import itertools
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple, Type

from ..observability import trace as _trace
from ..runners.engine import RunMonitor
from .errors import (
    JobFailed,
    JobTimeout,
    QuotaExceeded,
    ServiceClosed,
    ServiceError,
    ServiceOverloaded,
    TransientFailure,
)
from .metrics import ServiceMetrics
from .placement import PlacementRouter, Signature


class Priority(enum.IntEnum):
    """Lower value = served first."""

    HIGH = 0
    NORMAL = 1
    LOW = 2


def _priority_label(priority: Any) -> str:
    """Stable label value for the per-priority histogram series ("high" /
    "normal" / "low"; raw ints degrade to their str)."""
    return getattr(priority, "name", str(priority)).lower()


@dataclass(frozen=True)
class TenantQuota:
    """Per-tenant admission budget — the isolation half of multi-tenancy:
    one tenant's flood becomes ITS OWN typed :class:`QuotaExceeded` (HTTP
    429) instead of everyone's queue latency.

    ``rows_per_s`` / ``bytes_per_s`` are sustained ingest rates enforced
    by token bucket at the streaming admission edge (before anything is
    queued or folded); ``queue_share`` is the fraction of the scheduler's
    ``max_queue_depth`` this tenant's pending jobs may occupy (enforced
    inside :meth:`JobScheduler.submit`). ``None`` per field = unlimited.
    Tenants with NO quota registered are entirely unthrottled — quotas
    are opt-in per tenant (normally set from the tenant catalog's
    ``quotas`` document section)."""

    rows_per_s: Optional[float] = None
    bytes_per_s: Optional[float] = None
    queue_share: Optional[float] = None


class _TokenBucket:
    """Deficit token bucket on ``time.monotonic``: a charge is admitted
    whenever the balance is non-negative and then subtracts its FULL
    amount (the balance may go deeply negative), so any single batch size
    is admittable and the steady-state rate still converges on ``rate`` —
    a producer who sent a 1M-row frame simply owes the bucket ~1M/rate
    seconds of silence. ``charge`` returns 0.0 on admission or the
    seconds until the balance refills to zero (the caller's bounded
    backpressure wait); a refused charge consumes NOTHING."""

    __slots__ = ("rate", "burst", "tokens", "last")

    def __init__(self, rate: float):
        self.rate = float(rate)
        #: accrual cap: at most one second of idle credit, so a tenant
        #: idle for an hour cannot burst an hour's budget in one frame
        self.burst = float(rate)
        self.tokens = 0.0
        self.last: Optional[float] = None

    def charge(self, amount: float, now: float) -> float:
        if self.last is not None:
            self.tokens = min(
                self.tokens + (now - self.last) * self.rate, self.burst
            )
        self.last = now
        if self.tokens < 0:
            return -self.tokens / self.rate
        self.tokens -= float(amount)
        return 0.0


@dataclass
class JobContext:
    """What a job body receives: identity, attempt number, the worker it
    landed on, the placement the router chose for this attempt, the
    tenant's leased sub-mesh (``mesh``; None = one device — the fleet
    scheduler grants it per attempt when the job asked for one), and a
    RunMonitor the scheduler harvests into the export plane afterwards —
    also on failure, so a crashing run still reports its phase costs."""

    job_id: str
    tenant: str
    attempt: int
    worker_id: int
    placement: Optional[str]
    monitor: RunMonitor = field(default_factory=RunMonitor)
    mesh: Optional[Any] = None


class JobHandle:
    """Caller-side future for one admitted job."""

    def __init__(self, job_id: str, tenant: str, priority: Priority):
        self.job_id = job_id
        self.tenant = tenant
        self.priority = priority
        self._event = threading.Event()
        self._value: Any = None
        self._error: Optional[BaseException] = None
        self.attempts = 0
        self.phase_seconds: Dict[str, float] = {}
        #: the job's value when it COMPLETED but past its deadline (the
        #: JobTimeout carries completed=True): the work's side effects have
        #: committed, so the result stays reachable for callers that must
        #: not re-run committed work
        self.late_value: Any = None

    def done(self) -> bool:
        return self._event.is_set()

    @property
    def error(self) -> Optional[BaseException]:
        return self._error

    def result(self, timeout: Optional[float] = None) -> Any:
        """The job's value; raises its typed ServiceError on failure and
        ``TimeoutError`` if the handle is not done within ``timeout``."""
        if not self._event.wait(timeout):
            raise TimeoutError(f"job {self.job_id} not done after {timeout}s")
        if self._error is not None:
            raise self._error
        return self._value

    def _finish(self, value: Any, error: Optional[BaseException]) -> None:
        self._value = value
        self._error = error
        self._event.set()


class _Job:
    __slots__ = (
        "job_id", "fn", "tenant", "priority", "deadline_s", "deadline_abs",
        "submit_time", "max_retries", "retry_backoff_s", "retry_on",
        "signature", "handle", "attempts", "seq", "warm_fn", "serial_key",
        "span", "defer_key", "mesh_tenant", "recover_fn",
    )

    def __init__(self, **kw):
        self.defer_key = None
        self.mesh_tenant = None
        self.recover_fn = None
        for k, v in kw.items():
            setattr(self, k, v)
        self.attempts = 0
        #: the job's trace span: opened at admission, annotated by every
        #: attempt/retry/outcome, finished exactly once in _finish
        self.span = _trace.NULL


#: ready-queue entries a worker inspects looking for an affinity match
#: before falling back to the strict head (bounded so pickup stays O(1)-ish)
_AFFINITY_SCAN = 8

#: hard cap on entries the affinity loop may TOUCH, counting the same-key
#: siblings it skips without scanning: a deep single-session backlog (one
#: streaming session pipelining hundreds of folds) made the skip walk
#: O(queue depth) per pickup — measured ~1ms/fold of pure scan CPU at 500
#: queued folds (the streaming-knee scheduler diet)
_AFFINITY_INSPECT = 32

#: jobs a worker may claim in ONE queue-lock round-trip when the ready
#: list is deep (the batched pickup of the streaming-knee scheduler diet):
#: at thousands of micro-folds/s the per-job wake->lock->scan->unlock
#: cycle — and the GIL handoffs it forces between eight workers — was a
#: measurable slice of the fold fixed cost. Batching only engages under
#: queue PRESSURE (depth >= 2x workers), so a sparse queue keeps strict
#: one-at-a-time pickup and its latency profile.
_PICK_BATCH = 8


class JobScheduler:
    def __init__(
        self,
        workers: int = 4,
        max_queue_depth: int = 64,
        metrics: Optional[ServiceMetrics] = None,
        router: Optional[PlacementRouter] = None,
        name: str = "deequ-service",
        fleet=None,
    ):
        self.metrics = metrics or ServiceMetrics()
        self.router = router or PlacementRouter(self.metrics)
        #: the fleet scheduler (service.fleet.FleetScheduler) packing
        #: tenants onto disjoint sub-meshes; None = one-device routing
        #: (the DEEQU_TPU_FLEET=0 escape hatch, or a one-shard table).
        #: Jobs submitted with ``mesh_tenant`` lease their tenant's slice
        #: for the duration of each attempt.
        self.fleet = fleet
        self.max_queue_depth = int(max_queue_depth)
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        #: (priority, seq, job) — ready to run now, kept SORTED by
        #: (priority, submission seq); _pick scans it front-to-back past
        #: serial-key-blocked entries, so a heap's pop-only discipline
        #: would not fit
        self._ready: List[Tuple[int, int, _Job]] = []
        #: submitters blocked in backpressure mode wait here; workers
        #: notify it whenever a pickup frees queue space (same lock as
        #: _cond, separate waiter set so a freed slot wakes a submitter
        #: instead of another idle worker)
        self._space = threading.Condition(self._lock)
        #: backpressure submitters in arrival order: a freed slot goes to
        #: the oldest, and a newcomer that would block queues behind them
        #: instead of taking a slot a waiter was woken for (without this a
        #: waiter can starve past its ``block_s`` while newcomers barge)
        self._space_waiters: deque = deque()
        #: (not_before, seq, job) — backoff-delayed retries
        self._delayed: List[Tuple[float, int, _Job]] = []
        self._seq = itertools.count()
        self._active = 0
        self._closed = False
        #: serial key -> the job currently OWNING it: _pick skips ready
        #: jobs whose key another job owns, so one streaming session's
        #: pipelined folds occupy at most ONE worker (instead of parking
        #: the whole pool on a session lock) and dequeue in FIFO order per
        #: key. A retried job KEEPS its key through the backoff — releasing
        #: it would let a later-submitted sibling overtake the retry and
        #: fold out of order
        self._running_keys: Dict[Any, _Job] = {}
        #: coalesce keys under an ACTIVE drain: their jobs stay queued for
        #: bulk absorption instead of being picked (see _eligible)
        self._deferred: set = set()
        #: tenant -> TenantQuota; buckets are lazily built per (tenant,
        #: resource) and rebuilt when a quota edit changes the rate.
        #: Guarded by _quota_lock (NOT the queue lock: charge_quota's
        #: bounded sleeps must never park inside queue admission)
        self._quota_lock = threading.Lock()
        self._quotas: Dict[str, TenantQuota] = {}
        self._buckets: Dict[Tuple[str, str], _TokenBucket] = {}
        #: harvest listeners (fn(tenant)) invoked OUTSIDE the queue lock
        #: after every job harvest — the fleet watch's re-score trigger
        #: (see service.fleetwatch). Append-only; registration races at
        #: worst miss the in-flight harvest.
        self._harvest_listeners: List[Callable[[str], None]] = []
        self.metrics.describe(
            "deequ_service_jobs_submitted_total", "Jobs accepted into the queue."
        )
        self.metrics.describe(
            "deequ_service_jobs_shed_total",
            "Jobs rejected by admission control (ServiceOverloaded).",
        )
        self.metrics.describe(
            "deequ_service_quota_shed_total",
            "Admissions refused by a PER-TENANT quota (typed "
            "QuotaExceeded), by tenant and resource (rows_per_s / "
            "bytes_per_s / queue_share) — distinct from global "
            "jobs_shed_total: the tenant exceeded its OWN budget while "
            "neighbors kept their full service.",
        )
        self.metrics.describe(
            "deequ_service_jobs_completed_total",
            "Jobs that terminated, by outcome (success/failed/timeout).",
        )
        self.metrics.describe(
            "deequ_service_job_retries_total",
            "Transient-failure retries that were re-enqueued with backoff.",
        )
        self.metrics.describe(
            "deequ_service_isolation_reruns_total",
            "Battery-bisection re-passes run to isolate faulty analyzers.",
        )
        self.metrics.describe(
            "deequ_service_degraded_analyzers_total",
            "Analyzers/accumulators degraded to typed Failure metrics "
            "instead of failing their whole run.",
        )
        self.metrics.describe(
            "deequ_service_scan_stalls_total",
            "Engine passes cancelled by the scan watchdog for exceeding "
            "their deadline (hang-not-crash faults).",
        )
        self.metrics.describe(
            "deequ_service_shard_losses_total",
            "Mesh shards (devices/processes) declared lost mid-pass and "
            "absorbed by the elastic layer (salvage + re-shard).",
        )
        self.metrics.describe(
            "deequ_service_mesh_reshards_total",
            "Degraded-mesh rebuilds after shard loss, walking the "
            "8->4->2->1->host ladder (in-pass salvages and pass-level "
            "re-runs both count).",
        )
        self.metrics.describe(
            "deequ_service_salvaged_states_total",
            "Surviving per-shard algebraic states salvaged into a "
            "canonical merge after a shard loss (folded work kept, not "
            "recomputed).",
        )
        self.metrics.describe(
            "deequ_service_analyzer_cost_seconds_total",
            "Per-analyzer cost attribution: each signature bundle's "
            "measured compile+dispatch seconds split across its slots, "
            "labeled by analyzer repr.",
        )
        # incremental verification: the delta planner's partition decisions
        # (the reference's series, deequ_tpu/service/scheduler.py:341-366)
        self.metrics.describe(
            "deequ_service_partitions_scanned_total",
            "Partitions the incremental delta planner scheduled a scan "
            "for (new + invalidated).",
        )
        self.metrics.describe(
            "deequ_service_partitions_reused_total",
            "Partitions served from stored algebraic states with zero "
            "data touched.",
        )
        self.metrics.describe(
            "deequ_service_partitions_invalidated_total",
            "Stored partitions that went stale (content change, "
            "fingerprint mismatch, battery growth, corruption) and were "
            "re-scanned.",
        )
        self.metrics.describe(
            "deequ_service_partitions_dropped_total",
            "Stored partitions absent from an incoming partition set — "
            "excluded from the merge by re-merge semantics.",
        )
        self.metrics.describe(
            "deequ_service_partitions_rolled_up_total",
            "Partitions served by the rollup cache (the persisted "
            "left-fold prefix) — neither data nor state blobs touched.",
        )
        self.metrics.set_gauge_fn(
            "deequ_service_queue_depth", self.pending,
            "Jobs admitted but not yet running.",
        )
        self.metrics.set_gauge_fn(
            "deequ_service_active_jobs", lambda: self._active,
            "Jobs currently executing on a worker.",
        )
        self.metrics.describe_histogram(
            "deequ_service_admission_wait_seconds",
            "Queue wait from submit to worker pickup, per tenant and "
            "priority class (pow2 buckets, seconds).",
        )
        self.metrics.describe_histogram(
            "deequ_service_fold_latency_seconds",
            "End-to-end streaming fold latency (submit to terminal "
            "outcome, serial-keyed jobs), per tenant and priority class "
            "(pow2 buckets, seconds).",
        )
        self._workers = [
            threading.Thread(
                target=self._worker_loop, args=(i,),
                name=f"{name}-worker-{i}", daemon=True,
            )
            for i in range(int(workers))
        ]
        for t in self._workers:
            t.start()

    # -- submission ----------------------------------------------------------

    def pending(self) -> int:
        with self._lock:
            return len(self._ready) + len(self._delayed)

    def idle(self) -> bool:
        """No job queued, delayed, or EXECUTING — the only state in which
        it is safe to tear down structures a running job might still
        touch."""
        with self._lock:
            return (
                not self._ready and not self._delayed and self._active == 0
            )

    # -- tenant quotas -------------------------------------------------------

    def set_quota(self, tenant: str, quota: TenantQuota) -> None:
        """Install (or replace) ``tenant``'s admission budget. Takes
        effect on the next charge/submit; rate edits rebuild the token
        buckets (fresh balance — a quota RAISE must not inherit an hour
        of debt accrued under the old rate)."""
        tenant = str(tenant)
        with self._quota_lock:
            self._quotas[tenant] = quota
            for key in [k for k in self._buckets if k[0] == tenant]:
                del self._buckets[key]

    def clear_quota(self, tenant: str) -> None:
        tenant = str(tenant)
        with self._quota_lock:
            self._quotas.pop(tenant, None)
            for key in [k for k in self._buckets if k[0] == tenant]:
                del self._buckets[key]

    def get_quota(self, tenant: str) -> Optional[TenantQuota]:
        with self._quota_lock:
            return self._quotas.get(str(tenant))

    def charge_quota(
        self,
        tenant: str,
        rows: int = 0,
        nbytes: int = 0,
        block_s: Optional[float] = None,
    ) -> None:
        """Charge one ingest frame against ``tenant``'s rate quotas, or
        refuse it typed. Called at the streaming admission edge BEFORE
        anything queues or folds. Over-rate charges park the caller in
        bounded backpressure for up to ``block_s`` seconds (the bucket's
        own refill estimate paces the sleeps), then shed with
        :class:`QuotaExceeded` — which consumes NONE of the budget, so a
        shed flood cannot starve the tenant's own later frames. No quota
        registered: free. Never touches the queue lock."""
        tenant = str(tenant)
        with self._quota_lock:
            quota = self._quotas.get(tenant)
        if quota is None:
            return
        deadline = (
            None if not block_s else time.monotonic() + float(block_s)
        )
        for resource, rate, amount in (
            ("rows_per_s", quota.rows_per_s, rows),
            ("bytes_per_s", quota.bytes_per_s, nbytes),
        ):
            if not rate or amount <= 0:
                continue
            while True:
                now = time.monotonic()
                with self._quota_lock:
                    bucket = self._buckets.get((tenant, resource))
                    if bucket is None:
                        bucket = _TokenBucket(float(rate))
                        self._buckets[(tenant, resource)] = bucket
                    wait = bucket.charge(float(amount), now)
                    debt = -bucket.tokens
                if wait <= 0:
                    break
                remaining = (
                    None if deadline is None else deadline - time.monotonic()
                )
                if remaining is None or remaining <= 0:
                    self.metrics.inc(
                        "deequ_service_quota_shed_total",
                        tenant=tenant, resource=resource,
                    )
                    raise QuotaExceeded(
                        tenant, resource, float(rate),
                        float(debt + amount),
                    )
                time.sleep(min(wait, remaining))

    def submit(
        self,
        fn: Callable[[JobContext], Any],
        *,
        tenant: str = "default",
        priority: Priority = Priority.NORMAL,
        deadline_s: Optional[float] = None,
        max_retries: int = 2,
        retry_backoff_s: float = 0.05,
        retry_on: Tuple[Type[BaseException], ...] = (),
        signature: Signature = (),
        job_id: Optional[str] = None,
        warm_fn: Optional[Callable[[], None]] = None,
        serial_key: Optional[Any] = None,
        block_s: Optional[float] = None,
        defer_key: Optional[Any] = None,
        mesh_tenant: Optional[str] = None,
        recover_fn: Optional[Callable[[Any, BaseException], Any]] = None,
    ) -> JobHandle:
        """Admit one job, or shed it with :class:`ServiceOverloaded` (or
        :class:`QuotaExceeded`, when the tenant's pending jobs fill its
        quota's ``queue_share``).

        ``warm_fn``, if given, is what the placement router runs in the
        background when this job's battery is cold (typically a 1-row
        device-tier run that builds and launches the battery's kernels).
        Jobs sharing a ``serial_key`` execute one at a time, in submission
        order within a priority class — the scheduler-level serialization
        streaming sessions need, without blocking workers on a lock.

        ``block_s`` turns admission into BACKPRESSURE for up to that many
        seconds: a full queue parks the submitter until a worker pickup
        frees a slot instead of shedding immediately — the semantics a
        streaming producer wants (slow down, don't drop), bounded so a
        wedged service still sheds typed rather than hanging the producer
        forever. ``None`` (default) keeps the shed-immediately contract.

        ``mesh_tenant`` opts the job into FLEET scheduling: each attempt
        leases that tenant's sub-mesh from the fleet scheduler (disjoint
        from other tenants' slices) and hands it to the body as
        ``ctx.mesh``; the lease releases when the attempt ends. Ignored
        when the scheduler has no fleet.

        ``recover_fn(ctx, exc)``, if given, is consulted when the job is
        about to terminate WITHOUT its body having run to completion —
        a worker fault before the body, an infrastructure error, a
        queued-past-deadline kill. It returns ``None`` (nothing to
        adopt; the job fails/times out normally) or a ``(value, error)``
        outcome the job must adopt instead — the coalescer uses this to
        keep a fold's COMMIT and its job's FINISH atomic: a drain that
        already committed the fold makes the job succeed with the
        committed result, and an unclaimed fold is withdrawn so no later
        drain can commit a batch whose caller was told it failed."""
        # per-tenant queue share (quota-opted tenants only): a tenant's
        # pending jobs may occupy at most share * max_queue_depth slots,
        # so one tenant's backlog can fill ITS slice — never the queue
        with self._quota_lock:
            quota = self._quotas.get(tenant)
        share_limit = None
        if quota is not None and quota.queue_share:
            share_limit = max(1, int(float(quota.queue_share) * self.max_queue_depth))
        with self._cond:
            if self._closed:
                raise ServiceClosed("verification service is shut down")

            def _tenant_depth() -> int:
                return sum(1 for _, _, j in self._ready if j.tenant == tenant) + sum(
                    1 for _, _, j in self._delayed if j.tenant == tenant)

            deadline = time.monotonic() + float(block_s) if block_s else None
            if share_limit is not None and block_s:
                # a tenant over its share waits for its OWN slots outside
                # the arrival line below, so it never holds up neighbours
                # (pickups free tenant slots and notify this waiter set)
                while not self._closed and _tenant_depth() >= share_limit:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        break
                    self._space.wait(remaining)
            depth = len(self._ready) + len(self._delayed)
            if block_s and (depth >= self.max_queue_depth or self._space_waiters):
                ticket = object()
                self._space_waiters.append(ticket)
                try:
                    while not self._closed and (depth >= self.max_queue_depth
                                                or self._space_waiters[0] is not ticket):
                        remaining = deadline - time.monotonic()
                        if remaining <= 0:
                            break
                        self._space.wait(remaining)
                        depth = len(self._ready) + len(self._delayed)
                finally:
                    self._space_waiters.remove(ticket)
                    self._space.notify_all()  # the next waiter is now the head
            if self._closed:
                raise ServiceClosed("verification service is shut down")
            if depth >= self.max_queue_depth:
                self.metrics.inc("deequ_service_jobs_shed_total", tenant=tenant)
                raise ServiceOverloaded(depth, self.max_queue_depth)
            if share_limit is not None:
                tdepth = _tenant_depth()
                if tdepth >= share_limit:
                    self.metrics.inc("deequ_service_quota_shed_total",
                                     tenant=tenant, resource="queue_share")
                    raise QuotaExceeded(tenant, "queue_share", float(share_limit),
                                        float(tdepth))
            seq = next(self._seq)
            now = time.monotonic()
            jid = job_id or f"{tenant}-{seq}"
            handle = JobHandle(jid, tenant, priority)
            job = _Job(
                job_id=jid, fn=fn, tenant=tenant, priority=priority,
                deadline_s=deadline_s,
                deadline_abs=None if deadline_s is None else now + deadline_s,
                submit_time=now, max_retries=int(max_retries),
                retry_backoff_s=float(retry_backoff_s),
                retry_on=tuple(retry_on), signature=signature,
                handle=handle, seq=seq, warm_fn=warm_fn,
                serial_key=serial_key, defer_key=defer_key,
                mesh_tenant=mesh_tenant, recover_fn=recover_fn,
            )
            # the trace root of the job's whole causal chain: admission,
            # every attempt/retry, placement, the engine passes it runs
            # (children via the worker's attached context), and the
            # terminal outcome. Submitted under a caller's live span (a
            # traced streaming ingest) it joins that trace instead.
            job.span = _trace.start_span(
                f"job:{jid}", kind="job",
                attrs={"job_id": jid, "tenant": tenant,
                       "priority": int(priority)},
            )
            job.span.add_event("admitted", depth=depth, seq=seq)
            bisect.insort(self._ready, (int(priority), seq, job))
            self.metrics.inc("deequ_service_jobs_submitted_total", tenant=tenant)
            self._cond.notify()
            return handle

    # -- worker side ---------------------------------------------------------

    def _promote_due(self, now: float) -> None:
        while self._delayed and self._delayed[0][0] <= now:
            _, seq, job = heapq.heappop(self._delayed)
            bisect.insort(self._ready, (int(job.priority), seq, job))

    def _eligible(self, job: _Job) -> bool:
        """May this job run now? Its serial key must be free — or owned by
        the job itself (a promoted retry re-entering) — and its defer key
        (if any) must not be under an active coalesced drain: the drainer
        is about to execute the job's fold and retire the job straight
        from this queue (finish_absorbed), so a worker picking it up now
        would only fight the drainer for the GIL to read a memo. The
        drainer ALWAYS undefers on exit (finally + notify), so a deferred
        job is picked normally the moment no drain covers it."""
        if job.defer_key is not None and job.defer_key in self._deferred:
            return False
        if job.serial_key is None:
            return True
        owner = self._running_keys.get(job.serial_key)
        return owner is None or owner is job

    # -- coalescer coupling --------------------------------------------------

    def defer_pickup(self, key: Any) -> None:
        """A coalesced drain is active for ``key``: leave its jobs queued
        for absorption (see ``_eligible``)."""
        with self._cond:
            self._deferred.add(key)

    def resume_pickup(self, key: Any) -> None:
        with self._cond:
            self._deferred.discard(key)
            self._cond.notify_all()  # deferred jobs are pickable again

    def _pick(self, worker_id: int) -> Optional[_Job]:
        """The best ready job this worker may run, or None when every ready
        job's serial key is busy (the worker then waits instead of parking
        on a session lock). ``_ready`` is kept sorted, so this is a single
        front-to-back scan.

        An INELIGIBLE job blocks its later same-serial-key siblings from
        this scan: skipping a drain-DEFERRED job and picking its sibling
        would let the sibling's fold claim ahead of it — the serial key is
        free (neither is running), so ``_eligible`` alone cannot see the
        ordering violation. This was the cross-key commit-inversion flake:
        a session alternating micro-batch buckets had fold N deferred
        under key A's active drain while fold N+1 (key B) was picked and
        committed first."""
        first = None
        blocked_keys: set = set()
        for i, entry in enumerate(self._ready):
            job_i = entry[2]
            key = job_i.serial_key
            if (
                key is not None
                and key in blocked_keys
                # the key's OWNER is exempt: a promoted retry re-enters
                # with a LATER seq than its queued sibling, and blocking
                # it behind that (ineligible) sibling would deadlock the
                # key — the owner is by definition the ordering head
                and self._running_keys.get(key) is not job_i
            ):
                continue
            if self._eligible(job_i):
                first = i
                break
            if key is not None:
                blocked_keys.add(key)
        if first is None:
            return None
        # soft affinity: among the best few eligible entries of the same
        # priority class, prefer one whose battery this worker has run
        # (its device working set is hot). An entry whose serial key
        # already appeared earlier in the scan is NEVER promoted — affinity
        # must not reorder same-key siblings (FIFO per key).
        chosen = first
        scanned = 0
        inspected = 0
        # seed with the keys the first-eligible scan blocked: a job whose
        # earlier same-key sibling is deferred must not be AFFINITY-
        # promoted either, or the promotion re-opens the cross-key
        # commit-inversion hole the blocked_keys rule closes
        keys_seen: set = set(blocked_keys)
        for j in range(first, len(self._ready)):
            entry = self._ready[j]
            inspected += 1
            if (
                entry[0] != self._ready[first][0]
                or scanned >= _AFFINITY_SCAN
                or inspected > _AFFINITY_INSPECT
            ):
                break
            job_j = entry[2]
            if job_j.serial_key is not None:
                if job_j.serial_key in keys_seen:
                    continue  # an earlier same-key sibling goes first
                keys_seen.add(job_j.serial_key)
            if not self._eligible(job_j):
                continue
            scanned += 1
            # signatureless jobs (fast-path streaming folds) have no
            # device working set to be affine to — skip the router-lock
            # round-trip the preferred_workers probe would cost per
            # scanned entry (the streaming-knee scheduler diet)
            if job_j.signature and worker_id in self.router.preferred_workers(
                job_j.signature
            ):
                chosen = j
                break
        job = self._ready.pop(chosen)[2]
        if job.serial_key is not None:
            self._running_keys[job.serial_key] = job
        return job

    def _worker_loop(self, worker_id: int) -> None:
        while True:
            with self._cond:
                jobs: List[_Job] = []
                while not jobs:
                    now = time.monotonic()
                    self._promote_due(now)
                    job = self._pick(worker_id)
                    if job is not None:
                        jobs.append(job)
                        # batched pickup: under queue pressure, claim more
                        # eligible jobs in the SAME lock round-trip — the
                        # worker then runs them back-to-back instead of
                        # re-entering the wake/lock/scan cycle per job
                        if len(self._ready) >= 2 * len(self._workers):
                            while len(jobs) < _PICK_BATCH:
                                extra = self._pick(worker_id)
                                if extra is None:
                                    break
                                jobs.append(extra)
                        break
                    if self._closed and not self._delayed and not self._ready:
                        return
                    timeout = None
                    if self._delayed:
                        timeout = max(self._delayed[0][0] - now, 0.0)
                    # a finishing job notifies, releasing its serial key
                    self._cond.wait(timeout)
                self._active += len(jobs)
                # the pickups freed queue slots: wake as many blocked
                # backpressure submitters
                self._space.notify_all()
            for job in jobs:
                self._run_one(job, worker_id)

    def _run_one(self, job: _Job, worker_id: int) -> None:
        retried = False
        try:
            retried = self._execute(job, worker_id)
        except BaseException as exc:  # noqa: BLE001 - defense in depth:
            # an error OUTSIDE the job body (router, metrics, harvest)
            # must neither kill the worker thread nor leave the handle
            # unresolved forever — "every job terminates with a result
            # or a typed error" includes scheduler-infrastructure bugs
            if not job.handle.done():
                adopted = self._recover(job, None, exc)
                if adopted is not None and adopted[1] is None:
                    self._finish(job, adopted[0], None, outcome="success")
                else:
                    self._finish(
                        job, None, JobFailed(job.job_id, job.attempts, exc),
                        outcome="failed",
                    )
        finally:
            with self._cond:
                self._active -= 1
                # a retried job keeps OWNING its serial key through the
                # backoff: releasing it would let a later-submitted
                # sibling overtake the retry and execute out of order
                if job.serial_key is not None and not retried:
                    self._running_keys.pop(job.serial_key, None)
                # ONE completion makes at most ONE blocked job newly
                # eligible (the finished job's serial-key sibling), and
                # this worker loops straight back into _pick itself —
                # notify_all here was a thundering herd that woke every
                # idle worker per job (measured on the streaming knee:
                # 8 workers x thousands of folds/s of spurious
                # wake-scan-sleep cycles under the queue lock).
                # Shutdown wake-everyone stays notify_all in shutdown().
                self._cond.notify()

    def _execute(self, job: _Job, worker_id: int) -> bool:
        """Run one job attempt under the job's trace context; returns True
        iff the job was RE-ENQUEUED for retry (the worker then keeps its
        serial key owned — releasing it would let a later sibling overtake
        the retry)."""
        with _trace.attach(job.span):
            return self._execute_attempt(job, worker_id)

    def _execute_attempt(self, job: _Job, worker_id: int) -> bool:
        now = time.monotonic()
        if job.deadline_abs is not None and now > job.deadline_abs:
            # don't waste a run on a job that already missed its budget
            job.span.add_event(
                "queued_past_deadline", waited_s=now - job.submit_time
            )
            timeout = JobTimeout(
                job.job_id, job.deadline_s, now - job.submit_time
            )
            # a deadline-killed fold job never ran its body: withdraw the
            # pending fold (releasing the session's serial barrier) so it
            # cannot linger claimable after its caller was told timeout
            self._recover(job, None, timeout)
            self._finish(job, None, timeout, outcome="timeout")
            return False
        job.attempts += 1
        job.span.add_event(
            "picked_up", worker=worker_id, attempt=job.attempts
        )
        if job.attempts == 1:
            # first pickup only: retries measure backoff, not admission
            self.metrics.observe(
                "deequ_service_admission_wait_seconds",
                now - job.submit_time, tenant=job.tenant,
                priority=_priority_label(job.priority),
            )
        # fleet: lease the tenant's sub-mesh for THIS attempt, disjoint from
        # other tenants' slices and re-packed over the survivors when a
        # shard dropped out since the last attempt. The release lives in a
        # finally so no path out of the attempt (a raising router.decide
        # included) can leak the refcount: a leaked ref would pin a phantom
        # tenant into every future packing
        lease = None
        if job.mesh_tenant is not None and self.fleet is not None:
            lease = self.fleet.acquire(job.mesh_tenant)
        ctx = JobContext(
            job_id=job.job_id, tenant=job.tenant, attempt=job.attempts,
            worker_id=worker_id, placement=None,
            mesh=lease.mesh if lease is not None else None,
        )
        try:
            try:
                # raises when the battery's kernels failed to build or
                # launch in a background warm: the job fails with that error
                ctx.placement = self.router.decide(job.signature, job.warm_fn)
                job.span.add_event(
                    "placement", decision=ctx.placement or "auto",
                    attempt=job.attempts,
                    **({"fleet_devices": lease.n_dev}
                       if lease is not None else {}),
                )
                from ..reliability.faults import fault_point

                # chaos site: a WorkerCrash here simulates the worker
                # dying mid-job (executor loss); the job must still
                # terminate typed
                fault_point("worker", tag=str(worker_id))
                value = job.fn(ctx)
            except BaseException as exc:  # noqa: BLE001 - routed into
                # the taxonomy below
                # commit/job-finish atomicity: before failing a job whose
                # BODY may not have run (an injected worker fault fires
                # between pickup and fn), let its recover_fn reconcile —
                # a coalesced drain that already committed the job's fold
                # makes the job SUCCEED with the committed result, and an
                # unclaimed fold is withdrawn so no later drain can
                # commit work the caller was told failed
                adopted = self._recover(job, ctx, exc)
                self._harvest(job, ctx)
                if adopted is not None and adopted[1] is None:
                    self._finish(job, adopted[0], None, outcome="success")
                    return False
                if adopted is not None:
                    exc = adopted[1]
                if self._maybe_retry(job, exc):
                    return True  # worker keeps the serial key (FIFO)
                if isinstance(exc, ServiceError) and not isinstance(
                    exc, TransientFailure
                ):
                    self._finish(job, None, exc, outcome="failed")
                else:
                    self._finish(
                        job, None,
                        JobFailed(job.job_id, job.attempts, exc),
                        outcome="failed",
                    )
                return False
            self._harvest(job, ctx)
        finally:
            if lease is not None:
                self.fleet.release(job.mesh_tenant)
        # the monitor records the placement the engine actually RESOLVED
        # (None for jobs that never touched the engine)
        self.router.note_ran(job.signature, worker_id, ctx.monitor.placement)
        end = time.monotonic()
        if job.deadline_abs is not None and end > job.deadline_abs:
            # the work COMPLETED, just late — its side effects (streaming
            # state folds, repository saves) have committed, so the result
            # stays reachable on the handle (late_value) while the caller
            # gets the typed timeout; discarding it would bait callers into
            # re-running committed work
            job.span.add_event(
                "completed_late", waited_s=end - job.submit_time
            )
            job.handle.late_value = value
            self._finish(
                job, None,
                JobTimeout(
                    job.job_id, job.deadline_s, end - job.submit_time,
                    completed=True,
                ),
                outcome="timeout",
            )
            return False
        self._finish(job, value, None, outcome="success")
        return False

    def _recover(self, job: _Job, ctx, exc: BaseException):
        """Consult the job's recover_fn (see `submit`); defensive — a
        raising recover_fn must not mask the original failure."""
        if job.recover_fn is None:
            return None
        try:
            return job.recover_fn(ctx, exc)
        except BaseException:  # noqa: BLE001 - keep the original error
            import logging

            logging.getLogger(__name__).warning(
                "recover_fn for job %s raised; keeping the original "
                "failure", job.job_id, exc_info=True,
            )
            return None

    def finish_absorbed(self, absorbed) -> None:
        """Resolve jobs whose WORK was already executed by a coalesced
        drain while they sat in the ready queue: each is removed from the
        queue (one lock round-trip for the whole batch) and finished with
        its fold's outcome — it never occupies a worker. This is the
        batched-harvest half of the streaming-knee scheduler diet: a
        512-fold drain retires up to 511 sibling jobs without 511
        wake/pick/execute/finish cycles.

        ``absorbed``: iterable of ``(handle, value, error, tenant,
        monitor, signature, worker_id)``. Entries whose job was already
        picked up (or retried) are skipped — the running job consumes the
        fold's memoized outcome itself. Only deadline-FREE jobs are ever
        absorbed (the coalescer never drains deadline'd folds), so the
        queued-past-deadline contract is untouched."""
        entries = list(absorbed)
        if not entries:
            return
        handles = {e[0] for e in entries}
        found: Dict[Any, _Job] = {}
        with self._cond:
            kept = []
            for entry in self._ready:
                job = entry[2]
                if job.handle in handles:
                    found[job.handle] = job
                else:
                    kept.append(entry)
            if found:
                self._ready = kept
                # the absorptions freed queue slots: wake as many blocked
                # backpressure submitters
                self._space.notify_all()
        updates: list = []
        for handle, value, error, tenant, monitor, signature, worker_id in entries:
            job = found.get(handle)
            if job is None:
                continue
            job.attempts = 1  # the drain WAS the attempt
            job.span.add_event("absorbed_by_drain")
            self._harvest_monitor(
                tenant, monitor, job.handle, signature, updates=updates
            )
            if error is None:
                self.router.note_ran(signature, worker_id, monitor.placement)
                self._finish(job, value, None, outcome="success")
            elif isinstance(error, ServiceError) and not isinstance(
                error, TransientFailure
            ):
                self._finish(job, None, error, outcome="failed")
            else:
                self._finish(
                    job, None, JobFailed(job.job_id, 1, error),
                    outcome="failed",
                )
        if updates:
            self.metrics.inc_many(updates)

    def _harvest(self, job: _Job, ctx: JobContext) -> None:
        self._harvest_monitor(
            job.tenant, ctx.monitor, job.handle, job.signature
        )

    def _harvest_monitor(
        self, tenant: str, monitor: RunMonitor, handle: JobHandle, signature=(),
        updates: Optional[list] = None,
    ) -> None:
        # ONE batched metrics-lock round-trip for the whole harvest: at
        # thousands of folds/s the previous per-series inc() calls (phase
        # map + cost table + up to 8 reliability series, each taking the
        # export-plane lock) were a measurable slice of the per-fold fixed
        # cost the coalescing plane exists to kill. A caller-provided
        # ``updates`` list defers the flush — finish_absorbed batches a
        # whole drain's harvests into ONE round-trip.
        flush = updates is None
        if flush:
            updates = []
        with monitor._lock:
            # an abandoned pass of this job may still add a phase
            phases = dict(monitor.phase_seconds)
            costs = dict(monitor.cost_by_analyzer)
        updates += [
            ("deequ_service_phase_seconds_total", seconds, {"phase": phase})
            for phase, seconds in phases.items()
        ]
        for phase, seconds in phases.items():
            handle.phase_seconds[phase] = (
                handle.phase_seconds.get(phase, 0.0) + seconds
            )
        tenant_label = {"tenant": tenant}
        updates.extend(
            ("deequ_service_analyzer_cost_seconds_total", seconds,
             {"analyzer": analyzer, "tenant": tenant})
            for analyzer, seconds in costs.items()
        )
        if monitor.stalls:
            # every stall surfaces on the export plane; only DEVICE-tier
            # stalls feed the probation below (pinning a battery to the host
            # tier because the HOST hung would put it on the sick tier)
            updates.append(
                ("deequ_service_scan_stalls_total", float(monitor.stalls),
                 tenant_label)
            )
        # mesh elasticity on the export plane: every shard loss, re-shard
        # and salvaged state, per tenant
        if monitor.shard_losses:
            updates.append(
                ("deequ_service_shard_losses_total",
                 float(monitor.shard_losses), tenant_label)
            )
        if monitor.mesh_reshards:
            updates.append(
                ("deequ_service_mesh_reshards_total",
                 float(monitor.mesh_reshards), tenant_label)
            )
        if monitor.salvaged_states:
            updates.append(
                ("deequ_service_salvaged_states_total",
                 float(monitor.salvaged_states), tenant_label)
            )
        if monitor.isolation_reruns:
            updates.append(
                ("deequ_service_isolation_reruns_total",
                 float(monitor.isolation_reruns), tenant_label)
            )
        if monitor.degraded:
            updates.append(
                ("deequ_service_degraded_analyzers_total",
                 float(len(monitor.degraded)), tenant_label)
            )
        # the delta planner's per-run partition decisions, per tenant; the
        # series names are literals so the export-help lint can see them
        for field_name, series in (
            ("partitions_scanned", "deequ_service_partitions_scanned_total"),
            ("partitions_reused", "deequ_service_partitions_reused_total"),
            ("partitions_invalidated", "deequ_service_partitions_invalidated_total"),
            ("partitions_dropped", "deequ_service_partitions_dropped_total"),
            ("partitions_rolled_up", "deequ_service_partitions_rolled_up_total"),
        ):
            value = getattr(monitor, field_name)
            if value:
                updates.append((series, float(value), tenant_label))
        if flush:
            self.metrics.inc_many(updates)
        if (
            monitor.device_failovers
            or monitor.batch_bisections
            or monitor.device_stalls
            or monitor.shard_losses
        ):
            # the engine survived a device-tier fault under this battery:
            # teach the router to keep the battery on the host tier for a
            # probation window (also fires on failed attempts, so a retry
            # lands on the healthy tier at once; the reference's
            # scheduler.py:1105-1115)
            self.router.note_device_failure(signature)
        if monitor.shard_losses and self.fleet is not None:
            # a shard dropped out of the ladder during this job: make sure
            # the fleet packing reflects it (the elastic loss listener
            # usually already did; this probe-and-repack is the backstop
            # for pass-level re-shards, which name no position)
            self.fleet.note_shard_loss()
        for listener in self._harvest_listeners:
            # the fleet watch's trigger: a completed job means this tenant
            # may have committed fresh metrics. Defensive — a raising
            # listener must not take the harvested job down with it, and
            # listeners run outside every scheduler lock (they typically
            # re-enter submit())
            try:
                listener(tenant)
            except Exception:  # noqa: BLE001 - observability only
                import logging

                logging.getLogger(__name__).warning(
                    "harvest listener failed for tenant %s", tenant,
                    exc_info=True,
                )

    def add_harvest_listener(self, fn: Callable[[str], None]) -> None:
        """Register ``fn(tenant)`` to run after every job harvest (outside
        the queue lock; exceptions are swallowed with a warning). The
        fleet watch uses this as its standing re-score trigger."""
        self._harvest_listeners.append(fn)

    def _maybe_retry(self, job: _Job, exc: BaseException) -> bool:
        from ..exceptions import ScanStallError

        # an ESCAPED stall is retryable by construction: the pass was
        # killed and the worker is free, so requeueing gives the job a
        # fresh attempt instead of failing it outright
        retryable = (
            isinstance(exc, (TransientFailure, ScanStallError))
            or (job.retry_on and isinstance(exc, job.retry_on))
        )
        if not retryable or job.attempts > job.max_retries:
            return False
        delay = job.retry_backoff_s * (2 ** (job.attempts - 1))
        not_before = time.monotonic() + delay
        if job.deadline_abs is not None and not_before > job.deadline_abs:
            return False  # the backoff alone would blow the deadline
        job.span.add_event(
            "retry", attempt=job.attempts, delay_s=delay,
            error=f"{type(exc).__name__}: {str(exc)[:200]}",
        )
        self.metrics.inc("deequ_service_job_retries_total", tenant=job.tenant)
        with self._cond:
            heapq.heappush(self._delayed, (not_before, next(self._seq), job))
            self._cond.notify()
        return True

    def _finish(
        self, job: _Job, value: Any, error: Optional[BaseException], outcome: str
    ) -> None:
        self.metrics.inc(
            "deequ_service_jobs_completed_total",
            tenant=job.tenant, outcome=outcome,
        )
        if job.serial_key is not None:
            # serial-keyed jobs ARE the streaming folds; this single
            # terminal site covers serial, coalesced, and drain-absorbed
            # completions alike (all funnel through _finish)
            self.metrics.observe(
                "deequ_service_fold_latency_seconds",
                time.monotonic() - job.submit_time, tenant=job.tenant,
                priority=_priority_label(job.priority),
            )
        job.span.add_event(
            "outcome", outcome=outcome, attempts=job.attempts,
            **({"error": f"{type(error).__name__}: {str(error)[:200]}"}
               if error is not None else {}),
        )
        # finishing the job span closes the trace's unit of work — this is
        # also what releases any pending flight-recorder dump for it
        job.span.finish("ok" if error is None else "error")
        job.handle.attempts = job.attempts
        job.handle._finish(value, error)

    # -- lifecycle -----------------------------------------------------------

    def shutdown(self, wait: bool = True, timeout: Optional[float] = None) -> None:
        """Stop intake; workers drain every pending job, then exit."""
        with self._cond:
            self._closed = True
            self._cond.notify_all()
            # backpressure submitters parked on a full queue must wake to
            # their typed ServiceClosed instead of out-waiting block_s
            self._space.notify_all()
        if wait:
            deadline = None if timeout is None else time.monotonic() + timeout
            for t in self._workers:
                left = (
                    None if deadline is None
                    else max(deadline - time.monotonic(), 0.0)
                )
                t.join(left)
        self.router.close()
