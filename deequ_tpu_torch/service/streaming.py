"""Streaming micro-batch ingestion: long-lived per-(tenant, dataset)
verification sessions.

Schelter et al. (VLDB 2018) frame incremental verification over growing
datasets as the production mode: don't rescan history, fold each arriving
delta into persisted ALGEBRAIC states and recompute metrics from the merge.
A :class:`StreamingSession` is that mode hosted on the service's device
(the reference's ``deequ_tpu/service/streaming.py``, ported): every
micro-batch runs one fused pass over the delta with
``aggregate_with=save_states_with=<the session's state provider>`` — the
existing `StateLoader`/`StatePersister` machinery — so after batch N the
persisted states equal a single batch run over the concatenation of batches
1..N, and the session's checks are evaluated against the CUMULATIVE metrics
after every merge: anomalies surface mid-stream, not at end-of-day.

Batches enter through the service scheduler (admission control, deadlines,
retry, cache-aware placement all apply); merges within one session are
serialized by a session lock, so concurrent ingests never interleave their
load-merge-persist cycles.

Schema integrity: the first folded batch captures a
:class:`~deequ_tpu_torch.service.drift.SchemaContract` (column names, value
dtypes, dictionary-encoding) and every later batch validates against it
BEFORE the fold — compatible widenings (int32 arriving where int64 was
promised) are coerced and counted; incompatible drift (column added,
dropped, retyped) raises a typed ``SchemaDriftError`` with the persisted
states untouched, or coerces/degrades per the session's ``drift_policy``.

A session of a service with a partition store flushes its cumulative
states into it as partition ``session-<tenant>`` when it closes
(:meth:`StreamingSession.flush_to_partition`), for incremental
verification to reuse.

Every ingest first charges the tenant's rate quotas
(:meth:`~deequ_tpu_torch.service.scheduler.JobScheduler.charge_quota`), then,
when the session has a row gate
(:class:`~deequ_tpu_torch.ingest.rowgate.RowGate`, normally installed from
the tenant catalog), folds only the frame's conforming rows and sends the
rest to the gate's quarantine sidecar.
"""

from __future__ import annotations

import logging
import threading
from typing import Any, Callable, Optional, Sequence, Tuple

_logger = logging.getLogger(__name__)

from ..analyzers import Analyzer
from ..analyzers.state_provider import (
    InMemoryStateProvider,
    StateLoader,
    StatePersister,
)
from ..checks import Check, CheckStatus
from ..data import Dataset
from .errors import SessionClosed
from .scheduler import JobContext, Priority


def describe_streaming_series(metrics) -> None:
    """Register HELP text for every export-plane series the streaming
    sessions increment (called once per service). Literal per-series
    ``describe`` calls, not a data-driven loop: the export-plane
    completeness check in tools/statlint matches descriptions statically,
    and an unrolled call per series is what it (and a grepping operator)
    can see."""
    metrics.describe(
        "deequ_service_stream_batches_total",
        "Micro-batches folded into streaming sessions' persisted states.",
    )
    metrics.describe(
        "deequ_service_stream_rows_total",
        "Rows folded into streaming sessions' persisted states.",
    )
    metrics.describe(
        "deequ_service_stream_check_failures_total",
        "Per-fold check evaluations that did not come back SUCCESS, by "
        "status — the mid-stream anomaly signal.",
    )
    metrics.describe(
        "deequ_service_drift_rejections_total",
        "Micro-batches rejected BEFORE folding for incompatible schema "
        "drift (typed SchemaDriftError; persisted states untouched).",
    )
    metrics.describe(
        "deequ_service_drift_coercions_total",
        "Columns coerced to the session contract's dtype on compatible "
        "widenings (int32 arriving where int64 was promised).",
    )
    metrics.describe(
        "deequ_service_drift_repairs_total",
        "Micro-batches coerce-REPAIRED across hard schema drift per the "
        "session's drift policy (the producer's schema changed).",
    )
    metrics.describe(
        "deequ_service_drift_degraded_total",
        "Micro-batches folded with drifted columns degraded to typed "
        "Failure metrics per the session's drift policy.",
    )
    metrics.describe(
        "deequ_service_callback_failures_total",
        "on_result callbacks that raised; the fold had already committed, "
        "so the failure is contained, logged and counted here.",
    )


#: reconfigure()'s "field not passed" sentinel (None is meaningful for
#: row_gate: it means REMOVE the gate)
_UNSET = object()


def _bucket_batch_size(rows: int) -> int:
    """Micro-batch rows -> the next power of two (floor 1024): the
    reference's buckets, which bound its compiled shapes; here they decide
    which sessions' folds can stack into one coalesced launch, and keep the
    padded batches (and so every kernel's reduction order) equal to the
    reference's."""
    size = 1024
    while size < rows:
        size *= 2
    return size


def _session_batch_size(rows: int, batch_size) -> int:
    """The fold batch size: caller's choice, else the power-of-two bucket
    CLAMPED to the engine's default — an oversize micro-batch streams as
    ordinary engine-sized batches instead of one giant padded shape."""
    from ..config import DEFAULT_BATCH_SIZE

    return batch_size or min(DEFAULT_BATCH_SIZE, _bucket_batch_size(rows))


class StreamingSession:
    """One tenant's continuously-verified dataset."""

    def __init__(
        self,
        service,
        tenant: str,
        dataset: str,
        checks: Sequence[Check],
        *,
        required_analyzers: Sequence[Analyzer] = (),
        state_provider: Optional[Any] = None,
        priority: Priority = Priority.NORMAL,
        deadline_s: Optional[float] = None,
        max_retries: int = 0,
        batch_size: Optional[int] = None,
        on_result: Optional[Callable[[Any], None]] = None,
        keep_results: int = 256,
        drift_policy: str = "reject",
        admission_block_s: Optional[float] = None,
        row_gate: Optional[Any] = None,
    ):
        # max_retries defaults to 0 because a fold MUTATES persisted state:
        # a transient failure in the middle of a run can leave some
        # analyzers' states already merged, and re-running the fold would
        # double-count the batch. Opt into retries only when the state
        # provider is transactional for a whole fold. (A failure AFTER the
        # fold completed — e.g. an on_result callback — is safe either way:
        # the completed result is memoized per job and never re-folded.)
        if state_provider is not None and not (
            isinstance(state_provider, StateLoader)
            and isinstance(state_provider, StatePersister)
        ):
            raise TypeError(
                "state_provider must be both a StateLoader and a "
                f"StatePersister, got {type(state_provider).__name__}"
            )
        self.service = service
        self.tenant = tenant
        self.dataset = dataset
        self.checks = list(checks)
        self.required_analyzers = list(required_analyzers)
        self.provider = state_provider or InMemoryStateProvider()
        self.priority = priority
        self.deadline_s = deadline_s
        self.max_retries = max_retries
        self.batch_size = batch_size
        self.on_result = on_result
        #: seconds an ingest WAITS for queue space before the typed shed
        #: (backpressure for streaming producers); None keeps the
        #: scheduler's shed-immediately default
        self.admission_block_s = admission_block_s
        #: optional row-level gate (`deequ_tpu_torch.ingest.rowgate.RowGate`):
        #: every frame is conformance-masked BEFORE the fold, clean rows
        #: fold bit-exact, rejects quarantine typed. Normally installed
        #: from the tenant catalog's ``row_gate`` document section.
        self.row_gate = row_gate
        from .drift import DRIFT_POLICIES

        if drift_policy not in DRIFT_POLICIES:
            raise ValueError(
                f"drift_policy must be one of {DRIFT_POLICIES}, "
                f"got {drift_policy!r}"
            )
        self.drift_policy = drift_policy
        self._serial = threading.Lock()  # orders load-merge-persist cycles
        #: held across [coalescer enqueue -> scheduler submit] so a
        #: session's pending-fold queue order always equals its job
        #: submission order (the FIFO the coalescer's drains rely on);
        #: never held during a fold
        self._submit_order = threading.Lock()
        #: coalesce eligibility plans keyed by (reconfigure epoch, schema
        #: fingerprint); the epoch makes invalidation a read-side key
        #: change instead of a cross-lock dict clear (`_coalesce_plan`
        #: writes under the submit lock, reconfigure() under the serial
        #: lock — they must not share a mutable field)
        self._plans: dict = {}
        self._plans_epoch = 0
        self._closed = False
        self._schema = None
        #: the schema promise captured from the FIRST folded batch; every
        #: later batch validates against it BEFORE the fold so persisted
        #: states are never contaminated by mixed-schema merges. For a
        #: DURABLE (path-backed) provider the contract persists beside the
        #: states, so a session resumed in a new process still validates
        #: against the schema its persisted states were folded under — a
        #: fresh capture from the first post-restart batch would let a
        #: drifted producer contaminate days of state unchallenged
        self._contract = self._load_contract()
        #: drift observability: widenings coerced / batches folded degraded
        #: / batches whose HARD drift the coerce policy repaired
        self.drift_coercions = 0
        self.drift_degraded_batches = 0
        self.drift_repaired_batches = 0
        import itertools

        #: per-SUBMISSION counter for job ids — batches_ingested only moves
        #: when a fold runs, so pipelined ingests (wait=False) would all
        #: report the same batch identity in timeouts/failures
        self._submit_seq = itertools.count()
        self.batches_ingested = 0
        self.rows_ingested = 0
        #: columnar payload bytes folded (wire-equivalent arrow buffer
        #: sizes — what the ingest plane's MB/s numbers are made of)
        self.bytes_ingested = 0
        from collections import deque

        #: the most recent ``keep_results`` batch results — bounded, so a
        #: session ingesting for weeks cannot grow memory per micro-batch
        #: (counts live in batches_ingested / the export plane)
        self.results = deque(maxlen=max(int(keep_results), 1))
        from ..runners.analysis_runner import collect_required_analyzers

        self._analyzers = collect_required_analyzers(
            self.checks, self.required_analyzers
        )

    # -- ingestion -----------------------------------------------------------

    def ingest(
        self,
        data,
        *,
        wait: bool = True,
        timeout: Optional[float] = None,
        deadline_s: Optional[float] = None,
        block_s: Optional[float] = None,
    ):
        """Fold one micro-batch into the session's persisted states and
        evaluate the checks on the merged (cumulative) metrics.

        ``data`` is any columnar payload `deequ_tpu_torch.ingest.as_dataset`
        accepts: a :class:`Dataset`, a pyarrow ``Table``/``RecordBatch``,
        a **dict of numpy arrays** (zero-copy for numeric dtypes — the
        recommended in-process shape; no pandas hop), or a pandas
        DataFrame (the legacy path, which pays the conversion).

        With ``wait=True`` (default) returns the batch's
        ``VerificationResult``; with ``wait=False`` returns the
        :class:`JobHandle` so callers can pipeline batches."""
        if self._closed:
            raise SessionClosed(self.tenant, self.dataset)
        from ..ingest.columnar import as_dataset

        data = as_dataset(data)
        # per-tenant admission budget FIRST (one dict lookup for quota-
        # free tenants): the producer is charged for the WHOLE incoming
        # frame — garbage rows included — before any CPU is spent masking
        # or folding it, so an over-quota flood sheds typed (QuotaExceeded
        # -> 429) at the cheapest possible point
        from ..ingest.columnar import payload_bytes

        self.service.scheduler.charge_quota(
            self.tenant,
            rows=int(data.num_rows),
            nbytes=payload_bytes(data),
            block_s=(
                block_s if block_s is not None else self.admission_block_s
            ),
        )
        if self.row_gate is not None:
            # one vectorized conformance mask per frame BEFORE the fold:
            # clean rows continue bit-exact (arrow filter of the original
            # buffers), rejects quarantine typed; a fully-rejected frame
            # raises FrameQuarantinedError here and nothing folds
            data = self.row_gate.split(data, self.tenant, self.dataset)
        done: dict = {}  # per-job memo: a retried job must never re-fold
        bs = _session_batch_size(int(data.num_rows), self.batch_size)
        effective_deadline = (
            deadline_s if deadline_s is not None else self.deadline_s
        )

        from .placement import make_warm_fn, shape_qualified_signature

        # cross-session coalescing (service.coalesce): an eligible
        # micro-batch fold routes through the coalescer — the tiny-delta
        # host fast path, or a signature-keyed group that a worker stacks
        # into ONE device launch. prepare() returning None (knob off,
        # ineligible battery, multi-batch, mesh) keeps the exact
        # pre-coalescing path below. The submit-order lock makes [enqueue
        # -> submit] atomic per session, so the coalescer's per-session
        # FIFO equals the scheduler's serial-key FIFO; deadline'd folds
        # are never cross-drained (drainable=False), keeping JobTimeout
        # semantics with the fold's own job.
        coalescer = getattr(self.service, "coalescer", None)
        pending = None
        barrier = False
        with self._submit_order:
            if coalescer is not None:
                pending = coalescer.prepare(
                    self, data, bs, drainable=effective_deadline is None
                )
            if pending is not None:
                runner = coalescer.run_fold

                def fold(ctx: JobContext, _p=pending):
                    return runner(ctx, _p)

                if pending.route == "fast":
                    # no device program to warm, no affinity to track —
                    # the empty signature also short-circuits the
                    # scheduler's affinity scan (one less lock round-trip
                    # per pickup on the hot path)
                    signature, warm = (), None
                else:
                    signature = shape_qualified_signature(self._analyzers, bs)
                    if coalescer._fleet_stream_eligible(
                        pending.plan, int(data.num_rows), tenant=self.tenant,
                    ):
                        # the drain will shard this fold over the fleet
                        # sub-mesh (host partials and the mesh's fold and
                        # merge): there is no one-device program to warm
                        warm = None
                    else:
                        warm = make_warm_fn(
                            self.service.router, self._analyzers,
                            self.service.mesh, data, bs,
                        )
            else:
                # a SERIAL-path fold raises the session's coalescer
                # barrier: no later drainable fold may be cross-drained
                # ahead of it (per-session FIFO spans both paths); the
                # fold body clears it once, on its first attempt
                barrier = (
                    coalescer.note_serial_fold(self)
                    if coalescer is not None else False
                )
                skey = (self.tenant, self.dataset)

                def fold(ctx: JobContext):
                    try:
                        return self._fold_batch(ctx, data, done, bs)
                    finally:
                        if barrier and "barrier_cleared" not in done:
                            done["barrier_cleared"] = True
                            coalescer.clear_serial_barrier(skey)

                # under the fleet, a LARGE serial delta shards over the
                # tenant's sub-mesh (the job leases it via mesh_tenant);
                # warmth keys carry the slice's width so a re-packed
                # tenant's battery reads cold at its new width
                serial_mesh = self._fold_mesh_hint(int(data.num_rows))
                signature = shape_qualified_signature(
                    self._analyzers, bs, serial_mesh
                )
                warm = make_warm_fn(
                    self.service.router, self._analyzers, serial_mesh, data, bs,
                )
            try:
                handle = self.service.scheduler.submit(
                    fold,
                    tenant=self.tenant,
                    priority=self.priority,
                    deadline_s=effective_deadline,
                    max_retries=self.max_retries,
                    # per-shape warmth: the bucketed batch size is part of
                    # the key
                    signature=signature,
                    job_id=(
                        f"{self.tenant}/{self.dataset}"
                        f"#{next(self._submit_seq)}"
                    ),
                    warm_fn=warm,
                    # scheduler-level serialization: one fold at a time per
                    # session, in submission order — pipelined ingests
                    # occupy ONE worker and cannot fold out of order
                    # (per-batch anomaly attribution)
                    serial_key=(self.tenant, self.dataset),
                    # backpressure: wait for queue space up to block_s
                    # before the typed shed (per-call override, else the
                    # session default)
                    block_s=(
                        block_s if block_s is not None
                        else self.admission_block_s
                    ),
                    # while a drain sweeps this fold's coalesce key, the
                    # job stays queued for bulk absorption instead of
                    # being picked (scheduler._eligible)
                    defer_key=(
                        pending.key
                        if pending is not None and pending.drainable
                        else None
                    ),
                    # SERIAL-path folds over fleet-sized deltas lease the
                    # tenant's sub-mesh per attempt (coalesced folds lease
                    # inside their drain instead); the ONE hint computed
                    # above keeps the warmth key and the lease opt-in
                    # agreeing even across a concurrent re-pack
                    mesh_tenant=(
                        self.tenant
                        if pending is None and serial_mesh is not None
                        else None
                    ),
                    # commit/job-finish atomicity: a job that dies OUTSIDE
                    # the fold body (worker fault, deadline kill in queue)
                    # reconciles with the coalescer — adopting a drain's
                    # committed result, or withdrawing the unclaimed fold
                    # so no later drain can commit it after the failure
                    recover_fn=(
                        (lambda ctx, exc, _p=pending:
                         coalescer.reconcile_orphan(ctx, _p, exc))
                        if pending is not None else None
                    ),
                )
            except BaseException:
                if pending is not None:
                    # shed/closed before admission: the fold must not
                    # linger claimable in the coalescer
                    coalescer.abandon(pending)
                elif barrier:
                    # a shed serial fold never runs its body: release the
                    # barrier it raised
                    coalescer.clear_serial_barrier(
                        (self.tenant, self.dataset)
                    )
                raise
            if pending is not None:
                coalescer.mark_submitted(pending, handle, signature)
        if wait:
            from .errors import JobFailed, JobTimeout

            try:
                return handle.result(timeout)
            except JobTimeout:
                if handle.late_value is not None:
                    # the fold COMPLETED late: the batch is already merged
                    # into the persisted states — hand back the committed
                    # result rather than baiting a double-counting retry
                    return handle.late_value
                raise
            except JobFailed as exc:
                from ..exceptions import SchemaDriftError

                if isinstance(exc.__cause__, SchemaDriftError):
                    # surface the drift contract directly: the caller's
                    # remedy (fix the producer, change drift_policy) has
                    # nothing to do with job plumbing
                    raise exc.__cause__
                raise
        return handle

    def _fold_mesh_hint(self, rows: int):
        """The mesh this session's SERIAL fold of ``rows`` rows would shard
        over: the service's explicit mesh when one exists, else the
        tenant's fleet slice for fleet-sized deltas (a lease-shaped peek;
        the job's attempt leases the real thing), else None (one device).
        Drives both the warmth key and the mesh_tenant opt-in."""
        svc = self.service
        if svc.mesh is not None:
            return svc.mesh
        fleet = getattr(svc, "fleet", None)
        if fleet is None:
            return None
        from .fleet import fleet_stream_min_rows

        if rows < fleet_stream_min_rows():
            return None
        lease = fleet.peek(self.tenant)
        return lease if lease.n_dev >= 2 else None

    def _fold_batch(
        self, ctx: JobContext, data: Dataset, done: dict, batch_size: int
    ):
        from ..verification import VerificationSuite

        if "result" in done:
            # this job already folded the batch on an earlier attempt —
            # re-folding would merge the batch into the persisted states a
            # second time; hand back the memoized committed result
            return self._notify(done)
        from ..reliability.faults import fault_point

        # chaos site: fails a fold BEFORE any state mutates, so retry
        # semantics stay exercisable without double-count hazards
        fault_point("stream_fold", tag=ctx.job_id)
        with self._serial:
            if self._closed:
                raise SessionClosed(self.tenant, self.dataset)
            data, pending_contract, _degraded = self._pre_fold(data)
            result = VerificationSuite.do_verification_run(
                data,
                self.checks,
                self.required_analyzers,
                aggregate_with=self.provider,
                save_states_with=self.provider,
                batch_size=batch_size,
                monitor=ctx.monitor,
                device=self.service.device,
                # the attempt's fleet lease (ctx.mesh) when one was granted,
                # else the service's explicit mesh, else one device:
                # exactly the order _fold_mesh_hint promised the warmth key
                sharding=ctx.mesh if ctx.mesh is not None else self.service.mesh,
                placement=ctx.placement,
            )
            self._commit_fold(result, data, pending_contract, done)
        return self._notify(done)

    def _pre_fold(self, data: Dataset):
        """Under ``self._serial``: the schema-contract half of a fold.
        Returns ``(data_to_fold, pending_contract, guard_degraded)`` —
        ``pending_contract`` is non-None only for the session's FIRST fold
        (committed by `_commit_fold` after the fold succeeds), and
        ``guard_degraded`` flags a degrade-policy guard outcome (columns
        excluded) that only the full runner's per-analyzer degradation can
        honor. Raises typed ``SchemaDriftError`` with states untouched."""
        if self._contract is None:
            # the contract COMMITS only after this batch's fold
            # succeeds: a first batch whose fold raises never folded,
            # so its schema must not pin the session (a wrong-schema
            # first batch would otherwise reject every corrected
            # batch after it until an operator deleted the contract)
            from .drift import SchemaContract

            return data, SchemaContract.capture(data), False
        degraded_before = self.drift_degraded_batches
        data = self._guard_schema(data)
        return data, None, self.drift_degraded_batches != degraded_before

    def _commit_fold(self, result, data: Dataset, pending_contract, done: dict):
        """Under ``self._serial``: one successful fold's bookkeeping —
        contract commit, counters, bounded results ring, export-plane
        series. Shared verbatim between the serial path and the
        coalescer's fast/device folds so the two can never drift."""
        done["result"] = result
        if pending_contract is not None:
            self._contract = pending_contract
            self._store_contract()
        self._schema = self._schema or data.schema
        self.batches_ingested += 1
        self.rows_ingested += int(data.num_rows)
        from ..ingest.columnar import payload_bytes

        self.bytes_ingested += payload_bytes(data)
        self.results.append(result)
        metrics = self.service.metrics
        metrics.inc_many([
            ("deequ_service_stream_batches_total", 1.0,
             {"tenant": self.tenant, "dataset": self.dataset}),
            ("deequ_service_stream_rows_total", float(data.num_rows),
             {"tenant": self.tenant, "dataset": self.dataset}),
        ])
        if result.status != CheckStatus.SUCCESS:
            # the mid-stream anomaly signal: a failing merge is visible
            # on the export plane the moment it happens
            metrics.inc(
                "deequ_service_stream_check_failures_total",
                tenant=self.tenant, dataset=self.dataset,
                status=result.status.value,
            )

    def _coalesce_plan(self, data: Dataset):
        """The session's coalesce eligibility plan for this schema
        (``None`` = serial path). Per-session memo over the coalescer's
        SHARED plan cache — same-battery fleets build one plan total."""
        schema = data.schema
        # the epoch is read FIRST: a concurrent reconfigure() swaps the
        # analyzer battery before bumping it, so a plan memoized under
        # the new epoch was provably built from the new battery (a plan
        # built mid-swap lands under the old epoch and is never read)
        fp = tuple((c.name, c.kind) for c in schema.columns)
        key = (self._plans_epoch, fp)
        if key not in self._plans:
            # the shared cache keys by (battery, schema) — the epoch is a
            # session-local memo concern only
            self._plans[key] = self.service.coalescer.plan_for(
                self._analyzers, schema, fp
            )
        return self._plans[key]

    def _guard_schema(self, data: Dataset) -> Dataset:
        """The drift guard, run under the serial lock BEFORE anything
        mutates; the contract itself is captured (and committed only
        after a successful fold) in ``_fold_batch``. Raises typed
        ``SchemaDriftError`` (policy ``reject``, or an un-coercible
        batch) with persisted states untouched; returns the (possibly
        repaired) dataset to fold otherwise."""
        from ..exceptions import SchemaDriftError
        from ..observability import record_failure
        from ..observability import trace as _trace

        metrics = self.service.metrics
        try:
            report = self._contract.validate(
                data,
                policy=self.drift_policy,
                session=f"{self.tenant}/{self.dataset}",
            )
        except SchemaDriftError as exc:
            # a rejected batch is a typed failure an operator will want the
            # trace for: event + flight-recorder dump, then the existing
            # counter bump and raise
            record_failure(exc)
            metrics.inc(
                "deequ_service_drift_rejections_total",
                tenant=self.tenant, dataset=self.dataset,
            )
            raise
        if report.coercions:
            self.drift_coercions += len(report.coercions)
            _trace.add_event(
                "drift_coerced", columns=len(report.coercions),
                session=f"{self.tenant}/{self.dataset}",
            )
            metrics.inc(
                "deequ_service_drift_coercions_total",
                float(len(report.coercions)),
                tenant=self.tenant, dataset=self.dataset,
            )
        if report.repaired:
            self.drift_repaired_batches += 1
            _trace.add_event(
                "drift_repaired", repaired=list(report.repaired)[:8],
                session=f"{self.tenant}/{self.dataset}",
            )
            metrics.inc(
                "deequ_service_drift_repairs_total",
                tenant=self.tenant, dataset=self.dataset,
            )
            _logger.warning(
                "session %s/%s coerce-repaired hard schema drift before "
                "folding: %s — the producer's schema changed",
                self.tenant, self.dataset, report.repaired,
            )
        if report.degraded:
            self.drift_degraded_batches += 1
            _trace.add_event(
                "drift_degraded", columns=list(report.degraded)[:8],
                session=f"{self.tenant}/{self.dataset}",
            )
            metrics.inc(
                "deequ_service_drift_degraded_total",
                tenant=self.tenant, dataset=self.dataset,
            )
            _logger.warning(
                "session %s/%s folding batch with %d drifted column(s) "
                "degraded per policy: %s",
                self.tenant, self.dataset, len(report.degraded),
                report.degraded,
            )
        if report.table is None:
            return data
        return Dataset.from_arrow(report.table)

    # -- contract persistence ------------------------------------------------

    _CONTRACT_FILENAME = "schema-contract.json"

    def _contract_path(self):
        path = getattr(self.provider, "path", None)
        if path is None:
            return None
        from .. import io as dio

        return dio.join(path, self._CONTRACT_FILENAME)

    def _load_contract(self):
        path = self._contract_path()
        if path is None:
            return None
        import json

        from .. import io as dio
        from .drift import ColumnContract, SchemaContract

        if not dio.exists(path):
            return None
        try:
            with dio.open_file(path, "r") as fh:
                d = json.load(fh)
            from ..integrity import verify_json_checksum

            verify_json_checksum(
                {k: v for k, v in d.items() if k != "checksum"},
                d.get("checksum", ""), "schema contract", path,
            )
            return SchemaContract(
                tuple(ColumnContract(**c) for c in d["columns"])
            )
        except Exception:  # noqa: BLE001 - recapture beats refusing folds
            _logger.warning(
                "schema contract at %s is unreadable or corrupt; "
                "re-capturing from the next folded batch", path,
                exc_info=True,
            )
            return None

    def _store_contract(self, path: Optional[str] = None) -> None:
        path = path if path is not None else self._contract_path()
        if path is None or self._contract is None:
            return
        import json

        from .. import io as dio
        from ..integrity import checksum_json

        d = {
            "columns": [
                {"name": c.name, "dtype": c.dtype, "dictionary": c.dictionary}
                for c in self._contract.columns
            ]
        }
        d["checksum"] = checksum_json(d)
        try:
            dio.write_text_atomic(path, json.dumps(d))
        except Exception:  # noqa: BLE001 - durability is best-effort;
            # the in-process contract still guards every fold
            _logger.warning(
                "could not persist schema contract to %s", path, exc_info=True
            )

    def _notify(self, done: dict):
        """Deliver on_result at most once per fold, CONTAINED: by the time
        the callback runs, the batch is already merged into the persisted
        states — failing the job for a callback error would discard a
        committed result and bait the caller into a double-counting
        re-ingest. Callback failures are logged and counted instead."""
        result = done["result"]
        if self.on_result is not None and "notified" not in done:
            done["notified"] = True
            try:
                self.on_result(result)
            except Exception:  # noqa: BLE001 - advisory delivery
                _logger.warning(
                    "on_result callback failed for session %s/%s",
                    self.tenant, self.dataset, exc_info=True,
                )
                self.service.metrics.inc(
                    "deequ_service_callback_failures_total",
                    tenant=self.tenant, dataset=self.dataset,
                )
        return result

    # -- hot reconfiguration -------------------------------------------------

    def reconfigure(
        self,
        *,
        checks=None,
        drift_policy: Optional[str] = None,
        priority: Optional[Priority] = None,
        row_gate: Any = _UNSET,
    ) -> None:
        """Swap the session's declarative surface IN PLACE at a fold
        boundary — the hot-reload primitive the tenant catalog's
        :class:`~deequ_tpu_torch.service.catalog.CatalogPlane` drives: a
        catalog edit re-materializes checks, drift policy, priority and row
        gate on the live session without a restart, and without touching
        the persisted algebraic states, which stay on the device
        (analyzers shared between the old and new check set keep their
        cumulative history; newly-required analyzers start folding from
        their next batch).

        Serialized against folds by the session lock, so every fold runs
        under exactly ONE configuration. Fields left at their defaults are
        untouched (``row_gate`` uses a sentinel so passing ``None``
        explicitly REMOVES the gate)."""
        with self._serial:
            if checks is not None:
                self.checks = list(checks)
                from ..runners.analysis_runner import (
                    collect_required_analyzers,
                )

                self._analyzers = collect_required_analyzers(
                    self.checks, self.required_analyzers
                )
                # coalesce plans key off the analyzer battery: stale
                # plans would drain folds with the OLD battery's program.
                # Invalidate by epoch (the memo key carries it) — the
                # plans dict itself belongs to the submit lock
                self._plans_epoch += 1
            if drift_policy is not None:
                from .drift import DRIFT_POLICIES

                if drift_policy not in DRIFT_POLICIES:
                    raise ValueError(
                        f"drift_policy must be one of {DRIFT_POLICIES}, "
                        f"got {drift_policy!r}"
                    )
                self.drift_policy = drift_policy
            if priority is not None:
                self.priority = priority
            if row_gate is not _UNSET:
                self.row_gate = row_gate

    # -- state-only queries --------------------------------------------------

    def current(self):
        """Re-evaluate the session's checks from the persisted states alone
        — no data pass (the `run_on_aggregated_states` mode). Requires at
        least one ingested batch (the schema comes from it)."""
        from ..verification import VerificationSuite

        with self._serial:
            if self._schema is None:
                raise ValueError(
                    f"session {self.tenant}/{self.dataset} has no ingested "
                    "batches yet"
                )
            return VerificationSuite.run_on_aggregated_states(
                self._schema,
                self.checks,
                [self.provider],
                required_analyzers=self.required_analyzers,
                device=self.service.device,
            )

    @property
    def latest(self):
        """The most recent batch's VerificationResult (None before any)."""
        return self.results[-1] if self.results else None

    @property
    def closed(self) -> bool:
        return self._closed

    def flush_to_partition(self, store=None, partition: Optional[str] = None
                           ) -> Optional[str]:
        """Flush the session's cumulative states into a partition store as
        one partition of ``self.dataset`` (the reference's
        ``flush_to_partition``, deequ_tpu/service/streaming.py:844): a
        finished ingestion window becomes a partition that incremental
        verification reuses. ``store`` defaults to the service's partition
        store, ``partition`` to ``session-<tenant>``. Returns the partition
        name, or None when there is no store or the session never folded a
        batch. Each flush overwrites the partition with the newest states
        and a version token made from the fold counters; :meth:`close`
        flushes when the service has a store."""
        with self._serial:
            return self._flush_to_partition_locked(store, partition)

    def _flush_to_partition_locked(self, store=None, partition=None):
        store = store if store is not None else getattr(self.service, "partition_store", None)
        if store is None or self.batches_ingested == 0 or self._schema is None:
            return None
        from ..integrity import checksum_json
        from ..observability import trace as _trace
        from ..runners.incremental import analyzer_key, contract_fingerprint

        name = partition or f"session-{self.tenant}"
        keys = []
        provider = store.provider(self.dataset, name)
        store.invalidate(self.dataset, name)
        for a in self._analyzers:
            state = self.provider.load(a)
            if state is None:
                continue
            provider.persist(a, state)
            keys.append(analyzer_key(a))
        # the schema contract goes with the states: a session re-opened
        # against this partition's provider loads it, so its drift policy
        # holds across the move
        contract_path = getattr(provider, "path", None)
        if contract_path is not None:
            from .. import io as dio

            self._store_contract(dio.join(contract_path, self._CONTRACT_FILENAME))
        store.commit(
            self.dataset, name,
            fingerprint=contract_fingerprint(self._schema),
            # the version token: a digest of the fold counters, so a
            # re-flush after more folds reads as changed
            content_checksum=checksum_json({
                "batches": self.batches_ingested,
                "rows": self.rows_ingested,
                "bytes": self.bytes_ingested,
            }),
            num_rows=self.rows_ingested,
            analyzer_keys=keys,
            schema=[(c.name, c.kind.value) for c in self._schema.columns],
        )
        _trace.add_event("session_flushed_to_partition", dataset=self.dataset,
                         partition=name, rows=self.rows_ingested)
        return name

    def close(self) -> None:
        with self._serial:
            if self._closed:
                return
            self._closed = True
            # a session of a service with a partition store flushes its
            # cumulative states as a partition on close (best effort:
            # closing never fails on a full disk)
            try:
                self._flush_to_partition_locked()
            except Exception:  # noqa: BLE001 - the flush is an optimization
                _logger.warning("could not flush session %s/%s states to the partition "
                                "store", self.tenant, self.dataset, exc_info=True)


def session_key(tenant: str, dataset: str) -> Tuple[str, str]:
    return (str(tenant), str(dataset))
