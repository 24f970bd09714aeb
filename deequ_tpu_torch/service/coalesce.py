"""Cross-session fold coalescing: amortize the per-fold fixed cost (the
reference's ``deequ_tpu/service/coalesce.py``, ported).

With many concurrent sessions each folding small micro-batches, every fold
pays a fixed cost — an engine pass (features, copies, launches, a state
fetch) plus scheduler and state plumbing — far above the cost of its rows.
This module amortizes that cost across sessions:

- **Tiny-delta host fast path.** A micro-batch below the crossover
  computes its delta state with the host partials (``host_partial``, the
  native kernels of the host ingest tier) and merges it into the session's
  persisted states with :func:`~deequ_tpu_torch.analyzers.states.host_merge`:
  no engine pass, no launch. Valid only for batteries whose states are
  identity-merge transparent with the default ``ingest_partial``.

- **Coalesced device folds.** Pending folds whose batteries share a
  signature, a launch layout and a pow2 batch bucket are stacked along a
  leading session axis and folded with one launch per kernel
  (:func:`~deequ_tpu_torch.runners.engine.fold_sessions_coalesced`: the
  stacked entries of ``scan_reduce`` and ``hll_registers``), then merged
  into the sessions' persisted states on the device (one ``state_fold``
  launch for the group's scalar states): W sessions pay one launch per
  kernel and one packed fetch each way. Per-session FIFO, atomic fold semantics and
  retry-safe memoization are preserved (a fold executes exactly once, its
  own job consumes the memoized outcome), and a fault inside a coalesced
  launch is isolated to the owning session by bisecting the group
  (at most log2 W re-launches).

- **Crossover router.** :class:`CrossoverRouter` picks the route per fold
  from measured per-analyzer-class host rates against the measured device
  fixed cost; ``DEEQU_TPU_FAST_PATH_MAX_ROWS`` overrides the measurement.

Knobs (the reference's names):

- ``DEEQU_TPU_COALESCE``: "0" disables the whole plane — every ingest
  takes exactly the serial path.
- ``DEEQU_TPU_COALESCE_MAX_WIDTH``: sessions per coalesced launch
  (default 16).
- ``DEEQU_TPU_FAST_PATH_MAX_ROWS``: fixed fast-path row ceiling
  (default -1 = the measured crossover; 0 forces the device path).

Failure semantics: a fold that fails inside a launch fails ALONE with its
typed error; the sibling sessions' folds commit. Drift guards, contract
capture and session bookkeeping run under each session's serial lock as
on the serial path. Folds carrying a job deadline are never cross-drained,
and a fold is drained only after its job was ADMITTED.

Fleet stream folds: under the fleet scheduler a fold of at least
``fleet_stream_min_rows`` rows (``DEEQU_TPU_FLEET_STREAM_MIN_ROWS``, default
65,536) of a battery whose analyzers all have host partials takes the
device route even where the crossover would send it to the fast path, and
its drain shards it over the tenant's sub-mesh
(:meth:`FoldCoalescer._execute_mesh_fold`: one row slice per shard, each
slice's host partials folded into its shard's state by
``sharded_ingest_fold`` under the elastic ladder, the shards merged at the
drain boundary by ``collective_merge_states``). An explicit service
``mesh=`` turns coalescing off: every fold takes the serial path over that
mesh.

The service's tuning controller (``tuning.controller``) hooks in at three
places: the route decision (a shadow experiment on
``fast_path_max_rows`` routes every period-th eligible fold the
candidate's way and tags it with ``tuning_arm``), the host fast path (its
partials' seconds) and each coalesced launch (each fold's share of the
launch's seconds, the engine's wait after its kernels included).
"""

from __future__ import annotations

import logging
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

_logger = logging.getLogger(__name__)

#: "0" disables coalescing AND the fast path entirely (exact escape hatch)
COALESCE_ENV = "DEEQU_TPU_COALESCE"
#: max sessions stacked into one coalesced device launch
COALESCE_MAX_WIDTH_ENV = "DEEQU_TPU_COALESCE_MAX_WIDTH"
DEFAULT_COALESCE_MAX_WIDTH = 16
#: fixed fast-path row ceiling; -1 = measured crossover, 0 = never fast
FAST_PATH_MAX_ROWS_ENV = "DEEQU_TPU_FAST_PATH_MAX_ROWS"


def coalesce_enabled() -> bool:
    from ..utils import env_flag

    return env_flag(COALESCE_ENV, True)


def coalesce_max_width() -> int:
    from ..tuning import knobs

    return knobs.value("coalesce_max_width")


#: fast-route drains may run far wider than a device stack: they execute
#: sequentially on ONE worker (memory is one micro-batch at a time, not
#: width x bucket of stacked features), and the wider the run the fewer
#: GIL handoffs per fold — measured on the 1000-session soak: width 16 ->
#: 330 sessions/s, width 128 -> 484. Bounded so one worker's drain can
#: never hold more than this many sessions' folds at once; the device
#: stack keeps the (memory-relevant) DEEQU_TPU_COALESCE_MAX_WIDTH bound.
_FAST_DRAIN_WIDTH = 512


def fast_path_max_rows() -> int:
    from ..tuning import knobs

    return knobs.value("fast_path_max_rows")


class CrossoverRouter:
    """Fast-path vs device-path routing from MEASURED rates.

    The host fast path costs ``sum_over_analyzers(rows / host_rate[cls])``
    — per-analyzer-class rates observed on every fast fold (EWMA), seeded
    with a conservative default for classes never measured. The device
    path costs a FIXED launch+fetch overhead (observed per coalesced
    launch, amortized over its width) plus a per-row term. Below the
    crossover the host kernels win outright; above it the device's
    throughput pays for its fixed cost. ``DEEQU_TPU_FAST_PATH_MAX_ROWS``
    replaces the model with a hard ceiling (0 = always device, useful to
    force the coalesced path in tests)."""

    #: seed rows/s per analyzer class before any measurement (native block
    #: kernels measure 30-200M rows/s; seeding LOW biases early folds to
    #: the device path only for very large batches, which is safe). These
    #: class attributes mirror the registry's static defaults
    #: (tuning/knobs.py); live seeds resolve through the registry so a
    #: calibration profile replaces them with this substrate's measured
    #: rates.
    DEFAULT_HOST_ROWS_PER_S = 20e6
    #: seed device fixed seconds (the reference's seed, taken on its own
    #: hardware; ``observe_device`` replaces it with this card's measured
    #: launch+fetch cost)
    DEFAULT_DEVICE_FIXED_S = 0.02
    DEFAULT_DEVICE_ROWS_PER_S = 100e6
    _ALPHA = 0.2  # EWMA weight of the newest observation

    def __init__(self):
        self._lock = threading.Lock()
        self._host_rate: Dict[type, float] = {}
        self._default_host_rate = self.DEFAULT_HOST_ROWS_PER_S
        self._device_fixed_s = self.DEFAULT_DEVICE_FIXED_S
        self._device_rows_per_s = self.DEFAULT_DEVICE_ROWS_PER_S
        self._device_measured = False
        self.reseed_from_knobs()

    def reseed_from_knobs(self) -> None:
        """Pull cost-model seeds from the tuning registry. With autotune
        off (or nothing tuned) the registry returns the class defaults —
        byte-identical behavior. A calibration profile replaces the seeds
        only; the per-class EWMAs already measured stay authoritative."""
        from ..tuning import knobs

        with self._lock:
            self._default_host_rate = knobs.value("router_host_rows_per_s")
            self._device_rows_per_s = knobs.value("router_device_rows_per_s")
            if not self._device_measured:
                # an unmeasured fixed cost re-seeds too; once live launches
                # have refined it, the EWMA wins over any profile
                self._device_fixed_s = knobs.value("router_device_fixed_s")

    def reset(self) -> None:
        """Forget every fitted rate: the model goes back to the registry's
        seeds, as at boot. The host model has no fixed cost, so a fold of a
        few rows fits a host rate of a few thousand rows/s from its call
        overhead alone, and every later fold of that class then routes to
        the device; a caller that needs the seeds' routing resets first."""
        with self._lock:
            self._host_rate.clear()
            self._device_measured = False
        self.reseed_from_knobs()

    def observe_host(self, cls: type, rows: int, seconds: float) -> None:
        if seconds <= 0 or rows <= 0:
            return
        rate = rows / seconds
        with self._lock:
            prev = self._host_rate.get(cls)
            self._host_rate[cls] = (
                rate if prev is None
                else prev + self._ALPHA * (rate - prev)
            )

    def observe_device(self, rows: int, seconds: float, folds: int) -> None:
        """One coalesced launch of ``folds`` sessions x ``rows`` rows each
        took ``seconds``: its per-fold fixed share updates the model."""
        if seconds <= 0 or folds <= 0:
            return
        per_fold = seconds / folds
        with self._lock:
            fixed = max(per_fold - rows / self._device_rows_per_s, 1e-4)
            self._device_fixed_s += self._ALPHA * (fixed - self._device_fixed_s)
            self._device_measured = True

    def host_seconds(self, classes, rows: int) -> float:
        with self._lock:
            return sum(
                rows / self._host_rate.get(cls, self._default_host_rate)
                for cls in classes
            )

    def device_seconds(self, rows: int) -> float:
        with self._lock:
            return (
                self._device_fixed_s + rows / self._device_rows_per_s
            )

    def route(self, plan: "FoldPlan", rows: int) -> str:
        if not plan.fast_ok:
            return "device"
        override = fast_path_max_rows()
        if override >= 0:
            return "fast" if rows <= override else "device"
        classes = [type(a) for a in plan.battery]
        if self.host_seconds(classes, rows) <= self.device_seconds(rows):
            return "fast"
        return "device"


class FoldPlan:
    """Per-(session, schema) eligibility plan: the deduped battery, its
    feature machinery and the signature half of the coalesce key. Built
    once per schema; ``None`` from :func:`build_fold_plan` means the
    serial path must run (grouping sets, precondition failures,
    feature-validation failures — everything whose degradation semantics
    live in the full runner).

    ``signatures`` holds each analyzer's scan signature and ``layout`` the
    battery's launch layout (``BundledScanProgram.layout``): the port's
    program deduplicates slots, so batteries with equal per-analyzer
    signatures can still build different slot tables (Mean("a"), Sum("a")
    share one slot; Mean("a"), Sum("b") need two), and only equal layouts
    stack position by position."""

    __slots__ = ("battery", "columns", "fast_ok", "mesh_ok", "signatures", "layout",
                 "_builder")

    def __init__(self, battery, columns, fast_ok, signatures, mesh_ok=False):
        self.battery = battery
        self.columns = columns
        self.fast_ok = fast_ok
        #: may this battery's folds shard over a fleet sub-mesh? Requires
        #: host partials (the shard-local fold feeds `sharded_ingest_fold`
        #: with per-slice partial states)
        self.mesh_ok = mesh_ok
        self.signatures = signatures
        self.layout = self.program().layout
        self._builder = None

    def program(self):
        """This battery's program (engine-cached)."""
        from ..runners.engine import _fused_program

        return _fused_program(self.battery)

    def builder(self):
        from ..runners.features import FeatureBuilder

        if self._builder is None:
            self._builder = FeatureBuilder(
                [s for a in self.battery for s in a.feature_specs()]
            )
        return self._builder


def build_fold_plan(analyzers, schema) -> Optional[FoldPlan]:
    """Eligibility in one pass; mirrors the runner's split so a fold this
    plan serves computes exactly what `do_analysis_run` would. Each
    state's class comes from ``init_state`` on the CPU (the reference
    traces it abstractly)."""
    import torch

    from ..analyzers.base import (
        Preconditions,
        ScanShareableAnalyzer,
    )
    from ..analyzers.grouping import GroupingAnalyzer
    from ..analyzers.states import identity_merge_transparent
    from ..runners.engine import _scan_signature
    from ..runners.features import FeatureBuilder, dry_run_batch

    battery: List[Any] = []
    seen = set()
    for a in analyzers:
        if a in seen:
            continue
        seen.add(a)
        battery.append(a)
    if not battery:
        return None
    for a in battery:
        if not isinstance(a, ScanShareableAnalyzer):
            return None
        if isinstance(a, GroupingAnalyzer):
            return None
        if getattr(a, "host_exclusive", False):
            return None
        if Preconditions.find_first_failing(schema, a.preconditions()):
            return None
    dry = dry_run_batch(schema)
    specs: List[Any] = []
    for a in battery:
        try:
            FeatureBuilder(a.feature_specs()).build(dry)
        except Exception:  # noqa: BLE001 - serial path owns degradation
            return None
        specs.extend(a.feature_specs())
    if any(spec.kind == "pred" for spec in specs):
        columns = None  # predicates may read arbitrary columns
    else:
        cols = {spec.column for spec in specs if spec.column is not None}
        columns = [c for c in schema.names if c in cols]
    fast_ok = all(
        a.supports_host_partial
        and type(a).ingest_partial is ScanShareableAnalyzer.ingest_partial
        and identity_merge_transparent(type(a.init_state(torch.device("cpu"))))
        for a in battery
    )
    # the fleet's shard-local stream fold computes per-slice HOST partials
    # and folds them over the sub-mesh: any host-partial-capable battery
    # qualifies (identity-merge transparency is not required — the
    # collective merge is the same merge the host tier runs over a mesh)
    mesh_ok = all(a.supports_host_partial for a in battery)
    battery = tuple(battery)
    return FoldPlan(
        battery, columns, fast_ok,
        tuple(_scan_signature(a) for a in battery),
        mesh_ok=mesh_ok,
    )


#: pending-fold states
_ENQ, _CLAIMED, _DONE = 0, 1, 2


def _job_tag(pending) -> str:
    """The stream_fold chaos-site tag: the fold's job id when known (the
    serial path's tag), else the session key."""
    handle = pending.handle
    return handle.job_id if handle is not None else (
        f"{pending.skey[0]}/{pending.skey[1]}"
    )


class _PendingFold:
    __slots__ = (
        "session", "skey", "data", "bucket", "plan", "route", "key",
        "drainable", "monitor", "done", "event", "state", "result", "error",
        "submitted", "harvested", "handle", "signature", "tuning_arm",
    )

    def __init__(self, session, data, bucket, plan, route, key, drainable):
        from ..runners.engine import RunMonitor

        self.session = session
        self.skey = (session.tenant, session.dataset)
        self.data = data
        self.bucket = bucket
        self.plan = plan
        self.route = route
        self.key = key
        self.drainable = drainable
        self.monitor = RunMonitor()
        self.done: dict = {}
        self.event = threading.Event()
        self.state = _ENQ
        self.result = None
        self.error: Optional[BaseException] = None
        self.submitted = False
        self.harvested = False
        self.handle = None      # the scheduler JobHandle, from mark_submitted
        self.signature = ()     # the job's placement signature (device route)
        self.tuning_arm = None  # knob name when shadow-routed by tuning


class FoldCoalescer:
    """The service's cross-session fold batching plane."""

    #: seconds a job waits on a fold claimed by another worker's launch
    #: before declaring the launch lost (launches always complete their
    #: claims, even on BaseException — this is a deadlock backstop)
    CLAIM_WAIT_S = 600.0

    #: sentinel distinguishing "plan computed: ineligible" from "never
    #: computed" in the shared plan cache
    _NO_PLAN = object()

    def __init__(self, service):
        from ..utils import BoundedLRU

        self.service = service
        self.router = CrossoverRouter()
        self._lock = threading.Lock()
        #: (battery tuple, schema fingerprint) -> FoldPlan | _NO_PLAN.
        #: SHARED across sessions: 1000 sessions running the same checks
        #: build ONE plan, not 1000 (plan construction — dry-run feature
        #: validation + a state per analyzer — is first-fold latency)
        self._plan_cache = BoundedLRU(512)
        #: coalesce key -> deque of device-routed pending folds, enqueue
        #: order == per-session submission order (ingest holds the
        #: session's submit lock across enqueue+submit)
        self._queues: Dict[Tuple, deque] = {}
        #: sessions with a fold currently CLAIMED: a drain never takes a
        #: second fold of a session whose previous fold is still in
        #: flight, so per-session folds execute strictly one at a time,
        #: in FIFO order (atomic fold semantics under coalescing)
        self._inflight: set = set()
        #: keys with an ACTIVE drain loop (the flat-combining discipline):
        #: while one worker sweeps a key's queue, sibling jobs for that
        #: key PARK on their fold's event instead of starting competing
        #: claims — the drainer picks their folds up on its next sweep.
        #: Restores the accumulate-and-drain rhythm that makes one busy
        #: thread faster than eight contending ones on GIL-bound
        #: micro-folds (measured: 1 worker 1100 sessions/s vs 8 workers
        #: 440 before this discipline).
        self._draining: set = set()
        #: session key -> deque of that session's DRAINABLE pendings in
        #: submission order: a cross-drain may only claim a session's
        #: HEAD fold, so per-session FIFO holds even when a session's
        #: folds land under DIFFERENT coalesce keys (varying micro-batch
        #: buckets) — a drain on key B must not execute fold #2 while
        #: fold #1 (key A) is still outstanding
        self._session_fifo: Dict[Tuple, deque] = {}
        #: session key -> count of outstanding folds a drain cannot see
        #: (serial-path folds, non-drainable pendings): while positive,
        #: the session's drainable folds execute only via their own
        #: serial-key-ordered jobs, never a cross-drain — closing the
        #: ordering hole between a queued serial fold and a later
        #: drainable one. A barrier that leaks (a deadline'd job timing
        #: out in queue without running) only degrades that session to
        #: own-job execution; it can never reorder or lose a fold.
        self._serial_barrier: Dict[Tuple, int] = {}
        m = service.metrics
        m.describe(
            "deequ_service_coalesced_folds_total",
            "Streaming folds executed inside a cross-session coalesced "
            "device launch (stacked along a leading session axis).",
        )
        m.describe(
            "deequ_service_fast_path_folds_total",
            "Streaming folds served by the tiny-delta host fast path "
            "(host-kernel delta + algebraic merge; no engine pass).",
        )
        m.describe(
            "deequ_service_fold_route_total",
            "Streaming fold routing decisions, by route "
            "(fast/device/serial).",
        )
        m.describe(
            "deequ_service_coalesce_width_total",
            "Coalesced launches by pow2 width bucket (a width histogram: "
            "width=1 launches found no peers to amortize with).",
        )
        m.describe(
            "deequ_service_coalesce_width_sum",
            "Sum of coalesced-launch widths (divide by launch count for "
            "the mean amortization factor).",
        )
        m.describe(
            "deequ_service_coalesce_quarantined_total",
            "Folds isolated to a typed failure by coalesced-launch "
            "bisection while their group siblings committed.",
        )
        m.describe(
            "deequ_service_fleet_stream_folds_total",
            "Streaming folds sharded over a fleet sub-mesh (shard-local "
            "states, butterfly merge at the drain boundary), labeled by "
            "tenant and slice device count.",
        )
        m.describe_histogram(
            "deequ_service_coalesce_flush_seconds",
            "Wall time of the coalesced drain that flushed each pending "
            "fold, per tenant and priority class (pow2 buckets, seconds).",
        )

    # -- ingest-side API -----------------------------------------------------

    def plan_for(self, analyzers, schema, fingerprint) -> Optional[FoldPlan]:
        key = (tuple(analyzers), fingerprint)
        plan = self._plan_cache.get(key)
        if plan is None:
            plan = build_fold_plan(analyzers, schema)
            self._plan_cache[key] = (
                plan if plan is not None else self._NO_PLAN
            )
        return None if plan is self._NO_PLAN else plan

    def prepare(
        self, session, data, bucket: int, *, drainable: bool = True
    ) -> Optional[_PendingFold]:
        """Route one micro-batch fold, or None -> the serial path (exact
        pre-coalescing behavior). Called with the session's submit lock
        held; the returned fold must then be `mark_submitted` after the
        scheduler admitted its job, or `abandon`-ed if admission shed."""
        if not coalesce_enabled() or self.service.mesh is not None:
            return None
        rows = int(data.num_rows)
        if rows > bucket:
            return None  # multi-batch folds keep the streaming engine path
        plan = session._coalesce_plan(data)
        if plan is None:
            self.service.metrics.inc(
                "deequ_service_fold_route_total", route="serial"
            )
            return None
        route = self.router.route(plan, rows)
        fleet_forced = False
        if route == "fast" and self._fleet_stream_eligible(
            plan, rows, tenant=session.tenant
        ):
            # the fleet's sharding contract outranks the crossover model: a
            # delta at or above DEEQU_TPU_FLEET_STREAM_MIN_ROWS must reach
            # the mesh drain path (which lives on the device route)
            route = "device"
            fleet_forced = True
        tuning_arm = None
        controller = getattr(self.service, "tuning_controller", None)
        if controller is not None and plan.fast_ok and not fleet_forced:
            shadow = controller.choose(rows)
            if shadow is not None:
                # this fold measures the CANDIDATE fast-path ceiling:
                # route it the way the candidate would (the fleet contract
                # above still outranks any candidate)
                tuning_arm = "fast_path_max_rows"
                route = "fast" if shadow == "host" else "device"
        key = (route,) + plan.signatures + (plan.layout, bucket)
        pending = _PendingFold(
            session, data, bucket, plan, route, key, drainable
        )
        pending.tuning_arm = tuning_arm
        self.service.metrics.inc(
            "deequ_service_fold_route_total", route=route
        )
        # BOTH routes enqueue for cross-session draining: device folds
        # stack into one launch per kernel; fast folds run back-to-back on
        # the draining worker — one job pickup executes K folds while the
        # K-1 sibling jobs degenerate to memoized-result consumption.
        # Under the GIL, K tiny folds on ONE thread beat K workers
        # fighting over them (measured: 8 workers ran the 1000-session
        # soak SLOWER than 1 before draining). NON-drainable folds
        # (deadline'd) never enter the drain queue — they execute only
        # under their own job, and a job a deadline kills in the queue
        # must not leave a claimable fold behind; they raise the
        # session's serial barrier instead so later drainable folds
        # cannot overtake them.
        with self._lock:
            if pending.drainable:
                q = self._queues.get(key)
                if q is None:
                    q = deque()
                    self._queues[key] = q
                while q and q[0].state == _DONE:
                    q.popleft()  # lazily prune consumed entries
                q.append(pending)
                fifo = self._session_fifo.get(pending.skey)
                if fifo is None:
                    fifo = deque()
                    self._session_fifo[pending.skey] = fifo
                fifo.append(pending)
            else:
                self._serial_barrier[pending.skey] = (
                    self._serial_barrier.get(pending.skey, 0) + 1
                )
        return pending

    def note_serial_fold(self, session) -> bool:
        """A fold of this session is taking the SERIAL path (ineligible
        battery, multi-batch, …): raise its barrier so no later drainable
        fold of the session can be cross-drained ahead of it. Returns
        whether a barrier was raised (the caller clears it when the
        serial fold's job body runs)."""
        if not coalesce_enabled() or self.service.mesh is not None:
            return False
        skey = (session.tenant, session.dataset)
        with self._lock:
            self._serial_barrier[skey] = (
                self._serial_barrier.get(skey, 0) + 1
            )
        return True

    def clear_serial_barrier(self, skey: Tuple) -> None:
        with self._lock:
            n = self._serial_barrier.get(skey, 0) - 1
            if n > 0:
                self._serial_barrier[skey] = n
            else:
                self._serial_barrier.pop(skey, None)

    def mark_submitted(
        self, pending: _PendingFold, handle=None, signature=()
    ) -> None:
        with self._lock:
            pending.handle = handle
            pending.signature = signature
            pending.submitted = True

    def abandon(self, pending: _PendingFold) -> None:
        """Admission shed the fold's job before it was ever runnable."""
        with self._lock:
            q = self._queues.get(pending.key)
            if q is not None:
                try:
                    q.remove(pending)
                except ValueError:
                    pass
            if pending.drainable:
                self._fifo_remove_locked(pending)
            else:
                n = self._serial_barrier.get(pending.skey, 0) - 1
                if n > 0:
                    self._serial_barrier[pending.skey] = n
                else:
                    self._serial_barrier.pop(pending.skey, None)
            pending.state = _DONE

    def _fifo_remove_locked(self, pending: _PendingFold) -> None:
        fifo = self._session_fifo.get(pending.skey)
        if fifo is None:
            return
        if fifo and fifo[0] is pending:
            fifo.popleft()
        else:
            try:
                fifo.remove(pending)
            except ValueError:
                pass
        if not fifo:
            self._session_fifo.pop(pending.skey, None)

    # -- scheduler job body --------------------------------------------------

    #: how long a job parks on an active drainer before re-checking (the
    #: drainer may have exited between the check and the wait — the loop
    #: in run_fold then claims the fold itself; this is a liveness
    #: backstop, not a scheduling interval)
    _DRAIN_RECHECK_S = 0.2

    #: empty-sweep linger: how many times (x how long) a drainer waits
    #: for the feeders to refill its key before giving the drain up
    _DRAIN_LINGER_TRIES = 2
    _DRAIN_LINGER_S = 0.001

    def run_fold(self, ctx, pending: _PendingFold):
        """The job body for one pending fold: drive a drain loop over its
        key (claiming peers as they accumulate), park while another worker
        is already draining the key, or consume the outcome an earlier
        sweep produced for it."""
        if ctx.attempt > 1:
            # the scheduler decided to RETRY this fold: a memoized FAILURE
            # must re-execute (the serial path's done-dict memoizes only
            # committed results — failed attempts re-run), so re-arm the
            # fold; a memoized committed RESULT stays memoized, exactly
            # like the serial retry contract
            with self._lock:
                if pending.state == _DONE and pending.error is not None:
                    pending.state = _ENQ
                    pending.error = None
                    pending.result = None
                    pending.event.clear()
                    pending.harvested = False
                    # restore the ordering bookkeeping the failed
                    # attempt's completion released, so the retry's own
                    # completion balances it and no later fold of the
                    # session can cross-drain ahead of the retry
                    if pending.drainable:
                        fifo = self._session_fifo.get(pending.skey)
                        if fifo is None:
                            fifo = deque()
                            self._session_fifo[pending.skey] = fifo
                        fifo.appendleft(pending)
                    else:
                        self._serial_barrier[pending.skey] = (
                            self._serial_barrier.get(pending.skey, 0) + 1
                        )
        deadline = time.monotonic() + self.CLAIM_WAIT_S
        while pending.state != _DONE:
            group = None
            parked = False
            with self._lock:
                if pending.state == _ENQ:
                    if pending.key in self._draining and pending.drainable:
                        # a sibling worker is sweeping this key: park —
                        # its next sweep picks this fold up; contending
                        # with it would just shred the GIL
                        parked = True
                    else:
                        group = self._claim_group_locked(pending)
                        if pending.drainable:
                            self._draining.add(pending.key)
            if group is not None:
                if pending.drainable:
                    # while this drain runs, its key's queued jobs stay
                    # queued (the scheduler's _eligible defers them): the
                    # sweep executes their folds and finish_absorbed
                    # retires the jobs in bulk — no worker ever wakes
                    # just to read a memo
                    self.service.scheduler.defer_pickup(pending.key)
                try:
                    linger = 0
                    while group:
                        self._execute_group(group)
                        # bulk-retire the sibling jobs whose folds this
                        # sweep executed while they sat queued — they
                        # never occupy a worker (finish_absorbed)
                        self._absorb(ctx, group, skip=pending)
                        if not pending.drainable:
                            break
                        with self._lock:
                            group = self._claim_sweep_locked(pending.key)
                        if not group and linger < self._DRAIN_LINGER_TRIES:
                            # an empty sweep usually means the feeders are
                            # a millisecond behind, not done: LINGER
                            # briefly before abandoning the drain — an
                            # exiting drainer flips the key back into the
                            # many-small-claims mode whose GIL handoffs
                            # this loop exists to avoid
                            linger += 1
                            time.sleep(self._DRAIN_LINGER_S)
                            with self._lock:
                                group = self._claim_sweep_locked(pending.key)
                        if group:
                            linger = 0
                finally:
                    with self._lock:
                        self._draining.discard(pending.key)
                    if pending.drainable:
                        self.service.scheduler.resume_pickup(pending.key)
                break
            if parked or pending.state == _CLAIMED:
                pending.event.wait(self._DRAIN_RECHECK_S)
            if time.monotonic() > deadline and pending.state != _DONE:
                # a wedged drain held this fold past the liveness
                # backstop: resolve the fold itself with the typed error
                # (removing it from queue/fifo so no later sweep can
                # execute a fold the caller was told failed; execution
                # loops also skip DONE folds, so a drain that un-wedges
                # cannot double-fold it)
                self._complete(pending, error=RuntimeError(
                    f"coalesced launch holding fold for {pending.skey} "
                    f"did not complete within {self.CLAIM_WAIT_S:.0f}s"
                ))
                break
        return self._consume(ctx, pending)

    def _absorb(self, ctx, group: List[_PendingFold], skip: _PendingFold):
        """Hand the drained folds' outcomes to the scheduler so their
        still-queued jobs finish in ONE batched pass (the drainer's own
        fold is excluded — its running job returns the result itself).
        Jobs already picked up are left alone; their run consumes the
        memoized outcome, so marking ``harvested`` stays with whichever
        path actually exports the monitor. Only SUCCESS outcomes are
        absorbed: a failed fold's job must run normally so the
        scheduler's retry machinery (and the retry re-arm in run_fold)
        keeps the serial path's semantics."""
        entries = []
        for f in group:
            if (
                f is skip or f.handle is None or f.harvested
                or f.error is not None
            ):
                continue
            entries.append(
                (f.handle, f.result, f.error, f.skey[0], f.monitor,
                 f.signature, ctx.worker_id)
            )
        if entries:
            self.service.scheduler.finish_absorbed(entries)

    def _consume(self, ctx, pending: _PendingFold):
        if not pending.harvested:
            # once per fold, whichever attempt consumes it: the fold-local
            # monitor's costs reach the export plane through THIS job's
            # harvest, attributed to the tenant that submitted the fold
            pending.harvested = True
            ctx.monitor.merge_from(pending.monitor)
        if pending.error is not None:
            raise pending.error
        return pending.result

    # -- claiming ------------------------------------------------------------

    def _claim_group_locked(self, pending: _PendingFold) -> List[_PendingFold]:
        pending.state = _CLAIMED
        self._inflight.add(pending.skey)
        group = [pending]
        if pending.drainable:
            group.extend(self._drain_locked(pending.key, {pending.skey}))
        return group

    def _claim_sweep_locked(self, key: Tuple) -> List[_PendingFold]:
        """One more sweep of the drain loop: whatever accumulated for this
        key while the previous group executed."""
        return self._drain_locked(key, set())

    def _drain_locked(self, key: Tuple, seen_sessions: set) -> List[_PendingFold]:
        group: List[_PendingFold] = []
        q = self._queues.get(key)
        if not q:
            return group
        route = key[0]
        width = (
            max(_FAST_DRAIN_WIDTH, coalesce_max_width())
            if route == "fast"
            else coalesce_max_width()
        )
        keep: List[_PendingFold] = []
        already = len(seen_sessions)  # folds the caller claimed before us
        while q and already + len(group) < width:
            f = q.popleft()
            if f.state != _ENQ:
                continue  # claimed/consumed entries just drop out
            fifo = self._session_fifo.get(f.skey)
            if (
                not f.submitted
                or not f.drainable
                or f.skey in seen_sessions
                or f.skey in self._inflight
                # per-session FIFO across COALESCE KEYS: only the
                # session's oldest outstanding fold may cross-drain (an
                # older fold may sit under a different bucket's key), and
                # never past an outstanding serial-path/deadline'd fold
                # (the barrier)
                or fifo is None
                or not fifo
                or fifo[0] is not f
                or self._serial_barrier.get(f.skey, 0)
            ):
                keep.append(f)  # stays queued for a later drain
                continue
            f.state = _CLAIMED
            self._inflight.add(f.skey)
            seen_sessions.add(f.skey)
            group.append(f)
        for f in reversed(keep):
            q.appendleft(f)
        if not q:
            # a service cycling through many distinct batteries must not
            # grow the key map monotonically on empty deques
            self._queues.pop(key, None)
        return group

    def _complete_locked(
        self, pending: _PendingFold, result=None,
        error: Optional[BaseException] = None,
    ) -> bool:
        """Under ``self._lock``: resolve a fold and release its ordering
        bookkeeping; returns whether this call resolved it (False = it
        was already DONE)."""
        if pending.state == _DONE:
            return False  # a claim-wait failure already resolved it
        pending.result = result
        pending.error = error
        pending.state = _DONE
        self._inflight.discard(pending.skey)
        if pending.drainable:
            self._fifo_remove_locked(pending)
        else:
            n = self._serial_barrier.get(pending.skey, 0) - 1
            if n > 0:
                self._serial_barrier[pending.skey] = n
            else:
                self._serial_barrier.pop(pending.skey, None)
        return True

    def _complete(
        self, pending: _PendingFold, result=None,
        error: Optional[BaseException] = None,
    ) -> None:
        with self._lock:
            self._complete_locked(pending, result=result, error=error)
        pending.event.set()

    def reconcile_orphan(self, ctx, pending: _PendingFold, exc):
        """The fold's job is terminating WITHOUT run_fold having run to
        completion — a worker fault between pickup and the body, an
        infrastructure error, a queued-past-deadline kill. Make the
        fold's COMMIT and its job's FINISH atomic:

        - an UNCLAIMED fold is withdrawn (resolved failed, out of
          queue/fifo/barrier) so no later drain can execute a fold whose
          caller was told it failed — the orphan leak that broke the
          chaos soak's stream_fold_parity (a drain would commit the
          batch on the session's NEXT ingest, after the failure, and out
          of order);
        - a CLAIMED fold waits out the drain that owns it (drains always
          complete their claims) and the job ADOPTS the outcome: a
          committed fold makes the job succeed with the committed
          result.

        Returns None (nothing adopted; fail with the original error) or
        the fold's ``(result, error)`` outcome. Wired as the fold job's
        scheduler ``recover_fn``; a scheduler RETRY re-arms a withdrawn
        fold exactly like any memoized failure (run_fold's attempt>1
        path)."""
        with self._lock:
            if pending.state == _ENQ:
                self._complete_locked(pending, error=exc)
                withdrawn = True
            else:
                withdrawn = False
        if withdrawn:
            pending.event.set()
            return None
        # claimed (or already done): the drain owns the outcome
        deadline = time.monotonic() + self.CLAIM_WAIT_S
        while pending.state != _DONE and time.monotonic() < deadline:
            pending.event.wait(self._DRAIN_RECHECK_S)
        if pending.state != _DONE:
            self._complete(pending, error=RuntimeError(
                f"coalesced launch holding fold for {pending.skey} "
                f"did not complete within {self.CLAIM_WAIT_S:.0f}s"
            ))
        if not pending.harvested:
            pending.harvested = True
            if ctx is not None:
                ctx.monitor.merge_from(pending.monitor)
        return (pending.result, pending.error)

    # -- execution -----------------------------------------------------------

    def _execute_group(self, group: List[_PendingFold]) -> None:
        from ..observability import trace as _trace

        flush_t0 = time.perf_counter()
        try:
            if group[0].route == "fast":
                if len(group) > 1:
                    self._note_width(len(group))
                # ONE span per drain with a per-session child event each
                # (a full span per fold was 4 trace-ring appends per fold
                # — measurable at thousands of folds/s); the singleton
                # case keeps the same shape so traces read uniformly
                with _trace.span(
                    "fast_drain", kind="coalesce", width=len(group)
                ) as sp:
                    for f in group:
                        if f.state == _DONE:
                            continue  # claim-wait backstop resolved it
                        result, error = self._execute_fast(f, sp)
                        if f.state != _DONE:
                            self._complete(f, result=result, error=error)
            else:
                self._execute_device(group)
        except BaseException as exc:
            # backstop: a launch must ALWAYS complete its claims, or jobs
            # waiting on them would hang until the claim-wait deadline
            for f in group:
                if f.state != _DONE:
                    self._complete(f, error=exc)
            raise
        finally:
            for f in group:
                if f.state != _DONE:
                    self._complete(f, error=RuntimeError(
                        "coalesced launch dropped a claimed fold"
                    ))
            flush_s = time.perf_counter() - flush_t0
            metrics = self.service.metrics
            for f in group:
                metrics.observe(
                    "deequ_service_coalesce_flush_seconds", flush_s,
                    tenant=f.skey[0],
                    priority=getattr(
                        f.session.priority, "name", str(f.session.priority)
                    ).lower(),
                )

    def _serial_fallback(self, pending: _PendingFold, data, pending_contract):
        """A guard outcome only the full runner can honor (drift-degraded
        columns): run this fold through `do_verification_run` exactly like
        the serial path, under the session lock already held by the
        caller."""
        from ..verification import VerificationSuite

        session = pending.session
        result = VerificationSuite.do_verification_run(
            data,
            session.checks,
            session.required_analyzers,
            aggregate_with=session.provider,
            save_states_with=session.provider,
            batch_size=pending.bucket,
            monitor=pending.monitor,
            device=self.service.device,
            sharding=self.service.mesh,
        )
        session._commit_fold(result, data, pending_contract, pending.done)
        return result

    @staticmethod
    def _host_finalize(analyzer, delta, provider):
        """`_finalize` on the host: the fast path's states are
        identity-merge transparent, so `states.host_merge` computes the
        merge's bits with no launch on the whole load -> merge -> persist
        -> metric cycle."""
        from ..analyzers.states import host_merge

        try:
            loaded = provider.load(analyzer)
            state = delta if loaded is None else host_merge(loaded, delta)
            provider.persist(analyzer, state)
            return analyzer.compute_metric_from(state)
        except Exception as exc:  # noqa: BLE001 - typed Failure metric
            return analyzer.to_failure_metric(exc)

    def _merge_group(self, prepped, states_list, monitor,
                     held: bool = False) -> List[List[Any]]:
        """Merge a coalesced group's delta states into each session's
        persisted states on the service's device: every scalar state of
        the group in one ``merge_states_batched_many`` call (one
        ``state_fold`` launch, K8; each KLL sketch through K5's merge),
        fetched in one copy per dtype. Each state equals the serial
        path's ``_finalize`` merge bit for bit. A state that will not load
        is returned as its exception (the analyzer's metric fails, as on
        the serial path); a delta with nothing persisted is its own
        cumulative state. ``held``: the caller holds the sessions' serial
        locks."""
        import contextlib

        from ..analyzers.base import merge_states_batched_many
        from ..runners.engine import fetch_states

        out: List[List[Any]] = []
        merges: List[Tuple[int, int, Any, List[Any]]] = []
        for w, ((f, _, _, _), states) in enumerate(zip(prepped, states_list)):
            provider = f.session.provider
            row = list(states)
            with contextlib.nullcontext() if held else f.session._serial:
                for i, a in enumerate(f.plan.battery):
                    try:
                        loaded = provider.load(a)
                    except Exception as exc:  # noqa: BLE001 - the metric fails
                        row[i] = exc
                        continue
                    if loaded is not None:
                        merges.append((w, i, a, [loaded, states[i]]))
            out.append(row)
        if merges:
            with monitor.timed("metric_derivation"):
                merged = fetch_states(merge_states_batched_many(
                    [(a, pair) for _, _, a, pair in merges], self.service.device))
            for (w, i, _, _), state in zip(merges, merged):
                out[w][i] = state
        return out

    def _finalize_states(self, pending: _PendingFold, states) -> Any:
        """Persist one coalesced fold's cumulative states (merged by
        :meth:`_merge_group`) and evaluate the session's checks: the rest
        of the serial path's finalize (persist -> metric)."""
        from ..runners.context import AnalyzerContext
        from ..verification import VerificationSuite

        session = pending.session
        provider = session.provider
        metrics = {}
        with pending.monitor.timed("metric_derivation"):
            for a, state in zip(pending.plan.battery, states):
                try:
                    if isinstance(state, Exception):
                        raise state
                    provider.persist(a, state)
                    metrics[a] = a.compute_metric_from(state)
                except Exception as exc:  # noqa: BLE001 - typed Failure metric
                    metrics[a] = a.to_failure_metric(exc)
        return VerificationSuite.evaluate(session.checks, AnalyzerContext(metrics))

    def _execute_fast(self, pending: _PendingFold, drain_span) -> None:
        from ..analyzers.base import HostBatchContext
        from ..reliability.faults import fault_point
        from ..runners.context import AnalyzerContext
        from ..verification import VerificationSuite

        session = pending.session
        mon = pending.monitor
        provider = session.provider
        try:
            # the SAME pre-mutation chaos site the serial path fires (its
            # contract: a fold fails BEFORE any state mutates), plus the
            # coalesce-specific site the bisection drills key on
            fault_point("stream_fold", tag=_job_tag(pending))
            fault_point("coalesced_fold", tag=f"{pending.skey[0]}/{pending.skey[1]}")
            fast = True
            with session._serial:
                if session._closed:
                    from .errors import SessionClosed

                    raise SessionClosed(*pending.skey)
                data, pending_contract, degraded = session._pre_fold(
                    pending.data
                )
                if degraded:
                    # the guard excluded columns: only the full runner's
                    # per-analyzer degradation can honor this fold
                    fast = False
                    self._serial_fallback(pending, data, pending_contract)
                else:
                    rows = int(data.num_rows)
                    drain_span.add_event(
                        "fast_fold", tenant=pending.skey[0],
                        dataset=pending.skey[1], rows=rows,
                    )
                    # phase times accumulate straight into the fold monitor
                    # (no per-fold phase spans: the drain span above is the
                    # trace-side record; two ring appends per fold saved)
                    t_part = time.perf_counter()
                    batch = self._micro_batch(data, pending)
                    hctx = HostBatchContext(batch, batch_index=0)
                    deltas = []
                    for a in pending.plan.battery:
                        t0 = time.perf_counter()
                        deltas.append(a.host_partial(hctx))
                        self.router.observe_host(
                            type(a), rows, time.perf_counter() - t0
                        )
                    t_fin = time.perf_counter()
                    metrics = {
                        a: self._host_finalize(a, s, provider)
                        for a, s in zip(pending.plan.battery, deltas)
                    }
                    result = VerificationSuite.evaluate(
                        session.checks, AnalyzerContext(metrics)
                    )
                    t_done = time.perf_counter()
                    controller = getattr(self.service, "tuning_controller", None)
                    if controller is not None:
                        # the route's own compute only (observe_host's
                        # span): the finalize/evaluate tail is paid by both
                        # routes and would mask what the experiments compare
                        controller.record(rows, t_fin - t_part, arm=pending.tuning_arm)
                    mon.add_phase_time("host_partials", t_fin - t_part)
                    mon.add_phase_time("metric_derivation", t_done - t_fin)
                    mon.bump("passes")
                    mon.bump("batches")
                    mon.bump("fast_path_folds")
                    session._commit_fold(
                        result, data, pending_contract, pending.done
                    )
            # on_result delivery OUTSIDE the serial lock, exactly like the
            # serial path's _fold_batch -> _notify sequencing
            result = session._notify(pending.done)
            if fast:
                self.service.metrics.inc(
                    "deequ_service_fast_path_folds_total",
                    tenant=pending.skey[0],
                )
            return result, None
        except BaseException as exc:
            if not isinstance(exc, Exception):
                # KeyboardInterrupt-class injections ride out; the group
                # backstop completes every still-claimed fold
                raise
            return None, exc

    @staticmethod
    def _micro_batch(data, pending: _PendingFold):
        """The fold's single unpadded batch, memoized on the (immutable)
        Dataset: a payload broadcast to many sessions materializes its
        columns once instead of once per session."""
        cols = pending.plan.columns
        key = (pending.bucket, None if cols is None else tuple(cols))
        cache = getattr(data, "_micro_batch_cache", None)
        if cache is None:
            cache = data._micro_batch_cache = {}
        batch = cache.get(key)
        if batch is None:
            for batch in data.batches(
                pending.bucket, columns=cols, pad_to_batch_size=False
            ):
                break
            cache[key] = batch
        return batch

    def _fleet_stream_eligible(
        self, plan, rows: int, tenant: Optional[str] = None
    ) -> bool:
        """Would a fold of this battery at this size shard over a fleet
        sub-mesh? (The routing half of :meth:`_fleet_lease`; the lease
        itself happens at drain time.) With ``tenant``, also requires the
        CURRENT packing to grant that tenant a slice of two or more shards:
        a fast-routed fold must not be flipped onto the device route for a
        one-shard slice the drain would never shard."""
        fleet = getattr(self.service, "fleet", None)
        if fleet is None or plan is None or not plan.mesh_ok:
            return False
        from .fleet import fleet_stream_min_rows

        if int(rows) < fleet_stream_min_rows():
            return False
        return tenant is None or fleet.peek(tenant).n_dev >= 2

    def _fleet_lease(self, f: _PendingFold):
        """Acquire the tenant's sub-mesh lease for a fleet-eligible fold,
        or None (no fleet, battery without host partials, delta below the
        sharding floor, or a one-shard slice). The caller must release a
        non-None lease."""
        fleet = getattr(self.service, "fleet", None)
        if fleet is None or not f.plan.mesh_ok:
            return None
        from .fleet import fleet_stream_min_rows

        if int(f.data.num_rows) < fleet_stream_min_rows():
            return None
        lease = fleet.acquire(f.skey[0])
        if lease.n_dev < 2:
            fleet.release(f.skey[0])
            return None
        return lease

    def _execute_device(self, group: List[_PendingFold]) -> None:
        """Guard + stage every fold (features built on the host, per
        session), then launch the group as one stacked fold; bisect on
        launch failure so a fault inside the joint launch quarantines only
        the owning session(s). Fleet-sized folds peel off first: each
        shards over its tenant's sub-mesh (:meth:`_execute_mesh_fold`)
        instead of joining the one-device stack."""
        from ..reliability.faults import fault_point

        prepped = []
        for f in group:
            try:
                if f.state == _DONE:
                    continue  # claim-wait backstop resolved it
                lease = self._fleet_lease(f)
                if lease is not None:
                    fleet = self.service.fleet
                    try:
                        result, error = self._execute_mesh_fold(f, lease)
                    finally:
                        fleet.release(f.skey[0])
                        if f.monitor.shard_losses:
                            # the fold survived through the ladder: make the
                            # NEXT lease pack over the survivors
                            fleet.note_shard_loss()
                    if f.state != _DONE:
                        self._complete(f, result=result, error=error)
                    continue
                degraded = False
                fault_point("stream_fold", tag=_job_tag(f))
                with f.session._serial:
                    if f.session._closed:
                        from .errors import SessionClosed

                        raise SessionClosed(*f.skey)
                    data, pending_contract, degraded = f.session._pre_fold(
                        f.data
                    )
                    if degraded:
                        self._serial_fallback(f, data, pending_contract)
                if degraded:
                    self._complete(f, result=f.session._notify(f.done))
                    continue
                batch = None
                with f.monitor.timed("feature_build"):
                    for batch in data.batches(
                        f.bucket, columns=f.plan.columns
                    ):
                        break
                    feats = f.plan.builder().build(batch)
                prepped.append((f, data, pending_contract, feats))
            except BaseException as exc:
                self._complete(f, error=exc)
                if not isinstance(exc, Exception):
                    raise
        if prepped:
            self._launch_bisect(prepped)

    def _execute_mesh_fold(self, f: _PendingFold, lease):
        """One streaming fold sharded over the tenant's sub-mesh (the
        reference's ``_execute_mesh_fold``, deequ_tpu/service/coalesce.py:
        1239-1375): the micro-batch splits into one row slice per shard,
        each slice's HOST partials fold into that shard's state
        (``sharded_ingest_fold`` under the ``ElasticMeshFold`` ladder, so a
        shard lost mid-fold salvages and re-shards as a batch scan does),
        and the shards merge at THIS drain boundary
        (``collective_merge_states`` inside ``finish()``) into the delta
        that the session's persisted states absorb on the service's device
        (one ``state_fold`` launch, :meth:`_merge_group`). Checks, drift
        and commit are the coalesced path's own. Returns ``(result,
        error)``."""
        import math

        from ..analyzers.base import HostBatchContext
        from ..parallel import ElasticMeshFold
        from ..parallel.dcn import stack_partials
        from ..reliability.faults import fault_point
        from ..runners.engine import fetch_states, wait_kernels

        session = f.session
        mon = f.monitor
        mesh = lease.mesh
        n_dev = lease.n_dev
        sharded = True
        try:
            fault_point("stream_fold", tag=_job_tag(f))
            fault_point("coalesced_fold", tag=f"{f.skey[0]}/{f.skey[1]}")
            with session._serial:
                if session._closed:
                    from .errors import SessionClosed

                    raise SessionClosed(*f.skey)
                data, pending_contract, degraded = session._pre_fold(f.data)
                if degraded:
                    # drift-degraded columns: only the full runner's
                    # per-analyzer degradation can honor this fold
                    sharded = False
                    self._serial_fallback(f, data, pending_contract)
                else:
                    battery = f.plan.battery
                    rows = int(data.num_rows)
                    slice_rows = max(1, math.ceil(rows / n_dev))
                    elastic = ElasticMeshFold(battery, mesh, monitor=mon)

                    def slice_partials(wanted=None):
                        # one FRESH memo token per round: slices of one
                        # round may share per-pass memo work (the HLL
                        # dictionary skip), but a REPLAY round must never
                        # skip an entry whose only contribution died with
                        # the lost shard
                        run_token = object()
                        out = []
                        with mon.timed("host_partials"):
                            for i, batch in enumerate(data.batches(
                                slice_rows, columns=f.plan.columns,
                                pad_to_batch_size=False,
                            )):
                                if wanted is not None and i not in wanted:
                                    continue
                                ctx = HostBatchContext(batch, batch_index=i,
                                                       run_token=run_token)
                                out.append((i, tuple(a.host_partial(ctx) for a in battery)))
                        return out

                    def fold_slices(slices):
                        group = [p for _, p in slices]
                        idx = [i for i, _ in slices]
                        # one slot per shard: the padding repeats a real
                        # partial and its flag skips it
                        group = group + [group[0]] * (n_dev - len(group))
                        flags = np.zeros(n_dev, dtype=bool)
                        flags[: len(idx)] = True
                        with mon.timed("ingest_fold"):
                            elastic.fold(stack_partials(battery, group), flags,
                                         batch_indices=idx)
                            wait_kernels(None if elastic.host_mode else elastic.mesh.home)

                    fold_slices(slice_partials())
                    # the drain-boundary merge: a shard lost mid-fold (or
                    # during the merge itself) queues its slices for
                    # replay: recompute exactly those, re-fold on the
                    # rebuilt mesh and merge again, until a merge leaves
                    # nothing pending
                    while True:
                        while elastic.pending_replay:
                            todo = set(elastic.take_lost_batches())
                            fold_slices(slice_partials(wanted=todo))
                        with mon.timed("ingest_fold"):
                            states = elastic.finish()
                        if not elastic.pending_replay:
                            break
                    with mon.timed("state_fetch"):
                        delta = fetch_states(list(states))
                    merged = self._merge_group([(f, data, pending_contract, None)],
                                               [delta], mon, held=True)[0]
                    result = self._finalize_states(f, merged)
                    mon.bump("passes")
                    mon.bump("batches")
                    mon.bump("device_updates")
                    mon.bump("fleet_mesh_folds")
                    # "mesh", NOT "device": note_ran treats an executed
                    # placement of "device" as warmth of the one-device
                    # program, which this path never launches (it runs host
                    # partials and the mesh's fold and merge entries)
                    mon.placement = "mesh"
                    session._commit_fold(result, data, pending_contract, f.done)
            result = session._notify(f.done)
            if sharded:
                self.service.metrics.inc(
                    "deequ_service_fleet_stream_folds_total",
                    tenant=f.skey[0], devices=str(n_dev),
                )
            return result, None
        except BaseException as exc:
            if not isinstance(exc, Exception):
                raise
            return None, exc

    def _launch_bisect(self, prepped) -> None:
        from ..observability import trace as _trace

        try:
            states_list = self._launch(prepped)
        except Exception as exc:
            if len(prepped) == 1:
                f = prepped[0][0]
                self.service.metrics.inc(
                    "deequ_service_coalesce_quarantined_total",
                    tenant=f.skey[0],
                )
                _trace.add_event(
                    "coalesce_quarantined",
                    tenant=f.skey[0], dataset=f.skey[1],
                    error=f"{type(exc).__name__}: {str(exc)[:200]}",
                )
                self._complete(f, error=exc)
                return
            # the fault could belong to any member: split and re-launch —
            # ≤log2(W) extra launches isolate exactly the faulty fold(s)
            _trace.add_event("coalesce_bisect", width=len(prepped))
            mid = len(prepped) // 2
            self._launch_bisect(prepped[:mid])
            self._launch_bisect(prepped[mid:])
            return
        for (f, data, pending_contract, _), states in zip(
            prepped, states_list
        ):
            try:
                with f.session._serial:
                    result = self._finalize_states(f, states)
                    f.monitor.bump("passes")
                    f.monitor.bump("batches")
                    f.monitor.bump("device_updates")
                    f.monitor.bump("coalesced_folds")
                    f.monitor.placement = "device"
                    f.session._commit_fold(
                        result, data, pending_contract, f.done
                    )
                result = f.session._notify(f.done)
                self._complete(f, result=result)
            except BaseException as exc:
                self._complete(f, error=exc)
                if not isinstance(exc, Exception):
                    raise

    def _launch(self, prepped) -> List[List[Any]]:
        from ..observability import trace as _trace
        from ..reliability.faults import fault_point
        from ..runners.engine import RunMonitor, fold_sessions_coalesced

        width = len(prepped)
        rows = int(prepped[0][1].num_rows)
        with _trace.span(
            "coalesced_launch", kind="coalesce", width=width,
            bucket=prepped[0][0].bucket,
        ) as sp:
            for f, data, _, _ in prepped:
                # chaos site: an injected fault here aborts the joint
                # launch attempt; bisection then quarantines the session
                # the injector's tag match names
                fault_point(
                    "coalesced_fold", tag=f"{f.skey[0]}/{f.skey[1]}"
                )
                sp.add_event(
                    "coalesced_session", tenant=f.skey[0],
                    dataset=f.skey[1], rows=int(data.num_rows),
                )
            t0 = time.perf_counter()
            group = RunMonitor()
            states_list = fold_sessions_coalesced(
                [f.plan.program() for f, _, _, _ in prepped],
                [p[3] for p in prepped], self.service.device, monitor=group,
            )
            elapsed = time.perf_counter() - t0
            # inside the bisected launch: a merge that raises isolates its
            # session as a launch fault does, and nothing has persisted
            states_list = self._merge_group(prepped, states_list, group)
        self.router.observe_device(rows, elapsed, width)
        controller = getattr(self.service, "tuning_controller", None)
        # each fold carries its share of the group's phases
        for f, _, _, _ in prepped:
            for phase, seconds in group.phase_seconds.items():
                f.monitor.add_phase_time(phase, seconds / width)
            f.monitor.device = str(self.service.device)
            if controller is not None:
                controller.record(rows, elapsed / width, arm=f.tuning_arm)
        self._note_width(width, coalesced=True)
        return states_list

    def _note_width(self, width: int, coalesced: bool = False) -> None:
        """Width-histogram accounting for one multi-fold drain (pow2
        bucket counter + sum, the mean amortization factor's numerator)."""
        bucket = 1
        while bucket < width:
            bucket *= 2
        updates = [
            ("deequ_service_coalesce_width_total", 1.0,
             {"width": str(bucket)}),
            ("deequ_service_coalesce_width_sum", float(width), {}),
        ]
        if coalesced:
            updates.append(
                ("deequ_service_coalesced_folds_total", float(width), {})
            )
        self.service.metrics.inc_many(updates)
