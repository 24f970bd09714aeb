"""Fleet watch: the service's standing data-quality observability job
(the JAX package's module, copied: host code over metric histories).

One-shot anomaly checks score one series at a time, on demand. A service
hosting fleets of tenants wants the CONTINUOUS shape instead: every time
the scheduler harvests a finished job — i.e. every time a tenant may have
committed fresh metrics — the fleet watch re-scores every watched
tenant's metric history, batched: all series of one strategy bundle score
through ONE ``detect_batch`` call (every strategy carries one, Holt-Winters
included), with per-series newest-point search intervals so a ragged
fleet's freshest points are the ones judged.

Results land on the export plane as ``deequ_service_anomaly_*`` series
(scored / flagged / quarantined per tenant, scoring wall time), and every
FLAGGED anomaly schedules a flight-recorder dump correlated to the
harvesting job's trace — the 3am operator opens the dump and sees which
tenant, which analyzer, which value, inside the job tree that triggered
the scoring.

Poisoned histories degrade, never spread: a tenant whose repository
quarantined payloads during the load (bit rot, torn writes, or the
injected ``corrupt`` fault kind at the ``repository_load`` site) is
counted quarantined and scored on whatever entries survived; the other
tenants' scores are untouched.

Knobs (shared warn-once parsers):

- ``DEEQU_TPU_FLEETWATCH``: "0" detaches the watch from the scheduler's
  harvests (explicit ``harvest_now()`` still works).
- ``DEEQU_TPU_FLEETWATCH_WINDOW_MONTHS``: history window scored per
  harvest, in month buckets (default 12; 0 = unbounded) — rides the
  partitioned repository's O(queried window) loads.
- ``DEEQU_TPU_FLEETWATCH_BUNDLE``: max series per ``detect_batch`` call
  (default 16384) — one harvest of 10k series is one call.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

from ..observability import trace as _trace
from ..observability.recorder import recorder

FLEETWATCH_ENV = "DEEQU_TPU_FLEETWATCH"
FLEETWATCH_WINDOW_ENV = "DEEQU_TPU_FLEETWATCH_WINDOW_MONTHS"
FLEETWATCH_BUNDLE_ENV = "DEEQU_TPU_FLEETWATCH_BUNDLE"

#: the tenant name the watch's own scheduler jobs run under (never
#: watched, so a harvest of the watch job cannot re-trigger itself)
WATCH_TENANT = "__fleetwatch__"

#: minimum points a series needs before its newest point can be judged
#: against any history at all
_MIN_POINTS = 2


def fleetwatch_enabled() -> bool:
    from ..utils import env_flag

    return env_flag(FLEETWATCH_ENV, True)


def fleetwatch_window_months() -> int:
    from ..utils import env_number

    return env_number(FLEETWATCH_WINDOW_ENV, 12, int, minimum=0)


def fleetwatch_bundle_size() -> int:
    from ..utils import env_number

    return env_number(FLEETWATCH_BUNDLE_ENV, 16384, int, minimum=1)


def window_after_ms(months: int, now_ms: Optional[int] = None) -> Optional[int]:
    """The inclusive ``after`` bound covering the most recent ``months``
    month buckets (None = unbounded): the first millisecond of the month
    ``months - 1`` buckets back, so the current partial month always
    counts as one bucket — the same bucket arithmetic the partitioned
    repository lists by."""
    if months <= 0:
        return None
    from datetime import datetime, timezone

    now = (
        datetime.now(timezone.utc) if now_ms is None
        else datetime.fromtimestamp(now_ms / 1000.0, tz=timezone.utc)
    )
    total = now.year * 12 + (now.month - 1) - (months - 1)
    start = datetime(total // 12, total % 12 + 1, 1, tzinfo=timezone.utc)
    return int(start.timestamp() * 1000)


@dataclass(frozen=True)
class WatchSpec:
    """One tenant's standing watch: which repository holds its committed
    metric history, which analyzers' series to score, with which
    strategy."""

    tenant: str
    dataset: str
    repository: Any
    analyzers: Tuple[Any, ...]
    strategy: Any
    tags: Optional[Tuple[Tuple[str, str], ...]] = None


@dataclass
class HarvestReport:
    """What one fleet-watch scoring pass did."""

    tenants: int = 0
    series_scored: int = 0
    series_skipped: int = 0
    detect_calls: int = 0
    scoring_seconds: float = 0.0
    #: (tenant, dataset, analyzer repr, point index, value, detail)
    flagged: List[Tuple[str, str, str, int, Optional[float], str]] = field(
        default_factory=list
    )
    quarantined_tenants: List[str] = field(default_factory=list)


class FleetWatch:
    """The standing watch. Construct with a ``VerificationService`` (or
    anything exposing ``.scheduler`` and ``.metrics``); register tenants
    with :meth:`watch`; :meth:`attach` hooks scheduler harvests so every
    completed job re-scores the fleet. ``harvest_now()`` scores inline —
    tests, drills and cron-style callers use it directly."""

    def __init__(self, service: Any):
        self._service = service
        self.metrics = service.metrics
        self._lock = threading.Lock()
        self._watches: Dict[Tuple[str, str], WatchSpec] = {}
        self._job_pending = False
        self._attached = False
        #: fingerprints of anomalies already dumped/counted: a STANDING
        #: anomaly (same tenant/analyzer/point/value re-flagged every
        #: harvest) stays in each HarvestReport but exports ONE
        #: flagged-counter bump and ONE flight dump — re-dumping per
        #: harvest would exhaust the recorder's process-wide dump budget
        #: in minutes and suppress genuine failure dumps
        self._seen_flags: set = set()
        #: (tenant, dataset) watches currently inside a STANDING
        #: quarantine episode: the exported quarantined counter and the
        #: typed flight record fire once per episode, not once per
        #: harvest (a corrupt entry re-quarantines on every load until it
        #: heals; the mark clears on the first clean load so a LATER
        #: corruption counts anew)
        self._quarantine_marks: set = set()
        #: cached per-series model fits for strategies exposing
        #: ``fit_batch`` (Holt-Winters): the L-BFGS-B optimization is the
        #: dominant serial cost and its inputs (the training slice) only
        #: change when a tenant commits a new point — re-fitting an
        #: unchanged history every harvest would re-pay it per job
        #: completion. Keyed by (watch, analyzer, training fingerprint);
        #: bounded like _seen_flags.
        self._fit_cache: Dict[Any, Any] = {}
        self.last_report: Optional[HarvestReport] = None
        self.metrics.describe(
            "deequ_service_anomaly_series_scored_total",
            "Metric series (tenant x analyzer) scored by the fleet watch's "
            "batched anomaly pass, per tenant.",
        )
        self.metrics.describe(
            "deequ_service_anomaly_flagged_total",
            "Anomalous newest points the fleet watch flagged, per tenant "
            "(each also schedules a trace-correlated flight dump).",
        )
        self.metrics.describe(
            "deequ_service_anomaly_quarantined_total",
            "Tenants whose metric history quarantined corrupt payloads "
            "during a fleet-watch load (scored on the surviving entries).",
        )
        self.metrics.describe(
            "deequ_service_anomaly_harvests_total",
            "Fleet-watch scoring passes completed.",
        )
        self.metrics.describe(
            "deequ_service_anomaly_scoring_seconds_total",
            "Wall clock spent inside batched detect_batch scoring calls "
            "across fleet-watch harvests.",
        )
        self.metrics.set_gauge_fn(
            "deequ_service_anomaly_watched_series",
            self._watched_series,
            "Metric series (tenant x analyzer) under standing fleet-watch "
            "scoring.",
        )
        from .metrics import SloEvaluator

        #: latency objectives fed from the service histograms; burn rates
        #: surface as deequ_service_slo_burn_rate{slo=...} gauges beside
        #: the anomaly series (the fleet watch IS the alerting plane)
        self.slo = SloEvaluator(self.metrics)
        self.metrics.describe(
            "deequ_service_slo_burn_rate",
            "Error-budget burn rate per latency objective over its "
            "window: (1 - achieved fraction) / (1 - objective), from the "
            "service latency histogram buckets. 1 = burning exactly at "
            "budget; >1 = objective missed if the window persists.",
        )
        self.watch_slo(
            "fold_latency", "deequ_service_fold_latency_seconds",
            threshold_s=2.0, objective=0.99,
        )
        self.watch_slo(
            "admission_wait", "deequ_service_admission_wait_seconds",
            threshold_s=0.5, objective=0.99,
        )

    def _watched_series(self) -> int:
        with self._lock:
            return sum(len(w.analyzers) for w in self._watches.values())

    def watch_slo(
        self,
        slug: str,
        histogram: str,
        threshold_s: float,
        objective: float = 0.99,
        window_s: float = 300.0,
        **labels: str,
    ) -> None:
        """Register a latency objective over ``histogram`` (optionally
        filtered to one tenant/priority via ``labels``) and surface its
        burn rate as a ``deequ_service_slo_burn_rate{slo=...}`` gauge."""
        self.slo.add_objective(
            slug, histogram, threshold_s, objective, window_s, **labels
        )
        self.metrics.set_gauge_fn(
            "deequ_service_slo_burn_rate",
            lambda slug=slug: self.slo.burn_rate(slug),
            None, slo=slug,
        )

    def statusz_section(self) -> Dict[str, Any]:
        """The fleetwatch plane of the /statusz document."""
        with self._lock:
            quarantined = sorted(
                f"{tenant}/{dataset}"
                for tenant, dataset in self._quarantine_marks
            )
            watches = len(self._watches)
        return {
            "quarantined_sessions": quarantined,
            "watched_series": self._watched_series(),
            "watches": watches,
            "slo_burn_rates": self.slo.burn_rates(),
        }

    # -- registration --------------------------------------------------------

    def watch(
        self,
        tenant: str,
        repository: Any,
        analyzers: Sequence[Any],
        strategy: Any = None,
        dataset: str = "default",
        tags: Optional[Dict[str, str]] = None,
    ) -> WatchSpec:
        """Register (or replace) the standing watch for ``(tenant,
        dataset)``. ``strategy`` defaults to a 3-sigma
        ``OnlineNormalStrategy`` — the reference's continuous-monitoring
        default."""
        if strategy is None:
            from ..anomalydetection import OnlineNormalStrategy

            strategy = OnlineNormalStrategy()
        spec = WatchSpec(
            tenant=str(tenant),
            dataset=str(dataset),
            repository=repository,
            analyzers=tuple(analyzers),
            strategy=strategy,
            tags=tuple(sorted(tags.items())) if tags else None,
        )
        with self._lock:
            if (spec.tenant, spec.dataset) in self._watches:
                # re-registration replaces the watch wholesale: drop the
                # old strategy's cached fits too
                self._drop_watch_state_locked(spec.tenant, spec.dataset)
            self._watches[(spec.tenant, spec.dataset)] = spec
        return spec

    def unwatch(self, tenant: str, dataset: str = "default") -> bool:
        with self._lock:
            self._drop_watch_state_locked(str(tenant), str(dataset))
            return self._watches.pop((str(tenant), str(dataset)), None) is not None

    def _drop_watch_state_locked(self, tenant: str, dataset: str) -> None:
        """Purge a watch's cached fits and episode marks (callers hold
        the lock): a dead or re-registered watch must not retain fits its
        replacement could alias, nor an open quarantine episode."""
        self._fit_cache = {
            k: v for k, v in self._fit_cache.items()
            if not (k[0] == tenant and k[1] == dataset)
        }
        self._quarantine_marks.discard((tenant, dataset))

    # -- scheduler coupling --------------------------------------------------

    def attach(self) -> None:
        """Hook scheduler harvests: every completed job belonging to a
        WATCHED tenant marks the fleet dirty and (if none is pending)
        schedules one standing scoring job. Idempotent; a no-op when
        ``DEEQU_TPU_FLEETWATCH=0``."""
        if not fleetwatch_enabled():
            return
        with self._lock:
            if self._attached:
                return
            self._attached = True
        self._service.scheduler.add_harvest_listener(self._on_harvest)

    def _on_harvest(self, tenant: str) -> None:
        with self._lock:
            if not any(t == tenant for t, _ in self._watches):
                return
            # debounce to ONE in-flight scoring job; a harvest arriving
            # while one runs schedules the next pass the moment
            # _job_pending clears (the pass scores the WHOLE fleet — the
            # standing-watch contract — so there is no per-tenant backlog
            # to track)
            if self._job_pending:
                return
            self._job_pending = True
        try:
            self._service.scheduler.submit(
                self._run_harvest_job,
                tenant=WATCH_TENANT,
                priority=_low_priority(),
                max_retries=0,
                serial_key=WATCH_TENANT,
                job_id=f"fleetwatch-{int(time.time() * 1000)}",
                # liveness: if the job terminates WITHOUT its body running
                # (an injected worker fault between pickup and fn, a
                # raising router) the pending flag must still clear, or
                # the standing watch would be dead until process restart
                recover_fn=self._recover_harvest_job,
            )
        except Exception:  # noqa: BLE001 - a full queue (or shutdown)
            # must not take the triggering job's harvest down with it; the
            # next harvest re-schedules
            with self._lock:
                self._job_pending = False

    def _recover_harvest_job(self, ctx, exc):
        with self._lock:
            self._job_pending = False
        return None  # nothing to adopt; the job fails normally

    def _run_harvest_job(self, ctx) -> HarvestReport:
        with self._lock:
            self._job_pending = False
        return self.harvest_now()

    # -- scoring -------------------------------------------------------------

    def harvest_now(self) -> HarvestReport:
        """Score every watched tenant's windowed metric history NOW: one
        padded series tensor and ONE ``detect_batch`` call per strategy
        bundle (chunked only past ``DEEQU_TPU_FLEETWATCH_BUNDLE``
        series), newest point judged per series. Returns the
        :class:`HarvestReport`; counters land on the export plane and
        every flagged anomaly schedules a flight dump on the current
        trace (the harvesting job's, when scheduled)."""
        report = HarvestReport()
        with self._lock:
            watches = list(self._watches.values())
        after_ms = window_after_ms(fleetwatch_window_months())
        with _trace.span(
            "fleetwatch:harvest", kind="fleetwatch", watches=len(watches)
        ) as sp:
            # 1. gather: every watched (tenant, analyzer) series, with its
            # ragged newest-point interval
            series_values: List[List[float]] = []
            #: (spec, analyzer, point timestamps) per assembled series
            series_meta: List[Tuple[WatchSpec, Any, list]] = []
            bundles: Dict[Any, List[int]] = {}
            quarantined: set = set()
            for spec in watches:
                # attribution is PER REPOSITORY INSTANCE: a concurrent
                # quarantine elsewhere in the process (another tenant's
                # store, a partition-state blob) must never read as THIS
                # tenant's history rotting
                before = getattr(spec.repository, "quarantines", 0)
                try:
                    histories = self._load_history(spec, after_ms)
                except Exception as exc:  # noqa: BLE001 - one tenant's
                    # unreadable history must not starve the fleet: count
                    # it quarantined-typed and keep scoring the others
                    self._quarantine_tenant(spec, exc, report, quarantined)
                    continue
                if getattr(spec.repository, "quarantines", 0) > before:
                    from ..exceptions import CorruptStateError

                    self._quarantine_tenant(
                        spec,
                        CorruptStateError(
                            "metrics history", repr(spec.repository),
                            "payloads quarantined during fleet-watch load",
                        ),
                        report, quarantined,
                    )
                else:
                    # a clean load closes any standing quarantine
                    # episode: the NEXT corruption counts/dumps anew
                    with self._lock:
                        self._quarantine_marks.discard(
                            (spec.tenant, spec.dataset)
                        )
                for analyzer, values, times in histories:
                    if len(values) < _MIN_POINTS:
                        report.series_skipped += 1
                        continue
                    # Holt-Winters' two-full-cycles rule, applied BEFORE
                    # bundling: one too-young tenant must not degrade its
                    # whole bundle to per-series calls (the _detect
                    # fallback) every harvest
                    m = getattr(spec.strategy, "series_periodicity", None)
                    if m is not None and len(values) - 1 < 2 * m:
                        report.series_skipped += 1
                        continue
                    bundles.setdefault(spec.strategy, []).append(
                        len(series_values)
                    )
                    series_values.append(values)
                    series_meta.append((spec, analyzer, times))
            # 2. score: ONE batched call per strategy bundle (chunked only
            # past the bundle-size cap)
            bundle_cap = fleetwatch_bundle_size()
            flagged_updates: List[Tuple[str, float, Dict[str, str]]] = []
            scored_by_tenant: Dict[str, int] = {}
            for strategy, indices in bundles.items():
                for lo in range(0, len(indices), bundle_cap):
                    chunk = indices[lo:lo + bundle_cap]
                    values = [series_values[i] for i in chunk]
                    intervals = [(len(v) - 1, len(v)) for v in values]
                    params = self._cached_fits(
                        strategy, chunk, values, intervals, series_meta
                    )
                    t0 = time.perf_counter()
                    results, calls = self._detect(
                        strategy, values, intervals, params
                    )
                    report.scoring_seconds += time.perf_counter() - t0
                    report.detect_calls += calls
                    for local, rows in enumerate(results):
                        spec, analyzer, times = series_meta[chunk[local]]
                        if rows is None:
                            report.series_skipped += 1
                            continue
                        scored_by_tenant[spec.tenant] = (
                            scored_by_tenant.get(spec.tenant, 0) + 1
                        )
                        for index, anomaly in rows:
                            detail = (
                                f"tenant={spec.tenant} dataset={spec.dataset} "
                                f"analyzer={analyzer!r} point={index} "
                                f"value={anomaly.value}: "
                                f"{anomaly.detail or 'anomalous'}"
                            )
                            report.flagged.append((
                                spec.tenant, spec.dataset, repr(analyzer),
                                int(index), anomaly.value, detail,
                            ))
                            # a STANDING anomaly re-flags in every
                            # report, but exports/dumps once — re-dumping
                            # the same point per harvest would drain the
                            # recorder's process-wide dump budget and
                            # inflate the counter by harvest rate
                            # keyed by the point's TIMESTAMP (not its
                            # window-relative index): a NEW incident at a
                            # later date must count and dump even when
                            # the windowed history has the same length
                            fp = (
                                spec.tenant, spec.dataset, repr(analyzer),
                                times[int(index)], anomaly.value,
                            )
                            with self._lock:
                                if fp in self._seen_flags:
                                    continue
                                if len(self._seen_flags) >= 65536:
                                    # bounded memory beats a leak; a
                                    # clear at worst re-dumps standing
                                    # anomalies once
                                    self._seen_flags.clear()
                                self._seen_flags.add(fp)
                            flagged_updates.append((
                                "deequ_service_anomaly_flagged_total", 1.0,
                                {"tenant": spec.tenant},
                            ))
                            _trace.add_event(
                                "anomaly_flagged", span=sp,
                                tenant=spec.tenant, dataset=spec.dataset,
                                analyzer=repr(analyzer), index=int(index),
                                value=anomaly.value,
                            )
                            # the trace-correlated flight dump: released
                            # the moment the harvesting job's span (or
                            # this root) closes
                            recorder().note_failure(
                                "AnomalyFlagged",
                                getattr(sp, "trace_id", None), detail,
                            )
            report.tenants = len({w.tenant for w in watches})
            report.series_scored = sum(scored_by_tenant.values())
            updates = flagged_updates + [
                ("deequ_service_anomaly_series_scored_total", float(n),
                 {"tenant": tenant})
                for tenant, n in scored_by_tenant.items()
            ]
            updates.append(
                ("deequ_service_anomaly_harvests_total", 1.0, {})
            )
            updates.append((
                "deequ_service_anomaly_scoring_seconds_total",
                report.scoring_seconds, {},
            ))
            self.metrics.inc_many(updates)
            sp.set_attr("series_scored", report.series_scored)
            sp.set_attr("flagged", len(report.flagged))
        self.last_report = report
        return report

    def _cached_fits(self, strategy, chunk, values, intervals, series_meta):
        """Per-series model parameters for a fit-bearing strategy
        (``fit_batch`` — Holt-Winters), re-fitting ONLY the series whose
        training slice changed since the last harvest; None for
        strategies with no fit step. Parameters are bit-identical to an
        uncached run (the cache stores what the same optimizer call
        returned for the same training input)."""
        if not hasattr(strategy, "fit_batch"):
            return None
        keys = []
        for local, i in enumerate(chunk):
            spec, analyzer, _times = series_meta[i]
            start = intervals[local][0]
            training = tuple(values[local][:start])
            # keyed by the strategy's VALUE (type + periodicity, its
            # only fit-relevant hyperparameter), never its id() — a
            # recycled object address must not serve parameters fitted
            # under a different model
            keys.append((
                spec.tenant, spec.dataset, repr(analyzer),
                type(strategy).__name__,
                getattr(strategy, "series_periodicity", None),
                start, hash(training),
            ))
        with self._lock:
            params = [self._fit_cache.get(k) for k in keys]
        missing = [j for j, p in enumerate(params) if p is None]
        if missing:
            try:
                fitted = strategy.fit_batch(
                    [values[j] for j in missing],
                    [intervals[j] for j in missing],
                )
            except ValueError:
                return None  # _detect's per-series fallback handles it
            with self._lock:
                if len(self._fit_cache) >= 65536:
                    self._fit_cache.clear()  # bounded beats a leak
                for j, p in zip(missing, fitted):
                    params[j] = p
                    self._fit_cache[keys[j]] = p
        return params

    @staticmethod
    def _detect(strategy, values, intervals, params=None):
        """One batched call, returning ``(per-series rows, calls made)``.
        A ValueError from a mixed-validity fleet (a validation the gather
        pre-filters missed) degrades — with a warning, and honestly
        counted — to per-series calls so ONE unscorable series costs
        itself, not its bundle; unscorable series report None rows."""
        kw = {} if params is None else {"params": params}
        try:
            return strategy.detect_batch(values, intervals, **kw), 1
        except ValueError:
            import logging

            logging.getLogger(__name__).warning(
                "fleet-watch bundle of %d series degraded to per-series "
                "scoring (one series failed %s validation)",
                len(values), type(strategy).__name__, exc_info=True,
            )
            out = []
            for j, (v, iv) in enumerate(zip(values, intervals)):
                try:
                    pkw = (
                        {} if params is None else {"params": [params[j]]}
                    )
                    out.append(strategy.detect_batch([v], [iv], **pkw)[0])
                except ValueError:
                    out.append(None)
            return out, len(values)

    def _load_history(self, spec: WatchSpec, after_ms: Optional[int]):
        """[(analyzer, [values...]), ...] for one tenant, loading ONLY the
        scoring window (the partitioned repository walks just those month
        buckets) and extracting each analyzer's numeric series in time
        order, missing values dropped — the `HistoryUtils` contract."""
        from ..anomalydetection.wiring import extract_metric_values

        loader = spec.repository.load().for_analyzers(list(spec.analyzers))
        if spec.tags:
            loader = loader.with_tag_values(dict(spec.tags))
        if after_ms is not None:
            loader = loader.after(after_ms)
        results = loader.get()
        out = []
        for analyzer in spec.analyzers:
            points = extract_metric_values(results, analyzer)
            points = sorted(
                (p for p in points if p.metric_value is not None),
                key=lambda p: p.time,
            )
            out.append((
                analyzer,
                [p.metric_value for p in points],
                [p.time for p in points],
            ))
        return out

    def _quarantine_tenant(
        self, spec: WatchSpec, exc: BaseException, report: HarvestReport,
        quarantined: set,
    ) -> None:
        if spec.tenant in quarantined:
            return
        quarantined.add(spec.tenant)
        report.quarantined_tenants.append(spec.tenant)
        # the export counter and the typed flight record fire once per
        # STANDING episode (a corrupt entry re-quarantines on every load
        # until it heals; counting per harvest would inflate by harvest
        # rate); the report lists the tenant every harvest regardless
        with self._lock:
            mark = (spec.tenant, spec.dataset)
            new_episode = mark not in self._quarantine_marks
            self._quarantine_marks.add(mark)
        if not new_episode:
            return
        self.metrics.inc(
            "deequ_service_anomaly_quarantined_total", tenant=spec.tenant
        )
        _trace.add_event(
            "fleetwatch_history_quarantined", tenant=spec.tenant,
            dataset=spec.dataset, error=f"{type(exc).__name__}: {exc}",
        )
        from ..observability.recorder import record_failure

        record_failure(exc)


def _low_priority():
    from .scheduler import Priority

    return Priority.LOW
