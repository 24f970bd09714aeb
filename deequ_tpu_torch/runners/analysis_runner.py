"""AnalysisRunner: the scheduler.

Reference flow (`analyzers/runners/AnalysisRunner.scala:97-203`): dedupe
-> precondition partition -> split {scanning, grouping} -> one fused pass
-> assemble AnalyzerContext.

This port routes every analyzer of the package, all in ONE pass: the
scan-shareable reductions, DataType, HLL and the KLL sketches on the
device; histograms over dictionary-encoded columns on the device frequency
scan; and each grouping set (Uniqueness, Distinctness, UniqueValueRatio,
CountDistinct, Entropy, MutualInformation over one or several columns) on
one of three routes, as the reference package routes them
(deequ_tpu/runners/analysis_runner.py:186-460):

1. one dictionary-encoded column of at most ``device_freq_max_cardinality``
   entries (a knob, 2^16 by default): the device frequency scan (kernel
   ``dict_code_counts``);
2. a set the cardinality probe finds small, a set with a member that reads
   the table's keys (MutualInformation), or any set with
   ``device_freq=False``: the host group-by, folded batch by batch in the
   same pass;
3. any other set: the device frequency table (kernels ``freq_keys`` and
   ``freq_compact``), sized by ``freq_table_slots`` and
   ``freq_buffer_entries`` (knobs too). A table that dropped groups re-runs
   its set through the host group-by in one more pass
   (``freq_overflow_fallbacks``).

The host accumulators fold their batches in the same pass too: the exact
quantile mode (``relative_error=0.0``, a full sort of the column's values)
and every histogram the device frequency scan cannot take (a column that
is not dictionary-encoded, a ``binning_func``; the reference also sends a
dictionary over 2^16 entries to the host, which kernel
``dict_code_counts`` counts here). An accumulator that raises fails its
own metrics and no other. A host frequency table over the
``DEEQU_TPU_MAX_FREQUENCY_ENTRIES`` budget spills to disk; a run that saves
no states removes the spill files once the metrics are derived.

With ``aggregate_with`` or ``save_states_with``, route 3 is off, as in the
reference: a persisted or merged grouping state must be a value-keyed
:class:`FrequenciesAndNumRows`, which hashed device tables never give.

``placement`` picks the pass's ingest tier (``"device"``, ``"host"`` or
``"auto"``, see ``engine.resolve_scan_placement``). A pass on the host tier
gets no device frequency table either: its grouping sets go to the host
group-by, as in the reference (deequ_tpu/runners/analysis_runner.py:
602-626), since streaming raw keys is what the host tier avoids. A battery
with any analyzer without a host partial streams to the device whatever
the placement.

Incremental runs (reference `AnalysisRunner.scala:97-223, 385-460`):
``aggregate_with`` merges each analyzer's loaded state into the run's before
its metric, ``save_states_with`` persists the (merged) states, a metrics
repository can serve results for a key instead of computing them
(``reuse_existing_results_for_key``) and keeps the run's results
(``save_or_append_results_with_key``), and :meth:`AnalysisRunner.
run_on_aggregated_states` computes metrics from merged persisted states with
no data pass. Merges run on the run's device (``merge_states_batched``:
kernel ``state_fold`` for the scalar states, ``kll_compact`` for sketches).

An object that is not an analyzer of this package raises
``NotImplementedError`` naming it.
"""

from __future__ import annotations

import logging
from typing import Any, Dict, List, Optional, Sequence, Tuple

from ..analyzers.base import (
    Analyzer,
    Preconditions,
    ScanShareableAnalyzer,
    merge_states_batched,
    merge_states_batched_many,
)
from ..analyzers.state_provider import StateLoader, StatePersister  # noqa: F401
from ..analyzers.grouping import (
    DeviceFrequencyScan,
    DeviceFrequencyTableScan,
    FrequenciesAndNumRows,
    GroupingAnalyzer,
    Histogram,
    ScanShareableFrequencyBasedAnalyzer,
    device_counts_to_histogram_frequencies,
    device_freq_enabled,
    plan_table_scan,
    probably_low_cardinality,
)
from ..config import (
    DeviceLike,
    resolve_device,
    synchronize,
    x64_enabled,
)
from ..data import Dataset, Schema
from ..exceptions import MetricCalculationException
from ..kernels.build import KernelError
from ..metrics import Metric
from ..observability import trace as _trace
from ..tuning import knobs
from .context import AnalyzerContext
from .engine import (
    FEED_BANDWIDTH_THRESHOLD_MBPS,
    PLACEMENTS,
    RunMonitor,
    ScanEngine,
    default_placement,
    effective_batch_size,
    probe_feed_bandwidth,
    resolve_scan_placement,
)

def collect_required_analyzers(checks, required_analyzers=()) -> List[Analyzer]:
    """Every analyzer a verification run needs: the explicitly required
    ones plus each check's, in first-encounter order."""
    analyzers: List[Analyzer] = list(required_analyzers)
    for check in checks:
        analyzers.extend(check.required_analyzers())
    return analyzers


def _not_in_slice(analyzer: Any, why: str) -> NotImplementedError:
    return NotImplementedError(
        f"{analyzer!r} is not supported by deequ_tpu_torch yet: {why}"
    )


class AnalysisRunner:
    """Static entry points (reference `AnalysisRunner.onData/run`)."""

    @staticmethod
    def on_data(data: Dataset, device: DeviceLike = None) -> "AnalysisRunBuilder":
        from .builder import AnalysisRunBuilder

        return AnalysisRunBuilder(data, device=device)

    @staticmethod
    def do_analysis_run(
        data: Dataset,
        analyzers: Sequence[Analyzer],
        *,
        batch_size: Optional[int] = None,
        monitor: Optional[RunMonitor] = None,
        device: DeviceLike = None,
        freq_table_slots: Optional[int] = None,
        freq_buffer_entries: Optional[int] = None,
        device_freq: Optional[bool] = None,
        aggregate_with: Optional[Any] = None,
        save_states_with: Optional[Any] = None,
        metrics_repository: Optional[Any] = None,
        reuse_existing_results_for_key: Optional[Any] = None,
        fail_if_results_missing: bool = False,
        save_or_append_results_with_key: Optional[Any] = None,
        placement: Optional[str] = None,
        sharding: Optional[Any] = None,
        checkpointer: Optional[Any] = None,
    ) -> AnalyzerContext:
        """Compute every analyzer's metric in one pass over ``data``.
        ``freq_table_slots`` and ``freq_buffer_entries`` size the device
        frequency tables (None: their knobs, ``tuning/knobs.py``);
        ``device_freq=False`` sends every grouping set that is not a small
        dictionary column to the host group-by (None:
        ``DEEQU_TPU_DEVICE_FREQ``). ``aggregate_with`` (a StateLoader),
        ``save_states_with`` (a StatePersister), ``metrics_repository``
        with ``reuse_existing_results_for_key`` / ``fail_if_results_missing``
        and ``save_or_append_results_with_key``: as the reference's runner
        (module docstring). ``placement``: the ingest tier, ``"auto"`` when
        None (module docstring). ``sharding``: a
        :class:`~deequ_tpu_torch.parallel.Mesh` to shard the pass's rows
        over (either tier; the batch size rounds up to
        ``mesh_batch_quantum``); the run then lies on the mesh's first
        device, and ``device``, when given, must be of its type.
        ``checkpointer`` (a
        :class:`~deequ_tpu_torch.reliability.IngestCheckpointer`) makes the
        pass resumable (``ScanEngine.run``): a run interrupted mid-pass and
        called again with a checkpointer over the same provider restarts
        from its last checkpoint, with the metrics of an uninterrupted run.
        A battery with a host-exclusive analyzer (the exact quantile mode,
        whose states do not persist) runs without checkpoints, with a
        warning; a device frequency table's re-run pass never checkpoints.

        Every pass of the run (the primary pass, a battery bisection's
        re-passes, a tier failover's host pass) nests under one
        ``analysis_run`` span, so a degraded run reads as one trace."""
        dev = _run_device(device, sharding)
        if placement is not None and placement not in PLACEMENTS:
            raise ValueError(f"placement must be one of {PLACEMENTS}, got {placement!r}")
        if len(analyzers) == 0:
            return AnalyzerContext.empty()
        with _trace.span("analysis_run", kind="analysis", analyzers=len(analyzers)):
            return AnalysisRunner._do_analysis_run(
                data, analyzers, dev, batch_size=batch_size, monitor=monitor,
                freq_table_slots=freq_table_slots, freq_buffer_entries=freq_buffer_entries,
                device_freq=device_freq, aggregate_with=aggregate_with,
                save_states_with=save_states_with, metrics_repository=metrics_repository,
                reuse_existing_results_for_key=reuse_existing_results_for_key,
                fail_if_results_missing=fail_if_results_missing,
                save_or_append_results_with_key=save_or_append_results_with_key,
                placement=placement, sharding=sharding, checkpointer=checkpointer)

    @staticmethod
    def _do_analysis_run(
        data: Dataset,
        analyzers: Sequence[Analyzer],
        dev: Any,
        *,
        batch_size: Optional[int],
        monitor: Optional[RunMonitor],
        freq_table_slots: Optional[int],
        freq_buffer_entries: Optional[int],
        device_freq: Optional[bool],
        aggregate_with: Optional[Any],
        save_states_with: Optional[Any],
        metrics_repository: Optional[Any],
        reuse_existing_results_for_key: Optional[Any],
        fail_if_results_missing: bool,
        save_or_append_results_with_key: Optional[Any],
        placement: Optional[str],
        sharding: Optional[Any],
        checkpointer: Optional[Any],
    ) -> AnalyzerContext:
        """The body of :meth:`do_analysis_run` on the run's device ``dev``,
        inside its ``analysis_run`` span."""
        # dedupe identical analyzers, preserving order
        unique: List[Analyzer] = list(dict.fromkeys(analyzers))

        # reuse existing results from the repository
        # (reference `AnalysisRunner.scala:115-134`)
        results_loaded = AnalyzerContext.empty()
        analyzers_to_run = unique
        if metrics_repository is not None and reuse_existing_results_for_key is not None:
            existing = metrics_repository.load_by_key(reuse_existing_results_for_key)
            if existing is not None:
                wanted = set(unique)
                loaded = {a: m for a, m in existing.metric_map.items() if a in wanted}
                results_loaded = AnalyzerContext(loaded)
                analyzers_to_run = [a for a in unique if a not in loaded]
            if fail_if_results_missing and analyzers_to_run:
                raise MetricCalculationException(
                    "Could not find all necessary results in the MetricsRepository, "
                    f"the calculation of the metrics for these analyzers would be needed: "
                    f"{', '.join(str(a) for a in analyzers_to_run)}"
                )

        # precondition partition (reference `AnalysisRunner.scala:137-145`)
        schema = data.schema
        passed: List[Analyzer] = []
        failures: Dict[Analyzer, Metric] = {}
        for a in analyzers_to_run:
            if not isinstance(a, Analyzer):
                raise _not_in_slice(a, "it is not an analyzer of this package")
            exc = Preconditions.find_first_failing(schema, a.preconditions())
            if exc is None:
                passed.append(a)
            else:
                failures[a] = a.to_failure_metric(exc)
        if checkpointer is not None and any(getattr(a, "host_exclusive", False)
                                            for a in passed):
            logging.getLogger(__name__).warning(
                "ingest checkpointing is not supported with host-exclusive analyzers (the "
                "exact quantile mode, whose raw-value states are not persistable); running "
                "without checkpoints")
            checkpointer = None

        # validate each analyzer's features on a synthetic 1-row batch so a
        # bad predicate/regex fails only that analyzer, not the shared scan
        from .features import FeatureBuilder, dry_run_batch

        dry = dry_run_batch(schema)
        scanning: List[ScanShareableAnalyzer] = []
        grouping_sets: Dict[Tuple[str, ...], List[GroupingAnalyzer]] = {}
        histograms: List[Histogram] = []
        host_accum: List[Analyzer] = []
        for a in passed:
            if getattr(a, "host_exclusive", False):
                # the exact quantile mode: a host full sort, no device fold
                host_accum.append(a)
            elif isinstance(a, ScanShareableAnalyzer):
                try:
                    FeatureBuilder(a.feature_specs()).build(dry)
                except Exception as exc:  # noqa: BLE001
                    failures[a] = a.to_failure_metric(exc)
                    continue
                scanning.append(a)
            elif isinstance(a, GroupingAnalyzer):
                grouping_sets.setdefault(tuple(a.grouping_columns()), []).append(a)
            elif isinstance(a, Histogram):
                # kernel dict_code_counts counts a dictionary of any size
                # (past 2^16 codes in device memory), so only a plain column
                # or a binning function takes the host
                if a.binning_func is None and data.dictionary_size(a.column) is not None:
                    histograms.append(a)
                else:
                    host_accum.append(a)
            else:
                raise _not_in_slice(a, "no execution strategy in this package")

        # the frequency engine's knobs: explicit arguments win, None reads
        # the registry (env override > tuned > static) and the switch
        if freq_table_slots is None:
            freq_table_slots = knobs.value("freq_table_slots")
        if freq_buffer_entries is None:
            freq_buffer_entries = knobs.value("freq_buffer_entries")
        if device_freq is None:
            device_freq = device_freq_enabled()
        dict_card_limit = knobs.value("device_freq_max_cardinality")

        # route 1: the device frequency scan, for grouping sets of one small
        # dictionary column and for every histogram's column
        dict_sets = set()
        for cols in grouping_sets:
            size = data.dictionary_size(cols[0]) if len(cols) == 1 else None
            if size is not None and size <= dict_card_limit:
                dict_sets.add(cols)
        freq_cols = dict_sets | {(a.column,) for a in histograms}
        dictionaries = {cols: data.dictionary_values(cols[0]) for cols in freq_cols}
        freq_scans = {
            cols: DeviceFrequencyScan(cols[0], len(dictionaries[cols])) for cols in freq_cols
        }
        # route 3: the device frequency table; route 2: the host group-by.
        # Merged or persisted grouping states must be value-keyed, so a run
        # that aggregates or saves states keeps route 3 off, and so does the
        # 32-bit accumulator mode (the table's keys are uint64; the
        # reference's gate on jax_enable_x64)
        slim = aggregate_with is None and save_states_with is None
        batch_rows = effective_batch_size(batch_size, sharding)
        table_scans: Dict[Tuple[str, ...], DeviceFrequencyTableScan] = {}
        host_sets: List[Tuple[str, ...]] = []
        tables_ok = (slim and checkpointer is None and device_freq and x64_enabled()
                     and any(c not in dict_sets for c in grouping_sets)
                     and _device_tier_expected(scanning, placement, dev))
        for cols, members in grouping_sets.items():
            if cols in dict_sets:
                continue
            scan = None
            # a member that reads the table's keys (MutualInformation) needs
            # the value-keyed host table, never a hashed one
            counts_only = all(isinstance(a, ScanShareableFrequencyBasedAnalyzer)
                              for a in members)
            if tables_ok and counts_only and not probably_low_cardinality(data, cols):
                scan = plan_table_scan(schema, cols, data.num_rows, batch_rows,
                                       freq_table_slots, freq_buffer_entries,
                                       sharded=sharding is not None)
            if scan is None:
                host_sets.append(cols)
            else:
                table_scans[cols] = scan

        battery = scanning + list(freq_scans.values()) + list(table_scans.values())
        run_monitor = monitor if monitor is not None else RunMonitor()
        run_monitor.bump("device_freq_sets", len(table_scans))
        metrics: Dict[Analyzer, Metric] = {}
        if not battery and not host_sets and not host_accum:
            return _results(results_loaded + AnalyzerContext(failures), metrics_repository,
                            save_or_append_results_with_key)
        outcome = _run_pass(data, battery, host_sets, batch_size, dev, run_monitor, placement,
                            sharding, host_accum, checkpointer)
        shared: Dict[Any, Any] = dict(outcome.host_states)
        host_errors: Dict[Any, BaseException] = dict(outcome.host_errors)

        # drain the device frequency tables. A set whose table dropped
        # groups, or whose scan degraded, re-runs through the host group-by
        # in one more pass
        fallback: List[Tuple[str, ...]] = []
        losses: List[str] = []
        with run_monitor.timed("drain"):
            for cols, scan in table_scans.items():
                state = outcome.states.get(scan)
                drained = None if state is None else scan.drain(state)
                if drained is not None:
                    shared[cols] = drained
                    continue
                fallback.append(cols)
                if state is not None:
                    run_monitor.bump("freq_overflow_fallbacks")
                    losses.append(f"{cols}: ~{int(state.lost_groups)} groups / "
                                  f"{int(state.lost_rows)} rows dropped")
                else:
                    losses.append(f"{cols}: pass degraded")
        if fallback:
            logging.getLogger(__name__).warning(
                "device frequency table overflowed (or degraded) for grouping sets [%s]; "
                "re-running them through the host group-by", "; ".join(losses),
            )
            refold = _run_pass(data, [], fallback, batch_size, dev, run_monitor,
                               sharding=sharding)
            shared.update(refold.host_states)
            host_errors.update(refold.host_errors)
        for cols in fallback:
            if cols not in shared and cols not in host_errors:
                host_errors[cols] = outcome.errors[table_scans[cols]]

        # load old state -> merge -> persist -> metric (reference
        # `Analyzer.calculateMetric`, `Analyzer.scala:107-128`)
        def finalize(a: Analyzer, state: Any) -> Metric:
            return _finalize(a, state, aggregate_with, save_states_with, dev)

        with run_monitor.timed("metric_derivation"):
            for a in scanning:
                if a in outcome.states:
                    metrics[a] = finalize(a, outcome.states[a])
                else:
                    metrics[a] = a.to_failure_metric(outcome.errors[a])
            for cols in dict_sets:
                scan = freq_scans[cols]
                if scan in outcome.states:
                    shared[cols] = scan.to_frequencies(outcome.states[scan], dictionaries[cols])
                else:
                    host_errors[cols] = outcome.errors[scan]
            for cols, members in grouping_sets.items():
                for a in members:
                    if cols in host_errors:
                        metrics[a] = a.to_failure_metric(host_errors[cols])
                    else:
                        metrics[a] = finalize(a, shared[cols])
            for a in histograms:
                scan = freq_scans[(a.column,)]
                if scan not in outcome.states:
                    metrics[a] = a.to_failure_metric(outcome.errors[scan])
                    continue
                hist = device_counts_to_histogram_frequencies(
                    scan, outcome.states[scan], dictionaries[(a.column,)]
                )
                metrics[a] = finalize(a, hist)
            for a in host_accum:
                if a in host_errors:
                    metrics[a] = a.to_failure_metric(host_errors[a])
                else:
                    metrics[a] = finalize(a, shared[a])
        if slim:
            # the pass's host tables are dead once their metrics are
            # derived: remove any spill directory now (a run that persisted
            # or merged states may have handed the table on)
            for state in shared.values():
                if isinstance(state, FrequenciesAndNumRows):
                    state.close()
        context = results_loaded + AnalyzerContext(failures) + AnalyzerContext(metrics)
        return _results(context, metrics_repository, save_or_append_results_with_key)

    @staticmethod
    def run_on_aggregated_states(
        schema: Schema,
        analyzers: Sequence[Analyzer],
        state_loaders: Sequence[Any],
        *,
        save_states_with: Optional[Any] = None,
        metrics_repository: Optional[Any] = None,
        save_or_append_results_with_key: Optional[Any] = None,
        device: DeviceLike = None,
        monitor: Optional[RunMonitor] = None,
    ) -> AnalyzerContext:
        """Compute metrics purely from merged persisted states, with no data
        pass (reference `AnalysisRunner.runOnAggregatedStates`,
        `AnalysisRunner.scala:385-460`). Every analyzer's states fold in one
        call of ``merge_states_batched_many`` on ``device``: one
        ``state_fold`` launch for all the scalar, DataType, HLL and
        Correlation states, ``kll_compact`` merges for the sketches. The
        monitor's phases: ``state_load`` (the loaders), ``state_merge`` (the
        merges, ending in a synchronise), ``metric_derivation``."""
        dev = resolve_device(device)
        if len(analyzers) == 0 or len(state_loaders) == 0:
            return AnalyzerContext.empty()
        run_monitor = monitor if monitor is not None else RunMonitor()
        passed: List[Analyzer] = []
        failures: Dict[Analyzer, Metric] = {}
        for a in dict.fromkeys(analyzers):
            if not isinstance(a, Analyzer):
                raise _not_in_slice(a, "it is not an analyzer of this package")
            exc = Preconditions.find_first_failing(schema, a.preconditions())
            if exc is None:
                passed.append(a)
            else:
                failures[a] = a.to_failure_metric(exc)

        with run_monitor.timed("state_load"):
            loaded = [(a, [loader.load(a) for loader in state_loaders]) for a in passed]
        with run_monitor.timed("state_merge"):
            merged = merge_states_batched_many(loaded, dev)
            synchronize(dev)
        metrics: Dict[Analyzer, Metric] = {}
        with run_monitor.timed("metric_derivation"):
            for a, state in zip(passed, merged):
                if save_states_with is not None and state is not None:
                    save_states_with.persist(a, state)
                metrics[a] = _metric(a, state)
        context = AnalyzerContext(failures) + AnalyzerContext(metrics)
        return _results(context, metrics_repository, save_or_append_results_with_key)


def _finalize(analyzer: Analyzer, state: Any, aggregate_with: Optional[Any],
              save_states_with: Optional[Any], device) -> Metric:
    """The analyzer's metric from its run state, merged first with the
    state ``aggregate_with`` holds for it and persisted afterwards through
    ``save_states_with`` (reference `analysis_runner.py:583-599`)."""
    try:
        if aggregate_with is not None:
            state = merge_states_batched(analyzer, [aggregate_with.load(analyzer), state], device)
        if save_states_with is not None and state is not None:
            save_states_with.persist(analyzer, state)
        return analyzer.compute_metric_from(state)
    except KernelError:
        raise  # a faulty kernel fails the run, never one metric
    except Exception as exc:  # noqa: BLE001
        return analyzer.to_failure_metric(exc)


def _results(context: AnalyzerContext, repository: Optional[Any], key: Optional[Any]
             ) -> AnalyzerContext:
    if repository is not None and key is not None:
        _save_or_append(repository, key, context)
    return context


def _save_or_append(repository, key, context: AnalyzerContext) -> None:
    """Append semantics (reference `AnalysisRunner.scala:205-223`)."""
    existing = repository.load_by_key(key)
    combined = (existing or AnalyzerContext.empty()) + context
    repository.save(key, combined)


def _device_tier_expected(scanning: Sequence[ScanShareableAnalyzer], placement: Optional[str],
                          device) -> bool:
    """Whether the pass will stream batches to the device: the gate for the
    device frequency tables (the reference's ``_device_tier_expected``,
    deequ_tpu/runners/analysis_runner.py:602). It asks the engine's own
    ``resolve_scan_placement``, so the two never disagree; without a scan
    battery the tables would create a device pass, which only pays on a
    fast link or when the caller asked for the device."""
    if scanning:
        return resolve_scan_placement(scanning, placement, device) == "device"
    effective = default_placement(placement)
    if effective != "auto":
        return effective == "device"
    return probe_feed_bandwidth(device) >= FEED_BANDWIDTH_THRESHOLD_MBPS


def _run_device(device, sharding):
    """The device of a run: the mesh's first device under ``sharding``
    (``device``, when given, must be of its type), else ``device``
    resolved."""
    if sharding is None:
        return resolve_device(device)
    if device is not None and resolve_device(device).type != sharding.home.type:
        raise ValueError(f"device={device!r} does not match the mesh {sharding}")
    return sharding.home


def _run_pass(data: Dataset, battery: Sequence[ScanShareableAnalyzer],
              host_sets: Sequence[Tuple[str, ...]], batch_size: Optional[int], device,
              monitor: RunMonitor, placement: Optional[str] = None, sharding=None,
              host_accum: Sequence[Analyzer] = (), checkpointer: Optional[Any] = None):
    """One shared pass through the reliability layer (the reference's
    ``run_pass`` under ``run_scan_resilient``,
    deequ_tpu/runners/analysis_runner.py:330-426): ``battery`` on the ingest
    tier ``placement`` resolves to (row-sharded over the mesh
    ``sharding``), a host group-by per set of ``host_sets`` and each
    analyzer of ``host_accum`` folding its own host state.

    A device failure fails the battery over to the host tier (an OOM first
    halves the batch, an escaped shard loss re-shards the mesh), an
    analyzer fault bisects the battery until exactly the faulty analyzers
    degrade, and a host fold that raises is knocked out alone
    (``reliability.isolation``). Returns the
    :class:`~deequ_tpu_torch.reliability.ResilientScanOutcome`: the
    battery's host states and errors by analyzer, the host states (a set's
    :class:`FrequenciesAndNumRows` by its columns, an accumulator's by the
    analyzer) and the errors of the host folds. ``checkpointer`` makes the
    full battery's pass resumable (``ScanEngine.run``); bisection passes
    never save."""
    from ..reliability.isolation import run_scan_resilient

    def make_host_states():
        states: Dict[Any, Any] = {cols: FrequenciesAndNumRows.empty(list(cols))
                                  for cols in host_sets}
        update: Dict[Any, Any] = {cols: FrequenciesAndNumRows.update for cols in host_sets}
        for a in host_accum:
            states[a] = a.host_init()
            update[a] = a.host_update
        return states, update

    full_battery = tuple(battery)
    keep = object()

    def run_pass(part, host_states, host_updates, *, placement=None, batch_size=None,
                 sharding=keep):
        # the ladder overrides ``sharding`` only after a shard loss escaped
        # the engine: the pass re-runs whole on a mesh rebuilt over the
        # surviving devices (None: the mesh is gone)
        mesh = outer_sharding if sharding is keep else sharding
        engine = ScanEngine(list(part), device if mesh is None else mesh.home,
                            monitor=monitor, placement=placement, sharding=mesh)
        sets = [key for key in host_states if isinstance(key, tuple)]
        accum = [key for key in host_states if not isinstance(key, tuple)]
        states = engine.run(
            data, batch_size=batch_size,
            columns=_columns_needed(engine, data.schema, sets, accum),
            host_accumulators=host_states, host_update_fns=host_updates,
            checkpointer=checkpointer if tuple(part) == full_battery else None,
        )
        return states, host_states

    outer_sharding = sharding
    return run_scan_resilient(
        run_pass, full_battery, make_host_states, monitor,
        batch_size=effective_batch_size(batch_size), placement=placement,
        sharding=sharding, device=device)


def _metric(analyzer: Analyzer, state: Any) -> Metric:
    try:
        return analyzer.compute_metric_from(state)
    except KernelError:
        raise
    except Exception as exc:  # noqa: BLE001
        return analyzer.to_failure_metric(exc)


def _columns_needed(engine: ScanEngine, schema, host_sets: Sequence[Tuple[str, ...]] = (),
                    host_accum: Sequence[Analyzer] = ()) -> Optional[List[str]]:
    """Restrict batch materialization to columns any analyzer, host
    group-by or host accumulator touches; None (= all columns) when a
    predicate may reference arbitrary columns."""
    if any(spec.kind == "pred" for spec in engine.builder.specs.values()):
        return None
    cols = set(engine.required_columns())
    for set_cols in host_sets:
        cols.update(set_cols)
    for a in host_accum:
        if getattr(a, "where", None) is not None:
            # the accumulator evaluates its predicate over the raw batch
            return None
        cols.add(a.column)
    return [c for c in schema.names if c in cols]
