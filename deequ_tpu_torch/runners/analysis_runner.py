"""AnalysisRunner: the scheduler.

Reference flow (`analyzers/runners/AnalysisRunner.scala:97-203`): dedupe
-> precondition partition -> split {scanning, grouping} -> one fused pass
-> assemble AnalyzerContext.

This port routes what its slice covers, all in ONE pass: the
scan-shareable reductions, DataType, HLL and the KLL sketches on the
device; histograms over dictionary-encoded columns on the device frequency
scan; and each grouping set (Uniqueness, Distinctness, UniqueValueRatio,
CountDistinct, Entropy over one or several columns) on one of three routes,
as the reference package routes them (deequ_tpu/runners/analysis_runner.py:
240-460):

1. one dictionary-encoded column of at most ``DEVICE_FREQ_MAX_CARDINALITY``
   entries: the device frequency scan (kernel ``dict_code_counts``);
2. a set the cardinality probe finds small, or any set with
   ``device_freq=False``: the host group-by, folded batch by batch in the
   same pass;
3. any other set: the device frequency table (kernels ``freq_keys`` and
   ``freq_compact``), sized by ``freq_table_slots`` and
   ``freq_buffer_entries``. A table that dropped groups re-runs its set
   through the host group-by in one more pass (``freq_overflow_fallbacks``).

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

Anything else raises ``NotImplementedError`` naming the analyzer — nothing
is routed silently to another tier.
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
from ..analyzers.grouping import (
    DeviceFrequencyScan,
    DeviceFrequencyTableScan,
    FrequenciesAndNumRows,
    GroupingAnalyzer,
    Histogram,
    device_counts_to_histogram_frequencies,
    plan_table_scan,
    probably_low_cardinality,
)
from ..config import (
    DEFAULT_FREQ_BUFFER_ENTRIES,
    DEFAULT_FREQ_TABLE_SLOTS,
    DEVICE_FREQ_MAX_CARDINALITY,
    DeviceLike,
    resolve_device,
    synchronize,
)
from ..data import Dataset, Schema
from ..exceptions import MetricCalculationException
from ..metrics import Metric
from .context import AnalyzerContext
from .engine import (
    FEED_BANDWIDTH_THRESHOLD_MBPS,
    PLACEMENTS,
    RunMonitor,
    ScanEngine,
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
        freq_table_slots: int = DEFAULT_FREQ_TABLE_SLOTS,
        freq_buffer_entries: int = DEFAULT_FREQ_BUFFER_ENTRIES,
        device_freq: bool = True,
        aggregate_with: Optional[Any] = None,
        save_states_with: Optional[Any] = None,
        metrics_repository: Optional[Any] = None,
        reuse_existing_results_for_key: Optional[Any] = None,
        fail_if_results_missing: bool = False,
        save_or_append_results_with_key: Optional[Any] = None,
        placement: Optional[str] = None,
    ) -> AnalyzerContext:
        """Compute every analyzer's metric in one pass over ``data``.
        ``freq_table_slots`` and ``freq_buffer_entries`` size the device
        frequency tables (see ``config.py``); ``device_freq=False`` sends
        every grouping set that is not a small dictionary column to the
        host group-by. ``aggregate_with`` (a StateLoader),
        ``save_states_with`` (a StatePersister), ``metrics_repository``
        with ``reuse_existing_results_for_key`` / ``fail_if_results_missing``
        and ``save_or_append_results_with_key``: as the reference's runner
        (module docstring). ``placement``: the ingest tier, ``"auto"`` when
        None (module docstring)."""
        dev = resolve_device(device)
        if placement is not None and placement not in PLACEMENTS:
            raise ValueError(f"placement must be one of {PLACEMENTS}, got {placement!r}")
        if len(analyzers) == 0:
            return AnalyzerContext.empty()

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
            if getattr(a, "exact_mode", False):
                raise a.exact_mode_unsupported()
            exc = Preconditions.find_first_failing(schema, a.preconditions())
            if exc is None:
                passed.append(a)
            else:
                failures[a] = a.to_failure_metric(exc)

        # validate each analyzer's features on a synthetic 1-row batch so a
        # bad predicate/regex fails only that analyzer, not the shared scan
        from .features import FeatureBuilder, dry_run_batch

        dry = dry_run_batch(schema)
        scanning: List[ScanShareableAnalyzer] = []
        grouping_sets: Dict[Tuple[str, ...], List[GroupingAnalyzer]] = {}
        histograms: List[Histogram] = []
        for a in passed:
            if isinstance(a, ScanShareableAnalyzer):
                try:
                    FeatureBuilder(a.feature_specs()).build(dry)
                except Exception as exc:  # noqa: BLE001
                    failures[a] = a.to_failure_metric(exc)
                    continue
                scanning.append(a)
            elif isinstance(a, GroupingAnalyzer):
                grouping_sets.setdefault(tuple(a.grouping_columns()), []).append(a)
            elif isinstance(a, Histogram):
                if data.dictionary_size(a.column) is None:
                    raise _not_in_slice(a, f"column {a.column} is not dictionary-encoded")
                histograms.append(a)
            else:
                raise _not_in_slice(a, "no execution strategy in this package")

        # route 1: the device frequency scan, for grouping sets of one small
        # dictionary column and for every histogram's column
        dict_sets = set()
        for cols in grouping_sets:
            size = data.dictionary_size(cols[0]) if len(cols) == 1 else None
            if size is not None and size <= DEVICE_FREQ_MAX_CARDINALITY:
                dict_sets.add(cols)
        freq_cols = dict_sets | {(a.column,) for a in histograms}
        dictionaries = {cols: data.dictionary_values(cols[0]) for cols in freq_cols}
        freq_scans = {
            cols: DeviceFrequencyScan(cols[0], len(dictionaries[cols])) for cols in freq_cols
        }
        # route 3: the device frequency table; route 2: the host group-by.
        # Merged or persisted grouping states must be value-keyed, so a run
        # that aggregates or saves states keeps route 3 off.
        slim = aggregate_with is None and save_states_with is None
        batch_rows = effective_batch_size(batch_size)
        table_scans: Dict[Tuple[str, ...], DeviceFrequencyTableScan] = {}
        host_sets: List[Tuple[str, ...]] = []
        tables_ok = (slim and device_freq and any(c not in dict_sets for c in grouping_sets)
                     and _device_tier_expected(scanning, placement, dev))
        for cols in grouping_sets:
            if cols in dict_sets:
                continue
            scan = None
            if tables_ok and not probably_low_cardinality(data, cols):
                scan = plan_table_scan(schema, cols, data.num_rows, batch_rows,
                                       freq_table_slots, freq_buffer_entries)
            if scan is None:
                host_sets.append(cols)
            else:
                table_scans[cols] = scan

        battery = scanning + list(freq_scans.values()) + list(table_scans.values())
        run_monitor = monitor if monitor is not None else RunMonitor()
        run_monitor.device_freq_sets += len(table_scans)
        metrics: Dict[Analyzer, Metric] = {}
        if not battery and not host_sets:
            return _results(results_loaded + AnalyzerContext(failures), metrics_repository,
                            save_or_append_results_with_key)
        states, shared = _run_pass(data, battery, host_sets, batch_size, dev, run_monitor,
                                   placement)
        by_analyzer = dict(zip(battery, states))

        # drain the device frequency tables; a table that dropped groups
        # re-runs its set through the host group-by in one more pass
        fallback: List[Tuple[str, ...]] = []
        with run_monitor.timed("drain"):
            for cols, scan in table_scans.items():
                drained = scan.drain(by_analyzer[scan])
                if drained is None:
                    fallback.append(cols)
                else:
                    shared[cols] = drained
        if fallback:
            losses = "; ".join(
                f"{cols}: ~{int(by_analyzer[table_scans[cols]].lost_groups)} groups / "
                f"{int(by_analyzer[table_scans[cols]].lost_rows)} rows dropped"
                for cols in fallback
            )
            logging.getLogger(__name__).warning(
                "device frequency table overflowed for grouping sets [%s]; re-running "
                "them through the host group-by", losses,
            )
            run_monitor.freq_overflow_fallbacks += len(fallback)
            shared.update(_run_pass(data, [], fallback, batch_size, dev, run_monitor)[1])

        # load old state -> merge -> persist -> metric (reference
        # `Analyzer.calculateMetric`, `Analyzer.scala:107-128`)
        def finalize(a: Analyzer, state: Any) -> Metric:
            return _finalize(a, state, aggregate_with, save_states_with, dev)

        with run_monitor.timed("metric_derivation"):
            for a in scanning:
                metrics[a] = finalize(a, by_analyzer[a])
            for cols in dict_sets:
                scan = freq_scans[cols]
                shared[cols] = scan.to_frequencies(by_analyzer[scan], dictionaries[cols])
            for cols, members in grouping_sets.items():
                for a in members:
                    metrics[a] = finalize(a, shared[cols])
            for a in histograms:
                scan = freq_scans[(a.column,)]
                hist = device_counts_to_histogram_frequencies(
                    scan, by_analyzer[scan], dictionaries[(a.column,)]
                )
                metrics[a] = finalize(a, hist)
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
    effective = placement or "auto"
    if effective != "auto":
        return effective == "device"
    return probe_feed_bandwidth(device) >= FEED_BANDWIDTH_THRESHOLD_MBPS


def _run_pass(data: Dataset, battery: Sequence[ScanShareableAnalyzer],
              host_sets: Sequence[Tuple[str, ...]], batch_size: Optional[int], device,
              monitor: RunMonitor, placement: Optional[str] = None,
              ) -> Tuple[List[Any], Dict[Tuple[str, ...], Any]]:
    """One pass: ``battery`` on the ingest tier ``placement`` resolves to
    and a host group-by per set of ``host_sets``. Returns the battery's
    states (on the host) and each set's :class:`FrequenciesAndNumRows` by
    its columns."""
    engine = ScanEngine(battery, device, monitor=monitor, placement=placement)
    tables: Dict[Tuple[str, ...], Any] = {
        cols: FrequenciesAndNumRows.empty(list(cols)) for cols in host_sets
    }
    update = {cols: FrequenciesAndNumRows.update for cols in host_sets}
    states = engine.run(
        data, batch_size=batch_size, columns=_columns_needed(engine, data.schema, host_sets),
        host_accumulators=tables, host_update_fns=update,
    )
    return states, tables


def _metric(analyzer: Analyzer, state: Any) -> Metric:
    try:
        return analyzer.compute_metric_from(state)
    except Exception as exc:  # noqa: BLE001
        return analyzer.to_failure_metric(exc)


def _columns_needed(engine: ScanEngine, schema,
                    host_sets: Sequence[Tuple[str, ...]] = ()) -> Optional[List[str]]:
    """Restrict batch materialization to columns any analyzer or host
    group-by touches; None (= all columns) when a predicate may reference
    arbitrary columns."""
    if any(spec.kind == "pred" for spec in engine.builder.specs.values()):
        return None
    cols = set(engine.required_columns())
    for set_cols in host_sets:
        cols.update(set_cols)
    return [c for c in schema.names if c in cols]
