"""AnalysisRunner: the scheduler.

Reference flow (`analyzers/runners/AnalysisRunner.scala:97-203`): dedupe
-> precondition partition -> split {scanning, grouping} -> one fused pass
-> assemble AnalyzerContext.

This port routes what its slice covers, all in ONE pass on the device:
the scan-shareable reductions, DataType, HLL and the KLL sketches, and
grouping analyzers and histograms over a single dictionary-encoded column
whose dictionary is within ``DEVICE_FREQ_MAX_CARDINALITY`` (counted by the
device frequency scan). Anything else raises ``NotImplementedError`` naming
the analyzer — nothing is routed silently to another tier.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

from ..analyzers.base import Analyzer, Preconditions, ScanShareableAnalyzer
from ..analyzers.grouping import (
    DeviceFrequencyScan,
    GroupingAnalyzer,
    Histogram,
    device_counts_to_histogram_frequencies,
)
from ..config import DEVICE_FREQ_MAX_CARDINALITY, DeviceLike, resolve_device
from ..data import Dataset
from ..metrics import Metric
from .context import AnalyzerContext
from .engine import RunMonitor, ScanEngine


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
    ) -> AnalyzerContext:
        dev = resolve_device(device)
        if len(analyzers) == 0:
            return AnalyzerContext.empty()

        # dedupe identical analyzers, preserving order
        unique: List[Analyzer] = list(dict.fromkeys(analyzers))

        # precondition partition (reference `AnalysisRunner.scala:137-145`)
        schema = data.schema
        passed: List[Analyzer] = []
        failures: Dict[Analyzer, Metric] = {}
        for a in unique:
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
        grouping_sets: Dict[Tuple[str, ...], List[Analyzer]] = {}
        for a in passed:
            if isinstance(a, ScanShareableAnalyzer):
                try:
                    FeatureBuilder(a.feature_specs()).build(dry)
                except Exception as exc:  # noqa: BLE001
                    failures[a] = a.to_failure_metric(exc)
                    continue
                scanning.append(a)
            elif isinstance(a, (GroupingAnalyzer, Histogram)):
                cols = (a.column,) if isinstance(a, Histogram) else tuple(a.grouping_columns())
                if len(cols) != 1:
                    raise _not_in_slice(a, "grouping over several columns")
                size = data.dictionary_size(cols[0])
                if size is None:
                    raise _not_in_slice(a, f"column {cols[0]} is not dictionary-encoded")
                if size > DEVICE_FREQ_MAX_CARDINALITY:
                    raise _not_in_slice(
                        a, f"dictionary of {cols[0]} holds {size} > "
                        f"{DEVICE_FREQ_MAX_CARDINALITY} entries"
                    )
                grouping_sets.setdefault(cols, []).append(a)
            else:
                raise _not_in_slice(a, "no execution strategy in this package")

        # one device frequency scan per dictionary-encoded grouping column
        dictionaries = {cols: data.dictionary_values(cols[0]) for cols in grouping_sets}
        freq_scans = {
            cols: DeviceFrequencyScan(cols[0], len(dictionaries[cols]))
            for cols in grouping_sets
        }
        battery = scanning + list(freq_scans.values())
        metrics: Dict[Analyzer, Metric] = {}
        if battery:
            run_monitor = monitor if monitor is not None else RunMonitor()
            engine = ScanEngine(battery, dev, monitor=run_monitor)
            states = engine.run(
                data, batch_size=batch_size,
                columns=_columns_needed(engine, schema),
            )
            by_analyzer = dict(zip(battery, states))
            with run_monitor.timed("metric_derivation"):
                for a in scanning:
                    metrics[a] = _metric(a, by_analyzer[a])
                for cols, members in grouping_sets.items():
                    scan = freq_scans[cols]
                    state = by_analyzer[scan]
                    shared = scan.to_frequencies(state, dictionaries[cols])
                    for a in members:
                        if isinstance(a, Histogram):
                            hist = device_counts_to_histogram_frequencies(
                                scan, state, dictionaries[cols]
                            )
                            metrics[a] = _metric(a, hist)
                        else:
                            metrics[a] = _metric(a, shared)
        return AnalyzerContext(failures) + AnalyzerContext(metrics)


def _metric(analyzer: Analyzer, state: Any) -> Metric:
    try:
        return analyzer.compute_metric_from(state)
    except Exception as exc:  # noqa: BLE001
        return analyzer.to_failure_metric(exc)


def _columns_needed(engine: ScanEngine, schema) -> Optional[List[str]]:
    """Restrict batch materialization to columns any analyzer touches; None
    (= all columns) when a predicate may reference arbitrary columns."""
    if any(spec.kind == "pred" for spec in engine.builder.specs.values()):
        return None
    cols = set(engine.required_columns())
    return [c for c in schema.names if c in cols]
