"""VerificationSuite: the main orchestration façade.

``VerificationSuite.on_data(data, device=...).add_check(check).run()``
collects the analyzers every check needs, delegates metric computation to
the AnalysisRunner (one fused pass on the device), evaluates checks against
the resulting AnalyzerContext and reports an overall status
(reference `VerificationSuite.scala:42-315`, `VerificationRunBuilder.scala:
28-341`, `VerificationResult.scala:33-119`). A run can merge loaded states
(``aggregate_with``), persist its states (``save_states_with``), keep its
metrics in a repository and check the newest metrics against their history
(``use_repository(...).add_anomaly_check(...)``), and resume an
interrupted pass from an ingest checkpoint (``checkpoint_with``).
Partition-aware incremental verification (``on_partitions`` /
``verify_partitioned``) diffs an incoming partition set against a
:class:`~deequ_tpu_torch.repository.PartitionStateStore`, scans only new
or changed partitions and checks the merge of stored and fresh states
(``runners/incremental.py``).
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence

from .analyzers import Analyzer
from .checks import Check, CheckLevel, CheckResult, CheckStatus
from .config import DeviceLike, resolve_device
from .analyzers.state_provider import StateLoader, StatePersister  # noqa: F401
from .data import Dataset, Schema  # noqa: F401  (Schema: the reference's name here)
from .metrics import Metric
from .runners.analysis_runner import (
    AnalysisRunner,
    _save_or_append,
    collect_required_analyzers,
)
from .runners.builder import frequency_options
from .runners.context import AnalyzerContext
from .runners.engine import RunMonitor


class VerificationResult:
    """(reference `VerificationResult.scala:33-119`)."""

    def __init__(
        self,
        status: CheckStatus,
        check_results: Dict[Check, CheckResult],
        metrics: Dict[Analyzer, Metric],
        cost_by_analyzer: Optional[Dict[str, float]] = None,
    ):
        self.status = status
        self.check_results = check_results
        self.metrics = metrics
        #: seconds by repr(analyzer), from the run's
        #: ``RunMonitor.cost_by_analyzer``; empty for a run from persisted
        #: states and for checks evaluated against a given context
        self.cost_by_analyzer: Dict[str, float] = dict(cost_by_analyzer or {})

    def cost_by_analyzer_as_json(self) -> str:
        """``[{"analyzer": ..., "seconds": ...}, ...]``, most expensive
        first (the reference package's form, deequ_tpu/verification.py:46)."""
        rows = sorted(self.cost_by_analyzer.items(), key=lambda kv: -kv[1])
        return json.dumps([{"analyzer": k, "seconds": v} for k, v in rows])

    def success_metrics_as_data_frame(self, for_analyzers: Sequence[Analyzer] = ()):
        return AnalyzerContext(self.metrics).success_metrics_as_dataframe(for_analyzers)

    def success_metrics_as_json(self, for_analyzers: Sequence[Analyzer] = ()) -> str:
        return AnalyzerContext(self.metrics).success_metrics_as_json(for_analyzers)

    def check_results_as_data_frame(self):
        import pandas as pd

        rows = []
        for check, result in self.check_results.items():
            for cr in result.constraint_results:
                rows.append(
                    {
                        "check": check.description,
                        "check_level": check.level.value,
                        "check_status": result.status.value,
                        "constraint": str(cr.constraint),
                        "constraint_status": cr.status.value,
                        "constraint_message": cr.message or "",
                    }
                )
        return pd.DataFrame(
            rows,
            columns=[
                "check",
                "check_level",
                "check_status",
                "constraint",
                "constraint_status",
                "constraint_message",
            ],
        )

    def check_results_as_json(self) -> str:
        df = self.check_results_as_data_frame()
        return json.dumps(df.to_dict(orient="records"))


class IncrementalVerificationResult(VerificationResult):
    """A :class:`VerificationResult` plus the incremental run's report
    (``incremental``: an
    :class:`~deequ_tpu_torch.runners.incremental.IncrementalRunReport`, the
    scan/reuse/invalidated/dropped partitions, rows scanned against the
    total, the reuse ratio)."""

    def __init__(self, result: VerificationResult, report):
        super().__init__(result.status, result.check_results, result.metrics,
                         result.cost_by_analyzer)
        self.incremental = report


class VerificationSuite:
    """(reference `VerificationSuite.scala:42-315`)."""

    @staticmethod
    def on_data(data: Dataset, device: DeviceLike = None) -> "VerificationRunBuilder":
        return VerificationRunBuilder(data, device=device)

    @staticmethod
    def do_verification_run(
        data: Dataset,
        checks: Sequence[Check],
        required_analyzers: Sequence[Analyzer] = (),
        *,
        batch_size: Optional[int] = None,
        monitor: Optional[RunMonitor] = None,
        device: DeviceLike = None,
        aggregate_with: Optional[Any] = None,
        save_states_with: Optional[Any] = None,
        metrics_repository: Optional[Any] = None,
        reuse_existing_results_for_key: Optional[Any] = None,
        fail_if_results_missing: bool = False,
        save_or_append_results_with_key: Optional[Any] = None,
        placement: Optional[str] = None,
        sharding: Optional[Any] = None,
        checkpointer: Optional[Any] = None,
        **freq_options,
    ) -> VerificationResult:
        """One pass computing every metric the checks need, then the
        verdicts. ``freq_options``: ``freq_table_slots``,
        ``freq_buffer_entries`` and ``device_freq`` of
        :meth:`AnalysisRunner.do_analysis_run`; the state and repository
        keywords are its own too, except that the results are saved after
        the checks are evaluated, so an anomaly check never sees the current
        point in its own history (reference `VerificationSuite.scala:121-139`).
        ``placement``: the pass's ingest tier, ``sharding``: the mesh its
        rows shard over, and ``checkpointer``: the ingest checkpointer that
        makes the pass resumable, as ``do_analysis_run``'s. The run is one
        ``verification_run`` span, the checks' evaluation a
        ``constraint_evaluation`` phase span under it."""
        from .observability import trace as _trace

        checks = list(checks)  # evaluate() walks them again after the run
        analyzers = collect_required_analyzers(checks, required_analyzers)
        # a monitor always, so the result carries the run's cost by analyzer
        monitor = monitor if monitor is not None else RunMonitor()
        with _trace.span("verification_run", kind="verification", checks=len(checks),
                         analyzers=len(analyzers)):
            analysis_results = AnalysisRunner.do_analysis_run(
                data, analyzers, batch_size=batch_size, monitor=monitor, device=device,
                aggregate_with=aggregate_with, save_states_with=save_states_with,
                metrics_repository=metrics_repository,
                reuse_existing_results_for_key=reuse_existing_results_for_key,
                fail_if_results_missing=fail_if_results_missing, placement=placement,
                sharding=sharding, checkpointer=checkpointer, **freq_options,
            )
            with _trace.span("constraint_evaluation", kind="phase"):
                result = VerificationSuite.evaluate(checks, analysis_results)
            result.cost_by_analyzer = dict(monitor.cost_by_analyzer)
            if metrics_repository is not None and save_or_append_results_with_key is not None:
                _save_or_append(metrics_repository, save_or_append_results_with_key,
                                analysis_results)
            return result

    @staticmethod
    def run_on_aggregated_states(
        schema,
        checks: Sequence[Check],
        state_loaders: Sequence[Any],
        *,
        required_analyzers: Sequence[Analyzer] = (),
        save_states_with: Optional[Any] = None,
        metrics_repository: Optional[Any] = None,
        save_or_append_results_with_key: Optional[Any] = None,
        device: DeviceLike = None,
    ) -> VerificationResult:
        """Verification from merged persisted states, no data pass
        (reference `VerificationSuite.scala:208-229`)."""
        checks = list(checks)
        analyzers = collect_required_analyzers(checks, required_analyzers)
        context = AnalysisRunner.run_on_aggregated_states(
            schema, analyzers, state_loaders, save_states_with=save_states_with,
            metrics_repository=metrics_repository,
            save_or_append_results_with_key=save_or_append_results_with_key, device=device,
        )
        return VerificationSuite.evaluate(checks, context)

    @staticmethod
    def verify_partitioned(
        store,
        dataset_name: str,
        partitions,
        checks: Sequence[Check],
        required_analyzers: Sequence[Analyzer] = (),
        *,
        checksums=None,
        batch_size: Optional[int] = None,
        monitor: Optional[RunMonitor] = None,
        sharding: Optional[Any] = None,
        placement: Optional[str] = None,
        metrics_repository: Optional[Any] = None,
        save_or_append_results_with_key: Optional[Any] = None,
        delete_dropped: bool = False,
        device: DeviceLike = None,
    ) -> IncrementalVerificationResult:
        """Partition-aware incremental verification (the reference's
        ``verify_partitioned``, deequ_tpu/verification.py:183): diff the
        incoming partitions (name -> payload: a Dataset, an Arrow table, a
        dict of columns or a zero-argument callable giving one) against
        ``store`` (a :class:`~deequ_tpu_torch.repository.PartitionStateStore`),
        scan only new or changed partitions on ``device`` (persisting their
        states), load the unchanged partitions' states with no data touched
        and evaluate ``checks`` against the merge. ``checksums`` maps a
        partition to its version token (else its content is hashed). The
        result's ``incremental`` report carries the plan and the rows
        scanned."""
        from .observability import trace as _trace
        from .runners.incremental import run_incremental

        checks = list(checks)
        analyzers = collect_required_analyzers(checks, required_analyzers)
        monitor = monitor if monitor is not None else RunMonitor()
        with _trace.span("incremental_verification", kind="verification",
                         dataset=str(dataset_name), checks=len(checks)):
            context, report = run_incremental(
                store, dataset_name, partitions, analyzers, checksums=checksums,
                batch_size=batch_size, monitor=monitor, sharding=sharding,
                placement=placement, metrics_repository=metrics_repository,
                save_or_append_results_with_key=save_or_append_results_with_key,
                delete_dropped=delete_dropped, device=device,
            )
            with _trace.span("constraint_evaluation", kind="phase"):
                result = VerificationSuite.evaluate(checks, context)
            result.cost_by_analyzer = dict(monitor.cost_by_analyzer)
        return IncrementalVerificationResult(result, report)

    @staticmethod
    def on_partitions(store, dataset_name: str, partitions, checksums=None,
                      device: DeviceLike = None) -> "PartitionedVerificationRunBuilder":
        """Fluent entry point of :meth:`verify_partitioned`."""
        return PartitionedVerificationRunBuilder(store, dataset_name, partitions, checksums,
                                                 device=device)

    @staticmethod
    def evaluate(checks: Sequence[Check], context: AnalyzerContext) -> VerificationResult:
        """(reference `VerificationSuite.scala:263-281`)."""
        check_results = {check: check.evaluate(context) for check in checks}
        if not check_results:
            status = CheckStatus.SUCCESS
        else:
            status = max(
                (r.status for r in check_results.values()), key=lambda s: s.severity
            )
        return VerificationResult(status, check_results, dict(context.metric_map))


@dataclass(frozen=True)
class AnomalyCheckConfig:
    """(reference `VerificationRunBuilder.scala:336`)."""

    level: CheckLevel
    description: str
    with_tag_values: Dict[str, str] = field(default_factory=dict)
    after_date: Optional[int] = None
    before_date: Optional[int] = None


class VerificationRunBuilder:
    """Fluent run configuration (reference `VerificationRunBuilder.scala:
    28-163`)."""

    def __init__(self, data: Dataset, device: DeviceLike = None):
        self.data = data
        self.device = resolve_device(device)
        self.checks: List[Check] = []
        self.required_analyzers: List[Analyzer] = []
        self._batch_size: Optional[int] = None
        self._monitor: Optional[RunMonitor] = None
        self._freq_options: Dict = {}
        self._state_options: Dict[str, Any] = {}
        self._placement: Optional[str] = None
        self._sharding: Optional[Any] = None
        self._check_results_path: Optional[str] = None
        self._success_metrics_path: Optional[str] = None

    def add_check(self, check: Check) -> "VerificationRunBuilder":
        self.checks.append(check)
        return self

    def add_checks(self, checks: Sequence[Check]) -> "VerificationRunBuilder":
        self.checks.extend(checks)
        return self

    def add_required_analyzer(self, analyzer: Analyzer) -> "VerificationRunBuilder":
        self.required_analyzers.append(analyzer)
        return self

    def add_required_analyzers(self, analyzers: Sequence[Analyzer]) -> "VerificationRunBuilder":
        self.required_analyzers.extend(analyzers)
        return self

    def aggregate_with(self, state_loader) -> "VerificationRunBuilder":
        self._state_options["aggregate_with"] = state_loader
        return self

    def save_states_with(self, state_persister) -> "VerificationRunBuilder":
        self._state_options["save_states_with"] = state_persister
        return self

    def use_repository(self, repository) -> "VerificationRunBuilderWithRepository":
        return VerificationRunBuilderWithRepository(self, repository)

    def with_batch_size(self, batch_size: int) -> "VerificationRunBuilder":
        self._batch_size = batch_size
        return self

    def with_monitor(self, monitor: RunMonitor) -> "VerificationRunBuilder":
        self._monitor = monitor
        return self

    def with_placement(self, placement: str) -> "VerificationRunBuilder":
        """The pass's ingest tier: ``"device"``, ``"host"`` or ``"auto"``
        (reference `verification.py:351`)."""
        self._placement = placement
        return self

    def with_sharding(self, sharding) -> "VerificationRunBuilder":
        """Shard the pass's rows over a mesh
        (:func:`deequ_tpu_torch.parallel.make_mesh`; reference
        `verification.py:347`)."""
        self._sharding = sharding
        return self

    def checkpoint_with(self, checkpointer) -> "VerificationRunBuilder":
        """Make the pass resumable: a
        :class:`~deequ_tpu_torch.reliability.IngestCheckpointer` persists
        the states every K batches through its provider, and an interrupted
        run called again with a checkpointer over the same provider resumes
        from the last checkpoint, with the metrics of an uninterrupted run
        (reference `verification.py:357`)."""
        self._state_options["checkpointer"] = checkpointer
        return self

    def with_frequency_options(self, **options) -> "VerificationRunBuilder":
        """``freq_table_slots``, ``freq_buffer_entries`` and ``device_freq``
        of :meth:`AnalysisRunner.do_analysis_run`."""
        self._freq_options.update(frequency_options(**options))
        return self

    def save_check_results_json_to_path(self, path: str) -> "VerificationRunBuilder":
        """Write ``check_results_as_json()`` to ``path`` after the run."""
        self._check_results_path = path
        return self

    def save_success_metrics_json_to_path(self, path: str) -> "VerificationRunBuilder":
        """Write ``success_metrics_as_json()`` to ``path`` after the run."""
        self._success_metrics_path = path
        return self

    def run(self) -> VerificationResult:
        result = VerificationSuite.do_verification_run(
            self.data,
            self.checks,
            self.required_analyzers,
            batch_size=self._batch_size,
            monitor=self._monitor,
            device=self.device,
            placement=self._placement,
            sharding=self._sharding,
            **self._freq_options,
            **self._state_options,
        )
        # written atomically, local paths and URIs alike (reference
        # `VerificationSuite.scala:146-172`)
        from . import io as dio

        if self._check_results_path is not None:
            dio.write_text_atomic(self._check_results_path, result.check_results_as_json())
        if self._success_metrics_path is not None:
            dio.write_text_atomic(self._success_metrics_path, result.success_metrics_as_json())
        return result


class PartitionedVerificationRunBuilder:
    """Fluent configuration of partition-aware incremental verification
    (``VerificationSuite.on_partitions(store, name, partitions)``; reference
    `verification.py:410`): the checks of a :class:`VerificationRunBuilder`,
    run through the delta planner instead of one data pass."""

    def __init__(self, store, dataset_name: str, partitions, checksums=None,
                 device: DeviceLike = None):
        self.store = store
        self.dataset_name = dataset_name
        self.partitions = partitions
        self.checksums = checksums
        self.device = resolve_device(device)
        self.checks: List[Check] = []
        self.required_analyzers: List[Analyzer] = []
        self._batch_size: Optional[int] = None
        self._monitor: Optional[RunMonitor] = None
        self._sharding = None
        self._placement: Optional[str] = None
        self._metrics_repository = None
        self._save_key = None
        self._delete_dropped = False

    def add_check(self, check: Check) -> "PartitionedVerificationRunBuilder":
        self.checks.append(check)
        return self

    def add_checks(self, checks: Sequence[Check]) -> "PartitionedVerificationRunBuilder":
        self.checks.extend(checks)
        return self

    def add_required_analyzer(self, analyzer: Analyzer) -> "PartitionedVerificationRunBuilder":
        self.required_analyzers.append(analyzer)
        return self

    def add_required_analyzers(self, analyzers: Sequence[Analyzer]
                               ) -> "PartitionedVerificationRunBuilder":
        self.required_analyzers.extend(analyzers)
        return self

    def with_batch_size(self, batch_size: int) -> "PartitionedVerificationRunBuilder":
        self._batch_size = batch_size
        return self

    def with_monitor(self, monitor: RunMonitor) -> "PartitionedVerificationRunBuilder":
        self._monitor = monitor
        return self

    def with_sharding(self, sharding) -> "PartitionedVerificationRunBuilder":
        self._sharding = sharding
        return self

    def with_placement(self, placement: str) -> "PartitionedVerificationRunBuilder":
        self._placement = placement
        return self

    def use_repository(self, repository) -> "PartitionedVerificationRunBuilder":
        self._metrics_repository = repository
        return self

    def save_or_append_result(self, key) -> "PartitionedVerificationRunBuilder":
        self._save_key = key
        return self

    def delete_dropped_partitions(self) -> "PartitionedVerificationRunBuilder":
        """Retention: partitions absent from the incoming set are deleted
        from the store after the merge (the merge already left them out)."""
        self._delete_dropped = True
        return self

    def run(self) -> IncrementalVerificationResult:
        return VerificationSuite.verify_partitioned(
            self.store, self.dataset_name, self.partitions, self.checks,
            self.required_analyzers, checksums=self.checksums, batch_size=self._batch_size,
            monitor=self._monitor, sharding=self._sharding, placement=self._placement,
            metrics_repository=self._metrics_repository,
            save_or_append_results_with_key=self._save_key,
            delete_dropped=self._delete_dropped, device=self.device,
        )


class VerificationRunBuilderWithRepository(VerificationRunBuilder):
    """(reference `VerificationRunBuilder.scala:196-341`)."""

    def __init__(self, parent: VerificationRunBuilder, repository):
        self.__dict__.update(parent.__dict__)
        self._state_options = dict(parent._state_options, metrics_repository=repository)

    def reuse_existing_results_for_key(
        self, key, fail_if_results_missing: bool = False
    ) -> "VerificationRunBuilderWithRepository":
        self._state_options["reuse_existing_results_for_key"] = key
        self._state_options["fail_if_results_missing"] = fail_if_results_missing
        return self

    def save_or_append_result(self, key) -> "VerificationRunBuilderWithRepository":
        self._state_options["save_or_append_results_with_key"] = key
        return self

    def add_anomaly_check(
        self, anomaly_detection_strategy, analyzer: Analyzer, anomaly_check_config=None
    ) -> "VerificationRunBuilderWithRepository":
        """(reference `VerificationRunBuilder.scala:227-244`)."""
        description = f"Anomaly check for {analyzer}"
        config = anomaly_check_config or AnomalyCheckConfig(CheckLevel.WARNING, description)
        check = Check(config.level, config.description).is_newest_point_non_anomalous(
            self._state_options["metrics_repository"],
            anomaly_detection_strategy,
            analyzer,
            config.with_tag_values,
            config.after_date,
            config.before_date,
        )
        self.checks.append(check)
        return self
