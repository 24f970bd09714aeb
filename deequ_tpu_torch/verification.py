"""VerificationSuite: the main orchestration façade.

``VerificationSuite.on_data(data, device=...).add_check(check).run()``
collects the analyzers every check needs, delegates metric computation to
the AnalysisRunner (one fused pass on the device), evaluates checks against
the resulting AnalyzerContext and reports an overall status
(reference `VerificationSuite.scala:42-315`, `VerificationRunBuilder.scala:
28-341`, `VerificationResult.scala:33-119`). A run can merge loaded states
(``aggregate_with``), persist its states (``save_states_with``), keep its
metrics in a repository and check the newest metrics against their history
(``use_repository(...).add_anomaly_check(...)``); partition-aware
incremental verification is not part of this port yet.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence

from .analyzers import Analyzer
from .checks import Check, CheckLevel, CheckResult, CheckStatus
from .config import DeviceLike, resolve_device
from .data import Dataset
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
    ):
        self.status = status
        self.check_results = check_results
        self.metrics = metrics

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
        **freq_options,
    ) -> VerificationResult:
        """One pass computing every metric the checks need, then the
        verdicts. ``freq_options``: ``freq_table_slots``,
        ``freq_buffer_entries`` and ``device_freq`` of
        :meth:`AnalysisRunner.do_analysis_run`; the state and repository
        keywords are its own too, except that the results are saved after
        the checks are evaluated, so an anomaly check never sees the current
        point in its own history (reference `VerificationSuite.scala:121-139`).
        ``placement``: the pass's ingest tier, and ``sharding``: the mesh its
        rows shard over, as ``do_analysis_run``'s."""
        checks = list(checks)  # evaluate() walks them again after the run
        analyzers = collect_required_analyzers(checks, required_analyzers)
        analysis_results = AnalysisRunner.do_analysis_run(
            data, analyzers, batch_size=batch_size, monitor=monitor, device=device,
            aggregate_with=aggregate_with, save_states_with=save_states_with,
            metrics_repository=metrics_repository,
            reuse_existing_results_for_key=reuse_existing_results_for_key,
            fail_if_results_missing=fail_if_results_missing, placement=placement,
            sharding=sharding, **freq_options,
        )
        result = VerificationSuite.evaluate(checks, analysis_results)
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
    def on_partitions(store, dataset_name: str, partitions, checksums=None):
        """Partition-aware incremental verification: not ported yet."""
        raise NotImplementedError(
            "PartitionedVerificationRunBuilder (VerificationSuite.on_partitions, "
            "runners/incremental.py) is not supported by deequ_tpu_torch yet"
        )

    @staticmethod
    def verify_partitioned(store, dataset_name: str, partitions, checks, *args, **kwargs):
        """Partition-aware incremental verification: not ported yet."""
        raise NotImplementedError(
            "VerificationSuite.verify_partitioned (runners/incremental.py) is not "
            "supported by deequ_tpu_torch yet"
        )

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

    def with_frequency_options(self, **options) -> "VerificationRunBuilder":
        """``freq_table_slots``, ``freq_buffer_entries`` and ``device_freq``
        of :meth:`AnalysisRunner.do_analysis_run`."""
        self._freq_options.update(frequency_options(**options))
        return self

    def run(self) -> VerificationResult:
        return VerificationSuite.do_verification_run(
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
