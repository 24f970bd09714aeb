"""VerificationSuite: the main orchestration façade.

``VerificationSuite.on_data(data, device=...).add_check(check).run()``
collects the analyzers every check needs, delegates metric computation to
the AnalysisRunner (one fused pass on the device), evaluates checks against
the resulting AnalyzerContext and reports an overall status
(reference `VerificationSuite.scala:42-315`, `VerificationRunBuilder.scala:
28-341`, `VerificationResult.scala:33-119`). Repositories, state
persistence and anomaly checks are not part of this port yet.
"""

from __future__ import annotations

import json
from typing import Dict, List, Optional, Sequence

from .analyzers import Analyzer
from .checks import Check, CheckResult, CheckStatus
from .config import DeviceLike, resolve_device
from .data import Dataset
from .metrics import Metric
from .runners.analysis_runner import AnalysisRunner, collect_required_analyzers
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
        **freq_options,
    ) -> VerificationResult:
        """One pass computing every metric the checks need, then the
        verdicts. ``freq_options``: ``freq_table_slots``,
        ``freq_buffer_entries`` and ``device_freq`` of
        :meth:`AnalysisRunner.do_analysis_run`."""
        checks = list(checks)  # evaluate() walks them again after the run
        analyzers = collect_required_analyzers(checks, required_analyzers)
        analysis_results = AnalysisRunner.do_analysis_run(
            data, analyzers, batch_size=batch_size, monitor=monitor, device=device,
            **freq_options,
        )
        return VerificationSuite.evaluate(checks, analysis_results)

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

    def with_batch_size(self, batch_size: int) -> "VerificationRunBuilder":
        self._batch_size = batch_size
        return self

    def with_monitor(self, monitor: RunMonitor) -> "VerificationRunBuilder":
        self._monitor = monitor
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
            **self._freq_options,
        )
