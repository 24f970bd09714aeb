"""Fluent run configuration (reference `analyzers/runners/AnalysisRunBuilder.scala:25-186`)."""

from __future__ import annotations

from typing import List, Optional, Sequence

from ..analyzers.base import Analyzer
from ..config import DeviceLike, resolve_device
from ..data import Dataset
from .context import AnalyzerContext
from .engine import RunMonitor


class AnalysisRunBuilder:
    def __init__(self, data: Dataset, device: DeviceLike = None):
        self._data = data
        self._device = resolve_device(device)
        self._analyzers: List[Analyzer] = []
        self._batch_size: Optional[int] = None
        self._monitor: Optional[RunMonitor] = None

    def add_analyzer(self, analyzer: Analyzer) -> "AnalysisRunBuilder":
        self._analyzers.append(analyzer)
        return self

    def add_analyzers(self, analyzers: Sequence[Analyzer]) -> "AnalysisRunBuilder":
        self._analyzers.extend(analyzers)
        return self

    def with_batch_size(self, batch_size: int) -> "AnalysisRunBuilder":
        self._batch_size = batch_size
        return self

    def with_monitor(self, monitor: RunMonitor) -> "AnalysisRunBuilder":
        self._monitor = monitor
        return self

    def run(self) -> AnalyzerContext:
        from .analysis_runner import AnalysisRunner

        return AnalysisRunner.do_analysis_run(
            self._data,
            self._analyzers,
            batch_size=self._batch_size,
            monitor=self._monitor,
            device=self._device,
        )


class Analysis:
    """Immutable list of analyzers + run convenience
    (reference `analyzers/Analysis.scala:29-63`)."""

    def __init__(self, analyzers: Optional[Sequence[Analyzer]] = None):
        self.analyzers: List[Analyzer] = list(analyzers or [])

    def add_analyzer(self, analyzer: Analyzer) -> "Analysis":
        return Analysis(self.analyzers + [analyzer])

    def add_analyzers(self, analyzers: Sequence[Analyzer]) -> "Analysis":
        return Analysis(self.analyzers + list(analyzers))

    def run(self, data: Dataset, **kwargs) -> AnalyzerContext:
        from .analysis_runner import AnalysisRunner

        return AnalysisRunner.do_analysis_run(data, self.analyzers, **kwargs)
