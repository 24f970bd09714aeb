"""In-memory metrics repository
(reference `repository/memory/InMemoryMetricsRepository.scala`)."""

from __future__ import annotations

import threading
from typing import Dict, List, Optional

from ..runners.context import AnalyzerContext
from . import (
    AnalysisResult,
    MetricsRepository,
    MetricsRepositoryMultipleResultsLoader,
    ResultKey,
)


class InMemoryMetricsRepository(MetricsRepository):
    def __init__(self):
        self._results: Dict[ResultKey, AnalysisResult] = {}
        self._lock = threading.Lock()

    def save(self, result_key: ResultKey, analyzer_context: AnalyzerContext) -> None:
        # keep only successful metrics, mirroring the reference
        # (`InMemoryMetricsRepository.scala:44-52`)
        successful = AnalyzerContext(
            {a: m for a, m in analyzer_context.metric_map.items() if m.value.is_success}
        )
        with self._lock:
            self._results[result_key] = AnalysisResult(result_key, successful)

    def load_by_key(self, result_key: ResultKey) -> Optional[AnalyzerContext]:
        with self._lock:
            result = self._results.get(result_key)
        return result.analyzer_context if result is not None else None

    def load(self) -> "InMemoryMetricsRepositoryMultipleResultsLoader":
        return InMemoryMetricsRepositoryMultipleResultsLoader(self)

    def _snapshot(self) -> List[AnalysisResult]:
        with self._lock:
            return list(self._results.values())


class InMemoryMetricsRepositoryMultipleResultsLoader(MetricsRepositoryMultipleResultsLoader):
    def __init__(self, repository: InMemoryMetricsRepository):
        super().__init__()
        self._repository = repository

    def _all_results(self) -> List[AnalysisResult]:
        return self._repository._snapshot()
