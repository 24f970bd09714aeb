"""Metrics repository: keyed history store of analysis results.

``ResultKey(data_set_date, tags)`` identifies one analysis run;
repositories store the full ``AnalyzerContext`` per key and support
tag/time/analyzer-filtered multi-result queries
(reference `repository/MetricsRepository.scala:25-51`,
`repository/MetricsRepositoryMultipleResultsLoader.scala:27-139`).

A copy of the JAX package's ``deequ_tpu/repository``: the in-memory and
file-system repositories and the JSON serde (whose files the two packages
share). The partitioned repository and the partition state store are not
part of this port yet.
"""

from __future__ import annotations

import abc
import json
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

from ..analyzers import Analyzer
from ..runners.context import AnalyzerContext


@dataclass(frozen=True)
class ResultKey:
    """(reference `repository/MetricsRepository.scala:51`)."""

    data_set_date: int
    tags: Tuple[Tuple[str, str], ...] = ()

    def __init__(self, data_set_date: Optional[int] = None, tags=None):
        if data_set_date is None:
            data_set_date = ResultKey.current_milli_time()
        object.__setattr__(self, "data_set_date", int(data_set_date))
        if tags is None:
            tags = ()
        if isinstance(tags, dict):
            tags = tuple(sorted(tags.items()))
        object.__setattr__(self, "tags", tuple(tags))

    @property
    def tags_dict(self) -> Dict[str, str]:
        return dict(self.tags)

    @staticmethod
    def current_milli_time() -> int:
        return int(time.time() * 1000)


@dataclass(frozen=True)
class AnalysisResult:
    """(reference `repository/AnalysisResult.scala:25-40`)."""

    result_key: ResultKey
    analyzer_context: AnalyzerContext


class MetricsRepository(abc.ABC):
    """(reference `repository/MetricsRepository.scala:25-43`)."""

    @abc.abstractmethod
    def save(self, result_key: ResultKey, analyzer_context: AnalyzerContext) -> None:
        ...

    @abc.abstractmethod
    def load_by_key(self, result_key: ResultKey) -> Optional[AnalyzerContext]:
        ...

    @abc.abstractmethod
    def load(self) -> "MetricsRepositoryMultipleResultsLoader":
        ...


class MetricsRepositoryMultipleResultsLoader(abc.ABC):
    """Query builder over the whole history
    (reference `repository/MetricsRepositoryMultipleResultsLoader.scala`)."""

    def __init__(self):
        self._tag_values: Optional[Dict[str, str]] = None
        self._analyzers: Optional[List[Analyzer]] = None
        self._after: Optional[int] = None
        self._before: Optional[int] = None

    def with_tag_values(self, tag_values: Dict[str, str]):
        self._tag_values = dict(tag_values)
        return self

    def for_analyzers(self, analyzers: Sequence[Analyzer]):
        self._analyzers = list(analyzers)
        return self

    def after(self, date_time: int):
        self._after = date_time
        return self

    def before(self, date_time: int):
        self._before = date_time
        return self

    @abc.abstractmethod
    def _all_results(self) -> List[AnalysisResult]:
        ...

    def get(self) -> List[AnalysisResult]:
        out = []
        for result in self._all_results():
            key = result.result_key
            if self._after is not None and key.data_set_date < self._after:
                continue
            if self._before is not None and key.data_set_date > self._before:
                continue
            if self._tag_values is not None:
                tags = key.tags_dict
                if not all(tags.get(k) == v for k, v in self._tag_values.items()):
                    continue
            context = result.analyzer_context
            if self._analyzers is not None:
                wanted = set(self._analyzers)
                context = AnalyzerContext(
                    {a: m for a, m in context.metric_map.items() if a in wanted}
                )
            out.append(AnalysisResult(key, context))
        return out

    def get_success_metrics_as_records(self, with_tags: Sequence[str] = ()) -> List[dict]:
        """Union of per-result metric records, tags flattened into columns
        (reference `AnalysisResult.getSuccessMetricsAsDataFrame`)."""
        rows = []
        for result in self.get():
            tags = result.result_key.tags_dict
            for rec in result.analyzer_context.success_metrics_as_records():
                row = dict(rec)
                row["dataset_date"] = result.result_key.data_set_date
                for tag in with_tags:
                    row[tag] = tags.get(tag, "")
                rows.append(row)
        return rows

    def get_success_metrics_as_data_frame(self, with_tags: Sequence[str] = ()):
        import pandas as pd

        return pd.DataFrame(self.get_success_metrics_as_records(with_tags))

    def get_success_metrics_as_json(self, with_tags: Sequence[str] = ()) -> str:
        return json.dumps(self.get_success_metrics_as_records(with_tags))


from .memory import InMemoryMetricsRepository  # noqa: E402
from .fs import FileSystemMetricsRepository  # noqa: E402

__all__ = [
    "AnalysisResult",
    "FileSystemMetricsRepository",
    "InMemoryMetricsRepository",
    "MetricsRepository",
    "MetricsRepositoryMultipleResultsLoader",
    "ResultKey",
]
