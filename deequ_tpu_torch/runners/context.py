"""AnalyzerContext: the result of an analysis run
(reference `analyzers/runners/AnalyzerContext.scala:29-105`)."""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

from ..analyzers.base import Analyzer
from ..metrics import Metric


@dataclass(frozen=True)
class AnalyzerContext:
    metric_map: Dict[Analyzer, Metric] = field(default_factory=dict)

    @staticmethod
    def empty() -> "AnalyzerContext":
        return AnalyzerContext({})

    def all_metrics(self) -> List[Metric]:
        return list(self.metric_map.values())

    def __add__(self, other: "AnalyzerContext") -> "AnalyzerContext":
        merged = dict(self.metric_map)
        merged.update(other.metric_map)
        return AnalyzerContext(merged)

    def metric(self, analyzer: Analyzer) -> Optional[Metric]:
        return self.metric_map.get(analyzer)

    def success_metrics(
        self, for_analyzers: Optional[Sequence[Analyzer]] = None
    ) -> Dict[Analyzer, Metric]:
        return {
            a: m
            for a, m in self.metric_map.items()
            if (not for_analyzers or a in for_analyzers) and m.value.is_success
        }

    def success_metrics_as_records(
        self, for_analyzers: Optional[Sequence[Analyzer]] = None
    ) -> List[dict]:
        """Flattened (entity, instance, name, value) records
        (reference `AnalyzerContext.successMetricsAsDataFrame`,
        `AnalyzerContext.scala:48-77`)."""
        records = []
        for metric in self.success_metrics(for_analyzers).values():
            for flat in metric.flatten():
                if flat.value.is_success:
                    records.append(
                        {
                            "entity": flat.entity.value,
                            "instance": flat.instance,
                            "name": flat.name,
                            "value": flat.value.get(),
                        }
                    )
        return records

    def success_metrics_as_dataframe(self, for_analyzers=None):
        import pandas as pd

        records = self.success_metrics_as_records(for_analyzers)
        return pd.DataFrame(records, columns=["entity", "instance", "name", "value"])

    def success_metrics_as_json(self, for_analyzers=None) -> str:
        return json.dumps(self.success_metrics_as_records(for_analyzers))
