"""Wiring between checks and anomaly detection: the assertion behind
``Check.is_newest_point_non_anomalous`` (reference `checks/Check.scala:
998-1055` and `HistoryUtils.scala`)."""

from __future__ import annotations

from typing import Dict, Optional

from . import AnomalyDetector, DataPoint


def extract_metric_values(repository_results, analyzer):
    """AnalysisResults -> DataPoints for one analyzer
    (reference `HistoryUtils.extractMetricValues`)."""
    points = []
    for result in repository_results:
        metric = result.analyzer_context.metric_map.get(analyzer)
        value = None
        if metric is not None and metric.value.is_success:
            raw = metric.value.get()
            if isinstance(raw, (int, float)):
                value = float(raw)
        points.append(DataPoint(result.result_key.data_set_date, value))
    return points


def is_newest_point_non_anomalous(
    metrics_repository,
    anomaly_detection_strategy,
    analyzer,
    with_tag_values: Dict[str, str],
    after_date: Optional[int],
    before_date: Optional[int],
    current_metric_value: float,
) -> bool:
    loader = metrics_repository.load().for_analyzers([analyzer])
    if with_tag_values:
        loader = loader.with_tag_values(with_tag_values)
    if after_date is not None:
        loader = loader.after(after_date)
    if before_date is not None:
        loader = loader.before(before_date)
    repository_results = loader.get()
    history = extract_metric_values(repository_results, analyzer)
    if not history:
        raise ValueError(
            "There have to be previous results in the MetricsRepository!"
        )
    test_time = max(p.time for p in history) + 1
    detector = AnomalyDetector(anomaly_detection_strategy)
    result = detector.is_new_point_anomalous(
        history, DataPoint(test_time, float(current_metric_value))
    )
    return len(result.anomalies) == 0
