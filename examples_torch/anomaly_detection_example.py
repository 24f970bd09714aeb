"""Detect anomalous changes in metrics over time: yesterday's Size is stored
in a repository, today's more-than-doubled Size trips the anomaly check
(reference `examples/AnomalyDetectionExample.scala`)."""

import time

from deequ_tpu_torch import (
    CheckStatus,
    InMemoryMetricsRepository,
    ResultKey,
    VerificationSuite,
)
from deequ_tpu_torch.analyzers import Size
from deequ_tpu_torch.anomalydetection import RelativeRateOfChangeStrategy

from . import run_main
from .example_utils import SAMPLE_ITEMS, items_as_dataset


def main(device="cuda"):
    # anomaly detection operates on metrics stored in a metric repository
    metrics_repository = InMemoryMetricsRepository()
    now_ms = int(time.time() * 1000)

    # yesterday, the data had only two rows
    yesterdays_key = ResultKey(now_ms - 24 * 60 * 1000)
    yesterdays_dataset = items_as_dataset(*SAMPLE_ITEMS[:2])

    (
        VerificationSuite.on_data(yesterdays_dataset, device=device)
        .use_repository(metrics_repository)
        .save_or_append_result(yesterdays_key)
        .add_anomaly_check(
            RelativeRateOfChangeStrategy(max_rate_increase=2.0), Size()
        )
        .run()
    )

    # today's data has five rows: the size more than doubled
    todays_key = ResultKey(now_ms)
    todays_dataset = items_as_dataset(*SAMPLE_ITEMS)

    verification_result = (
        VerificationSuite.on_data(todays_dataset, device=device)
        .use_repository(metrics_repository)
        .save_or_append_result(todays_key)
        .add_anomaly_check(
            RelativeRateOfChangeStrategy(max_rate_increase=2.0), Size()
        )
        .run()
    )

    if verification_result.status != CheckStatus.SUCCESS:
        print("Anomaly detected in the Size() metric!")
        frame = (
            metrics_repository.load()
            .for_analyzers([Size()])
            .get_success_metrics_as_data_frame()
        )
        print(frame)

    return verification_result


if __name__ == "__main__":
    run_main(main)
