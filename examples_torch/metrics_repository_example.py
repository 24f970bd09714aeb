"""Store computed metrics in a repository and query the history by key, time
window and tags (reference `examples/MetricsRepositoryExample.scala`)."""

import tempfile
import time
from pathlib import Path

from deequ_tpu_torch import (
    Check,
    CheckLevel,
    FileSystemMetricsRepository,
    ResultKey,
    VerificationSuite,
)
from deequ_tpu_torch.analyzers import Completeness

from . import run_main
from .example_utils import SAMPLE_ITEMS, items_as_dataset


def main(device="cuda"):
    data = items_as_dataset(*SAMPLE_ITEMS)

    # a json file in which the computed metrics will be stored
    metrics_file = str(Path(tempfile.mkdtemp()) / "metrics.json")
    repository = FileSystemMetricsRepository(metrics_file)

    # the key under which results are stored: a timestamp plus arbitrary tags
    now_ms = int(time.time() * 1000)
    result_key = ResultKey(now_ms, {"tag": "repositoryExample"})

    (
        VerificationSuite.on_data(data, device=device)
        .add_check(
            Check(CheckLevel.ERROR, "integrity checks")
            .has_size(lambda size: size == 5)
            .is_complete("id")
            .is_complete("productName")
            .is_contained_in("priority", ["high", "low"])
            .is_non_negative("numViews")
        )
        .use_repository(repository)
        .save_or_append_result(result_key)
        .run()
    )

    # load the metric for a particular analyzer stored under our result key
    completeness_of_product_name = (
        repository.load_by_key(result_key).metric(Completeness("productName")).value.get()
    )
    print(f"The completeness of the productName column is: {completeness_of_product_name}")

    # query all metrics from the last 10 minutes as json
    json_metrics = (
        repository.load().after(now_ms - 10 * 60 * 1000).get_success_metrics_as_json()
    )
    print(f"Metrics from the last 10 minutes:\n{json_metrics}")

    # query by tag value, result as a dataframe
    frame = (
        repository.load()
        .with_tag_values({"tag": "repositoryExample"})
        .get_success_metrics_as_data_frame()
    )
    print(frame)
    return frame


if __name__ == "__main__":
    run_main(main)
