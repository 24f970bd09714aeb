"""Maintain table-level metrics over partitioned data: compute state per
partition, derive metrics from merged states, refresh one partition without
touching the others (reference
`examples/UpdateMetricsOnPartitionedDataExample.scala:60-92`, engine path
`AnalysisRunner.runOnAggregatedStates`, `AnalysisRunner.scala:385-460`)."""

from deequ_tpu_torch import Check, CheckLevel
from deequ_tpu_torch.analyzers.state_provider import InMemoryStateProvider
from deequ_tpu_torch.runners import AnalysisRunner
from deequ_tpu_torch.runners.builder import Analysis

from . import run_main
from .example_utils import Manufacturer, manufacturers_as_dataset


def main(device="cuda"):
    # a table of manufacturers stored/processed partitioned by country code
    de_manufacturers = manufacturers_as_dataset(
        Manufacturer(1, "ManufacturerA", "DE"),
        Manufacturer(2, "ManufacturerB", "DE"),
    )
    us_manufacturers = manufacturers_as_dataset(
        Manufacturer(3, "ManufacturerD", "US"),
        Manufacturer(4, "ManufacturerE", "US"),
        Manufacturer(5, "ManufacturerF", "US"),
    )
    cn_manufacturers = manufacturers_as_dataset(
        Manufacturer(6, "ManufacturerG", "CN"),
        Manufacturer(7, "ManufacturerH", "CN"),
    )

    # constraints on the table as a whole
    check = (
        Check(CheckLevel.WARNING, "a check")
        .is_complete("manufacturerName")
        .contains_url("manufacturerName", lambda ratio: ratio == 0.0)
        .is_contained_in("countryCode", ["DE", "US", "CN"])
    )
    analysis = Analysis(check.required_analyzers())

    # compute and store the state of the metrics per partition
    de_states = InMemoryStateProvider()
    us_states = InMemoryStateProvider()
    cn_states = InMemoryStateProvider()
    analysis.run(de_manufacturers, save_states_with=de_states, device=device)
    analysis.run(us_manufacturers, save_states_with=us_states, device=device)
    analysis.run(cn_manufacturers, save_states_with=cn_states, device=device)

    # metrics for the whole table from the partition states alone —
    # the data is not touched again
    table_metrics = AnalysisRunner.run_on_aggregated_states(
        de_manufacturers.schema, analysis.analyzers, [de_states, us_states, cn_states],
        device=device,
    )
    print("Metrics for the whole table:\n")
    for analyzer, metric in table_metrics.metric_map.items():
        print(f"\t{analyzer}: {metric.value.get()}")

    # a single partition changes: recompute ONLY its state
    updated_us = manufacturers_as_dataset(
        Manufacturer(3, "ManufacturerDNew", "US"),
        Manufacturer(4, None, "US"),
        Manufacturer(5, "ManufacturerFNew http://clickme.com", "US"),
    )
    updated_us_states = InMemoryStateProvider()
    analysis.run(updated_us, save_states_with=updated_us_states, device=device)

    updated_table_metrics = AnalysisRunner.run_on_aggregated_states(
        de_manufacturers.schema,
        analysis.analyzers,
        [de_states, updated_us_states, cn_states],
        device=device,
    )
    print("Metrics for the whole table after updating the US partition:\n")
    for analyzer, metric in updated_table_metrics.metric_map.items():
        print(f"\t{analyzer}: {metric.value.get()}")

    return table_metrics, updated_table_metrics


if __name__ == "__main__":
    run_main(main)
