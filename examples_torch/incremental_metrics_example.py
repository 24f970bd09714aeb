"""Incrementally update metrics on a growing dataset from persisted states —
no rescan of the old data (reference `examples/IncrementalMetricsExample.scala`;
the algebra is `analyzers/Analyzer.scala:107-128` aggregateWith)."""

from deequ_tpu_torch.analyzers import ApproxCountDistinct, Completeness, Size
from deequ_tpu_torch.analyzers.state_provider import InMemoryStateProvider
from deequ_tpu_torch.runners.builder import Analysis

from . import run_main
from .example_utils import Item, items_as_dataset


def main(device="cuda"):
    data = items_as_dataset(
        Item(1, "Thingy A", "awesome thing.", "high", 0),
        Item(2, "Thingy B", "available tomorrow", "low", 0),
        Item(3, "Thing C", None, None, 5),
    )
    more_data = items_as_dataset(
        Item(4, "Thingy D", None, "low", 10),
        Item(5, "Thingy E", None, "high", 12),
    )

    analysis = (
        Analysis()
        .add_analyzer(Size())
        .add_analyzer(ApproxCountDistinct("id"))
        .add_analyzer(Completeness("productName"))
        .add_analyzer(Completeness("description"))
    )

    state_store = InMemoryStateProvider()

    # persist the internal state of the computation
    metrics_for_data = analysis.run(data, save_states_with=state_store, device=device)

    # continue from the stored states WITHOUT touching the previous data
    metrics_after_adding_more_data = analysis.run(
        more_data, aggregate_with=state_store, device=device
    )

    print("Metrics for the first 3 records:\n")
    for analyzer, metric in metrics_for_data.metric_map.items():
        print(f"\t{analyzer}: {metric.value.get()}")

    print("\nMetrics after adding 2 more records:\n")
    for analyzer, metric in metrics_after_adding_more_data.metric_map.items():
        print(f"\t{analyzer}: {metric.value.get()}")

    return metrics_for_data, metrics_after_adding_more_data


if __name__ == "__main__":
    run_main(main)
