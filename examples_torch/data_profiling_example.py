"""Profile raw (mostly string) data: completeness, approximate distinct
counts, inferred types, numeric statistics after casting, and full value
distributions for low-cardinality columns
(reference `examples/DataProfilingExample.scala`)."""

from deequ_tpu_torch.profiles import ColumnProfilerRunner, NumericColumnProfile

from . import run_main
from .example_utils import SAMPLE_RAW_DATA, raw_data_as_dataset


def main(device="cuda"):
    raw_data = raw_data_as_dataset(*SAMPLE_RAW_DATA)

    # three passes over the data, no shuffles
    result = ColumnProfilerRunner.on_data(raw_data, device=device).run()

    # a profile for each column: completeness, approx distinct count,
    # inferred datatype
    for product_name, profile in result.profiles.items():
        print(
            f"Column '{product_name}':\n"
            f"\tcompleteness: {profile.completeness}\n"
            f"\tapproximate number of distinct values: "
            f"{profile.approximate_num_distinct_values}\n"
            f"\tdatatype: {profile.data_type}\n"
        )

    # numeric columns get descriptive statistics ('totalNumber' is a string
    # column whose values are numeric, so the profiler casts it)
    total_number_profile = result.profiles["totalNumber"]
    assert isinstance(total_number_profile, NumericColumnProfile)
    print(
        "Statistics of 'totalNumber':\n"
        f"\tminimum: {total_number_profile.minimum}\n"
        f"\tmaximum: {total_number_profile.maximum}\n"
        f"\tmean: {total_number_profile.mean}\n"
        f"\tstandard deviation: {total_number_profile.std_dev}\n"
    )

    # low-cardinality columns get the full value distribution
    status_profile = result.profiles["status"]
    print("Value distribution in 'status':")
    if status_profile.histogram is not None:
        for key, entry in status_profile.histogram.values.items():
            print(f"\t{key} occurred {entry.absolute} times (ratio is {entry.ratio})")

    return result


if __name__ == "__main__":
    run_main(main)
