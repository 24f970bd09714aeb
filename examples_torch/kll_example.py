"""Profile with explicit KLL sketch parameters and inspect the resulting
quantile sketch: buckets, parameters, raw compactor buffers
(reference `examples/KLLExample.scala`)."""

from deequ_tpu_torch.analyzers import KLLParameters
from deequ_tpu_torch.profiles import NumericColumnProfile
from deequ_tpu_torch.suggestions import ConstraintSuggestionRunner, Rules

from . import run_main
from .example_utils import SAMPLE_ITEMS, items_as_dataset


def main(device="cuda"):
    df = items_as_dataset(*SAMPLE_ITEMS)

    suggestion_result = (
        ConstraintSuggestionRunner.on_data(df, device=device)
        .add_constraint_rules(Rules.DEFAULT)
        .set_kll_parameters(KLLParameters(2, 0.64, 2))
        .run()
    )

    column_profiles = suggestion_result.column_profiles

    print("Observed statistics:")
    for name, profile in column_profiles.items():
        print(f"Feature '{name}': ")
        if isinstance(profile, NumericColumnProfile):
            print(
                f"\tminimum: {profile.minimum}\n"
                f"\tmaximum: {profile.maximum}\n"
                f"\tmean: {profile.mean}\n"
                f"\tstandard deviation: {profile.std_dev}"
            )
            kll_metric = profile.kll
            if kll_metric is not None:
                print("\tKLL buckets:")
                for item in kll_metric.buckets:
                    print(
                        f"\t\tlow_value: {item.low_value} "
                        f"high_value: {item.high_value} count: {item.count}"
                    )
                print(
                    f"\tparameters: c: {kll_metric.parameters[0]}, "
                    f"k: {kll_metric.parameters[1]}"
                )
                print(f"\tcompactor buffers: {kll_metric.data}")
        elif profile.histogram is not None:
            for key, entry in profile.histogram.values.items():
                print(f"\t{key} occurred {entry.absolute} times (ratio is {entry.ratio})")

    return suggestion_result


if __name__ == "__main__":
    run_main(main)
