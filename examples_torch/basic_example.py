"""Declare checks on a small Item table and verify them — the canonical
entry-point walkthrough (reference `examples/BasicExample.scala`)."""

from deequ_tpu_torch import Check, CheckLevel, CheckStatus, VerificationSuite
from deequ_tpu_torch.constraints import ConstraintStatus

from . import run_main
from .example_utils import SAMPLE_ITEMS, items_as_dataset


def main(device="cuda"):
    data = items_as_dataset(*SAMPLE_ITEMS)

    verification_result = (
        VerificationSuite.on_data(data, device=device)
        .add_check(
            Check(CheckLevel.ERROR, "integrity checks")
            # we expect 5 records
            .has_size(lambda size: size == 5)
            # 'id' should never be NULL
            .is_complete("id")
            # 'id' should not contain duplicates
            .is_unique("id")
            # 'productName' should never be NULL
            .is_complete("productName")
            # 'priority' should only contain the values "high" and "low"
            .is_contained_in("priority", ["high", "low"])
            # 'numViews' should not contain negative values
            .is_non_negative("numViews")
        )
        .add_check(
            Check(CheckLevel.WARNING, "distribution checks")
            # at least half of the 'description's should contain a url
            .contains_url("description", lambda ratio: ratio >= 0.5)
            # half of the items should have less than 10 'numViews'
            .has_approx_quantile("numViews", 0.5, lambda median: median <= 10)
        )
        .run()
    )

    if verification_result.status == CheckStatus.SUCCESS:
        print("The data passed the test, everything is fine!")
    else:
        print("We found errors in the data, the following constraints were not satisfied:\n")
        for check_result in verification_result.check_results.values():
            for result in check_result.constraint_results:
                if result.status != ConstraintStatus.SUCCESS:
                    print(f"{result.constraint} failed: {result.message}")

    return verification_result


if __name__ == "__main__":
    run_main(main)
