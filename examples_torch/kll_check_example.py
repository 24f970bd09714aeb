"""Assert on a KLL quantile sketch inside a verification run
(reference `examples/KLLCheckExample.scala`)."""

from deequ_tpu_torch import Check, CheckLevel, CheckStatus, Dataset, VerificationSuite
from deequ_tpu_torch.analyzers import KLLParameters
from deequ_tpu_torch.constraints import ConstraintStatus

from . import run_main
from .example_utils import SAMPLE_ITEMS


def main(device="cuda"):
    # the reference casts numViews to double first
    new_data = Dataset.from_dict(
        {"numViews": [float(i.num_views) for i in SAMPLE_ITEMS]}
    )

    verification_result = (
        VerificationSuite.on_data(new_data, device=device)
        .add_check(
            Check(CheckLevel.ERROR, "integrity checks")
            # we expect 5 records
            .has_size(lambda size: size == 5)
            # we expect the maximum of views to be not more than 10
            .has_max("numViews", lambda v: v <= 10)
            # we expect the sketch size to be at least 16
            .kll_sketch_satisfies(
                "numViews",
                lambda dist: dist.parameters[1] >= 16,
                kll_parameters=KLLParameters(2, 0.64, 2),
            )
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
