"""Let the library suggest constraints from a data profile: the rules are
heuristics, so review the suggestions before applying them in production
(reference `examples/ConstraintSuggestionExample.scala`)."""

from deequ_tpu_torch.suggestions import ConstraintSuggestionRunner, Rules

from . import run_main
from .example_utils import SAMPLE_RAW_DATA, RawData, raw_data_as_dataset


def main(device="cuda"):
    # twice the raw-data rows, with a little numeric variation
    data = raw_data_as_dataset(
        *SAMPLE_RAW_DATA,
        RawData("thingA", "13.0", "IN_TRANSIT", "true"),
        RawData("thingA", "5", "DELAYED", "false"),
        RawData("thingB", None, "DELAYED", None),
        RawData("thingC", None, "IN_TRANSIT", "false"),
        RawData("thingD", "1.0", "DELAYED", "true"),
        RawData("thingC", "17.0", "UNKNOWN", None),
        RawData("thingC", "22", "UNKNOWN", None),
        RawData("thingE", "23", "DELAYED", "false"),
    )

    # profile the data, then apply the default rule set to suggest constraints
    suggestion_result = (
        ConstraintSuggestionRunner.on_data(data, device=device)
        .add_constraint_rules(Rules.DEFAULT)
        .run()
    )

    # each suggestion comes with a textual description and runnable code
    for column, suggestions in suggestion_result.constraint_suggestions.items():
        for suggestion in suggestions:
            print(
                f"Constraint suggestion for '{column}':\t{suggestion.description}\n"
                f"The corresponding code is {suggestion.code_for_constraint}\n"
            )

    return suggestion_result


if __name__ == "__main__":
    run_main(main)
