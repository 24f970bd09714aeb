"""Seeded violation for the env-knob-convention check: a DEEQU_TPU_* knob
read straight off os.environ instead of through utils.env_number /
env_str / env_flag (so a typo'd value would crash or silently diverge
instead of warning once and keeping the default)."""

import os

FIXTURE_KNOB_ENV = "DEEQU_TPU_FIXTURE_KNOB"


def fixture_knob() -> int:
    return int(os.environ.get(FIXTURE_KNOB_ENV, "4"))
