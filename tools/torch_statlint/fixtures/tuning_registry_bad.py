"""Seeded violation for the tuning-registry check: a hand-coded routing
threshold — a module-level numeric cutoff compared against at a decision
site — instead of a registered knob in deequ_tpu_torch/tuning/knobs.py (so
boot-time calibration and the online controller could never move it)."""

FIXTURE_ROUTE_MIN_ROWS = 1 << 20


def fixture_route(rows: int) -> str:
    if rows <= FIXTURE_ROUTE_MIN_ROWS:
        return "host"
    return "device"
