"""Check plugins: one module per machine-checked contract. A check module
exposes ``CHECK`` (the id every finding carries) and ``run(index) ->
List[Finding]``; registering it here is all it takes to gate tier-1."""

from . import (  # noqa: F401
    dead_imports,
    env_knobs,
    export_help,
    failure_registry,
    lock_discipline,
    span_kinds,
    state_algebra,
    trace_purity,
    tuning_registry,
)

ALL_CHECKS = (
    trace_purity,
    lock_discipline,
    env_knobs,
    failure_registry,
    export_help,
    state_algebra,
    dead_imports,
    tuning_registry,
    span_kinds,
)
