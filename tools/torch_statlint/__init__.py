"""The port's invariant linter: repo-specific static analysis for the
contracts ``deequ_tpu_torch``'s service plane is built on.
``python -m tools.torch_statlint`` gates tier-1 via
``tests/test_torch_statlint.py``; see ``core.py`` for the architecture and
``checks/`` for one module per machine-checked contract."""

from .core import (  # noqa: F401
    PACKAGE,
    Finding,
    Module,
    ModuleIndex,
    apply_baseline,
    load_baseline,
    pkg,
    run_checks,
    write_baseline,
)
