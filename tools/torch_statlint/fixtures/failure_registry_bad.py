"""Seeded violations for the failure-registry check: a typed exception
defined outside the registry modules (and not re-exported via
``exceptions._SUBSYSTEM_EXCEPTIONS``), plus a ``fault_point`` probe whose
site name is not registered in ``reliability/faults.KNOWN_FAULT_SITES``."""

from deequ_tpu_torch.reliability.faults import fault_point


class RogueSubsystemError(RuntimeError):
    """A typed failure nobody can import from the taxonomy."""


def poke() -> None:
    fault_point("fixture_unregistered_site")
    raise RogueSubsystemError("boom")
