"""Seeded violations for the state-algebra check: a *State class without a
merge() (not a semigroup), and an identity-merge-transparency registry
naming a class that does not exist."""


class OrphanState:
    @staticmethod
    def init() -> "OrphanState":
        return OrphanState()


IDENTITY_TRANSPARENT_STATES = frozenset({GhostState})  # noqa: F821
