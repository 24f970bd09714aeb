"""Seeded-violation fixtures: each module plants exactly the contract
violation its namesake check exists to catch. They are PARSED by the
linter (never imported or executed) and pinned by
tests/test_torch_statlint.py: ``python -m tools.torch_statlint <fixture>``
must exit non-zero, one per check; a check that cannot catch its own
seeded violation is not a check."""
