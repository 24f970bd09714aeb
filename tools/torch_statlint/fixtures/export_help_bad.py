"""Seeded violation for the export-plane completeness check: a
``deequ_service_*`` series incremented without a HELP description
registered anywhere."""


def bump(metrics) -> None:
    metrics.inc("deequ_service_fixture_undescribed_total", tenant="t")
