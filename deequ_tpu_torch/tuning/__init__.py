"""The self-tuning control plane (the reference's ``deequ_tpu/tuning/``,
ported):

- :mod:`.knobs`: the registry every tunable routing constant resolves
  through (env override > tuned > static default);
- :mod:`.calibrate` and :mod:`.profile`: boot-time probes on the card,
  persisted as a checksummed per-substrate profile;
- :mod:`.controller`: the online re-fitter that shadow-routes candidates
  under live traffic and promotes only behind a tolerance band, with a
  never-below-static floor.

``DEEQU_TPU_AUTOTUNE=0`` disables all of it: no profile load, no
controller, every knob its env override or static default.
"""

from __future__ import annotations

import logging
from typing import Optional

from . import knobs
from .controller import TuningController
from .profile import SubstrateProfile, load_profile, save_profile

logger = logging.getLogger(__name__)

__all__ = [
    "knobs", "TuningController", "SubstrateProfile",
    "load_profile", "save_profile", "bootstrap_service",
]


def bootstrap_service(service) -> Optional[TuningController]:
    """Wire the tuning plane into a VerificationService at construction.

    Always describes the ``deequ_service_tuning_*`` series (a disabled
    plane exports zeros, so dashboards have no gaps). With autotune on:
    load the profile of ``service.device``'s substrate if one exists (a
    corrupt or stale one is quarantined by the loader and the service
    boots on static defaults, with a warning), apply its knob values,
    start the controller, register its gauges, reseed the router from the
    (possibly tuned) seeds and run the controller on the scheduler's
    harvest tick."""
    from ..exceptions import CorruptStateError

    metrics = getattr(service, "metrics", None)
    if metrics is not None:
        TuningController._describe_series(metrics)
    if not knobs.autotune_enabled():
        return None

    profile = None
    try:
        profile = load_profile(device=service.device)
    except CorruptStateError as exc:
        logger.warning("tuning profile rejected (%s); booting on static defaults", exc)
    if profile is not None:
        applied = profile.apply(source="profile")
        logger.info("tuning profile %s applied: %d knob(s) tuned for this substrate",
                    profile.fingerprint, len(applied))

    router = getattr(getattr(service, "coalescer", None), "router", None)
    controller = TuningController(metrics=metrics, router=router, profile=profile)
    if metrics is not None:
        controller.register_gauges(metrics)
    if router is not None:
        router.reseed_from_knobs()
    scheduler = getattr(service, "scheduler", None)
    if scheduler is not None and hasattr(scheduler, "add_harvest_listener"):
        scheduler.add_harvest_listener(controller.on_harvest)
    return controller
