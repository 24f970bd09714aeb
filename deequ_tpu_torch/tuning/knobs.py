"""The tunable-knob registry: one audited surface for the routing
constants the streaming service, the engine's feed pipeline and the mesh
read (the reference's
``deequ_tpu/tuning/knobs.py``, cut to the knobs this package reads).

Every knob is a registered :class:`Knob` with a name, an optional
operator env var (parsed with the shared warn-once ``utils.env_number``),
its static default and the bounds a calibration may never leave.
:func:`value` resolves env override > static default: the port has no
calibration or online controller yet (ROADMAP A6), so it reads exactly as
the reference does under ``DEEQU_TPU_AUTOTUNE=0``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional


@dataclass(frozen=True)
class Knob:
    """One registered tunable: its audit record and parse semantics."""

    name: str                    #: registry key
    env: Optional[str]           #: operator env override (None = internal)
    static_default: Any          #: the default the reference measured
    cast: Callable               #: int or float
    lo: Any                      #: tuned-value clamp floor
    hi: Any                      #: tuned-value clamp ceiling
    substrate_sensitive: bool    #: does calibration expect to move it?
    description: str             #: what the knob governs (audit surface)
    #: minimum the env parser enforces (warn-once + fallback below it)
    env_minimum: Any = None


def _registry() -> Dict[str, Knob]:
    k = Knob
    knobs = [
        # -- streaming fold routing (service/coalesce.py) ------------------
        k("fast_path_max_rows", "DEEQU_TPU_FAST_PATH_MAX_ROWS", -1, int,
          lo=-1, hi=1 << 30, substrate_sensitive=True, env_minimum=-1,
          description=(
              "Fixed host-fast-path row ceiling; -1 = route from the "
              "measured per-analyzer-class crossover, 0 = always device."
          )),
        k("coalesce_max_width", "DEEQU_TPU_COALESCE_MAX_WIDTH", 16, int,
          lo=1, hi=1024, substrate_sensitive=True, env_minimum=1,
          description="Max sessions stacked into one coalesced device launch."),
        # -- CrossoverRouter seeds (internal: the router's EWMAs refine
        # them from live folds) --------------------------------------------
        k("router_host_rows_per_s", None, 20e6, float,
          lo=1e3, hi=1e12, substrate_sensitive=True,
          description=(
              "Seed host-kernel rows/s per analyzer class before any "
              "fold is measured (seeded LOW deliberately)."
          )),
        k("router_device_fixed_s", None, 0.02, float,
          lo=1e-6, hi=10.0, substrate_sensitive=True,
          description=(
              "Seed fixed seconds per device launch+fetch before any "
              "coalesced launch is measured."
          )),
        k("router_device_rows_per_s", None, 100e6, float,
          lo=1e3, hi=1e13, substrate_sensitive=True,
          description="Seed device per-row throughput of the cost model."),
        # -- ingest feed pipeline (ingest/prefetch.py) ---------------------
        k("prefetch_depth", "DEEQU_TPU_PREFETCH_DEPTH", 0, int,
          lo=0, hi=64, substrate_sensitive=True, env_minimum=0,
          description=(
              "Staged batches in the double-buffered host->device feed "
              "pipeline (0 = serial inline)."
          )),
        # -- the mesh's heartbeat (parallel/health.py) ----------------------
        k("shard_heartbeat_s", "DEEQU_TPU_SHARD_HEARTBEAT_S", 5.0, float,
          lo=0.0, hi=3600.0, substrate_sensitive=False,
          description=(
              "Seconds between heartbeat probes of a mesh fold, and each "
              "probe's deadline; <= 0 disables the periodic heartbeat."
          )),
    ]
    return {knob.name: knob for knob in knobs}


REGISTRY: Dict[str, Knob] = _registry()


def value(name: str) -> Any:
    """Resolve one knob: env override > static default."""
    from ..utils import env_number

    k = REGISTRY[name]
    if k.env is None:
        return k.static_default
    return env_number(k.env, k.static_default, k.cast, minimum=k.env_minimum)
