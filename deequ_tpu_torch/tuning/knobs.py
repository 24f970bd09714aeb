"""The tunable-knob registry: one audited surface for every routing
constant the hot paths read (the reference's
``deequ_tpu/tuning/knobs.py``, ported whole).

Every knob is a registered :class:`Knob` with

- a **name** (the key the calibrator and the online controller read and
  write through),
- an optional **env var** (the operator override; it always wins, parsed
  with the shared warn-once ``utils.env_number``),
- its **static default** (the value the port runs with when nothing is
  tuned; the frequency engine's come from ``config.py``),
- **bounds** a calibration or a promotion may never leave, and
- a **substrate-sensitivity** flag (whether calibration is expected to
  move it).

Resolution order of :func:`value`: env override > tuned value (only when
``DEEQU_TPU_AUTOTUNE`` is not "0") > static default. With
``DEEQU_TPU_AUTOTUNE=0`` the tuned layer is invisible and every read is
its env override or static default.

Tuned values enter through :func:`set_tuned` only (a substrate profile
applied at service start, ``tuning.profile``, and the controller's
promotions and trials, ``tuning.controller``) and are clamped to the
knob's bounds. The layer is process-global: tests clear it.

One static default differs from the reference's on purpose:
``prefetch_depth`` is 0, the serial loop (the reference's is 2).
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional

from ..config import (
    AUTOTUNE_ENV,
    DEFAULT_FREQ_BUFFER_ENTRIES,
    DEFAULT_FREQ_TABLE_SLOTS,
    DEVICE_FREQ_MAX_CARDINALITY,
    FREQ_HOST_ROUTE_MAX_DISTINCT,
    FREQ_HOST_ROUTE_MIN_ROWS,
    FREQ_PROBE_ROWS,
    TUNING_BAND_ENV,
    TUNING_MIN_SAMPLES_ENV,
    TUNING_PROFILE_DIR_ENV,  # noqa: F401 - re-exported, as the reference defines it here
    TUNING_SHADOW_FRACTION_ENV,
)

DEFAULT_TUNING_SHADOW_FRACTION = 0.05
DEFAULT_TUNING_MIN_SAMPLES = 32
DEFAULT_TUNING_BAND = 0.25


def autotune_enabled() -> bool:
    from ..utils import env_flag

    return env_flag(AUTOTUNE_ENV, True)


def shadow_fraction() -> float:
    from ..utils import env_number

    fraction = env_number(TUNING_SHADOW_FRACTION_ENV, DEFAULT_TUNING_SHADOW_FRACTION, float,
                          minimum=0.0)
    return min(fraction, 0.5)  # the incumbent keeps the majority of the folds


def tuning_min_samples() -> int:
    from ..utils import env_number

    return env_number(TUNING_MIN_SAMPLES_ENV, DEFAULT_TUNING_MIN_SAMPLES, int, minimum=1)


def tuning_band() -> float:
    from ..utils import env_number

    return env_number(TUNING_BAND_ENV, DEFAULT_TUNING_BAND, float, minimum=0.0)


@dataclass(frozen=True)
class Knob:
    """One registered tunable: its audit record and parse semantics."""

    name: str                    #: registry key
    env: Optional[str]           #: operator env override (None = internal)
    static_default: Any          #: the value when nothing is tuned
    cast: Callable               #: int or float
    lo: Any                      #: tuned-value clamp floor
    hi: Any                      #: tuned-value clamp ceiling
    substrate_sensitive: bool    #: does calibration expect to move it?
    description: str             #: what the knob governs (audit surface)
    #: minimum the env parser enforces (warn-once + fallback below it);
    #: kept apart from ``lo``: fast_path_max_rows' env accepts -1
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
          description=(
              "Max sessions stacked into one coalesced device launch "
              "(pow2-bucketed widths)."
          )),
        k("fleet_stream_min_rows", "DEEQU_TPU_FLEET_STREAM_MIN_ROWS",
          65536, int, lo=0, hi=1 << 30, substrate_sensitive=True,
          env_minimum=0,
          description=(
              "Minimum micro-batch rows before a streaming fold shards "
              "over the tenant's fleet sub-mesh."
          )),
        # -- ingest feed pipeline (ingest/prefetch.py) ---------------------
        k("prefetch_depth", "DEEQU_TPU_PREFETCH_DEPTH", 0, int,
          lo=0, hi=64, substrate_sensitive=True, env_minimum=0,
          description=(
              "Staged batches in the host->device feed pipeline (0 = "
              "serial inline, the default: depth 2 measured 28% slower "
              "on the H100's column profile and no faster on a "
              "verification pass)."
          )),
        # -- device frequency engine (runners/analysis_runner.py) ----------
        k("freq_table_slots", "DEEQU_TPU_FREQ_TABLE_SLOTS",
          DEFAULT_FREQ_TABLE_SLOTS, int,
          lo=1 << 10, hi=1 << 26, substrate_sensitive=True, env_minimum=1,
          description=(
              "Distinct-group capacity per device frequency table "
              "(pow2-rounded)."
          )),
        k("freq_buffer_entries", "DEEQU_TPU_FREQ_BUFFER_ENTRIES",
          DEFAULT_FREQ_BUFFER_ENTRIES, int, lo=1 << 16, hi=1 << 28,
          substrate_sensitive=True, env_minimum=1,
          description=(
              "Raw u64 key-buffer cap; runs fitting it ride the resident "
              "compaction-free table."
          )),
        k("device_freq_max_cardinality",
          "DEEQU_TPU_DEVICE_FREQ_MAX_CARDINALITY", DEVICE_FREQ_MAX_CARDINALITY, int,
          lo=1 << 8, hi=1 << 22, substrate_sensitive=True, env_minimum=1,
          description=(
              "Dictionary-size ceiling of the dense per-code device "
              "counting path."
          )),
        # -- grouping host-route probe (probably_low_cardinality) ----------
        k("freq_host_route_max_distinct",
          "DEEQU_TPU_FREQ_HOST_ROUTE_MAX_DISTINCT", FREQ_HOST_ROUTE_MAX_DISTINCT, int,
          lo=1 << 6, hi=1 << 22, substrate_sensitive=True, env_minimum=1,
          description=(
              "Union-distinct ceiling for confidently routing a grouping "
              "set to the host group-by instead of the device table."
          )),
        k("freq_probe_rows", "DEEQU_TPU_FREQ_PROBE_ROWS", FREQ_PROBE_ROWS, int,
          lo=1 << 10, hi=1 << 22, substrate_sensitive=False, env_minimum=1,
          description=(
              "Rows per head/mid/tail slice of the cardinality "
              "pre-routing probe."
          )),
        k("freq_host_route_min_rows",
          "DEEQU_TPU_FREQ_HOST_ROUTE_MIN_ROWS", FREQ_HOST_ROUTE_MIN_ROWS, int,
          lo=0, hi=1 << 30, substrate_sensitive=True, env_minimum=0,
          description=(
              "Row floor at or below which the probe never answers host: "
              "the engines' absolute cost gap only pays at scale."
          )),
        # -- CrossoverRouter seeds (internal: the router's EWMAs refine
        # them from live folds, calibration replaces them) -----------------
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
    ]
    return {knob.name: knob for knob in knobs}


REGISTRY: Dict[str, Knob] = _registry()

#: the process-global tuned layer (profile application and controller
#: promotions); value() reads race controller writes, hence the lock
_TUNED_LOCK = threading.Lock()
_TUNED: Dict[str, Any] = {}
_TUNED_SOURCE: Dict[str, str] = {}


def knob(name: str) -> Knob:
    return REGISTRY[name]


def static_value(name: str) -> Any:
    return REGISTRY[name].static_default


def value(name: str) -> Any:
    """Resolve one knob: env override > tuned (autotune on) > static."""
    from ..utils import env_number

    k = REGISTRY[name]
    fallback = k.static_default
    if autotune_enabled():
        with _TUNED_LOCK:
            tuned = _TUNED.get(name)
        if tuned is not None:
            fallback = tuned
    if k.env is None:
        return fallback
    return env_number(k.env, fallback, k.cast, minimum=k.env_minimum)


def set_tuned(name: str, new_value: Any, source: str = "controller") -> Any:
    """Install a tuned value, clamped to the knob's bounds; returns the
    value installed. Raises KeyError for an unregistered name."""
    k = REGISTRY[name]
    clamped = min(max(k.cast(new_value), k.lo), k.hi)
    with _TUNED_LOCK:
        _TUNED[name] = clamped
        _TUNED_SOURCE[name] = source
    return clamped


def clear_tuned(name: Optional[str] = None) -> None:
    """Drop one tuned value (back to static), or all of them."""
    with _TUNED_LOCK:
        if name is None:
            _TUNED.clear()
            _TUNED_SOURCE.clear()
        else:
            _TUNED.pop(name, None)
            _TUNED_SOURCE.pop(name, None)


def any_tuned() -> bool:
    """Cheap per-fold predicate for the controller's hot path."""
    with _TUNED_LOCK:
        return bool(_TUNED)


def tuned_snapshot() -> Dict[str, Dict[str, Any]]:
    """{name: {value, source, static}} for every tuned knob."""
    with _TUNED_LOCK:
        return {
            name: {
                "value": v,
                "source": _TUNED_SOURCE.get(name, "?"),
                "static": REGISTRY[name].static_default,
            }
            for name, v in _TUNED.items()
        }
