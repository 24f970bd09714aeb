"""/statusz: ONE versioned ops snapshot of every service plane.

The service tier is six interacting planes (scheduler, tuning, cluster,
catalog, fleetwatch, partition store); debugging it one counter at a time
means six mental joins. ``/statusz`` (the borgmon tradition) serves a
single schema-checked JSON document that snapshots all of them at once,
so harnesses assert their invariants against THIS document instead of
reaching into internals (a copy of the JAX package's module; the port's
service reports its own planes, and says which it has not taken yet).

Contract:

- ``statusz_version`` is a monotonically bumped schema version; consumers
  gate on it before parsing deeper.
- ``planes`` holds one object per registered plane. A plane whose
  snapshot callable raises degrades to ``{"error": ...}`` — a sick plane
  must not take down the snapshot that would diagnose it — and
  :func:`validate_statusz` reports it.
- :data:`REQUIRED_PLANES` is the closed set every full service exposes;
  :func:`validate_statusz` checks presence, shape, and the per-plane
  required keys in :data:`PLANE_REQUIRED_KEYS`.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Callable, Dict, List

#: bump on ANY backwards-incompatible change to the document shape or the
#: per-plane required keys (consumers gate on it before parsing deeper)
STATUSZ_VERSION = 1

#: every full service exposes exactly these planes (a worker that is not
#: cluster-attached still reports ``cluster: {"attached": false}``)
REQUIRED_PLANES = (
    "scheduler", "tuning", "cluster", "catalog", "fleetwatch",
    "partition_store",
)

#: keys each plane's section must carry — the "schema-checked" part of the
#: contract, kept deliberately shallow: presence + type of the load-bearing
#: fields, not the full value space
PLANE_REQUIRED_KEYS: Dict[str, tuple] = {
    "scheduler": ("queue_depth", "active_jobs", "shed_total",
                  "quota_shed_total"),
    "tuning": ("enabled",),
    "cluster": ("attached",),
    "catalog": ("enabled",),
    "fleetwatch": ("quarantined_sessions", "watched_series"),
    "partition_store": ("attached",),
}


class StatuszRegistry:
    """Plane name -> snapshot callable. ``snapshot()`` assembles the one
    document; registration is idempotent last-wins (a cluster worker
    overwrites the default detached ``cluster`` section with its own
    membership view)."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._sections: Dict[str, Callable[[], Dict[str, Any]]] = {}

    def register(
        self, plane: str, fn: Callable[[], Dict[str, Any]]
    ) -> None:
        with self._lock:
            self._sections[plane] = fn

    def planes(self) -> List[str]:
        with self._lock:
            return sorted(self._sections)

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            sections = sorted(self._sections.items())
        planes: Dict[str, Any] = {}
        for plane, fn in sections:
            try:
                planes[plane] = fn()
            except Exception as exc:  # noqa: BLE001 - a sick plane must
                # not take down the snapshot that would diagnose it
                planes[plane] = {
                    "error": f"{type(exc).__name__}: {exc}"[:500]
                }
        return {
            "statusz_version": STATUSZ_VERSION,
            "generated_unix_s": time.time(),
            "planes": planes,
        }


def validate_statusz(doc: Any) -> List[str]:
    """Schema check; returns the list of problems ([] = valid). Harnesses
    assert this comes back empty, so every required plane must be present,
    healthy (no ``error`` key), and carrying its required fields."""
    problems: List[str] = []
    if not isinstance(doc, dict):
        return [f"document is {type(doc).__name__}, expected object"]
    version = doc.get("statusz_version")
    if version != STATUSZ_VERSION:
        problems.append(
            f"statusz_version is {version!r}, expected {STATUSZ_VERSION}"
        )
    if not isinstance(doc.get("generated_unix_s"), (int, float)):
        problems.append("generated_unix_s missing or not a number")
    planes = doc.get("planes")
    if not isinstance(planes, dict):
        return problems + ["planes missing or not an object"]
    for plane in REQUIRED_PLANES:
        section = planes.get(plane)
        if not isinstance(section, dict):
            problems.append(f"plane {plane!r} missing or not an object")
            continue
        if "error" in section:
            problems.append(f"plane {plane!r} errored: {section['error']}")
            continue
        for key in PLANE_REQUIRED_KEYS.get(plane, ()):
            if key not in section:
                problems.append(f"plane {plane!r} missing key {key!r}")
    return problems
