"""Versioned, checksummed per-substrate calibration profiles (the
reference's ``deequ_tpu/tuning/profile.py``, ported).

A :class:`SubstrateProfile` is what calibration measured on ONE substrate
(backend, device kind, device count, host, engine) and what a cold service
on that substrate loads at start, so that it boots with measured
crossovers instead of the static defaults. Profiles live in one directory
(``DEEQU_TPU_TUNING_PROFILE_DIR``, by default the reference's), one JSON
file per substrate fingerprint, so a shared home directory holds one
profile per substrate without collisions. The record format, the file
names and the xxhash64 checksum are the reference's: a file written by
either package loads in the other at its fingerprint. The ``engine`` field
of the port's key keeps a profile measured by the JAX package on the same
box from booting the port.

The file carries the payload, an xxhash64 content checksum
(:func:`~deequ_tpu_torch.integrity.checksum_bytes`) and a schema version.
A profile that fails its checksum, fails to parse, or carries another
schema version is **quarantined** (moved to ``.quarantine/``, so it can
never poison a later boot) and raises
:class:`~deequ_tpu_torch.exceptions.CorruptStateError`; the service's boot
catches it and runs on static defaults. A profile of another substrate is
absent, not corrupt.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import time
from dataclasses import dataclass, field
from typing import Any, Dict, Optional

from ..config import TUNING_PROFILE_DIR_ENV, DeviceLike
from ..exceptions import CorruptStateError
from ..integrity import checksum_bytes
from . import knobs as _knobs

logger = logging.getLogger(__name__)

#: bump on any incompatible payload change; older files quarantine on load
PROFILE_VERSION = 1


def profile_dir() -> str:
    """``DEEQU_TPU_TUNING_PROFILE_DIR``, or the reference's default: a
    ``deequ_tpu_tuning`` directory beside ``DEEQU_TPU_COMPILE_CACHE``'s."""
    from ..utils import env_str

    configured = env_str(TUNING_PROFILE_DIR_ENV, "")
    if configured:
        return os.path.expanduser(configured)
    cache = env_str("DEEQU_TPU_COMPILE_CACHE", os.path.expanduser("~/.cache/deequ_tpu_xla"))
    return os.path.join(os.path.dirname(os.path.expanduser(cache)) or ".", "deequ_tpu_tuning")


def substrate_key(device: DeviceLike = None) -> Dict[str, Any]:
    """The identity a profile is keyed by, for ``device`` (default
    ``cuda``; without a card that raises unless ``device="cpu"``). The
    host fingerprint is the reference's: two boxes with different core
    counts are different substrates (the host fast path runs on them)."""
    import platform

    import torch

    from ..config import resolve_device

    dev = resolve_device(device)
    if dev.type == "cuda":
        backend, kind, count = "cuda", torch.cuda.get_device_name(dev), torch.cuda.device_count()
    else:
        backend, kind, count = "cpu", "cpu", 1
    return {
        "backend": backend,
        "device_kind": kind,
        "chip_count": count,
        "host": f"{platform.machine()}-{os.cpu_count()}cpu",
        "engine": "torch",
    }


def substrate_fingerprint(key: Optional[Dict[str, Any]] = None,
                          device: DeviceLike = None) -> str:
    payload = json.dumps(key or substrate_key(device), sort_keys=True)
    return checksum_bytes(payload.encode("utf-8"))


@dataclass
class SubstrateProfile:
    """One substrate's measured calibration results."""

    substrate: Dict[str, Any]
    #: raw probe measurements (rates in rows/s, costs in seconds)
    probes: Dict[str, float] = field(default_factory=dict)
    #: derived knob values, name -> value
    knob_values: Dict[str, Any] = field(default_factory=dict)
    created_at: float = 0.0
    calibration_wall_s: float = 0.0
    version: int = PROFILE_VERSION

    @property
    def fingerprint(self) -> str:
        return substrate_fingerprint(self.substrate)

    def to_payload(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    @classmethod
    def from_payload(cls, payload: Dict[str, Any]) -> "SubstrateProfile":
        try:
            profile = cls(**payload)
        except TypeError as exc:
            raise CorruptStateError("tuning profile", "payload",
                                    f"structurally torn: {exc}") from exc
        if profile.version != PROFILE_VERSION:
            raise CorruptStateError(
                "tuning profile", "payload",
                f"schema version {profile.version} != {PROFILE_VERSION} "
                "(stale profile from another build)",
            )
        return profile

    def apply(self, source: str = "profile") -> Dict[str, Any]:
        """Install the knob values into the tuned layer (clamped). Unknown
        names are skipped with a warning: a profile of a newer build must
        not fail the boot. Returns {name: installed value}."""
        applied: Dict[str, Any] = {}
        for name, value in self.knob_values.items():
            if name not in _knobs.REGISTRY:
                logger.warning("tuning profile carries unknown knob %r; skipped", name)
                continue
            applied[name] = _knobs.set_tuned(name, value, source=source)
        return applied


def _profile_path(directory: str, fingerprint: str) -> str:
    return os.path.join(directory, f"profile-{fingerprint}.json")


def save_profile(profile: SubstrateProfile, directory: Optional[str] = None) -> str:
    """Persist atomically (a temporary file, then a replace) under the
    substrate fingerprint; returns the path written."""
    directory = directory or profile_dir()
    os.makedirs(directory, exist_ok=True)
    if not profile.created_at:
        profile.created_at = time.time()
    payload = profile.to_payload()
    body = json.dumps(payload, sort_keys=True)
    record = {"payload": payload, "checksum": checksum_bytes(body.encode("utf-8"))}
    path = _profile_path(directory, profile.fingerprint)
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w", encoding="utf-8") as fh:
        json.dump(record, fh, sort_keys=True, indent=1)
    os.replace(tmp, path)
    return path


def _quarantine(path: str) -> Optional[str]:
    """Move a bad profile into ``.quarantine/`` under a content-addressed
    name (repeat offenders do not pile up); best effort."""
    try:
        with open(path, "rb") as fh:
            digest = checksum_bytes(fh.read())
        qdir = os.path.join(os.path.dirname(path), ".quarantine")
        os.makedirs(qdir, exist_ok=True)
        dest = os.path.join(qdir, f"{digest}-{os.path.basename(path)}")
        os.replace(path, dest)
        return dest
    except OSError:
        return None


def load_profile(directory: Optional[str] = None, fingerprint: Optional[str] = None,
                 device: DeviceLike = None) -> Optional[SubstrateProfile]:
    """Load the profile at ``fingerprint`` (default: the substrate of
    ``device``), verifying its checksum and schema version.

    Returns None when no such profile exists (normal on a fresh box).
    Raises :class:`CorruptStateError` after quarantining a file that
    exists but cannot be trusted."""
    directory = directory or profile_dir()
    fingerprint = fingerprint or substrate_fingerprint(device=device)
    path = _profile_path(directory, fingerprint)
    if not os.path.exists(path):
        return None
    try:
        with open(path, "r", encoding="utf-8") as fh:
            record = json.load(fh)
        payload = record["payload"]
        stored = record["checksum"]
    except (OSError, ValueError, KeyError, TypeError) as exc:
        dest = _quarantine(path)
        raise CorruptStateError("tuning profile", path,
                                f"unreadable ({exc}); quarantined to {dest}") from exc
    body = json.dumps(payload, sort_keys=True)
    actual = checksum_bytes(body.encode("utf-8"))
    if actual != stored:
        dest = _quarantine(path)
        raise CorruptStateError(
            "tuning profile", path,
            f"failed its content checksum (stored {stored}, computed {actual}); "
            f"quarantined to {dest}",
        )
    try:
        return SubstrateProfile.from_payload(payload)
    except CorruptStateError:
        _quarantine(path)
        raise
