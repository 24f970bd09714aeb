"""Content checksums for persisted payloads (state blobs, metrics-history
entries), verified on load.

A copy of the JAX package's ``deequ_tpu/integrity.py``: the digest must be
the reference's bit for bit, since a blob written by either package is
verified by the other. Checksums are 16 lowercase hex chars of an xxhash64
digest (seed ``0x5EED``). Payloads under 1 KiB hash through the canonical
scalar xxhash64; larger ones through a vectorised construction over the
same primitive: the payload's little-endian u64 words are position-tagged
(``word ^ index * prime``), hashed per word with the numpy ``xxhash64_u64``,
XOR-combined, and finalised with a scalar xxhash64 over (combined, byte
tail, length). A mismatch raises :class:`CorruptStateError` and is logged
(the reference also flight-records it; that plane is not ported).
"""

from __future__ import annotations

import json
import logging
from typing import Any, Dict

import numpy as np

from .exceptions import CorruptStateError
from .ops.hashing import xxhash64_bytes, xxhash64_u64

#: seed distinguishing integrity checksums from the HLL row-hash domain
CHECKSUM_SEED = 0x5EED

#: payloads below this size hash through the canonical scalar xxhash64
_VECTOR_THRESHOLD = 1 << 10

#: position-tag multiplier for the block checksum (xxhash64's prime 1)
_POS_PRIME = np.uint64(11400714785074694791)

_logger = logging.getLogger(__name__)

#: warn-once latches per payload family
_LEGACY_WARNED: Dict[str, bool] = {}


def warn_once_unchecksummed(kind: str, source: str) -> None:
    """Log (once per process per ``kind``) that a legacy payload without a
    content checksum was loaded unverified."""
    if not _LEGACY_WARNED.get(kind):
        _LEGACY_WARNED[kind] = True
        _logger.warning(
            "loading legacy %s without a content checksum (first seen: %s); "
            "integrity verification is skipped for unchecksummed payloads — "
            "re-persist to upgrade them",
            kind, source,
        )


def checksum_bytes(payload) -> str:
    """Content checksum of raw bytes (or any buffer-protocol object, hashed
    in place), as 16 hex chars."""
    n = len(payload)
    if n < _VECTOR_THRESHOLD:
        if not isinstance(payload, bytes):
            payload = bytes(payload)
        return f"{xxhash64_bytes(payload, CHECKSUM_SEED):016x}"
    words = np.frombuffer(payload, dtype="<u8", count=n // 8)
    with np.errstate(over="ignore"):
        tagged = words ^ (np.arange(words.size, dtype=np.uint64) * _POS_PRIME)
        combined = np.bitwise_xor.reduce(xxhash64_u64(tagged, CHECKSUM_SEED))
    tail = bytes(memoryview(payload)[(n // 8) * 8:])
    final = xxhash64_bytes(
        int(combined).to_bytes(8, "little") + tail + n.to_bytes(8, "little"),
        CHECKSUM_SEED,
    )
    return f"{final:016x}"


def checksum_json(obj: Dict[str, Any]) -> str:
    """Checksum of a JSON-able dict under a canonical encoding (sorted keys,
    no whitespace)."""
    return checksum_bytes(
        json.dumps(obj, sort_keys=True, separators=(",", ":")).encode("utf-8")
    )


def _raise_corrupt(kind: str, source: str, detail: str) -> None:
    exc = CorruptStateError(kind, source, detail)
    _logger.error("integrity check failed: %s", exc)
    raise exc


def verify_checksum(payload: bytes, expected: str, kind: str, source: str) -> None:
    """Raise :class:`CorruptStateError` unless ``payload`` hashes to
    ``expected``."""
    actual = checksum_bytes(payload)
    if actual != str(expected):
        _raise_corrupt(kind, source, f"checksum mismatch (stored {expected}, computed {actual})")


def verify_json_checksum(obj: Dict[str, Any], expected: str, kind: str, source: str) -> None:
    actual = checksum_json(obj)
    if actual != str(expected):
        _raise_corrupt(kind, source, f"checksum mismatch (stored {expected}, computed {actual})")
