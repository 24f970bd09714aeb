"""xxHash64 (seed 42) — the hash the reference feeds its HLL++ registers
(reference `analyzers/catalyst/StatefulHyperloglogPlus.scala:89-115`, which
uses Spark's XxHash64 with seed 42).

The 8-byte fixed-width path (longs / doubles) is fully vectorized in numpy
uint64 modular arithmetic; variable-length strings are hashed in one pass
by the native library (``deequ_tpu_torch/native``), which the tests hold
to its Python twin :func:`xxhash64_strings_plain`; dictionary columns
hash each DISTINCT value once per dataset (see
``runners/features.dict_entry_hashes``).
"""

from __future__ import annotations

import struct

import numpy as np

_P1 = np.uint64(11400714785074694791)
_P2 = np.uint64(14029467366897019727)
_P3 = np.uint64(1609587929392839161)
_P4 = np.uint64(9650029242287828579)
_P5 = np.uint64(2870177450012600261)

_MASK = (1 << 64) - 1
DEFAULT_SEED = 42


def _rotl(x: np.ndarray, r: int) -> np.ndarray:
    r = np.uint64(r)
    return (x << r) | (x >> (np.uint64(64) - r))


def xxhash64_u64(values: np.ndarray, seed=DEFAULT_SEED) -> np.ndarray:
    """Vectorized xxHash64 of 8-byte little-endian inputs (one u64 per row).
    ``seed`` may be a scalar or a per-row u64 array (broadcast)."""
    values = np.ascontiguousarray(values, dtype=np.uint64)
    with np.errstate(over="ignore"):
        h = np.asarray(seed, dtype=np.uint64) + _P5 + np.uint64(8)
        k = _rotl(values * _P2, 31) * _P1
        h = h ^ k
        h = _rotl(h, 27) * _P1 + _P4
        # avalanche
        h ^= h >> np.uint64(33)
        h *= _P2
        h ^= h >> np.uint64(29)
        h *= _P3
        h ^= h >> np.uint64(32)
    return h


def _rotl_i(x: int, r: int) -> int:
    return ((x << r) | (x >> (64 - r))) & _MASK


def xxhash64_bytes(data: bytes, seed: int = DEFAULT_SEED) -> int:
    """Scalar xxHash64 over arbitrary bytes (reference algorithm, public spec)."""
    p1, p2, p3, p4, p5 = (int(_P1), int(_P2), int(_P3), int(_P4), int(_P5))
    n = len(data)
    i = 0
    if n >= 32:
        v1 = (seed + p1 + p2) & _MASK
        v2 = (seed + p2) & _MASK
        v3 = seed & _MASK
        v4 = (seed - p1) & _MASK
        while i + 32 <= n:
            for vi in range(4):
                (lane,) = struct.unpack_from("<Q", data, i + 8 * vi)
                v = (v1, v2, v3, v4)[vi]
                v = (_rotl_i((v + lane * p2) & _MASK, 31) * p1) & _MASK
                if vi == 0:
                    v1 = v
                elif vi == 1:
                    v2 = v
                elif vi == 2:
                    v3 = v
                else:
                    v4 = v
            i += 32
        h = (_rotl_i(v1, 1) + _rotl_i(v2, 7) + _rotl_i(v3, 12) + _rotl_i(v4, 18)) & _MASK
        for v in (v1, v2, v3, v4):
            k = (_rotl_i((v * p2) & _MASK, 31) * p1) & _MASK
            h = ((h ^ k) * p1 + p4) & _MASK
    else:
        h = (seed + p5) & _MASK
    h = (h + n) & _MASK
    while i + 8 <= n:
        (lane,) = struct.unpack_from("<Q", data, i)
        k = (_rotl_i((lane * p2) & _MASK, 31) * p1) & _MASK
        h = ((_rotl_i(h ^ k, 27) * p1) + p4) & _MASK
        i += 8
    if i + 4 <= n:
        (lane,) = struct.unpack_from("<I", data, i)
        h = ((_rotl_i(h ^ ((lane * p1) & _MASK), 23) * p2) + p3) & _MASK
        i += 4
    while i < n:
        h = (_rotl_i(h ^ ((data[i] * p5) & _MASK), 11) * p1) & _MASK
        i += 1
    h ^= h >> 33
    h = (h * p2) & _MASK
    h ^= h >> 29
    h = (h * p3) & _MASK
    h ^= h >> 32
    return h


def as_object_array(values) -> np.ndarray:
    """Materialize a possibly-arrow string source into an object array —
    the SINGLE null-preserving arrow→object conversion shared by every
    python string path (hashing here; lengths and regexes in
    runners.features import it)."""
    if isinstance(values, np.ndarray):
        return values
    vals = values.to_numpy(zero_copy_only=False)
    return vals if vals.dtype == object else vals.astype(object)


def xxhash64_strings(values, seed: int = DEFAULT_SEED) -> np.ndarray:
    """xxHash64 of a numpy object array of str/None or of a pyarrow string
    array, by the native batch hash (one C++ pass over Arrow buffers).
    Nulls hash to the seed constant (they are masked out downstream
    anyway)."""
    from ..native import native_xxhash64_strings

    return native_xxhash64_strings(values, seed)


def xxhash64_strings_plain(values, seed: int = DEFAULT_SEED) -> np.ndarray:
    """:func:`xxhash64_strings` one value at a time in Python."""
    # arrow input (e.g. a lazily-kept dictionary payload): materialize to
    # python objects first — iterating the arrow array directly yields pa
    # scalars whose nulls fail the `v is None` check and stringify to
    # "None", hashing as that literal instead of the seed
    values = as_object_array(values)
    out = np.empty(len(values), dtype=np.uint64)
    for idx, v in enumerate(values):
        if v is None:
            out[idx] = seed
        else:
            out[idx] = xxhash64_bytes(str(v).encode("utf-8"), seed)
    return out


def hash_column(values: np.ndarray, mask: np.ndarray, kind, seed: int = DEFAULT_SEED) -> np.ndarray:
    """Hash a column to u64, matching Spark's per-type byte layout:
    integrals as int64 LE, fractionals as IEEE754 double bits (with -0.0
    normalized to 0.0), booleans as int64 0/1, strings as UTF-8 bytes."""
    from ..data import ColumnKind

    if kind == ColumnKind.STRING:
        return xxhash64_strings(values, seed)
    if kind == ColumnKind.BOOLEAN:
        as_u64 = values.astype(np.int64).view(np.uint64)
        return xxhash64_u64(as_u64, seed)
    if kind == ColumnKind.INTEGRAL:
        return xxhash64_u64(values.astype(np.int64).view(np.uint64), seed)
    # fractional: double bits, normalize -0.0 and NaN. Java's
    # Double.doubleToLongBits (what Spark's XxHash64 hashes) collapses
    # every NaN payload to the canonical quiet NaN.
    vals = values.astype(np.float64, copy=True)
    vals[vals == 0.0] = 0.0  # -0.0 -> 0.0
    vals[np.isnan(vals)] = np.nan
    vals[~mask] = 0.0
    return xxhash64_u64(vals.view(np.uint64), seed)


# ---------------------------------------------------------------------------
# Frequency keys: the device frequency table's 64-bit group keys (kernel
# ``freq_keys``). PyTorch has few uint64 operations, so the tensor versions
# below work on int64 tensors holding the uint64 bit patterns: int64 adds
# and multiplies wrap modulo 2^64 exactly as uint64 ones do, and a logical
# right shift is an arithmetic one with the sign-extended bits masked off.
# ---------------------------------------------------------------------------

#: the key reserved for masked-out and null rows: it sorts after every real
#: key in unsigned order, so compactions and drains drop it. Real keys equal
#: to it are counted in the state's ``sent_rows`` instead.
FREQ_KEY_SENTINEL = 0xFFFFFFFFFFFFFFFF
#: the same bits as an int64
FREQ_KEY_SENTINEL_I64 = -1

_SM1 = 0xBF58476D1CE4E5B9
_SM2 = 0x94D049BB133111EB


def _i64(c: int) -> int:
    """A uint64 constant as the int64 with the same bits."""
    return c - (1 << 64) if c >= 1 << 63 else c


def _lsr(x, s: int):
    """Logical right shift of int64 bit patterns."""
    return (x >> s) & ((1 << (64 - s)) - 1)


def _rotl64(x, r: int):
    return (x << r) | _lsr(x, 64 - r)


def splitmix64(v: np.ndarray) -> np.ndarray:
    """SplitMix64 finalizer over uint64 (a bijection): integral and
    boolean grouping columns derive their frequency keys through it, so a
    single-column key never collides."""
    v = np.ascontiguousarray(v, dtype=np.uint64)
    with np.errstate(over="ignore"):
        v = v ^ (v >> np.uint64(30))
        v = v * np.uint64(_SM1)
        v = v ^ (v >> np.uint64(27))
        v = v * np.uint64(_SM2)
        v = v ^ (v >> np.uint64(31))
    return v


def splitmix64_torch(v):
    """:func:`splitmix64` on an int64 tensor of uint64 bit patterns."""
    v = v ^ _lsr(v, 30)
    v = v * _i64(_SM1)
    v = v ^ _lsr(v, 27)
    v = v * _i64(_SM2)
    return v ^ _lsr(v, 31)


def xxhash64_u64_torch(values, seed):
    """:func:`xxhash64_u64` on int64 tensors of uint64 bit patterns.
    ``seed`` is an int or a per-row tensor: several grouping columns chain
    their key by seeding each column's hash with the key so far (Spark's
    ``XxHash64`` over several columns), so a combined key depends on every
    column and on their order."""
    p1, p2, p3, p4 = (_i64(int(p)) for p in (_P1, _P2, _P3, _P4))
    if isinstance(seed, int):
        h = _i64((seed + int(_P5) + 8) & _MASK)
    else:
        h = seed + _i64(int(_P5) + 8)
    k = _rotl64(values * p2, 31) * p1
    h = h ^ k
    h = _rotl64(h, 27) * p1 + p4
    h = h ^ _lsr(h, 33)
    h = h * p2
    h = h ^ _lsr(h, 29)
    h = h * p3
    return h ^ _lsr(h, 32)
