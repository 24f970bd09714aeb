"""ctypes bindings for the native host kernels (``src/host_kernels.cpp``).

Object arrays of Python strings are converted once per call to Arrow
large-string layout (one UTF-8 buffer and int64 offsets, a C-speed
conversion through pyarrow), then each kernel runs one C++ pass over the
buffers. The library builds and loads at the first call (``build.py``);
a build or load failure raises.

``DEEQU_TPU_NO_NATIVE=1``, read when this module is imported, routes
every export to its numpy version in ``plain.py`` (equal bit for bit, and
slow) and :func:`load` refuses: the reference's switch, whose Python
fallbacks compute the same values.
"""

from __future__ import annotations

import ctypes
import re
import threading
from typing import Dict, Optional

import numpy as np
import pyarrow as pa

from ..utils import env_flag
from . import build

#: set to 1 to run every host kernel's numpy version instead of the library
NO_NATIVE_ENV = "DEEQU_TPU_NO_NATIVE"
NATIVE_DISABLED = env_flag(NO_NATIVE_ENV, False)

#: the library's exports, each with a numpy twin ``<name>_plain`` in plain.py
EXPORTS = (
    "native_xxhash64_strings", "native_classify_types", "native_string_lengths",
    "native_hll_pack_numeric", "native_hll_pack_strings", "native_block_stats",
    "native_block_comoments", "native_block_hll", "native_block_hll_strings",
    "native_block_kll_sample", "native_dict_masked_bincount", "native_block_kll_pick",
    "native_pattern_match", "native_u64_value_counts",
)

_u8p = ctypes.POINTER(ctypes.c_uint8)
_i64p = ctypes.POINTER(ctypes.c_int64)
_u64p = ctypes.POINTER(ctypes.c_uint64)
_i32p = ctypes.POINTER(ctypes.c_int32)
_u16p = ctypes.POINTER(ctypes.c_uint16)
_f64p = ctypes.POINTER(ctypes.c_double)
_f32p = ctypes.POINTER(ctypes.c_float)

_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None


def _bind(lib: ctypes.CDLL) -> None:
    lib.xxhash64_batch.argtypes = [_u8p, _i64p, _u8p, ctypes.c_int64, ctypes.c_uint64, _u64p]
    lib.classify_types_batch.argtypes = [_u8p, _i64p, _u8p, ctypes.c_int64, _i32p]
    lib.string_lengths_batch.argtypes = [_u8p, _i64p, _u8p, ctypes.c_int64, _i32p]
    lib.hll_pack_f64.argtypes = [_f64p, _u8p, ctypes.c_int64, ctypes.c_uint64, _u16p]
    lib.hll_pack_i64.argtypes = [_i64p, _u8p, ctypes.c_int64, ctypes.c_uint64, _u16p]
    lib.hll_pack_strings.argtypes = [_u8p, _i64p, _u8p, ctypes.c_int64, ctypes.c_uint64, _u16p]
    for name, vp in (
        ("block_stats_f64", _f64p), ("block_stats_f32", _f32p),
        ("block_stats_i64", _i64p), ("block_stats_i32", _i32p),
    ):
        getattr(lib, name).argtypes = [vp, _u8p, ctypes.c_int64, _f64p]
    lib.block_comoments_f64.argtypes = [_f64p, _f64p, _u8p, ctypes.c_int64, _f64p]
    lib.block_hll_f64.argtypes = [_f64p, _u8p, ctypes.c_int64, ctypes.c_uint64, _u8p]
    lib.block_hll_i64.argtypes = [_i64p, _u8p, ctypes.c_int64, ctypes.c_uint64, _u8p]
    lib.block_hll_strings.argtypes = [_u8p, _i64p, _u8p, ctypes.c_int64, ctypes.c_uint64, _u8p]
    lib.block_kll_sample_f64.argtypes = [
        _f64p, _u8p, ctypes.c_int64, ctypes.c_int32, ctypes.c_uint32, _f64p, _i64p, _f64p,
    ]
    lib.dict_masked_bincount.argtypes = [_i32p, _u8p, ctypes.c_int64, ctypes.c_int64, _i64p]
    for name, vp in (("block_kll_pick_f64", _f64p), ("block_kll_pick_i64", _i64p)):
        getattr(lib, name).argtypes = [
            vp, _u8p, ctypes.c_int64, ctypes.c_int32, ctypes.c_uint32, ctypes.c_int64,
            _f64p, _i64p,
        ]
    lib.pattern_match_batch.argtypes = [_u8p, _i64p, _u8p, ctypes.c_int64, ctypes.c_char_p, _u8p]
    lib.pattern_match_batch.restype = ctypes.c_int
    lib.u64_value_counts.argtypes = [_u64p, _i64p, ctypes.c_int64, _u64p, _i64p]
    lib.u64_value_counts.restype = ctypes.c_int64


def load() -> ctypes.CDLL:
    """The loaded library, built first if needed."""
    global _LIB
    if NATIVE_DISABLED:
        raise ImportError(f"native kernels disabled via {NO_NATIVE_ENV}")
    with _LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(build.build())
            _bind(lib)
            _LIB = lib
        return _LIB


#: how pattern matches ran since the last reset: "pcre2" (the library's
#: PCRE2 matcher) or "re" (Python's, when libpcre2-8 cannot be loaded or
#: refuses the pattern)
_PATTERN_ROUTES: Dict[str, int] = {"pcre2": 0, "re": 0}


def pattern_routes() -> Dict[str, int]:
    with _LOCK:
        return dict(_PATTERN_ROUTES)


def reset_pattern_routes() -> None:
    with _LOCK:
        for key in _PATTERN_ROUTES:
            _PATTERN_ROUTES[key] = 0


def _count_route(route: str) -> None:
    with _LOCK:
        _PATTERN_ROUTES[route] += 1


def _arrow_layout(values):
    """(data u8[:], offsets i64[n+1], valid u8[n]) from an object array of
    str/None or from a pyarrow string array (no Python objects made)."""
    if isinstance(values, pa.Array):
        arr = values
        if not pa.types.is_large_string(arr.type):
            arr = arr.cast(pa.large_string())  # widens offsets only
    else:
        arr = pa.array(values, type=pa.large_string(), from_pandas=True)
    buffers = arr.buffers()  # [validity, offsets, data]
    n = len(arr)
    offsets = np.frombuffer(buffers[1], dtype=np.int64, count=n + 1 + arr.offset)
    if arr.offset:
        offsets = offsets[arr.offset:]
    data_buf = buffers[2]
    data = (
        np.frombuffer(data_buf, dtype=np.uint8)
        if data_buf is not None and len(data_buf) > 0
        else np.zeros(1, dtype=np.uint8)
    )
    if arr.null_count:
        valid = np.asarray(arr.is_valid()).astype(np.uint8)
    else:
        valid = np.ones(n, dtype=np.uint8)
    return data, np.ascontiguousarray(offsets), valid


def _ptr(arr: np.ndarray, ctype):
    return arr.ctypes.data_as(ctype)


def _mask_u8(mask):
    if mask is None:
        return None, None
    m = np.ascontiguousarray(mask, dtype=np.uint8)
    return m, _ptr(m, _u8p)


def native_xxhash64_strings(values, seed: int) -> np.ndarray:
    """xxHash64 of each string; nulls hash to ``seed``."""
    lib = load()
    data, offsets, valid = _arrow_layout(values)
    n = len(values)
    out = np.empty(n, dtype=np.uint64)
    lib.xxhash64_batch(
        _ptr(data, _u8p), _ptr(offsets, _i64p), _ptr(valid, _u8p),
        n, ctypes.c_uint64(seed), _ptr(out, _u64p),
    )
    return out


def native_classify_types(values, mask: np.ndarray) -> np.ndarray:
    """int32 type class 0..4 of each string (null or masked: 0)."""
    lib = load()
    data, offsets, valid = _arrow_layout(values)
    valid = valid & np.asarray(mask, dtype=np.uint8)
    n = len(values)
    out = np.empty(n, dtype=np.int32)
    lib.classify_types_batch(
        _ptr(data, _u8p), _ptr(offsets, _i64p), _ptr(valid, _u8p), n, _ptr(out, _i32p)
    )
    return out


def native_string_lengths(values, mask: np.ndarray) -> np.ndarray:
    """int32 code-point length of each string (null or masked: 0)."""
    lib = load()
    data, offsets, valid = _arrow_layout(values)
    valid = valid & np.asarray(mask, dtype=np.uint8)
    n = len(values)
    out = np.empty(n, dtype=np.int32)
    lib.string_lengths_batch(
        _ptr(data, _u8p), _ptr(offsets, _i64p), _ptr(valid, _u8p), n, _ptr(out, _i32p)
    )
    return out


def native_hll_pack_numeric(values: np.ndarray, mask, seed: int) -> np.ndarray:
    """uint16 ``(idx << 6) | pw`` HLL feature per row of a numeric array;
    masked rows give 0. Floats hash as IEEE754 bits (-0.0 as 0.0), other
    numbers as int64."""
    lib = load()
    n = len(values)
    out = np.empty(n, dtype=np.uint16)
    _m, vp = _mask_u8(mask)
    if np.issubdtype(values.dtype, np.floating):
        vals = np.ascontiguousarray(values, dtype=np.float64)
        lib.hll_pack_f64(_ptr(vals, _f64p), vp, n, ctypes.c_uint64(seed), _ptr(out, _u16p))
    else:
        vals = np.ascontiguousarray(values, dtype=np.int64)
        lib.hll_pack_i64(_ptr(vals, _i64p), vp, n, ctypes.c_uint64(seed), _ptr(out, _u16p))
    return out


def native_hll_pack_strings(values, mask, seed: int) -> np.ndarray:
    lib = load()
    data, offsets, valid = _arrow_layout(values)
    if mask is not None:
        valid = valid & np.asarray(mask, dtype=np.uint8)
    n = len(values)
    out = np.empty(n, dtype=np.uint16)
    lib.hll_pack_strings(
        _ptr(data, _u8p), _ptr(offsets, _i64p), _ptr(valid, _u8p),
        n, ctypes.c_uint64(seed), _ptr(out, _u16p),
    )
    return out


# -- block partials (the host ingest tier) -----------------------------------

_BLOCK_STATS = {
    np.dtype(np.float64): ("block_stats_f64", _f64p),
    np.dtype(np.float32): ("block_stats_f32", _f32p),
    np.dtype(np.int64): ("block_stats_i64", _i64p),
    np.dtype(np.int32): ("block_stats_i32", _i32p),
}


def native_block_stats(values: np.ndarray, mask) -> np.ndarray:
    """One C pass: ``[count, sum, min, max, m2, nonnan, max_nonnan]`` over
    the masked block. float64, float32, int64 and int32 blocks are read in
    their own dtype; others are cast to float64 first."""
    lib = load()
    entry = _BLOCK_STATS.get(values.dtype)
    if entry is None:
        values = np.ascontiguousarray(values, dtype=np.float64)
        entry = _BLOCK_STATS[values.dtype]
    else:
        values = np.ascontiguousarray(values)
    name, vp = entry
    out = np.empty(7, dtype=np.float64)
    _m, mp = _mask_u8(mask)
    getattr(lib, name)(_ptr(values, vp), mp, len(values), _ptr(out, _f64p))
    return out


def native_block_kll_pick(values: np.ndarray, mask, k: int, tick: int, nv: int):
    """``(items f64[4k] ascending with +inf padding, m, h)``: the KLL
    sampler for callers that already know the non-NaN valid count ``nv``."""
    lib = load()
    k = max(int(k), 1)  # the kernel's clamp
    items = np.full(4 * k, np.inf, dtype=np.float64)
    meta = np.zeros(2, dtype=np.int64)
    _m, mp = _mask_u8(mask)
    if values.dtype == np.int64 and values.flags.c_contiguous:
        lib.block_kll_pick_i64(
            _ptr(values, _i64p), mp, len(values), ctypes.c_int32(k),
            ctypes.c_uint32(tick & 0xFFFFFFFF), ctypes.c_int64(nv),
            _ptr(items, _f64p), _ptr(meta, _i64p),
        )
    else:
        vals = np.ascontiguousarray(values, dtype=np.float64)
        lib.block_kll_pick_f64(
            _ptr(vals, _f64p), mp, len(vals), ctypes.c_int32(k),
            ctypes.c_uint32(tick & 0xFFFFFFFF), ctypes.c_int64(nv),
            _ptr(items, _f64p), _ptr(meta, _i64p),
        )
    m = int(meta[0])
    items[m:] = np.inf
    return items, m, int(meta[1])


def native_block_comoments(x: np.ndarray, y: np.ndarray, mask) -> np.ndarray:
    """``[n, xsum, ysum, ck, xmk, ymk]`` over the jointly masked block."""
    lib = load()
    x = np.ascontiguousarray(x, dtype=np.float64)
    y = np.ascontiguousarray(y, dtype=np.float64)
    out = np.empty(6, dtype=np.float64)
    _m, mp = _mask_u8(mask)
    lib.block_comoments_f64(_ptr(x, _f64p), _ptr(y, _f64p), mp, len(x), _ptr(out, _f64p))
    return out


def native_block_hll(values: np.ndarray, mask, seed: int,
                     regs: Optional[np.ndarray] = None) -> np.ndarray:
    """A uint8[512] HLL register block updated (or made) from numbers."""
    lib = load()
    if regs is None:
        regs = np.zeros(512, dtype=np.uint8)
    _m, mp = _mask_u8(mask)
    if np.issubdtype(values.dtype, np.floating):
        vals = np.ascontiguousarray(values, dtype=np.float64)
        lib.block_hll_f64(_ptr(vals, _f64p), mp, len(vals), ctypes.c_uint64(seed), _ptr(regs, _u8p))
    else:
        vals = np.ascontiguousarray(values, dtype=np.int64)
        lib.block_hll_i64(_ptr(vals, _i64p), mp, len(vals), ctypes.c_uint64(seed), _ptr(regs, _u8p))
    return regs


def native_block_hll_strings(values, mask, seed: int,
                             regs: Optional[np.ndarray] = None) -> np.ndarray:
    lib = load()
    if regs is None:
        regs = np.zeros(512, dtype=np.uint8)
    data, offsets, valid = _arrow_layout(values)
    if mask is not None:
        valid = valid & np.asarray(mask, dtype=np.uint8)
    lib.block_hll_strings(
        _ptr(data, _u8p), _ptr(offsets, _i64p), _ptr(valid, _u8p),
        len(values), ctypes.c_uint64(seed), _ptr(regs, _u8p),
    )
    return regs


def native_block_kll_sample(values: np.ndarray, mask, k: int, tick: int):
    """``(items f64[4k] ascending with +inf padding beyond m, m, h, nv, min,
    max)``; m <= 2k. An empty block gives the identity (0 items, min +inf,
    max -inf)."""
    lib = load()
    k = max(int(k), 1)  # the kernel's clamp
    vals = np.ascontiguousarray(values, dtype=np.float64)
    items = np.full(4 * k, np.inf, dtype=np.float64)
    meta = np.zeros(3, dtype=np.int64)
    minmax = np.zeros(2, dtype=np.float64)
    _m, mp = _mask_u8(mask)
    lib.block_kll_sample_f64(
        _ptr(vals, _f64p), mp, len(vals), ctypes.c_int32(k),
        ctypes.c_uint32(tick & 0xFFFFFFFF),
        _ptr(items, _f64p), _ptr(meta, _i64p), _ptr(minmax, _f64p),
    )
    m, h, nv = int(meta[0]), int(meta[1]), int(meta[2])
    items[m:] = np.inf
    if nv == 0:
        return items, 0, 0, 0, np.inf, -np.inf
    return items, m, h, nv, float(minmax[0]), float(minmax[1])


def native_pattern_match(values, mask, pattern: str) -> np.ndarray:
    """bool[n]: an unanchored, non-empty regex match per row, by PCRE2 over
    the Arrow buffers. When libpcre2-8 cannot be loaded or refuses the
    pattern, Python's ``re`` matches every row instead (the reference's
    semantics); rows PCRE2 cannot judge (invalid UTF-8) are re-checked under
    ``re``. :func:`pattern_routes` counts which route ran."""
    lib = load()
    data, offsets, valid = _arrow_layout(values)
    if mask is not None:
        valid = valid & np.asarray(mask, dtype=np.uint8)
    n = len(valid)
    out = np.zeros(n, dtype=np.uint8)
    rc = lib.pattern_match_batch(
        _ptr(data, _u8p), _ptr(offsets, _i64p), _ptr(valid, _u8p),
        ctypes.c_int64(n), pattern.encode("utf-8"), _ptr(out, _u8p),
    )
    if rc != 0:
        _count_route("re")
        out[:] = 0
        undecided = np.flatnonzero(valid)
    else:
        _count_route("pcre2")
        undecided = np.flatnonzero(out == 2)
    result = out == 1
    compiled = re.compile(pattern) if undecided.size else None
    for i in undecided:
        s = int(offsets[i])
        e = int(offsets[i + 1])
        text = bytes(data[s:e]).decode("utf-8", errors="surrogateescape")
        m = compiled.search(text)
        result[i] = bool(m) and m.group(0) != ""
    return result


def native_u64_value_counts(keys: np.ndarray, weights=None):
    """``(unique keys u64[m], summed weights i64[m])`` over u64 keys, in the
    kernel's partition and probe order; ``weights=None`` counts each key
    once, explicit weights must be positive (0 marks an empty slot). Raises
    ``MemoryError`` when the kernel cannot allocate."""
    lib = load()
    keys = np.ascontiguousarray(keys, dtype=np.uint64)
    n = len(keys)
    out_keys = np.empty(n, dtype=np.uint64)
    out_weights = np.empty(n, dtype=np.int64)
    wp = None
    if weights is not None:
        weights = np.ascontiguousarray(weights, dtype=np.int64)
        wp = _ptr(weights, _i64p)
    m = lib.u64_value_counts(
        _ptr(keys, _u64p), wp, ctypes.c_int64(n),
        _ptr(out_keys, _u64p), _ptr(out_weights, _i64p),
    )
    if m < 0:
        raise MemoryError(f"u64_value_counts could not allocate its tables for {n} keys")
    return out_keys[:m].copy(), out_weights[:m].copy()


def native_dict_masked_bincount(codes: np.ndarray, mask: np.ndarray, num_cats: int) -> np.ndarray:
    """int64[num_cats + 1] count of each dictionary code among masked rows;
    masked-out and out-of-range rows count in the last slot."""
    lib = load()
    codes = np.ascontiguousarray(codes, dtype=np.int32)
    out = np.zeros(int(num_cats) + 1, dtype=np.int64)
    m = np.ascontiguousarray(mask, dtype=np.uint8)
    lib.dict_masked_bincount(
        _ptr(codes, _i32p), _ptr(m, _u8p), len(codes), ctypes.c_int64(int(num_cats)),
        _ptr(out, _i64p),
    )
    return out


def _plain_pattern_match(values, mask, pattern: str) -> np.ndarray:
    from .plain import native_pattern_match_plain

    _count_route("re")
    return native_pattern_match_plain(values, mask, pattern)


if NATIVE_DISABLED:
    from . import plain as _plain

    for _name in EXPORTS:
        globals()[_name] = getattr(_plain, _name + "_plain")
    native_pattern_match = _plain_pattern_match  # noqa: F811
