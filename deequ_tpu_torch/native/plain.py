"""numpy versions of the native library's exports, one per export of
``lib.py`` under the same name with ``_plain`` appended.

They compute what the C++ computes, in its order, so the library equals
them bit for bit:

- The block reductions keep eight lane accumulators (``BLOCK_STATS_LANES``
  in ``src/host_kernels.cpp``): row ``i`` of the first ``n - n % 8`` rows
  adds into lane ``i % 8``, the rest into lane 0, and the lanes add up in
  order. A lane's min or max is the first of its values that compares
  smallest or largest, which decides the sign of a zero result.
- The library is built with ``-O3 -march=native`` and no ``-ffast-math``,
  so g++ contracts each ``acc += d * d`` of the second-moment passes into a
  fused multiply-add, rounded once: :func:`fma` emulates it exactly.
- The KLL samplers sort with ``qsort``, which glibc runs as a stable merge
  sort; a stable numpy sort gives the same order of -0.0 and +0.0.
- ``u64_value_counts`` returns the keys in the order of the kernel's radix
  partitions and linear-probing tables.

Only the tests call these: they are slow (Python loops over rows and
lanes) and exact.
"""

from __future__ import annotations

from fractions import Fraction
from typing import Optional, Tuple

import numpy as np

LANES = 8
_M32 = 0xFFFFFFFF
_M64 = (1 << 64) - 1


# ---------------------------------------------------------------------------
# fused multiply-add, correctly rounded
# ---------------------------------------------------------------------------

_SPLIT = 134217729.0  # 2^27 + 1 (Veltkamp)


def _two_sum(a, b):
    s = a + b
    bb = s - a
    return s, (a - (s - bb)) + (b - bb)


def _two_prod(a, b):
    p = a * b
    t = _SPLIT * a
    ah = t - (t - a)
    al = a - ah
    t = _SPLIT * b
    bh = t - (t - b)
    bl = b - bh
    return p, ((ah * bh - p) + ah * bl + al * bh) + al * bl


def _fma_exact(a: float, b: float, c: float) -> float:
    if not (np.isfinite(a) and np.isfinite(b) and np.isfinite(c)):
        return a * b + c
    exact = Fraction(a) * Fraction(b) + Fraction(c)
    if exact == 0:
        # an exact zero is +0 unless both terms are -0
        zero_product = a == 0 or b == 0
        negative = zero_product and c == 0 and np.signbit(c) and np.signbit(a) != np.signbit(b)
        return -0.0 if negative else 0.0
    try:
        return float(exact)  # int / int: correctly rounded
    except OverflowError:
        return float("inf") if exact > 0 else float("-inf")


def fma(a: np.ndarray, b: np.ndarray, c: np.ndarray) -> np.ndarray:
    """``a * b + c`` rounded once, elementwise over float64 arrays.

    The product splits exactly into two doubles (Dekker), the sum with ``c``
    into two more, the low parts add rounded to odd, and the last addition
    then rounds correctly (Boldo and Melquiond, "Emulation of FMA and
    correctly rounded sums: proved algorithms using rounding to odd", IEEE
    Trans. Computers 57(4), 2008). Elements where those steps could
    overflow or underflow are computed in exact rational arithmetic."""
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    c = np.asarray(c, dtype=np.float64)
    shape = np.broadcast(a, b, c).shape
    a, b, c = (np.broadcast_to(t, shape).reshape(-1) for t in (a, b, c))
    with np.errstate(all="ignore"):
        ph, pl = _two_prod(a, b)
        th, tl = _two_sum(c, ph)
        v, err = _two_sum(tl, pl)
        even = (v.view(np.int64) & 1) == 0
        toward = np.where(err > 0, np.inf, -np.inf)
        v = np.where((err != 0) & even, np.nextafter(v, toward), v)
        out = th + v
        aa, ab, ac = np.abs(a), np.abs(b), np.abs(c)
        safe = (
            ((a == 0) | ((aa > 2.0 ** -450) & (aa < 2.0 ** 450)))
            & ((b == 0) | ((ab > 2.0 ** -450) & (ab < 2.0 ** 450)))
            & (ac < 2.0 ** 1000)
            & ((ac == 0) | (ac > 2.0 ** -900))
            & ((np.abs(ph) == 0) | (np.abs(ph) > 2.0 ** -900))
        )
    for i in np.flatnonzero(~safe):
        out[i] = _fma_exact(float(a[i]), float(b[i]), float(c[i]))
    return out.reshape(shape)


# ---------------------------------------------------------------------------
# lane helpers
# ---------------------------------------------------------------------------


def _lane_sequences(x: np.ndarray):
    """The values each of the eight lanes sees, in order."""
    n = len(x)
    main = n - n % LANES
    lanes = [x[j:main:LANES] for j in range(LANES)]
    lanes[0] = np.concatenate([lanes[0], x[main:]])
    return lanes


def _seq_sum(seq: np.ndarray) -> float:
    """A sum taken left to right from +0.0 (``np.add.accumulate`` never
    reorders)."""
    return float(np.add.accumulate(np.concatenate([[0.0], seq]))[-1])


def _lane_sum(x: np.ndarray) -> float:
    total = 0.0
    for seq in _lane_sequences(x):
        total += _seq_sum(seq)
    return total


def _lane_min(x: np.ndarray) -> float:
    """min with the kernel's order of comparisons (``x < acc ? x : acc``
    from +inf per lane, then across lanes)."""
    mn = np.inf
    for seq in _lane_sequences(x):
        lane = seq[np.argmin(seq)] if len(seq) else np.inf
        if lane < mn:
            mn = lane
    return float(mn)


def _lane_max(x: np.ndarray) -> float:
    mx = -np.inf
    for seq in _lane_sequences(x):
        lane = seq[np.argmax(seq)] if len(seq) else -np.inf
        if lane > mx:
            mx = lane
    return float(mx)


def _lane_fma_sums(*pairs: Tuple[np.ndarray, np.ndarray]):
    """For each (u, v): the lane sums of ``acc = fma(u, v, acc)``, added
    across lanes in order."""
    n = len(pairs[0][0])
    main = n - n % LANES
    totals = []
    for u, v in pairs:
        acc = np.zeros(LANES, dtype=np.float64)
        U = u[:main].reshape(-1, LANES)
        V = v[:main].reshape(-1, LANES)
        for r in range(U.shape[0]):
            acc = fma(U[r], V[r], acc)
        for i in range(main, n):
            acc[0] = fma(u[i], v[i], acc[0])
        total = 0.0
        for j in range(LANES):
            total += float(acc[j])
        totals.append(total)
    return totals


def _live(mask, n: int) -> np.ndarray:
    return np.ones(n, dtype=bool) if mask is None else np.asarray(mask).astype(bool)


# ---------------------------------------------------------------------------
# block partials
# ---------------------------------------------------------------------------

_STATS_DTYPES = (np.dtype(np.float64), np.dtype(np.float32), np.dtype(np.int64),
                 np.dtype(np.int32))


def native_block_stats_plain(values: np.ndarray, mask) -> np.ndarray:
    if np.asarray(values).dtype not in _STATS_DTYPES:
        values = np.asarray(values, dtype=np.float64)
    x = np.asarray(values).astype(np.float64)
    n = len(x)
    live = _live(mask, n)
    isnan = np.isnan(x)
    count = int(np.count_nonzero(live))
    nans = int(np.count_nonzero(live & isnan))
    with np.errstate(invalid="ignore"):
        total = _lane_sum(np.where(live, x, 0.0))
    ok = live & ~isnan
    mn = _lane_min(np.where(ok, x, np.inf))
    mx = _lane_max(np.where(ok, x, -np.inf))
    m2 = 0.0
    if count > 0:
        mean = total / count
        with np.errstate(invalid="ignore"):
            d = np.where(live, x - mean, 0.0)
        (m2,) = _lane_fma_sums((d, d))
    nonnan = count - nans
    nan = float("nan")
    return np.array([
        float(count), total,
        mn if nonnan > 0 else nan,
        nan if nans > 0 else (mx if nonnan > 0 else nan),
        m2, float(nonnan),
        mx if nonnan > 0 else nan,
    ], dtype=np.float64)


def native_block_comoments_plain(x: np.ndarray, y: np.ndarray, mask) -> np.ndarray:
    x = np.asarray(x, dtype=np.float64)
    y = np.asarray(y, dtype=np.float64)
    live = _live(mask, len(x))
    with np.errstate(invalid="ignore"):
        xs = _lane_sum(np.where(live, x, 0.0))
        ys = _lane_sum(np.where(live, y, 0.0))
    count = int(np.count_nonzero(live))
    ck = xmk = ymk = 0.0
    if count > 0:
        xa, ya = xs / count, ys / count
        with np.errstate(invalid="ignore"):
            dx = np.where(live, x - xa, 0.0)
            dy = np.where(live, y - ya, 0.0)
        ck, xmk, ymk = _lane_fma_sums((dx, dy), (dx, dx), (dy, dy))
    return np.array([float(count), xs, ys, ck, xmk, ymk], dtype=np.float64)


def _kll_policy(k: int, nv: int):
    h, stride = 0, 1
    while stride * k < nv:
        stride <<= 1
        h += 1
    dense = 2 if h >= 2 else h
    return h - dense, stride >> dense, k << dense, dense


def _kll_r(tick: int, nv: int) -> int:
    a = ((tick & _M32) * 2654435761) & _M32
    b = ((nv & _M32) * 2246822519) & _M32
    return (a ^ b) >> 7


def _kll_emit(picked: np.ndarray, k: int, h: int, dense: int, r: int):
    picked = np.sort(picked.astype(np.float64), kind="stable")
    if dense >= 2 and picked.size > 1:
        picked = picked[(r >> 8) & 1::2]
        h += 1
    items = np.full(4 * k, np.inf, dtype=np.float64)
    items[:picked.size] = picked
    return items, int(picked.size), h


def native_block_kll_sample_plain(values: np.ndarray, mask, k: int, tick: int):
    k = max(int(k), 1)
    v = np.asarray(values, dtype=np.float64)
    ok = _live(mask, len(v)) & ~np.isnan(v)
    nv = int(np.count_nonzero(ok))
    if nv == 0:
        return np.full(4 * k, np.inf), 0, 0, 0, np.inf, -np.inf
    mn = _lane_min(np.where(ok, v, np.inf))
    mx = _lane_max(np.where(ok, v, -np.inf))
    h, stride, cap, dense = _kll_policy(k, nv)
    r = _kll_r(tick, nv)
    picked = v[ok][r % stride::stride][:cap]
    items, m, h = _kll_emit(picked, k, h, dense, r)
    return items, m, h, nv, mn, mx


def native_block_kll_pick_plain(values: np.ndarray, mask, k: int, tick: int, nv: int):
    k = max(int(k), 1)
    n = len(values)
    live = _live(mask, n)
    if np.asarray(values).dtype == np.int64:
        sel = values if nv == n else values[live]
    else:
        v = np.asarray(values, dtype=np.float64)
        sel = v if nv == n else v[live & ~np.isnan(v)]
    h, stride, cap, dense = _kll_policy(k, nv)
    r = _kll_r(tick, nv)
    return _kll_emit(np.asarray(sel)[r % stride::stride][:cap], k, h, dense, r)


def native_dict_masked_bincount_plain(codes: np.ndarray, mask: np.ndarray,
                                      num_cats: int) -> np.ndarray:
    c = np.asarray(codes, dtype=np.int32).astype(np.int64)
    keep = np.asarray(mask).astype(bool) & (c >= 0) & (c < num_cats)
    slot = np.where(keep, c, num_cats)
    return np.bincount(slot, minlength=int(num_cats) + 1).astype(np.int64)


# ---------------------------------------------------------------------------
# hashing and HLL
# ---------------------------------------------------------------------------


def _numeric_hashes(values: np.ndarray, seed: int) -> np.ndarray:
    from ..ops.hashing import xxhash64_u64

    if np.issubdtype(values.dtype, np.floating):
        v = np.asarray(values, dtype=np.float64)
        bits = np.where(v == 0.0, 0.0, v).view(np.uint64)  # -0.0 hashes as 0.0
    else:
        bits = np.asarray(values, dtype=np.int64).view(np.uint64)
    return xxhash64_u64(bits, seed)


def _string_valid(values, mask) -> np.ndarray:
    from ..ops.hashing import as_object_array

    obj = as_object_array(values)
    valid = np.array([v is not None for v in obj], dtype=bool)
    return valid if mask is None else valid & np.asarray(mask).astype(bool)


def _registers(hashes: np.ndarray, live: np.ndarray, regs) -> np.ndarray:
    from ..ops.hll import hll_features

    out = np.zeros(512, dtype=np.uint8) if regs is None else regs
    pairs = hll_features(hashes)
    np.maximum.at(out, pairs[0][live], pairs[1][live].astype(np.uint8))
    return out


def native_xxhash64_strings_plain(values, seed: int) -> np.ndarray:
    from ..ops.hashing import xxhash64_strings_plain

    return xxhash64_strings_plain(values, seed)


def native_classify_types_plain(values, mask: np.ndarray) -> np.ndarray:
    from ..data import ColumnKind
    from ..runners.features import classify_type_codes_plain

    return classify_type_codes_plain(values, np.asarray(mask).astype(bool), ColumnKind.STRING)


def native_string_lengths_plain(values, mask: np.ndarray) -> np.ndarray:
    from ..runners.features import string_lengths_plain

    return string_lengths_plain(values, np.asarray(mask).astype(bool))


def native_hll_pack_numeric_plain(values: np.ndarray, mask, seed: int) -> np.ndarray:
    from ..ops.hll import hll_pack_features

    return hll_pack_features(_numeric_hashes(values, seed), mask)


def native_hll_pack_strings_plain(values, mask, seed: int) -> np.ndarray:
    from ..ops.hashing import xxhash64_strings_plain
    from ..ops.hll import hll_pack_features

    return hll_pack_features(xxhash64_strings_plain(values, seed), _string_valid(values, mask))


def native_block_hll_plain(values: np.ndarray, mask, seed: int,
                           regs: Optional[np.ndarray] = None) -> np.ndarray:
    return _registers(_numeric_hashes(values, seed), _live(mask, len(values)), regs)


def native_block_hll_strings_plain(values, mask, seed: int,
                                   regs: Optional[np.ndarray] = None) -> np.ndarray:
    from ..ops.hashing import xxhash64_strings_plain

    return _registers(xxhash64_strings_plain(values, seed), _string_valid(values, mask), regs)


def native_pattern_match_plain(values, mask, pattern: str) -> np.ndarray:
    from ..runners.features import regex_matches_plain

    return regex_matches_plain(values, _live(mask, len(values)), pattern)


# ---------------------------------------------------------------------------
# u64 value counts
# ---------------------------------------------------------------------------


def _next_pow2(v: int) -> int:
    p = 1
    while p < v:
        p <<= 1
    return p


def _count_run(keys, weights, out_k, out_w) -> None:
    """One partition through a linear-probing table of next_pow2(2 len)
    slots, emitted in slot order (``count_run`` in the C++)."""
    cap = _next_pow2(2 * len(keys))
    msk = cap - 1
    tk = [0] * cap
    tw = [0] * cap
    for k, w in zip(keys, weights):
        s = ((k * 0x9E3779B97F4A7C15) & _M64) >> 16 & msk
        while True:
            if tw[s] == 0:
                tk[s], tw[s] = k, w
                break
            if tk[s] == k:
                tw[s] += w
                break
            s = (s + 1) & msk
    for s in range(cap):
        if tw[s] != 0:
            out_k.append(tk[s])
            out_w.append(tw[s])


def native_u64_value_counts_plain(keys: np.ndarray, weights=None):
    keys = np.ascontiguousarray(keys, dtype=np.uint64)
    n = len(keys)
    w = np.ones(n, dtype=np.int64) if weights is None else np.asarray(weights, dtype=np.int64)
    out_k: list = []
    out_w: list = []
    if n > 0:
        parts = 1
        while parts < (1 << 12) and n // parts > (1 << 14):
            parts <<= 1
        shift = 64 - (parts.bit_length() - 1)
        part = (keys >> np.uint64(shift)).astype(np.int64) if parts > 1 else np.zeros(n, np.int64)
        # the kernel's scatter keeps input order within a partition
        order = np.argsort(part, kind="stable")
        bounds = np.searchsorted(part[order], np.arange(parts + 1))
        for p in range(parts):
            sel = order[bounds[p]:bounds[p + 1]]
            if len(sel):
                _count_run(keys[sel].tolist(), w[sel].tolist(), out_k, out_w)
    return np.array(out_k, dtype=np.uint64), np.array(out_w, dtype=np.int64)
