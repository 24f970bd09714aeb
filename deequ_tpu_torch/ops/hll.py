"""HyperLogLog++ cardinality sketch (p=9, 512 registers): the host half.

The reference implements HLL++ as a Spark ImperativeAggregate doing per-row
register updates on a packed 52-long agg buffer (reference
`analyzers/catalyst/StatefulHyperloglogPlus.scala:89-139`, constants
`analyzers/catalyst/HLLConstants.scala:25-37`). Here the per-row work is
vectorized: the host turns xxhash64 values into packed (register-index,
leading-zero-count) keys in one numpy pass, the device folds a whole batch
into the 512-register state with the ``hll_registers`` kernel
(``deequ_tpu_torch/kernels``), and merge is an elementwise register max.

Register layout is kept unpacked (``int32[512]``) on device; :func:`registers_to_words` / :func:`words_to_registers` convert
to/from the reference's packed 6-bit/52-word format for state persistence
parity (reference `StatefulHyperloglogPlus.scala:170-186`).
"""

from __future__ import annotations

from typing import Optional

import numpy as np

#: HLL++ precision: relativeSD = 0.05 => p = ceil(2*log2(1.106/0.05)) = 9
#: (reference `StatefulHyperloglogPlus.scala:154-161`)
RELATIVE_SD = 0.05
P = 9
M = 1 << P  # 512 registers
IDX_SHIFT = 64 - P
W_PADDING = np.uint64(1 << (P - 1))
REGISTER_SIZE = 6
REGISTERS_PER_WORD = 64 // REGISTER_SIZE  # 10
NUM_WORDS = (M + REGISTERS_PER_WORD - 1) // REGISTERS_PER_WORD  # 52
REGISTER_WORD_MASK = np.uint64((1 << REGISTER_SIZE) - 1)

#: alpha * m^2 for p >= 7 (HLL++ paper; reference `StatefulHyperloglogPlus.scala:163-168`)
ALPHA_M2 = (0.7213 / (1.0 + 1.079 / M)) * M * M

#: nearest-neighbour count used in bias interpolation
#: (reference `HLLConstants.scala:35`)
K_NEIGHBORS = 6

#: linear-counting threshold for p=9 (reference `HLLConstants.scala:37`, entry P-4)
THRESHOLD = 400.0

# Empirical bias-correction data for p=9 from the HLL++ paper's published
# appendix (Heule et al. 2013); same values the reference carries in
# `HLLConstants.scala:39-105` (row P-4). RAW_ESTIMATES are the sorted raw
# estimate anchors, BIASES the measured bias at each anchor.
RAW_ESTIMATES_P9 = np.array([
    369, 374.8294, 381.2452, 387.6698, 394.1464, 400.2024, 406.8782, 413.6598,
    420.462, 427.2826, 433.7102, 440.7416, 447.9366, 455.1046, 462.285,
    469.0668, 476.306, 483.8448, 491.301, 498.9886, 506.2422, 513.8138,
    521.7074, 529.7428, 537.8402, 545.1664, 553.3534, 561.594, 569.6886,
    577.7876, 585.65, 594.228, 602.8036, 611.1666, 620.0818, 628.0824,
    637.2574, 646.302, 655.1644, 664.0056, 672.3802, 681.7192, 690.5234,
    700.2084, 708.831, 718.485, 728.1112, 737.4764, 746.76, 756.3368,
    766.5538, 775.5058, 785.2646, 795.5902, 804.3818, 814.8998, 824.9532,
    835.2062, 845.2798, 854.4728, 864.9582, 875.3292, 886.171, 896.781,
    906.5716, 916.7048, 927.5322, 937.875, 949.3972, 958.3464, 969.7274,
    980.2834, 992.1444, 1003.4264, 1013.0166, 1024.018, 1035.0438, 1046.34,
    1057.6856, 1068.9836, 1079.0312, 1091.677, 1102.3188, 1113.4846,
    1124.4424, 1135.739, 1147.1488, 1158.9202, 1169.406, 1181.5342,
    1193.2834, 1203.8954, 1216.3286, 1226.2146, 1239.6684, 1251.9946,
    1262.123, 1275.4338, 1285.7378, 1296.076, 1308.9692, 1320.4964,
    1333.0998, 1343.9864, 1357.7754, 1368.3208, 1380.4838, 1392.7388,
    1406.0758, 1416.9098, 1428.9728, 1440.9228, 1453.9292, 1462.617, 1476.05,
    1490.2996, 1500.6128, 1513.7392, 1524.5174, 1536.6322, 1548.2584,
    1562.3766, 1572.423, 1587.1232, 1596.5164, 1610.5938, 1622.5972,
    1633.1222, 1647.7674, 1658.5044, 1671.57, 1683.7044, 1695.4142,
    1708.7102, 1720.6094, 1732.6522, 1747.841, 1756.4072, 1769.9786,
    1782.3276, 1797.5216, 1808.3186, 1819.0694, 1834.354, 1844.575,
    1856.2808, 1871.1288, 1880.7852, 1893.9622, 1906.3418, 1920.6548,
    1932.9302, 1945.8584, 1955.473, 1968.8248, 1980.6446, 1995.9598,
    2008.349, 2019.8556, 2033.0334, 2044.0206, 2059.3956, 2069.9174,
    2082.6084, 2093.7036, 2106.6108, 2118.9124, 2132.301, 2144.7628,
    2159.8422, 2171.0212, 2183.101, 2193.5112, 2208.052, 2221.3194,
    2233.3282, 2247.295, 2257.7222, 2273.342, 2286.5638, 2299.6786,
    2310.8114, 2322.3312, 2335.516, 2349.874, 2363.5968, 2373.865, 2387.1918,
    2401.8328, 2414.8496, 2424.544, 2436.7592, 2447.1682, 2464.1958,
    2474.3438, 2489.0006, 2497.4526, 2513.6586, 2527.19, 2540.7028, 2553.768,
])

BIASES_P9 = np.array([
    368, 361.8294, 355.2452, 348.6698, 342.1464, 336.2024, 329.8782,
    323.6598, 317.462, 311.2826, 305.7102, 299.7416, 293.9366, 288.1046,
    282.285, 277.0668, 271.306, 265.8448, 260.301, 254.9886, 250.2422,
    244.8138, 239.7074, 234.7428, 229.8402, 225.1664, 220.3534, 215.594,
    210.6886, 205.7876, 201.65, 197.228, 192.8036, 188.1666, 184.0818,
    180.0824, 176.2574, 172.302, 168.1644, 164.0056, 160.3802, 156.7192,
    152.5234, 149.2084, 145.831, 142.485, 139.1112, 135.4764, 131.76,
    129.3368, 126.5538, 122.5058, 119.2646, 116.5902, 113.3818, 110.8998,
    107.9532, 105.2062, 102.2798, 99.4728, 96.9582, 94.3292, 92.171,
    89.7809999999999, 87.5716, 84.7048, 82.5322, 79.875, 78.3972, 75.3464,
    73.7274, 71.2834, 70.1444, 68.4263999999999, 66.0166, 64.018,
    62.0437999999999, 60.3399999999999, 58.6856, 57.9836, 55.0311999999999,
    54.6769999999999, 52.3188, 51.4846, 49.4423999999999, 47.739,
    46.1487999999999, 44.9202, 43.4059999999999, 42.5342000000001, 41.2834,
    38.8954000000001, 38.3286000000001, 36.2146, 36.6684, 35.9946, 33.123,
    33.4338, 31.7378000000001, 29.076, 28.9692, 27.4964, 27.0998, 25.9864,
    26.7754, 24.3208, 23.4838, 22.7388000000001, 24.0758000000001,
    21.9097999999999, 20.9728, 19.9228000000001, 19.9292, 16.617, 17.05,
    18.2996000000001, 15.6128000000001, 15.7392, 14.5174, 13.6322,
    12.2583999999999, 13.3766000000001, 11.423, 13.1232, 9.51639999999998,
    10.5938000000001, 9.59719999999993, 8.12220000000002, 9.76739999999995,
    7.50440000000003, 7.56999999999994, 6.70440000000008, 6.41419999999994,
    6.71019999999999, 5.60940000000005, 4.65219999999999, 6.84099999999989,
    3.4072000000001, 3.97859999999991, 3.32760000000007, 5.52160000000003,
    3.31860000000006, 2.06940000000009, 4.35400000000004, 1.57500000000005,
    0.280799999999999, 2.12879999999996, -0.214799999999968,
    -0.0378000000000611, -0.658200000000079, 0.654800000000023,
    -0.0697999999999865, 0.858400000000074, -2.52700000000004,
    -2.1751999999999, -3.35539999999992, -1.04019999999991,
    -0.651000000000067, -2.14439999999991, -1.96659999999997,
    -3.97939999999994, -0.604400000000169, -3.08260000000018,
    -3.39159999999993, -5.29640000000018, -5.38920000000007,
    -5.08759999999984, -4.69900000000007, -5.23720000000003,
    -3.15779999999995, -4.97879999999986, -4.89899999999989,
    -7.48880000000008, -5.94799999999987, -5.68060000000014,
    -6.67180000000008, -4.70499999999993, -7.27779999999984,
    -4.6579999999999, -4.4362000000001, -4.32139999999981,
    -5.18859999999995, -6.66879999999992, -6.48399999999992,
    -5.1260000000002, -4.4032000000002, -6.13500000000022,
    -5.80819999999994, -4.16719999999987, -4.15039999999999,
    -7.45600000000013, -7.24080000000004, -9.83179999999993,
    -5.80420000000004, -8.6561999999999, -6.99940000000015,
    -10.5473999999999, -7.34139999999979, -6.80999999999995,
    -6.29719999999998, -6.23199999999997,
])


def _clz64(x: np.ndarray) -> np.ndarray:
    """Vectorized count-leading-zeros over uint64 (exact: works on 32-bit
    halves so float rounding can never flip a bit)."""
    x = x.astype(np.uint64)
    hi = (x >> np.uint64(32)).astype(np.uint32)
    lo = (x & np.uint64(0xFFFFFFFF)).astype(np.uint32)

    def clz32(v: np.ndarray) -> np.ndarray:
        # float64 represents every uint32 exactly, so log2 is exact enough:
        # bit_length = floor(log2(v)) + 1 for v > 0
        out = np.full(v.shape, 32, dtype=np.int32)
        nz = v != 0
        out[nz] = 31 - np.floor(np.log2(v[nz].astype(np.float64))).astype(np.int32)
        return out

    hi_clz = clz32(hi)
    return np.where(hi != 0, hi_clz, 32 + clz32(lo)).astype(np.int32)


def hll_features(hashes: np.ndarray) -> np.ndarray:
    """(2, B) int32: register indices and leading-zero counts per hash.

    Mirrors the per-row math of the reference `update`
    (`StatefulHyperloglogPlus.scala:93-114`): idx = top P bits of the hash,
    pw = clz((hash << P) | 2^(P-1)) + 1.
    """
    h = np.ascontiguousarray(hashes, dtype=np.uint64)
    idx = (h >> np.uint64(IDX_SHIFT)).astype(np.int32)
    w = (h << np.uint64(P)) | W_PADDING
    pw = _clz64(w) + 1
    return np.stack([idx, pw.astype(np.int32)])


def hll_pack_features(hashes: np.ndarray, mask: Optional[np.ndarray] = None) -> np.ndarray:
    """uint16 (idx << 6) | pw per hash — the wire format of the HLL feature
    (2 bytes/row instead of 8; pw <= 57 fits 6 bits, idx < 512 fits 10).
    Masked rows pack as 0, which never wins a register max."""
    pairs = hll_features(hashes)
    packed = ((pairs[0].astype(np.uint16) << np.uint16(6))
              | pairs[1].astype(np.uint16))
    if mask is not None:
        packed = np.where(mask, packed, np.uint16(0))
    return packed


def estimate_cardinality(registers: np.ndarray) -> float:
    """HLL++ estimate with linear counting + bias correction
    (reference `StatefulHyperloglogPlus.count`, `:210-257`)."""
    regs = np.asarray(registers, dtype=np.int64)
    z_inverse = np.sum(np.ldexp(1.0, -regs))
    v = float(np.count_nonzero(regs == 0))

    e = ALPHA_M2 / z_inverse
    if e < 5.0 * M:
        e_corrected = e - _estimate_bias(e)
    else:
        e_corrected = e

    if v > 0:
        h = M * np.log(M / v)
        estimate = h if h <= THRESHOLD else e_corrected
    else:
        estimate = e_corrected
    return round_half_up(estimate)


def round_half_up(x: float) -> float:
    """JVM ``Math.round`` semantics: floor(x + 0.5), i.e. ties round toward
    +inf (reference `StatefulHyperloglogPlus.count` returns
    `Math.round(estimate)`, `:256`). numpy's ``rint`` rounds half-to-even and
    diverges on exact .5 boundaries."""
    return float(np.floor(x + 0.5))


def _estimate_bias(e: float) -> float:
    """K-nearest-neighbour interpolation into the empirical bias table
    (reference `StatefulHyperloglogPlus.estimateBias`, `:259-297`)."""
    estimates = RAW_ESTIMATES_P9
    n = len(estimates)
    nearest = int(np.searchsorted(estimates, e, side="left"))
    low = max(nearest - K_NEIGHBORS + 1, 0)
    high = min(low + K_NEIGHBORS, n)

    def distance(i: int) -> float:
        d = e - estimates[i]
        return d * d

    while high < n and distance(high) < distance(low):
        low += 1
        high += 1
    return float(np.mean(BIASES_P9[low:high]))


def registers_to_words(registers: np.ndarray) -> np.ndarray:
    """Pack int32[512] registers into the reference's uint64[52] word layout
    (6 bits per register, 10 registers per word, little-endian within word)."""
    regs = np.asarray(registers, dtype=np.uint64)
    words = np.zeros(NUM_WORDS, dtype=np.uint64)
    for i in range(M):
        word_offset = i // REGISTERS_PER_WORD
        shift = np.uint64(REGISTER_SIZE * (i % REGISTERS_PER_WORD))
        words[word_offset] |= (regs[i] & REGISTER_WORD_MASK) << shift
    return words


def words_to_registers(words: np.ndarray) -> np.ndarray:
    """Inverse of :func:`registers_to_words`."""
    words = np.asarray(words, dtype=np.uint64)
    regs = np.zeros(M, dtype=np.int32)
    for i in range(M):
        word = words[i // REGISTERS_PER_WORD]
        shift = np.uint64(REGISTER_SIZE * (i % REGISTERS_PER_WORD))
        regs[i] = int((word >> shift) & REGISTER_WORD_MASK)
    return regs
