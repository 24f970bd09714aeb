"""The native host tier: C++ kernels for the host-side hot loops.

A copy of the reference's native library (``src/host_kernels.cpp``, byte
for byte): batch string hashing, type classes, string lengths, HLL packing,
PCRE2 pattern matching, the per-batch block partials of the host ingest
tier (moments, co-moments, HLL registers, KLL samples, dictionary code
counts) and the u64 value counts of the frequency drains. It compiles with
g++ at first use into ``_build/`` and loads through ctypes (``lib.py``); a
failed build raises with the compiler's output. ``plain.py`` holds a numpy
version of every export, which the tests hold the library to bit for bit.
"""

from __future__ import annotations

from .lib import (  # noqa: F401
    load,
    native_block_comoments,
    native_block_hll,
    native_block_hll_strings,
    native_block_kll_pick,
    native_block_kll_sample,
    native_block_stats,
    native_classify_types,
    native_dict_masked_bincount,
    native_hll_pack_numeric,
    native_hll_pack_strings,
    native_pattern_match,
    native_string_lengths,
    native_u64_value_counts,
    native_xxhash64_strings,
    pattern_routes,
    reset_pattern_routes,
)

EXPORTS = (
    "native_xxhash64_strings", "native_classify_types", "native_string_lengths",
    "native_hll_pack_numeric", "native_hll_pack_strings", "native_block_stats",
    "native_block_comoments", "native_block_hll", "native_block_hll_strings",
    "native_block_kll_sample", "native_dict_masked_bincount", "native_block_kll_pick",
    "native_pattern_match", "native_u64_value_counts",
)
