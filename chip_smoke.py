#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (deequ_tpu_torch) once on one CUDA GPU.

    python3 chip_smoke.py [--seed S]

Phases, each of which fails the run when it fails:

1. the card's name and power limit; build every kernel from
   ``deequ_tpu_torch/kernels/csrc`` (one ``nvcc`` per source, in parallel)
   and print ptxas's register and shared-memory report;
2. each kernel against its plain PyTorch version on the card, at the shapes
   the main paths give it (the features of the first 1M-row batch of each),
   with CUDA-event times of the device work of the kernel, of the plain
   version and, where one exists, of the single PyTorch call that computes
   the same function, and the host time of each call apart. For the
   verification path: K1-K3. For the profile path: K1 with its class-count
   slots, K2, K3, and K4 and K5 on every numeric column; K4 again on a batch
   of signed zeros, NaN and values beyond the float32 range, and K5's merge
   of two sketches. For the grouping path: K6 on the first batch of the
   bench grouping workload, on lineitem's two-column primary key and on an
   edge batch; K7 compacting that batch's keys into a full 2^22-slot
   table, merging two full tables, and compacting the edge batch's keys.
   For the incremental path (timed inside phase 6, at its shapes): K8 at
   N = 2 on config 4's partition states and at N = 32 on states of every
   kind (a month of day partitions), bit for bit, beside ``torch.amax``
   over the stacked HLL registers; K1 with one co-moment slot over two
   1M-row float64 columns. For the host tier: K8's carry entry on config
   2's battery at the chunk shape (the carry and the host partials of 32
   batches of 2^18 rows), beside ``torch.amax`` plus ``torch.sum`` of the
   stacked partials; K5's ingest entry on the chunk phase 7 (c) folds
   (the host samples of config 3's numeric columns over its ten 2^20-row
   batches), beside ``torch.sort`` of one 4,096-item level, on a full
   chunk of 32 samples of 2^18-row batches and on an edge chunk (m = 0,
   m = 2k, h = 0, +-inf), all bit for bit; and the host tier's rank
   limit against faulty versions of (c)'s chunk;
3. the verification path: one ``VerificationSuite`` over a 10M-row dataset
   (BASELINE config 2's synthetic numeric/categorical table: four nullable
   float64 columns with NaN, an int64 id, dictionary columns of ~1,000 and
   ~50,000 categories) with about twenty checks covering its analyzers, on
   ``device="cuda"``; its metrics are held against the same run on
   ``device="cpu"`` and against a numpy oracle;
4. the profile path: ``ColumnProfilerRunner`` over a 10M-row TPC-H
   lineitem-shaped table (BASELINE config 3's 16 columns, cut from 100M to
   10M rows) on ``device="cuda"``, held against the same profile on
   ``device="cpu"`` and against a numpy oracle (exact counts, histograms,
   type counts, min and max; moments within 1e-9; KLL percentiles within
   twice the sketch's relative error in rank);
5. the grouping path: Uniqueness, CountDistinct and Entropy over the
   JAX bench's grouping workload (25M int64 keys, 3,571,428 distinct,
   seed 1) with a resident frequency table (a), a non-resident one (b) and
   one that overflows into the host group-by (c), held against (a) on
   ``device="cpu"`` and a numpy oracle; lineitem's primary key and key
   checks through ``VerificationSuite`` (d), against the CPU run and
   pandas value counts; BasicExample (e), against its CPU run;
6. the incremental path, BASELINE config 4: two day partitions of 50M rows
   of the JAX bench's scan table (``build_scan_data``, seed 42), batches
   of 1M, the bench's battery. (a) each partition with ``save_states_with``
   (an in-memory provider per partition) and an in-memory metrics
   repository keyed by day; (b) ``run_on_aggregated_states`` over both
   providers, timed, Size = 100M; (c) anomaly checks on Size and Mean over
   the day history: a steady day passes, a quarter-size day does not; (d)
   the states through ``FileSystemStateProvider`` files, merged again: (b)'s
   metrics bit for bit; (e) a battery of every other persistable state type
   (Correlation, StandardDeviation, Minimum, Maximum and Mean with NaN,
   DataType, a Histogram of a dictionary column, Uniqueness, a second KLL)
   over the same partitions, merged and held against one full-table run.
   (b) and (e) are held against numpy over the whole table, and the phase
   at 2 x 5M rows against the same on ``device="cpu"``;
7. the host ingest tier (``placement="host"``), each run where its data
   lives: (a) after phase 3, its table and checks plus an ApproxQuantile,
   in batches of 2^18 rows, against phase 3's metrics, the same run on
   ``device="cpu"`` bit for bit and the oracle, then again in phase 3's
   batches of 2^20 rows; (b) inside phase 6, the two day partitions with
   ``save_states_with``, their states bit for bit against the same runs on
   ``device="cpu"``, refreshed alone and each merged with phase 6's
   device-tier state of the other day, against the oracle; (c) after
   phase 5, the profile bit for bit against the same run on
   ``device="cpu"``, its sketches against phase 2's ingest of the same
   chunk, and against phase 4's oracle. Every run launches K8's carry
   entry and K5's ingest entry and prints how its pattern matches ran
   (PCRE2 or Python's ``re``). Sketches filled on the host tier hold a
   looser rank limit (``HOST_KLL_RANK_LIMIT``), which phase 2 shows a
   biased sample exceeds.

Each main path runs with the kernels' launch counts set to 0 just before it
and read just after, and every kernel of the path must have been launched.
The native host library (``deequ_tpu_torch/native``) builds with g++ at
its first use, inside phase 2.
The last two lines of standard output are the ``{"kernels": [...]}`` table
and ``{"ok": true, "device": {...}}``; ``nvidia-smi``'s name and power
limit come on a line before them. Without a CUDA device the script exits
with code 2 and prints no result.
"""

from __future__ import annotations

import argparse
import functools
import json
import math
import re
import statistics
import subprocess
import sys
import time

import numpy as np
import pyarrow as pa

#: cycles of ``torch.cuda._sleep`` per millisecond at the H100 SXM's
#: highest clock (1.98 GHz); at a lower clock the spin only lasts longer
SPIN_CYCLES_PER_MS = 2_000_000

#: H100 SXM data sheet: HBM3 bandwidth, and the highest non-tensor-core
#: rate (float32, 67 TFLOP/s) as the peak for the kernels' scalar adds
#: and compares
PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = 67e12

#: rows of the verification path's table: BASELINE config 2's 10M
ROWS = 10_000_000
BATCH_ROWS = 1 << 20
SMALL_CATEGORIES = 1_000
LARGE_CATEGORIES = 50_000
#: a dictionary size whose shared-memory histogram needs the >48 KB opt-in
ATTRIBUTE_PATH_CATEGORIES = 20_000

TPU_KERNELS = {
    "scan_reduce": "deequ_tpu/runners/engine.py:366",
    "hll_registers": "deequ_tpu/analyzers/sketches.py:277",
    "dict_code_counts": "deequ_tpu/analyzers/grouping.py:660",
    "kll_sample": "deequ_tpu/ops/kll.py:233",
    "kll_compact": "deequ_tpu/ops/kll.py:204",
    "freq_keys": "deequ_tpu/analyzers/grouping.py:911",
    "freq_compact": "deequ_tpu/ops/__init__.py:33",
    "state_fold": "deequ_tpu/analyzers/base.py:273",
    # the host ingest tier's entries of K8 and K5
    "state_fold_carry": "deequ_tpu/runners/engine.py:1760",
    "kll_compact_ingest": "deequ_tpu/ops/kll.py:284",
}
#: the CUDA source of each kernel (an entry's is its kernel's)
KERNEL_SOURCES = {name: name for name in TPU_KERNELS} | {
    "state_fold_carry": "state_fold", "kll_compact_ingest": "kll_compact"}
#: the kernels each main path must launch
VERIFICATION_KERNELS = ("scan_reduce", "hll_registers", "dict_code_counts")
PROFILE_KERNELS = ("scan_reduce", "hll_registers", "dict_code_counts", "kll_sample",
                   "kll_compact")
FREQ_KERNELS = ("freq_keys", "freq_compact")
#: the merged-state refresh of the incremental path: K8 and K5's merge
INCREMENTAL_KERNELS = ("state_fold", "kll_compact")
#: the host ingest tier: K8's carry entry and K5's ingest entry
HOST_KERNELS = ("state_fold_carry", "kll_compact_ingest")
#: rows per batch of phase 7 (a): 40 batches, a full chunk of 32 and a tail
HOST_BATCH_ROWS = 1 << 18
#: host partials of one chunk (the engine's INGEST_CHUNK)
CHUNK = 32

#: the bench's grouping workload (bench.py run_grouping_stage,
#: tools/grouping_sweep.py): 25M int64 keys over rows // 7 distinct values
GROUPING_ROWS = 25_000_000
GROUPING_DISTINCT = GROUPING_ROWS // 7
GROUPING_SEED = 1
#: the non-resident table: 2^22 slots (the default) and a 2^20-key buffer
FULL_TABLE_SLOTS = 1 << 22
#: a table too small for the workload's keys: the overflow run (c)
OVERFLOW_TABLE_SLOTS = 1 << 20


# ---------------------------------------------------------------------------
# data, checks and oracle (plain numpy/pyarrow: callable on the CPU)
# ---------------------------------------------------------------------------


def build_table(rows: int, seed: int) -> pa.Table:
    """The synthetic table: ``a``..``d`` float64 with ~5% nulls (``c`` and
    ``d`` also ~0.1% NaN values), ``id`` int64 0..rows-1, ``cat_small`` and
    ``cat_large`` dictionary-encoded strings with ~3% nulls."""
    rng = np.random.default_rng(seed)
    cols = {}
    for name, (mu, sigma) in zip("abcd", [(10.0, 3.0), (-2.0, 5.0), (0.5, 1.0), (100.0, 40.0)]):
        v = rng.normal(mu, sigma, rows)
        if name in "cd":
            v[rng.random(rows) < 0.001] = np.nan
        cols[name] = pa.array(v, mask=rng.random(rows) < 0.05)
    cols["id"] = pa.array(np.arange(rows, dtype=np.int64))
    for name, k, prefix in (
        ("cat_small", SMALL_CATEGORIES, "s"),
        ("cat_large", LARGE_CATEGORIES, "L"),
    ):
        # Zipf-like skew: a few heavy categories, a long tail
        codes = np.minimum(rng.zipf(1.3, rows) - 1, k - 1).astype(np.int32)
        codes = ((codes * 7919) % k).astype(np.int32)
        cols[name] = pa.DictionaryArray.from_arrays(
            pa.array(codes, mask=rng.random(rows) < 0.03),
            pa.array([f"{prefix}{i:05d}" for i in range(k)]),
        )
    return pa.table(cols)


#: BASELINE config 3's table: TPC-H lineitem's 16 columns (bench.py
#: build_lineitem_data, seed 19), at 10M rows (scale factor ~1.7)
LINEITEM_ROWS = 10_000_000
LINEITEM_SEED = 19
COMMENT_POOL = 1_000_000


def build_lineitem(rows: int, seed: int = LINEITEM_SEED, comment_pool: int = COMMENT_POOL) -> pa.Table:
    """TPC-H lineitem-shaped synthetic (BASELINE config 3): 4 int64 keys, 4
    float64 measures, 2 flags, 3 dates as dictionary strings, ship
    instruction and mode, and a dictionary comment column drawn from a pool
    of ``comment_pool`` texts. With ``seed`` 19 this is ``bench.py``'s
    ``build_lineitem_data``."""
    rng = np.random.default_rng(seed)
    cols = {}
    cols["l_orderkey"] = pa.array(rng.integers(1, max(rows // 4, 2), rows))
    cols["l_partkey"] = pa.array(rng.integers(1, 200_001, rows))
    cols["l_suppkey"] = pa.array(rng.integers(1, 10_001, rows))
    cols["l_linenumber"] = pa.array(rng.integers(1, 8, rows))
    cols["l_quantity"] = pa.array(rng.integers(1, 51, rows).astype(np.float64))
    cols["l_extendedprice"] = pa.array(np.round(rng.uniform(900, 105_000, rows), 2))
    cols["l_discount"] = pa.array(np.round(rng.uniform(0, 0.10, rows), 2))
    cols["l_tax"] = pa.array(np.round(rng.uniform(0, 0.08, rows), 2))
    flags = np.array(["A", "N", "R"])
    cols["l_returnflag"] = pa.array(flags[rng.integers(0, 3, rows)])
    status = np.array(["F", "O"])
    cols["l_linestatus"] = pa.array(status[rng.integers(0, 2, rows)])
    day0 = np.datetime64("1992-01-01")
    for name in ("l_shipdate", "l_commitdate", "l_receiptdate"):
        days = rng.integers(0, 2526, rows)  # 1992-01-01 .. 1998-12-01
        dates = (day0 + days.astype("timedelta64[D]")).astype("datetime64[D]")
        dic = pa.array(np.unique(dates).astype(str))
        codes = pa.array(np.searchsorted(np.unique(days), days).astype(np.int32))
        cols[name] = pa.DictionaryArray.from_arrays(codes, dic)
    instr = np.array(["DELIVER IN PERSON", "COLLECT COD", "NONE", "TAKE BACK RETURN"])
    cols["l_shipinstruct"] = pa.array(instr[rng.integers(0, 4, rows)])
    modes = np.array(["AIR", "FOB", "MAIL", "RAIL", "REG AIR", "SHIP", "TRUCK"])
    cols["l_shipmode"] = pa.array(modes[rng.integers(0, 7, rows)])
    pool = np.array(
        [f"comment text fragment number {i} about the order" for i in range(comment_pool)]
    )
    codes = pa.array(rng.integers(0, len(pool), rows).astype(np.int32))
    cols["l_comment"] = pa.DictionaryArray.from_arrays(codes, pa.array(pool))
    return pa.table(cols)


def build_check(dq, rows: int):
    """About twenty checks over every analyzer of the port, some with
    where-filters. ``dq`` is the ``deequ_tpu_torch`` package."""
    yes = lambda _: True  # noqa: E731 - the values are compared, not asserted
    return (
        dq.Check(dq.CheckLevel.ERROR, "smoke")
        .has_size(lambda n: n == rows)
        .is_complete("id")
        .has_completeness("a", lambda v: v > 0.9)
        .has_completeness("b", yes).where("a > 10")
        .has_mean("a", yes)
        .has_sum("b", yes)
        .has_min("c", yes)
        .has_max("d", yes)
        .has_standard_deviation("a", yes)
        .has_standard_deviation("b", yes).where("c > 0")
        .has_mean("id", yes).where("b < 0")
        .is_non_negative("id")
        .satisfies("a > b", "a above b", yes)
        .is_contained_in("cat_small", [f"s{i:05d}" for i in range(0, SMALL_CATEGORIES, 2)], assertion=yes)
        .has_approx_count_distinct("id", yes)
        .has_approx_count_distinct("cat_large", yes)
        .has_uniqueness(["cat_small"], yes)
        .has_distinctness(["cat_large"], yes)
        .has_unique_value_ratio(["cat_large"], yes)
        .has_entropy("cat_small", yes)
        .has_number_of_distinct_values("cat_large", yes)
        .has_histogram_values("cat_small", yes)
        .has_min_length("cat_large", yes)
        .has_max_length("cat_small", yes)
        .has_pattern("cat_large", r"L0\d[05]", yes)
    )


def oracle(table: pa.Table) -> dict:
    """Exact counts and means with numpy, keyed (analyzer name, instance,
    where)."""
    def valid(name):
        arr = table[name].combine_chunks()
        return arr.to_numpy(zero_copy_only=False), np.asarray(arr.is_valid())

    a, am = valid("a")
    b, bm = valid("b")
    c, cm = valid("c")
    d, dm = valid("d")
    ids = table["id"].to_numpy()
    n = len(ids)
    out = {
        ("Size", "*", None): float(n),
        ("Completeness", "id", None): 1.0,
        ("Completeness", "a", None): am.mean(),
        ("Completeness", "b", "a > 10"): (bm & am & (a > 10)).sum() / (am & (a > 10)).sum(),
        ("Mean", "a", None): a[am].mean(),
        ("Sum", "b", None): b[bm].sum(),
        ("Minimum", "c", None): np.nanmin(c[cm]),
        ("Maximum", "d", None): np.max(d[dm]),  # a NaN value wins the max
        ("StandardDeviation", "a", None): a[am].std(),
        ("Mean", "id", "b < 0"): ids[bm & (b < 0)].mean(),
        ("Compliance", "id is non-negative", None): 1.0,
    }
    for name in ("cat_small", "cat_large"):
        col = table[name].combine_chunks()
        present = np.asarray(col.is_valid())
        codes = col.indices.fill_null(0).to_numpy(zero_copy_only=False)
        counts = np.bincount(codes[present].astype(np.int64), minlength=len(col.dictionary))
        counts = counts[counts > 0]
        if name == "cat_small":
            out[("Uniqueness", name, None)] = (counts == 1).sum() / n
        else:
            out[("Distinctness", name, None)] = len(counts) / n
            out[("UniqueValueRatio", name, None)] = (counts == 1).sum() / len(counts)
    return out


def metric_key(analyzer) -> tuple:
    return (analyzer.name, analyzer.instance, getattr(analyzer, "where", None))


def metric_values(result) -> dict:
    """Metric values keyed like :func:`oracle`; histograms as their bins."""
    out = {}
    for analyzer, metric in result.metrics.items():
        if metric.value.is_failure:
            out[metric_key(analyzer)] = ("failure", str(metric.value.exception))
            continue
        value = metric.value.get()
        if hasattr(value, "values"):  # Distribution
            value = (value.number_of_bins, {k: v.absolute for k, v in value.values.items()})
        out[metric_key(analyzer)] = value
    return out


#: metrics that are float sums or moments; all others must match exactly
MOMENT_METRICS = ("Mean", "Sum", "StandardDeviation", "Correlation")


def compare_metrics(got: dict, want: dict, rtol: float = 1e-12) -> list:
    """Differences between two metric maps: exact for every metric but the
    float moments, which agree within ``rtol`` relative."""
    problems = []
    if set(got) != set(want):
        problems.append(f"different metrics: {sorted(set(got) ^ set(want), key=str)}")
    for key in sorted(set(got) & set(want), key=str):
        g, w = got[key], want[key]
        if isinstance(g, float) and isinstance(w, float):
            if math.isnan(g) or math.isnan(w):
                ok = math.isnan(g) and math.isnan(w)
            elif key[0] in MOMENT_METRICS:
                ok = abs(g - w) <= rtol * max(abs(w), 1e-300)
            else:
                ok = g == w
        else:
            ok = g == w
        if not ok:
            problems.append(f"{key}: {g!r} != {w!r}")
    return problems


def compare_oracle(got: dict, want: dict, rtol: float = 1e-9) -> list:
    problems = []
    for key, w in want.items():
        g = got.get(key)
        w = float(w)
        if not isinstance(g, float):
            problems.append(f"{key}: {g!r}, oracle {w!r}")
        elif math.isnan(w):
            if not math.isnan(g):
                problems.append(f"{key}: {g!r}, oracle NaN")
        elif abs(g - w) > rtol * max(abs(w), 1e-300):
            problems.append(f"{key}: {g!r}, oracle {w!r}")
    return problems


#: the profiler's KLL sketch size, and the relative error in rank it is
#: held to: the port sizes a sketch at 4 / error items for a relative error
KLL_SKETCH_SIZE = 2048
KLL_RELATIVE_ERROR = 4.0 / KLL_SKETCH_SIZE
#: the rank limit of sketches filled on the host tier. Its sampler (the
#: reference's block_kll_sample, bit for bit) is a strided pick of each
#: unsorted batch, so its error is a sample's, not a compactor's: phases
#: 7 (a)-(c) read 0.0017-0.0041 on an H100 80GB HBM3 at 700 W, above twice
#: the sketch's relative error (0.0039). The limit lies between those and
#: phase 2's biased control (each sample's lower half), which must exceed
#: it. Faults that keep a sample unbiased (a wrong level, dropped samples)
#: move no percentile of lineitem's i.i.d. columns past it: the bit-for-bit
#: comparisons with the same runs on ``device="cpu"`` hold those.
HOST_KLL_RANK_LIMIT = 0.01
MOMENT_FIELDS = ("mean", "sum", "std_dev")

# the reference's type-inference regexes and decision order
# (`analyzers/catalyst/StatefulDataType.scala:36-38`)
_TYPE_PATTERNS = (
    ("Fractional", re.compile(r"(-|\+)? ?\d*\.\d*", re.ASCII)),
    ("Integral", re.compile(r"(-|\+)? ?\d*", re.ASCII)),
    ("Boolean", re.compile(r"true|false")),
)
TYPE_NAMES = ("Unknown", "Fractional", "Integral", "Boolean", "String")


def _type_name(value: str) -> str:
    for name, pattern in _TYPE_PATTERNS:
        if pattern.fullmatch(value):
            return name
    return "String"


def profile_values(profiles) -> dict:
    """Every field of every column profile, as plain Python values."""
    out = {"__records__": profiles.num_records}
    for name, p in profiles.profiles.items():
        entry = {
            "kind": type(p).__name__, "data_type": p.data_type,
            "inferred": p.is_data_type_inferred, "completeness": p.completeness,
            "distinct": p.approximate_num_distinct_values, "type_counts": dict(p.type_counts),
            "histogram": None if p.histogram is None else (
                p.histogram.number_of_bins,
                {k: (v.absolute, v.ratio) for k, v in p.histogram.values.items()}),
        }
        for f in ("mean", "maximum", "minimum", "sum", "std_dev", "approx_percentiles"):
            entry[f] = getattr(p, f, None)
        kll = getattr(p, "kll", None)
        entry["kll"] = None if kll is None else (
            [(b.low_value, b.high_value, b.count) for b in kll.buckets], kll.parameters, kll.data)
        out[name] = entry
    return out


def compare_profiles(got: dict, want: dict, rtol: float = 1e-12) -> list:
    """Differences between two profiles: every field equal but the means,
    sums and standard deviations, which agree within ``rtol`` relative."""
    problems = []
    if list(got) != list(want):
        return [f"different columns: {list(got)} vs {list(want)}"]
    if got["__records__"] != want["__records__"]:
        problems.append(f"records: {got['__records__']} != {want['__records__']}")
    for name in list(want)[1:]:
        for field, w in want[name].items():
            g = got[name][field]
            if field in MOMENT_FIELDS and g is not None and w is not None:
                ok = abs(g - w) <= rtol * max(abs(w), 1e-300)
            else:
                ok = g == w
            if not ok:
                problems.append(f"{name}.{field}: {str(g)[:200]} != {str(w)[:200]}")
    return problems


def _rank_error(sorted_items: np.ndarray, x: float, q: float) -> float:
    """How far q lies outside the rank interval [P(X < x), P(X <= x)]."""
    n = len(sorted_items)
    lo = np.searchsorted(sorted_items, np.float32(x), "left") / n
    hi = np.searchsorted(sorted_items, np.float32(x), "right") / n
    return 0.0 if lo <= q <= hi else float(min(abs(q - lo), abs(q - hi)))


def compare_profile_oracle(got: dict, table: pa.Table, rtol: float = 1e-9,
                           rank_limit: float = 2 * KLL_RELATIVE_ERROR) -> tuple:
    """Differences between a profile and numpy's exact answers on
    ``table``: record count, completeness, type counts, histograms, bucket
    totals, min and max exactly; mean, sum and standard deviation within
    ``rtol``; each of the 100 percentiles within twice the KLL relative
    error in rank, ranked among the column's float32-rounded values (the
    items a sketch holds). Returns (problems, largest rank error)."""
    import pyarrow.compute as pc

    problems = []
    rows = table.num_rows
    if got["__records__"] != rows:
        problems.append(f"records: {got['__records__']} != {rows}")
    worst_rank = 0.0
    for name in table.column_names:
        col = table[name].combine_chunks()
        if isinstance(col, pa.DictionaryArray):
            col = col.dictionary_decode()
        valid = rows - col.null_count
        p = got[name]
        if p["completeness"] != valid / rows:
            problems.append(f"{name}.completeness: {p['completeness']} != {valid / rows}")
        counts = {row["values"]: row["counts"] for row in pc.value_counts(col).to_pylist()}
        counts.pop(None, None)
        if pa.types.is_string(col.type):
            want = dict.fromkeys(TYPE_NAMES, 0)
            want["Unknown"] = rows - valid
            for value, c in counts.items():
                want[_type_name(value)] += c
            if p["type_counts"] != want:
                problems.append(f"{name}.type_counts: {p['type_counts']} != {want}")
        if (p["histogram"] is not None) != (len(counts) <= 120):
            problems.append(f"{name}: histogram {p['histogram'] is not None} at {len(counts)} values")
        if p["histogram"] is not None:
            key = float if pa.types.is_floating(col.type) or pa.types.is_integer(col.type) else str
            hist = {key(k): a for k, (a, _) in p["histogram"][1].items()}
            if hist != {key(k): c for k, c in counts.items()}:
                problems.append(f"{name}.histogram differs from the exact counts")
        if p["kll"] is None:
            continue
        v = col.to_numpy(zero_copy_only=False).astype(np.float64)
        for field, exact in (("minimum", v.min()), ("maximum", v.max())):
            if p[field] != float(exact):
                problems.append(f"{name}.{field}: {p[field]!r} != {float(exact)!r}")
        for field, exact in (("mean", v.mean()), ("sum", v.sum()), ("std_dev", v.std())):
            if abs(p[field] - exact) > rtol * max(abs(exact), 1e-300):
                problems.append(f"{name}.{field}: {p[field]!r}, oracle {float(exact)!r}")
        if sum(b[2] for b in p["kll"][0]) != valid:
            problems.append(f"{name}: KLL buckets do not add up to {valid}")
        items = np.sort(np.clip(v, -3.4028234663852886e38, 3.4028234663852886e38).astype(np.float32))
        errors = [_rank_error(items, x, (i + 1) / 100) for i, x in enumerate(p["approx_percentiles"])]
        worst_rank = max(worst_rank, max(errors))
        if max(errors) > rank_limit:
            problems.append(f"{name}: percentile rank error {max(errors)} > {rank_limit}")
    return problems, worst_rank


# ---------------------------------------------------------------------------
# states of every kind state_fold folds (plain numpy/torch: callable on the CPU)
# ---------------------------------------------------------------------------


def fold_groups(dq, n_states: int, seed: int, device: str = "cpu") -> list:
    """``(analyzer, [n_states states])`` for every state kind of K8
    ``state_fold``, random from ``seed``: counts, sums, minima and maxima
    with NaN and signed zeros among them, moments and co-moments with
    empty (n = 0) states, DataType counts and HLL registers."""
    import torch

    from deequ_tpu_torch.analyzers import states as st

    rng = np.random.default_rng(seed)

    def f(x):
        return torch.tensor(float(x), dtype=torch.float64, device=device)

    def i(x):
        return torch.tensor(int(x), dtype=torch.int64, device=device)

    def value():
        r = rng.random()
        if r < 0.1:
            return math.nan
        if r < 0.2:
            return -0.0 if rng.random() < 0.5 else 0.0
        return float(rng.normal(5.0, 100.0))

    def n_or_empty():
        return 0.0 if rng.random() < 0.2 else float(rng.integers(1, 10_000))

    def moments():
        n = n_or_empty()
        if n == 0:
            return st.StandardDeviationState(f(0), f(0), f(0))
        return st.StandardDeviationState(f(n), f(rng.normal(3.0, 50.0)), f(rng.random() * n * 30))

    def comoments():
        n = n_or_empty()
        if n == 0:
            return st.CorrelationState(*(f(0) for _ in range(6)))
        x, y = rng.random() * n * 9, rng.random() * n * 4
        return st.CorrelationState(f(n), f(rng.normal(0, 9)), f(rng.normal(1, 4)),
                                   f(rng.normal(0, 1) * math.sqrt(x * y)), f(x), f(y))

    def count():
        return rng.integers(0, 1 << 40)

    makers = [
        (dq.Size(), lambda: st.NumMatches(i(count()))),
        (dq.Completeness("x0"), lambda: st.NumMatchesAndCount(i(count()), i(count()))),
        (dq.Mean("x0"), lambda: st.MeanState(f(value()), i(count()))),
        (dq.Sum("x1"), lambda: st.SumState(f(value()), i(count()))),
        (dq.Minimum("x2"), lambda: st.MinState(f(value()), i(count()))),
        (dq.Maximum("x2"), lambda: st.MaxState(f(value()), i(count()))),
        (dq.StandardDeviation("x3"), moments),
        (dq.Correlation("x0", "x1"), comoments),
        (dq.DataType("x0"), lambda: st.DataTypeHistogram(torch.from_numpy(
            rng.integers(0, 1 << 30, 5)).to(device))),
        (dq.ApproxCountDistinct("cat"), lambda: st.ApproxCountDistinctState(torch.from_numpy(
            rng.integers(0, 40, 512).astype(np.int32)).to(device))),
    ]
    return [(a, [make() for _ in range(n_states)]) for a, make in makers]


def carry_groups(dq, n_states: int, seed: int, device: str = "cpu") -> list:
    """:func:`fold_groups` and a dictionary column's code counts: every
    state kind a host partial gives K8's carry entry."""
    import torch

    from deequ_tpu_torch.analyzers import states as st
    from deequ_tpu_torch.analyzers.grouping import DeviceFrequencyScan

    rng = np.random.default_rng(seed + 1)

    def counts():
        return st.FrequencyCountsState(
            torch.from_numpy(rng.integers(0, 1 << 20, 300)).to(device),
            torch.tensor(int(rng.integers(0, 1 << 30)), dtype=torch.int64, device=device))

    return fold_groups(dq, n_states, seed, device) + [
        (DeviceFrequencyScan("cat", 300), [counts() for _ in range(n_states)])]


def edge_samples(k: int, n: int, seed: int) -> list:
    """``n`` host KLL samples ``(items f64[4k], m, h, nv, min, max)`` at the
    edges K5's ingest entry must take: empty samples (m = 0), full ones
    (m = 2k, the host sampler's widest), h = 0 and up to 6, and items of
    +-inf and beyond the float32 range (no NaN: the sampler drops it)."""
    rng = np.random.default_rng(seed)
    out = []
    for b in range(n):
        m = (0, 2 * k, int(rng.integers(1, 2 * k + 1)))[b % 3]
        h = 0 if b % 4 == 0 else int(rng.integers(0, 7))
        vals = rng.normal(b % 7, 1e3, m)
        if m >= 4:
            vals[:4] = [np.inf, -np.inf, 5e38, -1e300]
        vals = np.sort(vals)
        items = np.full(4 * k, np.inf)
        items[:m] = vals
        if m == 0:
            out.append((items, 0, 0, 0, np.inf, -np.inf))
        else:
            out.append((items, m, h, m << h, float(vals[0]), float(vals[-1])))
    return out


def same_state_bits(got, want) -> bool:
    """Whether two tensor states hold the same leaves, bit for bit (NaN
    equal to NaN whatever its payload)."""
    from deequ_tpu_torch.analyzers.states import leaves

    if type(got) is not type(want) or len(leaves(got)) != len(leaves(want)):
        return False
    for g, w in zip(leaves(got), leaves(want)):
        g, w = g.cpu().numpy(), w.cpu().numpy()
        if g.dtype != w.dtype or g.shape != w.shape:
            return False
        if g.dtype.kind == "f":
            nan = np.isnan(g)
            if not np.array_equal(nan, np.isnan(w)):
                return False
            g, w = np.where(nan, 0.0, g), np.where(nan, 0.0, w)
        if g.tobytes() != w.tobytes():
            return False
    return True


def sequential_fold(states: list):
    """The left-to-right fold of the states' own ``merge``."""
    merged = states[0]
    for s in states[1:]:
        merged = merged.merge(s)
    return merged


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions, with times and bounds
# ---------------------------------------------------------------------------


def _time_ms(torch, fn, reps: int = 30, warmup: int = 3) -> dict:
    """Times of one call of ``fn``: ``ms``, the median CUDA-event time of
    the device work the call queues; ``host_ms``, the median host time the
    call takes to queue it; ``ahead``, how many of the ``reps`` calls were
    queued whole before their start event fired. Where any was, ``ms`` is
    the median over those alone.

    Before every call the L2 cache is flushed (the main path reads freshly
    copied features, not cached ones) and a spin kernel is queued that
    outlasts the call's host work, with the start event behind it. So the
    events bracket the queued work alone, back to back, and not the host
    time between launches. A call that waits for the card itself (a copy
    to the host, a data-dependent size) cannot be queued ahead; its ``ms``
    then includes the host time after that wait, and ``ahead`` says so."""
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    spin_ms = 2.0 + 4e3 * (time.perf_counter() - t0)
    torch.cuda.synchronize()
    device, host, queued = [], [], []
    for _ in range(reps):
        flush.zero_()
        torch.cuda._sleep(int(SPIN_CYCLES_PER_MS * spin_ms))
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        t0 = time.perf_counter()
        fn()
        host.append((time.perf_counter() - t0) * 1e3)
        queued.append(not start.query())
        end.record()
        torch.cuda.synchronize()
        device.append(start.elapsed_time(end))
    if any(queued):
        device = [ms for ms, q in zip(device, queued) if q]
    return {"ms": statistics.median(device), "host_ms": statistics.median(host),
            "ahead": sum(queued), "reps": reps}


def _time_kernel_ms(torch, fn) -> dict:
    """:func:`_time_ms` of a kernel's wrapper, which never waits for the
    card: most calls must have been queued ahead of their start event (a
    host thread descheduled past the spin can miss it now and then)."""
    t = _time_ms(torch, fn)
    if 2 * t["ahead"] < t["reps"]:
        raise AssertionError(f"a kernel call started before it was queued whole: {t}")
    return t


def _bound_ms(nbytes: float, ops: float) -> tuple:
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _max_abs_err(got, want) -> float:
    g = got.double().cpu().numpy().ravel()
    w = want.double().cpu().numpy().ravel()
    same = (np.isnan(g) & np.isnan(w)) | (g == w)
    diff = np.abs(g[~same] - w[~same])
    return float(diff.max()) if diff.size else 0.0


def check_kernels(torch, engine, features) -> dict:
    """Hold every kernel launch the main path makes on one batch against
    its plain version, printing each launch's times; returns per kernel the
    summed measurements of one batch's launches."""
    from deequ_tpu_torch.analyzers.base import resolve_slot
    from deequ_tpu_torch.analyzers.grouping import DeviceFrequencyScan
    from deequ_tpu_torch.analyzers.sketches import ApproxCountDistinct, KLLSketch
    from deequ_tpu_torch.kernels.dict_code_counts import dict_code_counts, dict_code_counts_plain
    from deequ_tpu_torch.kernels.hll_registers import hll_registers, hll_registers_plain
    from deequ_tpu_torch.kernels.scan_reduce import KIND_MOMENTS, scan_reduce, scan_reduce_plain

    rows = features["rows"]
    n = rows.shape[0]
    results = _new_results()
    add = functools.partial(_add, results)

    # K1: one launch per bundle of slots
    for bundle in engine.program.bundles:
        slots = [resolve_slot(spec, features) for spec in bundle]
        ki, kf = scan_reduce(slots, rows)
        pi, pf = scan_reduce_plain(slots, rows)
        torch.cuda.synchronize()
        if not torch.equal(ki, pi):
            raise AssertionError("scan_reduce counts differ from the plain version")
        kf_h, pf_h = kf.cpu().numpy(), pf.cpu().numpy()
        for col in (1, 2):
            a, b = kf_h[:, col], pf_h[:, col]
            same = (np.isnan(a) & np.isnan(b)) | ((a == b) & (np.signbit(a) == np.signbit(b)))
            if not same.all():
                raise AssertionError(f"scan_reduce min/max column {col} differs from the plain version")
        for s, slot in enumerate(slots):
            if slot.vals is None:
                continue
            v = slot.vals.double()
            v = v[torch.isfinite(v)]
            scales = [float(v.abs().sum()), float(v.abs().max()), float((v * v).sum())]
            for col, scale in zip((0, 3, 4), scales):
                a, b = kf_h[s, col], pf_h[s, col]
                if not ((np.isnan(a) and np.isnan(b)) or abs(a - b) <= 1e-12 * max(scale, 1.0)):
                    raise AssertionError(f"scan_reduce slot {s} column {col}: {a!r} vs {b!r}")
        arrays = {id(t): t for slot in slots for t in (slot.where, slot.sel, slot.vals) if t is not None}
        arrays[id(rows)] = rows
        nbytes = sum(t.numel() * t.element_size() for t in arrays.values()) + len(slots) * 7 * 8
        sel = pi[:, 0].cpu().numpy()
        ops = sum(2 * n + (7 * int(sel[s]) if slot.kind == KIND_MOMENTS else 0)
                  for s, slot in enumerate(slots))
        add("scan_reduce", f"{len(slots)} slots", _max_abs_err(kf, pf),
            _time_kernel_ms(torch, lambda: scan_reduce(slots, rows)),
            _time_ms(torch, lambda: scan_reduce_plain(slots, rows)), nbytes, ops)

    for a in engine.scan_analyzers:
        if isinstance(a, ApproxCountDistinct):
            key = a._where_key()
            args = (features[f"hll:{a.column}"], rows,
                    None if key is None else features[key], features[f"mask:{a.column}"])
            got, want = hll_registers(*args), hll_registers_plain(*args)
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                raise AssertionError(f"hll_registers differs from the plain version on {a.column}")
            valid = args[1] & args[3]
            k = torch.where(valid, args[0].to(torch.int32), 0)
            idx, rank = (k >> 6).long(), k & 63
            library = _time_ms(torch, lambda: torch.zeros(512, dtype=torch.int32, device="cuda")
                               .scatter_reduce_(0, idx, rank, "amax"))
            add("hll_registers", a.column, _max_abs_err(got, want),
                _time_kernel_ms(torch, lambda: hll_registers(*args)),
                _time_ms(torch, lambda: hll_registers_plain(*args)),
                4 * n + 512 * 4, 2 * n, library)
        elif isinstance(a, DeviceFrequencyScan):
            _check_counts(torch, add, features[f"codes:{a.column}"], rows,
                          features[f"mask:{a.column}"], a.num_categories,
                          dict_code_counts, dict_code_counts_plain, True)
        elif isinstance(a, KLLSketch):
            key = a._where_key()
            _check_kll(torch, add, a.column, a._sketch_size(), features[f"num:{a.column}"], rows,
                       None if key is None else features[key], features[f"mask:{a.column}"])
    # the >48 KB shared-memory path, which the main path's dictionaries skip
    rng = np.random.default_rng(0)
    codes = torch.from_numpy(rng.integers(0, ATTRIBUTE_PATH_CATEGORIES, n).astype(np.int32)).cuda()
    _check_counts(torch, add, codes, rows, rows, ATTRIBUTE_PATH_CATEGORIES,
                  dict_code_counts, dict_code_counts_plain, False)
    return results


def _new_results() -> dict:
    return {name: {"ms": 0.0, "plain_ms": 0.0, "library_ms": None, "bound_ms": 0.0,
                   "max_abs_err": 0.0, "bound_by": "bytes"}
            for name in TPU_KERNELS}


def _add(results, name, label, err, kernel, plain, nbytes, ops, library=None) -> None:
    """Add one launch's measurements to ``results[name]`` and print them."""
    r = results[name]
    r["max_abs_err"] = max(r["max_abs_err"], err)
    r["ms"] += kernel["ms"]
    r["plain_ms"] += plain["ms"]
    bound, by = _bound_ms(nbytes, ops)
    r["bound_ms"] += bound
    r["bound_by"] = by
    if library is not None:
        r["library_ms"] = (r["library_ms"] or 0.0) + library["ms"]
    lib = "None" if library is None else (
        f"{library['ms']:.4f} (queued ahead {library['ahead']}/{library['reps']})")
    print(f"[launch {name} {label}] ms={kernel['ms']:.4f} host_ms={kernel['host_ms']:.4f} "
          f"plain_ms={plain['ms']:.4f} (queued ahead {plain['ahead']}/{plain['reps']}) "
          f"library_ms={lib} bound_ms={bound:.4f} ({by}) bytes={nbytes}", flush=True)


def _same_bits(got, want) -> bool:
    return all(g.cpu().numpy().tobytes() == w.cpu().numpy().tobytes() for g, w in zip(got, want))


def _compact_bytes(sizes: list, level: int, m: int, k: int, width: int) -> int:
    """Bytes K5 must move to append ``m`` items at ``level`` and run the
    cascade on these level sizes: the appended items read and written,
    then per compacted level its n items read, the level rewritten and
    n / 2 items written one level up."""
    sizes = list(sizes)
    nbytes = 8 * m
    sizes[level] = min(sizes[level] + m, width)
    while level < len(sizes) - 1 and sizes[level] > k:
        n = sizes[level]
        nbytes += 4 * n + 4 * n + 4 * (n // 2)
        sizes[level + 1] = min(sizes[level + 1] + n // 2, width)
        sizes[level] = n & 1
        level += 1
    return nbytes


def _check_kll(torch, add, label, k, values, rows, where, present) -> None:
    """K4 on one batch of a column, then K5 appending a second sample of it
    to a sketch that already holds the first: the append overflows level h
    and compacts it, as the second batch of the main path does."""
    from deequ_tpu_torch.kernels.kll_compact import kll_compact_update, kll_compact_update_plain
    from deequ_tpu_torch.kernels.kll_sample import F32_MAX, kll_sample, kll_sample_plain
    from deequ_tpu_torch.ops.kll import kll_init, kll_update

    n = values.shape[0]
    state = kll_init(k, device=values.device)
    args = (values, rows, where, present)
    got, want = kll_sample(*args, state.ticks, k), kll_sample_plain(*args, state.ticks, k)
    torch.cuda.synchronize()
    if not _same_bits(got, want):
        raise AssertionError(f"kll_sample differs from the plain version on {label}")
    keep = rows & present & ~torch.isnan(values)
    if where is not None:
        keep &= where
    items = torch.where(keep, values.clamp(-F32_MAX, F32_MAX), float("inf")).float()
    mask_bytes = n * (2 + (where is not None))
    add("kll_sample", label, _max_abs_err(got.samples, want.samples),
        _time_kernel_ms(torch, lambda: kll_sample(*args, state.ticks, k)),
        _time_ms(torch, lambda: kll_sample_plain(*args, state.ticks, k)),
        8 * n + mask_bytes + 4 * k + 12 + 16, n, _time_ms(torch, lambda: torch.sort(items)))

    state = kll_update(state, *args)
    sample = kll_sample(*args, state.ticks, k)
    got = kll_compact_update(state.tensors(), sample, k)
    want = kll_compact_update_plain(state.tensors(), sample, k)
    torch.cuda.synchronize()
    if not _same_bits(got, want):
        raise AssertionError(f"kll_compact differs from the plain version on {label}")
    m, h, _ = sample.meta.tolist()
    sizes = state.sizes.tolist()
    level = state.items[h, :sizes[h]].clone()
    level = torch.cat([level, sample.samples[:m]])
    add("kll_compact", f"{label} level {h}: {sizes[h]} + {m} items",
        _max_abs_err(got[0], want[0]),
        _time_kernel_ms(torch, lambda: kll_compact_update(state.tensors(), sample, k)),
        _time_ms(torch, lambda: kll_compact_update_plain(state.tensors(), sample, k)),
        _compact_bytes(sizes, h, m, k, state.items.shape[1]), level.numel(),
        _time_ms(torch, lambda: torch.sort(level)))


def check_kll_edges(torch, values, rows, k: int = KLL_SKETCH_SIZE) -> None:
    """K4 on a batch of signed zeros, NaN, +-inf and values beyond the
    float32 range, and K5 merging the sketch of that batch into the
    sketch of a main-path column: both bit-exact against the plain
    versions. Prints the merge's times, and a profiler trace of K4's and
    K5's launches on the main-path column."""
    from deequ_tpu_torch.kernels.kll_compact import (
        kll_compact_merge,
        kll_compact_merge_plain,
        kll_compact_update,
    )
    from deequ_tpu_torch.kernels.kll_sample import kll_sample, kll_sample_plain
    from deequ_tpu_torch.ops.kll import kll_init, kll_update

    n = values.shape[0]
    rng = np.random.default_rng(7)
    v = rng.normal(0.0, 1.0, n)
    for value, p in ((0.0, 0.1), (-0.0, 0.1), (np.nan, 0.05), (np.inf, 0.01), (-np.inf, 0.01),
                     (1e300, 0.02), (-3.5e38, 0.02)):
        v[rng.random(n) < p] = value
    device = values.device
    edge = torch.from_numpy(v).to(device)
    present = torch.from_numpy(rng.random(n) < 0.9).to(device)
    ticks = torch.tensor(3, dtype=torch.int32, device=device)
    got = kll_sample(edge, rows, None, present, ticks, k)
    want = kll_sample_plain(edge, rows, None, present, ticks, k)
    torch.cuda.synchronize()
    if not _same_bits(got, want):
        raise AssertionError("kll_sample differs from the plain version on the edge batch")
    a = kll_update(kll_update(kll_init(k, device=device), values, rows), values, rows)
    b = kll_update(kll_init(k, device=device), edge, rows, None, present)
    got = kll_compact_merge(a.tensors(), b.tensors(), k)
    want = kll_compact_merge_plain(a.tensors(), b.tensors(), k)
    torch.cuda.synchronize()
    if not _same_bits(got, want):
        raise AssertionError("kll_compact's merge differs from the plain version")
    kernel = _time_kernel_ms(torch, lambda: kll_compact_merge(a.tensors(), b.tensors(), k))
    plain = _time_ms(torch, lambda: kll_compact_merge_plain(a.tensors(), b.tensors(), k))
    print(f"[kll edges] kll_sample bit-exact on signed zeros, NaN, +-inf and |v| > f32 max; "
          f"merge of sketches of {a.sizes.tolist()[:12]} and {b.sizes.tolist()[:12]} items "
          f"bit-exact: ms={kernel['ms']:.4f} host_ms={kernel['host_ms']:.4f} "
          f"plain_ms={plain['ms']:.4f}", flush=True)
    # the second batch of the main path: its append overflows level h
    one = kll_update(kll_init(k, device=device), values, rows)
    sample = kll_sample(values, rows, None, None, one.ticks, k)
    trace_kernels(torch, "kll_sample", lambda: kll_sample(values, rows, None, None, one.ticks, k))
    trace_kernels(torch, "kll_compact", lambda: kll_compact_update(one.tensors(), sample, k))


def trace_kernels(torch, label: str, fn, calls: int = 10) -> None:
    """Device time per call of each CUDA kernel that ``fn`` launches, from
    torch.profiler's CUDA activity (CUPTI); says so where the profiler
    records none."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    try:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
    except RuntimeError as exc:
        print(f"[trace {label}] torch.profiler failed: {exc}", flush=True)
        return
    events = [(e.key, getattr(e, "device_time_total", 0.0), e.count)
              for e in prof.key_averages()]
    events = sorted((e for e in events if e[1] > 0), key=lambda e: -e[1])
    if not events:
        print(f"[trace {label}] torch.profiler recorded no device time", flush=True)
    for key, us, count in events:
        print(f"[trace {label}] {key}: {us / calls / 1e3:.4f} ms in {count / calls:g} "
              "launches per call", flush=True)


def _check_counts(torch, add, codes, rows, present, k, kernel, plain, main_path):
    got, got_rows = kernel(codes, rows, present, k)
    want, want_rows = plain(codes, rows, present, k)
    torch.cuda.synchronize()
    if not (torch.equal(got, want) and int(got_rows) == int(want_rows)):
        raise AssertionError(f"dict_code_counts differs from the plain version at K={k}")
    if not main_path:
        return
    n = codes.shape[0]
    keys = torch.where(rows & present & (codes >= 0) & (codes < k), codes, k).long()
    library = _time_ms(torch, lambda: torch.bincount(keys, minlength=k + 1))
    add("dict_code_counts", f"K={k}", _max_abs_err(got, want),
        _time_kernel_ms(torch, lambda: kernel(codes, rows, present, k)),
        _time_ms(torch, lambda: plain(codes, rows, present, k)),
        6 * n + 8 * k + 8, 2 * n, library)
    # the same launch on codes spread evenly over the K codes: the time the
    # skew of the main path's codes adds (atomics on the same few bins)
    even = torch.randint(0, k, (n,), dtype=torch.int32, device=codes.device,
                         generator=torch.Generator(codes.device).manual_seed(0))
    t = _time_kernel_ms(torch, lambda: kernel(even, rows, present, k))
    print(f"[launch dict_code_counts K={k} even codes] ms={t['ms']:.4f}", flush=True)


# ---------------------------------------------------------------------------
# phase 2 for the grouping path: K6 freq_keys and K7 freq_compact
# ---------------------------------------------------------------------------


def _table_features(torch, dq, table: pa.Table, cols: tuple):
    """The first 1M-row batch's features of the device frequency table
    that the runner plans for ``cols`` of ``table``, on the card, and the
    planned scan."""
    from deequ_tpu_torch.analyzers.grouping import plan_table_scan
    from deequ_tpu_torch.runners.engine import ScanEngine, to_device

    data = dq.Dataset.from_arrow(table)
    scan = plan_table_scan(data.schema, cols, data.num_rows, BATCH_ROWS)
    engine = ScanEngine([scan], torch.device("cuda"))
    batch = next(data.batches(BATCH_ROWS, columns=list(cols)))
    return scan, to_device(engine.builder.build(batch), torch.device("cuda"))


def _check_freq_keys(torch, add, label, columns, rows):
    """K6 on one batch against its plain version (keys and counters bit
    for bit); returns the kernel's keys."""
    from deequ_tpu_torch.kernels.freq_keys import freq_keys, freq_keys_plain

    n = rows.shape[0]
    got_keys = torch.empty(n, dtype=torch.int64, device="cuda")
    want_keys = torch.empty_like(got_keys)
    got = freq_keys(columns, rows, got_keys, 0)
    want = freq_keys_plain(columns, rows, want_keys, 0)
    torch.cuda.synchronize()
    if not (torch.equal(got_keys, want_keys) and torch.equal(got, want)):
        raise AssertionError(f"freq_keys differs from the plain version on {label}")
    nbytes = n + sum(n + c.values.numel() * c.values.element_size() for c in columns) + 8 * n + 16
    # SplitMix64 or a load per column and an xxhash64 per chained column:
    # about 10 and 16 integer operations a row
    ops = n * (10 * len(columns) + 16 * (len(columns) - 1))
    add("freq_keys", f"{label}: {n} rows, {len(columns)} columns, sent_rows={int(got[0])}",
        0.0, _time_kernel_ms(torch, lambda: freq_keys(columns, rows, got_keys, 0)),
        _time_ms(torch, lambda: freq_keys_plain(columns, rows, want_keys, 0)), nbytes, ops)
    return got_keys


def _full_table(torch, start: int, slots: int):
    """A full table of ``slots`` sorted keys: the SplitMix64 keys of the
    integers start .. start + slots - 1, each with a count of 1 to 8."""
    from deequ_tpu_torch.kernels.freq_compact import freq_compact_plain
    from deequ_tpu_torch.ops.hashing import splitmix64_torch

    keys = splitmix64_torch(torch.arange(start, start + slots, dtype=torch.int64, device="cuda"))
    counts = 1 + torch.arange(slots, dtype=torch.int64, device="cuda") % 8
    return freq_compact_plain(keys, counts, slots)


def _check_freq_compact(torch, add, label, a_keys, a_counts, b_keys, b_counts, out_size) -> None:
    """K7 against the reference's compaction in plain PyTorch on the same
    pairs: every output bit for bit."""
    from deequ_tpu_torch.kernels.freq_compact import freq_compact, freq_compact_plain
    from deequ_tpu_torch.ops.hashing import FREQ_KEY_SENTINEL_I64

    counts_b = b_counts if b_counts is not None else (b_keys != FREQ_KEY_SENTINEL_I64).long()
    keys = torch.cat([a_keys, b_keys])
    counts = torch.cat([a_counts, counts_b])
    got = freq_compact(a_keys, a_counts, b_keys, b_counts, out_size)
    want = freq_compact_plain(keys, counts, out_size)
    torch.cuda.synchronize()
    for field, g, w in zip(got._fields, got, want):
        if not torch.equal(g, w):
            raise AssertionError(f"freq_compact {field} differs from the plain version on {label}")
    na, nb = a_keys.shape[0], b_keys.shape[0]
    # pairs read (a buffer's keys alone), the table written, and the scalars
    nbytes = 16 * na + (8 if b_counts is None else 16) * nb + 16 * out_size + 32
    add("freq_compact", f"{label}: {na} + {nb} entries into {out_size}, "
        f"n_unique={int(got.n_unique)} kept={int(got.kept_rows)} total={int(got.total_rows)}",
        0.0, _time_kernel_ms(torch, lambda: freq_compact(a_keys, a_counts, b_keys, b_counts,
                                                         out_size)),
        _time_ms(torch, lambda: freq_compact_plain(keys, counts, out_size)), nbytes, na + nb,
        _time_ms(torch, lambda: torch.sort(keys)))


def check_freq_kernels(torch, dq, grouping: pa.Table, lineitem: pa.Table) -> dict:
    """K6 and K7 at the grouping path's shapes, each bit-exact against its
    plain version; returns the measurements of the main path's launches:
    K6 on the first batch of the bench grouping workload, K7 compacting
    that batch's keys into a full 2^22-slot table. Also checked and
    printed: K6 on lineitem's two-column key and on an edge batch, K7
    merging two full tables and compacting the edge batch's keys."""
    from deequ_tpu_torch.data import ColumnKind
    from deequ_tpu_torch.kernels.freq_compact import freq_compact
    from deequ_tpu_torch.kernels.freq_keys import KIND_HASH, KIND_NUM, KeyColumn
    from deequ_tpu_torch.ops.hashing import hash_column

    results, others = _new_results(), _new_results()
    scan, features = _table_features(torch, dq, grouping, ("k",))
    if scan.resident is not True:
        raise AssertionError(f"the grouping workload should plan resident, got {scan}")
    keys = _check_freq_keys(torch, functools.partial(_add, results), "bench grouping batch 1",
                            scan.key_columns(features), features["rows"])
    table = _full_table(torch, 0, FULL_TABLE_SLOTS)
    _check_freq_compact(torch, functools.partial(_add, results), "non-resident compaction",
                        table.keys, table.counts, keys, None, FULL_TABLE_SLOTS)

    add = functools.partial(_add, others)
    pk_scan, pk = _table_features(torch, dq, lineitem, ("l_orderkey", "l_linenumber"))
    _check_freq_keys(torch, add, "lineitem (l_orderkey, l_linenumber)",
                     pk_scan.key_columns(pk), pk["rows"])
    other = _full_table(torch, FULL_TABLE_SLOTS // 2, FULL_TABLE_SLOTS)
    _check_freq_compact(torch, add, "merge of two full tables", table.keys, table.counts,
                        other.keys, other.counts, FULL_TABLE_SLOTS)

    # the edge batch: the int64 whose SplitMix64 is the sentinel (a real
    # key counted in sent_rows), negative and narrow integers, booleans,
    # and NaN, -0.0 and 0.0 as xxhash64 keys
    n = BATCH_ROWS
    rng = np.random.default_rng(5)
    i64 = rng.integers(-50, 50, n)
    i64[::101] = SENTINEL_PREIMAGE
    f = rng.integers(-20, 20, n) / 4.0
    f[rng.random(n) < 0.05] = np.nan
    f[rng.random(n) < 0.05] = -0.0
    fmask = rng.random(n) < 0.97
    cuda = lambda a: torch.from_numpy(np.ascontiguousarray(a)).cuda()  # noqa: E731
    edge = [
        KeyColumn(KIND_NUM, cuda(i64), cuda(rng.random(n) < 0.98)),
        KeyColumn(KIND_NUM, cuda(rng.integers(-128, 128, n).astype(np.int8)), cuda(np.ones(n, bool))),
        KeyColumn(KIND_NUM, cuda(rng.integers(-2**31, 2**31, n).astype(np.int32) // 4096),
                  cuda(np.ones(n, bool))),
        KeyColumn(KIND_NUM, cuda((rng.random(n) < 0.5).astype(np.float64)), cuda(np.ones(n, bool))),
        KeyColumn(KIND_HASH, cuda(hash_column(f, fmask, ColumnKind.FRACTIONAL).view(np.int64)),
                  cuda(fmask)),
    ]
    rows = cuda(rng.random(n) < 0.99)
    for width in (1, 2, 5):
        edge_keys = _check_freq_keys(torch, add, f"edge batch, {width} columns", edge[:width],
                                     rows)
        small = _full_table(torch, 0, 1 << 10)
        _check_freq_compact(torch, add, f"edge keys of {width} columns", small.keys,
                            small.counts, edge_keys, None, 1 << 16)
    trace_kernels(torch, "freq_compact",
                  lambda: freq_compact(table.keys, table.counts, keys, None, FULL_TABLE_SLOTS))
    return results


#: the int64 whose SplitMix64 mix is all ones, the frequency key sentinel
SENTINEL_PREIMAGE = -3487469807577879104


# ---------------------------------------------------------------------------
# phase 5: the grouping path
# ---------------------------------------------------------------------------


def build_grouping(rows: int = GROUPING_ROWS, distinct: int = GROUPING_DISTINCT,
                   seed: int = GROUPING_SEED) -> pa.Table:
    """The bench's grouping workload: ``rows`` int64 keys drawn uniformly
    from ``distinct`` values (tools/grouping_sweep.py measure_point)."""
    rng = np.random.default_rng(seed)
    return pa.table({"k": rng.integers(0, distinct, rows)})


def _count_metrics(counts: np.ndarray, rows: int) -> dict:
    """Uniqueness, CountDistinct and Entropy of a count multiset."""
    p = counts / rows
    return {"Uniqueness": float((counts == 1).sum()) / rows, "CountDistinct": float(len(counts)),
            "Entropy": float(-(p * np.log(p)).sum())}


def _compare_grouping(got: dict, want: dict, rtol: float) -> list:
    problems = []
    for name, w in want.items():
        g = got[name]
        ok = g == w if name != "Entropy" else abs(g - w) <= rtol * abs(w)
        if not ok:
            problems.append(f"{name}: {g!r} != {w!r}")
    return problems


def _timed_run(torch, label: str, run, rows: int, kernels=()) -> tuple:
    """Run ``run(monitor)`` on the card with the launch counts set to 0
    just before; prints rows/s, the phases, launches and peak memory, and
    fails when a kernel of ``kernels`` was not launched."""
    import deequ_tpu_torch as dq
    from deequ_tpu_torch.kernels import launch_counts, reset_launch_counts

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    monitor = dq.RunMonitor()
    reset_launch_counts()
    t0 = time.perf_counter()
    out = run(monitor)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    phases = {k: round(v, 4) for k, v in monitor.phase_seconds.items()}
    print(f"[{label}] {rows} rows in {seconds:.3f}s = {rows / seconds:.0f} rows/s; "
          f"passes={monitor.passes} batches={monitor.batches} "
          f"device_freq_sets={monitor.device_freq_sets} "
          f"freq_overflow_fallbacks={monitor.freq_overflow_fallbacks}; launches={launches}; "
          f"peak device memory {peak / 2**20:.1f} MiB; phases={phases}", flush=True)
    missing = [name for name in kernels if launches[name] == 0]
    if missing:
        raise AssertionError(f"{label} launched no {missing}")
    return out, monitor, launches


def grouping_runs(torch, dq, grouping: pa.Table) -> dict:
    """Phase 5 (a)-(c): the bench grouping workload resident, with a
    non-resident 2^22-slot table, and overflowing a 2^20-slot table; each
    held against (a) on the CPU and a numpy oracle. Returns the launch
    counts of (a) and (b)."""
    rows = grouping.num_rows
    data = dq.Dataset.from_arrow(grouping)
    battery = [dq.Uniqueness(["k"]), dq.CountDistinct(["k"]), dq.Entropy("k")]

    def run(device, **options):
        def go(monitor):
            ctx = (dq.AnalysisRunner.on_data(data, device=device).add_analyzers(battery)
                   .with_batch_size(BATCH_ROWS).with_monitor(monitor)
                   .with_frequency_options(**options).run())
            return {a.name: ctx.metric(a).value.get() for a in battery}
        return go

    expected_batches = -(-rows // BATCH_ROWS)
    resident, mon_a, launches_a = _timed_run(torch, "grouping (a) resident", run("cuda"), rows,
                                             ("freq_keys",))
    if launches_a["freq_keys"] != expected_batches or launches_a["freq_compact"] != 0:
        raise AssertionError(f"(a) expected {expected_batches} freq_keys launches and no "
                             f"freq_compact: {launches_a}")
    if mon_a.device_freq_sets != 1 or mon_a.passes != 1:
        raise AssertionError(f"(a) should run one device table in one pass: {mon_a}")
    t0 = time.perf_counter()
    cpu = run("cpu")(dq.RunMonitor())
    print(f"[cpu] grouping (a) on the CPU in {time.perf_counter() - t0:.1f}s", flush=True)
    _, counts = np.unique(grouping["k"].to_numpy(), return_counts=True)
    oracle = _count_metrics(counts, rows)
    problems = _compare_grouping(resident, cpu, 0.0) + _compare_grouping(resident, oracle, 1e-9)

    compacting, mon_b, launches_b = _timed_run(
        torch, "grouping (b) non-resident", run("cuda", freq_buffer_entries=FULL_TABLE_SLOTS),
        rows, FREQ_KERNELS)
    # no fallback pass: the drain found lost_rows == 0
    if mon_b.freq_overflow_fallbacks != 0 or mon_b.passes != 1:
        raise AssertionError(f"(b) should keep every group in one pass: {mon_b}")
    problems += [f"(b) {p}" for p in _compare_grouping(compacting, resident, 0.0)]

    overflowing, mon_c, _ = _timed_run(
        torch, "grouping (c) overflow", run("cuda", freq_table_slots=OVERFLOW_TABLE_SLOTS,
                                            freq_buffer_entries=FULL_TABLE_SLOTS),
        rows, FREQ_KERNELS)
    if mon_c.freq_overflow_fallbacks != 1 or mon_c.passes != 2:
        raise AssertionError(f"(c) should overflow and re-run on the host once: {mon_c}")
    problems += [f"(c) {p}" for p in _compare_grouping(overflowing, resident, 0.0)]
    if problems:
        raise AssertionError("grouping metrics disagree:\n" + "\n".join(problems))
    print(f"[grouping metrics] (a), (b) and (c) agree with the CPU run and the oracle: "
          f"{resident}", flush=True)
    return {"resident": launches_a, "compaction": launches_b}


def build_lineitem_check(dq, rows: int):
    """Lineitem's key checks (phase 5 d): its primary key, distinctness
    and entropy of keys and measures, the comment dictionary, and scan
    checks beside them."""
    yes = lambda _: True  # noqa: E731 - the values are compared, not asserted
    return (
        dq.Check(dq.CheckLevel.ERROR, "lineitem keys")
        .has_size(lambda n: n == rows)
        .is_primary_key("l_orderkey", "l_linenumber")
        .has_uniqueness(["l_partkey"], yes)
        .has_entropy("l_suppkey", yes)
        .has_distinctness(["l_extendedprice"], yes)
        .has_number_of_distinct_values("l_comment", yes)
        .has_unique_value_ratio(["l_comment"], yes)
        .is_complete("l_orderkey")
        .has_mean("l_quantity", yes)
        .is_non_negative("l_discount")
        .has_approx_count_distinct("l_partkey", yes)
        .is_contained_in("l_returnflag", ["A", "N", "R"])
    )


def lineitem_oracle(table: pa.Table) -> dict:
    """The lineitem checks' grouping metrics from pandas value counts."""
    import pandas as pd

    n = table.num_rows
    df = table.select(["l_orderkey", "l_linenumber", "l_partkey", "l_suppkey",
                       "l_extendedprice"]).to_pandas()
    pk = df.groupby(["l_orderkey", "l_linenumber"]).size().to_numpy()
    part = df["l_partkey"].value_counts().to_numpy()
    supp = df["l_suppkey"].value_counts().to_numpy()
    price = df["l_extendedprice"].value_counts(dropna=False).to_numpy()
    codes = table["l_comment"].combine_chunks().indices.to_numpy()
    comment = np.bincount(codes)
    comment = comment[comment > 0]
    p = supp / n
    return {
        ("Uniqueness", "l_orderkey,l_linenumber", None): (pk == 1).sum() / n,
        ("Uniqueness", "l_partkey", None): (part == 1).sum() / n,
        ("Entropy", "l_suppkey", None): float(-(p * np.log(p)).sum()),
        ("Distinctness", "l_extendedprice", None): len(price) / n,
        ("UniqueValueRatio", "l_comment", None): (comment == 1).sum() / len(comment),
        ("Size", "*", None): float(n),
        "comment bins": len(comment),
    }


#: BASELINE config 1: the five items of examples/example_utils.py
SAMPLE_ITEMS = (
    (1, "Thingy A", "awesome thing.", "high", 0),
    (2, "Thingy B", "available at http://thingb.com", None, 0),
    (3, None, None, "low", 5),
    (4, "Thingy D", "checkout https://thingd.ca", "low", 10),
    (5, "Thingy E", None, "high", 12),
)


def basic_example(dq, device: str, monitor=None):
    """examples/basic_example.py's verification on ``device``."""
    names = ("id", "productName", "description", "priority", "numViews")
    types = (pa.int64(), pa.string(), pa.string(), pa.string(), pa.int64())
    table = pa.table({name: pa.array([item[i] for item in SAMPLE_ITEMS], type=t)
                      for i, (name, t) in enumerate(zip(names, types))})
    return (
        dq.VerificationSuite.on_data(dq.Dataset.from_arrow(table), device=device)
        .add_check(
            dq.Check(dq.CheckLevel.ERROR, "integrity checks")
            .has_size(lambda size: size == 5)
            .is_complete("id")
            .is_unique("id")
            .is_complete("productName")
            .is_contained_in("priority", ["high", "low"])
            .is_non_negative("numViews"))
        .add_check(
            dq.Check(dq.CheckLevel.WARNING, "distribution checks")
            .contains_url("description", lambda ratio: ratio >= 0.5)
            .has_approx_quantile("numViews", 0.5, lambda median: median <= 10))
        .with_monitor(monitor or dq.RunMonitor())
        .run()
    )


def _statuses(result) -> list:
    return [(r.status, [c.status for c in r.constraint_results])
            for r in result.check_results.values()]


def grouping_path(torch, dq, lineitem: pa.Table) -> tuple:
    """Phase 2 at the grouping path's shapes, then phase 5 (a)-(e).
    Returns the K6 and K7 measurements and the launch counts of the runs
    that report them."""
    t0 = time.perf_counter()
    grouping = build_grouping()
    print(f"[grouping data] {grouping.num_rows} rows, {GROUPING_DISTINCT} possible keys in "
          f"{time.perf_counter() - t0:.1f}s", flush=True)
    measured = check_freq_kernels(torch, dq, grouping, lineitem)
    _print_kernel_totals(measured, FREQ_KERNELS, "grouping path")
    launches = grouping_runs(torch, dq, grouping)
    del grouping

    # (d) lineitem's keys through VerificationSuite
    rows = lineitem.num_rows
    data = dq.Dataset.from_arrow(lineitem)
    check = build_lineitem_check(dq, rows)

    def verify(device):
        return lambda monitor: (dq.VerificationSuite.on_data(data, device=device)
                                .add_check(check).with_monitor(monitor).run())

    result, monitor, _ = _timed_run(torch, "grouping (d) lineitem keys", verify("cuda"), rows,
                                    VERIFICATION_KERNELS + ("freq_keys",))
    if monitor.device_freq_sets != 4 or monitor.passes != 1:
        raise AssertionError(f"(d) should run four device tables in one pass: {monitor}")
    t0 = time.perf_counter()
    cpu_result = verify("cpu")(dq.RunMonitor())
    print(f"[cpu] lineitem keys on the CPU in {time.perf_counter() - t0:.1f}s", flush=True)
    gpu_metrics = metric_values(result)
    problems = compare_metrics(gpu_metrics, metric_values(cpu_result))
    want = lineitem_oracle(lineitem)
    bins = want.pop("comment bins")
    problems += compare_oracle(gpu_metrics, want)
    got_bins = gpu_metrics[("Histogram", "l_comment", None)][0]
    if got_bins != bins:
        problems.append(f"l_comment histogram: {got_bins} bins, oracle {bins}")
    if _statuses(result) != _statuses(cpu_result):
        problems.append(f"check statuses differ: {_statuses(result)}")
    if problems:
        raise AssertionError("lineitem metrics disagree:\n" + "\n".join(problems))
    print(f"[lineitem metrics] {len(gpu_metrics)} metrics agree with the CPU run and the "
          f"oracle; check status {result.status.value}", flush=True)
    del data, result, cpu_result

    # (e) BasicExample
    example, _, _ = _timed_run(torch, "grouping (e) BasicExample",
                               lambda monitor: basic_example(dq, "cuda", monitor),
                               len(SAMPLE_ITEMS),
                               ("freq_keys",))
    cpu_example = basic_example(dq, "cpu")
    problems = compare_metrics(metric_values(example), metric_values(cpu_example))
    if _statuses(example) != _statuses(cpu_example) or problems:
        raise AssertionError(f"BasicExample differs from its CPU run: {problems}")
    print(f"[basic example] status {example.status.value}, equal to the CPU run", flush=True)
    return measured, launches


# ---------------------------------------------------------------------------
# main
# ---------------------------------------------------------------------------


# ---------------------------------------------------------------------------
# phase 6: the incremental path, BASELINE config 4
# ---------------------------------------------------------------------------

#: BASELINE config 4: two day partitions of 50M rows of the JAX bench's
#: scan table (bench.py build_scan_data, seed 42), batches of 1M
INCREMENTAL_PARTITION_ROWS = 50_000_000
INCREMENTAL_PARTITIONS = 2
#: the CPU comparison runs the same phase at 2 x 5M rows
INCREMENTAL_CPU_PARTITION_ROWS = 5_000_000
INCREMENTAL_SEED = 42
#: months of day partitions: the N of state_fold's every-kind check
MONTH_OF_DAYS = 32


def build_scan_data(rows: int, seed: int = INCREMENTAL_SEED) -> pa.Table:
    """``bench.py build_scan_data``: x0-x3 normal (mean 100 i, sd 10) with
    5% nulls and ``cat``, int64 over 100,000 values; plus the second
    battery's columns: ``grade``, a dictionary of 100 categories
    (cat // 1000), and ``x3n``, x3 with NaN where cat % 97 == 0."""
    rng = np.random.default_rng(seed)
    cols = {}
    for i in range(4):
        vals = rng.normal(100 * i, 10, rows)
        nulls = rng.random(rows) < 0.05
        cols[f"x{i}"] = pa.array(vals, mask=nulls)
    cat = rng.integers(0, 100_000, rows)
    cols["cat"] = pa.array(cat)
    cols["grade"] = pa.DictionaryArray.from_arrays(
        pa.array((cat // 1000).astype(np.int32)), pa.array([f"g{i:02d}" for i in range(100)]))
    x3 = cols["x3"].to_numpy(zero_copy_only=False).copy()
    x3[cat % 97 == 0] = np.nan
    cols["x3n"] = pa.array(x3, mask=np.asarray(cols["x3"].is_null()))
    return pa.table(cols)


def incremental_battery(dq) -> list:
    """The bench's config-4 battery (bench.py run_incremental_stage)."""
    return [dq.Size(), dq.Completeness("x0"), dq.Mean("x0"), dq.Mean("x1"),
            dq.ApproxCountDistinct("cat"), dq.KLLSketch("x0")]


def every_state_battery(dq) -> list:
    """(e): every other persistable state type over the same partitions."""
    return [dq.Correlation("x0", "x1"), dq.StandardDeviation("x2"), dq.Minimum("x3n"),
            dq.Maximum("x3n"), dq.Mean("x3n"), dq.DataType("x2"), dq.Histogram("grade"),
            dq.Uniqueness(["cat"]), dq.KLLSketch("x1")]


def context_values(context) -> dict:
    """Metric values of an AnalyzerContext keyed like :func:`oracle`; a
    histogram as its bins, a KLL sketch as its buckets and items."""
    out = {}
    for analyzer, metric in context.metric_map.items():
        if metric.value.is_failure:
            out[metric_key(analyzer)] = ("failure", str(metric.value.exception))
            continue
        value = metric.value.get()
        if hasattr(value, "buckets"):
            value = (tuple((b.low_value, b.high_value, b.count) for b in value.buckets),
                     tuple(map(tuple, value.data)))
        elif hasattr(value, "values"):
            value = (value.number_of_bins, {k: v.absolute for k, v in value.values.items()})
        out[metric_key(analyzer)] = value
    return out


def kll_percentiles(data) -> list:
    """The 100 percentiles of a sketch from its compactor items (level l
    items weigh 2^l): for each q the first item whose cumulative weight
    reaches q of the total."""
    items = np.concatenate([np.asarray(level, dtype=np.float64) for level in data])
    weights = np.concatenate([np.full(len(level), 2.0 ** lvl) for lvl, level in enumerate(data)])
    order = np.argsort(items, kind="stable")
    items, cum = items[order], np.cumsum(weights[order])
    qs = np.arange(1, 101) / 100
    idx = np.minimum(np.searchsorted(cum, qs * cum[-1], "left"), len(items) - 1)
    return items[idx].tolist()


def incremental_oracle(table: pa.Table) -> tuple:
    """numpy's exact answers for both batteries over ``table``, keyed like
    :func:`oracle`, and the sorted float32-rounded valid values of x0 and
    x1 (the KLL sketches' rank oracle)."""
    def valid(name):
        arr = table[name].combine_chunks()
        return arr.to_numpy(zero_copy_only=False), np.asarray(arr.is_valid())

    n = table.num_rows
    x0, m0 = valid("x0")
    x1, m1 = valid("x1")
    x2, m2 = valid("x2")
    x3n, m3 = valid("x3n")
    cat = table["cat"].to_numpy()
    both = m0 & m1
    xc, yc = x0[both] - x0[both].mean(), x1[both] - x1[both].mean()
    v3 = x3n[m3]
    counts = np.bincount(cat)
    grade = np.bincount(table["grade"].combine_chunks().indices.to_numpy(), minlength=100)
    out = {
        ("Size", "*", None): float(n),
        ("Completeness", "x0", None): m0.mean(),
        ("Mean", "x0", None): x0[m0].mean(),
        ("Mean", "x1", None): x1[m1].mean(),
        ("Correlation", "x0,x1", None): (xc * yc).sum() / np.sqrt((xc * xc).sum() * (yc * yc).sum()),
        ("StandardDeviation", "x2", None): x2[m2].std(),
        ("Minimum", "x3n", None): np.nanmin(v3),
        ("Maximum", "x3n", None): np.max(v3),  # a NaN value wins the max
        ("Mean", "x3n", None): v3.mean(),  # NaN
        ("Uniqueness", "cat", None): (counts == 1).sum() / n,
    }
    exact = {
        ("DataType", "x2", None): (5, {"Unknown": int(n - m2.sum()), "Fractional": int(m2.sum()),
                                        "Integral": 0, "Boolean": 0, "String": 0}),
        ("Histogram", "grade", None): (100, {f"g{i:02d}": int(c) for i, c in enumerate(grade)}),
        "distinct cat": int((counts > 0).sum()),
    }
    ranks = {c: np.sort(v[m].astype(np.float32)) for c, v, m in (("x0", x0, m0), ("x1", x1, m1))}
    return out, exact, ranks


def check_incremental_oracle(values: dict, table: pa.Table,
                             rank_limit: float = 2 * KLL_RELATIVE_ERROR,
                             battery_only: bool = False) -> tuple:
    """Differences between merged metrics and numpy over the whole table:
    counts, min, max, histograms, type counts exactly; means, the standard
    deviation and the correlation within 1e-9; the HLL estimate within
    three standard errors of the exact distinct count (1.04 / sqrt(512));
    each KLL percentile within ``rank_limit`` in rank (twice the sketch's
    relative error). ``values`` holds both batteries' metrics, or with
    ``battery_only`` the first battery's alone. Returns (problems, largest
    rank error)."""
    out, exact, ranks = incremental_oracle(table)
    if battery_only:
        out = {k: v for k, v in out.items() if k in values}
    problems = compare_oracle({k: v for k, v in values.items() if k in out}, out)
    for key, want in exact.items():
        if key == "distinct cat":
            got = values[("ApproxCountDistinct", "cat", None)]
            if abs(got - want) > 3 * 1.04 / math.sqrt(512) * want:
                problems.append(f"ApproxCountDistinct(cat) {got} vs {want} distinct")
        elif key in values and values[key] != want:
            problems.append(f"{key}: {values[key]!r}, oracle {want!r}")
    worst = 0.0
    for col in ("x0", "x1"):
        key = ("KLLSketch", col, None)
        if key not in values:
            continue
        buckets, data = values[key]
        if sum(b[2] for b in buckets) != len(ranks[col]):
            problems.append(f"{key}: buckets do not add up to {len(ranks[col])}")
        errors = [_rank_error(ranks[col], x, (i + 1) / 100)
                  for i, x in enumerate(kll_percentiles(data))]
        worst = max(worst, max(errors))
        if max(errors) > rank_limit:
            problems.append(f"{key}: percentile rank error {max(errors)}")
    return problems, worst


def _state_bytes(providers, analyzers) -> int:
    from deequ_tpu_torch.analyzers.states import leaves

    total = 0
    for provider in providers:
        for a in analyzers:
            state = provider.load(a)
            if hasattr(state, "frequencies"):
                total += int(state.frequencies.memory_usage(index=True, deep=True))
            elif state is not None:
                total += sum(t.numel() * t.element_size() for t in leaves(state))
    return total


def partition_runs(torch, dq, table: pa.Table, rows: int, analyzers: list, device: str,
                   label: str, kernels=(), placement=None) -> tuple:
    """Run every day partition with ``save_states_with`` (one in-memory
    provider per partition) and an in-memory metrics repository keyed by
    day, on the ingest tier ``placement``. On the card each run is timed;
    returns the providers, the repository and the last run's launches."""
    from deequ_tpu_torch.analyzers.state_provider import InMemoryStateProvider
    from deequ_tpu_torch.repository import InMemoryMetricsRepository, ResultKey

    providers, repo, launches = [], InMemoryMetricsRepository(), {}
    for p in range(table.num_rows // rows):
        part = dq.Dataset.from_arrow(table.slice(p * rows, rows))
        sp = InMemoryStateProvider()

        def run(monitor, part=part, sp=sp, p=p):
            return dq.AnalysisRunner.do_analysis_run(
                part, analyzers, save_states_with=sp, metrics_repository=repo,
                save_or_append_results_with_key=ResultKey(p, {"day": str(p)}),
                batch_size=BATCH_ROWS, device=device, monitor=monitor, placement=placement)

        if device == "cuda":
            _, _, launches = _timed_run(torch, f"{label} day {p}", run, rows, kernels)
        else:
            run(dq.RunMonitor())
        providers.append(sp)
    return providers, repo, launches


def merged_run(torch, dq, schema, analyzers: list, providers: list, device: str,
               label: str, kernels=()) -> tuple:
    """``run_on_aggregated_states`` over ``providers``: on the card timed
    (with the state bytes merged, the phases, launches and peak memory)."""
    def run(monitor):
        return dq.AnalysisRunner.run_on_aggregated_states(schema, analyzers, providers,
                                                          device=device, monitor=monitor)

    if device != "cuda":
        return run(dq.RunMonitor()), {}
    nbytes = _state_bytes(providers, analyzers)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    from deequ_tpu_torch.kernels import launch_counts, reset_launch_counts

    monitor = dq.RunMonitor()
    reset_launch_counts()
    t0 = time.perf_counter()
    ctx = run(monitor)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = launch_counts()
    phases = {k: round(v, 6) for k, v in monitor.phase_seconds.items()}
    print(f"[{label}] merged {len(providers)} partitions' states of {len(analyzers)} "
          f"analyzers ({nbytes} state bytes) in {seconds * 1e3:.3f} ms; passes={monitor.passes}; "
          f"launches={launches}; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB; phases={phases}", flush=True)
    missing = [name for name in kernels if launches[name] == 0]
    if missing or monitor.passes:
        raise AssertionError(f"{label} launched no {missing} or read data: {monitor}")
    return ctx, launches


def anomaly_days(dq, table: pa.Table, repo, rows: int, device: str) -> tuple:
    """(c): a steady day and a quarter-size day against the partitions'
    history, anomaly checks on Size and Mean(x1)."""
    from deequ_tpu_torch.anomalydetection import RelativeRateOfChangeStrategy
    from deequ_tpu_torch.repository import ResultKey

    def day(n, key):
        return (dq.VerificationSuite.on_data(dq.Dataset.from_arrow(table.slice(0, n)),
                                             device=device)
                .with_batch_size(BATCH_ROWS).use_repository(repo)
                .save_or_append_result(ResultKey(key, {"day": str(key)}))
                .add_anomaly_check(RelativeRateOfChangeStrategy(
                    max_rate_increase=1.5, max_rate_decrease=0.5), dq.Size())
                .add_anomaly_check(RelativeRateOfChangeStrategy(
                    max_rate_increase=1.1, max_rate_decrease=0.9), dq.Mean("x1"))
                .run())

    days = INCREMENTAL_PARTITIONS
    steady, quarter = day(rows, days), day(rows // 4, days + 1)
    if steady.status != dq.CheckStatus.SUCCESS or quarter.status == dq.CheckStatus.SUCCESS:
        raise AssertionError(f"anomaly checks: steady day {steady.status}, quarter-size day "
                             f"{quarter.status}")
    return steady.status.value, quarter.status.value


def persisted_merge(dq, schema, analyzers: list, providers: list, device: str) -> dict:
    """(d): the partitions' states through FileSystemStateProviders in a
    temporary directory, loaded by fresh providers and merged."""
    import shutil
    import tempfile

    from deequ_tpu_torch.analyzers.state_provider import FileSystemStateProvider

    root = tempfile.mkdtemp(prefix="chip-smoke-states-")
    try:
        t0 = time.perf_counter()
        for p, provider in enumerate(providers):
            store = FileSystemStateProvider(f"{root}/day{p}")
            for a in analyzers:
                store.persist(a, provider.load(a))
        written = time.perf_counter() - t0
        fresh = [FileSystemStateProvider(f"{root}/day{p}") for p in range(len(providers))]
        t0 = time.perf_counter()
        ctx = dq.AnalysisRunner.run_on_aggregated_states(schema, analyzers, fresh, device=device)
        loaded = time.perf_counter() - t0
    finally:
        shutil.rmtree(root, ignore_errors=True)
    print(f"[incremental (d)] persisted {len(providers)} partitions x {len(analyzers)} states "
          f"in {written:.3f}s; loaded and merged in {loaded:.3f}s", flush=True)
    return ctx


def check_fold_kernels(torch, dq, providers: list, analyzers: list, features) -> dict:
    """Phase 2 for K8 and K1's co-moment slot: K8 at N = 2 on config 4's
    partition states and at N = 32 on every state kind, bit for bit
    against its plain version, beside ``torch.amax`` over the stacked HLL
    registers; K1 with one co-moment slot over two 1M-row float64 columns
    against its plain version."""
    from deequ_tpu_torch.analyzers.base import (
        fold_layout,
        pack_states,
        resolve_slot,
        unpack_states,
    )
    from deequ_tpu_torch.kernels.scan_reduce import scan_reduce, scan_reduce_plain
    from deequ_tpu_torch.kernels.state_fold import fold_bytes, state_fold, state_fold_plain

    results = _new_results()
    add = functools.partial(_add, results)
    layout = fold_layout()
    config4 = [[p.load(a) for p in providers] for a in analyzers
               if type(providers[0].load(a)) in layout]
    month = [states for _, states in fold_groups(dq, MONTH_OF_DAYS, 11)]
    for label, jobs in (("config 4, N=2", config4), (f"every kind, N={MONTH_OF_DAYS}", month)):
        mats, slots, places = pack_states(jobs, layout)
        mats = [m.cuda() for m in mats]
        got = state_fold(*mats, slots)
        want = state_fold_plain(*mats, slots)
        torch.cuda.synchronize()
        for g, w in zip(unpack_states(jobs, places, got), unpack_states(jobs, places, want)):
            if not same_state_bits(g, w):
                raise AssertionError(f"state_fold differs from its plain version ({label})")
        library = _time_ms(torch, lambda: torch.amax(mats[2], dim=0))
        ops = sum(m.numel() for m in mats)
        add("state_fold", label, 0.0, _time_kernel_ms(torch, lambda: state_fold(*mats, slots)),
            _time_ms(torch, lambda: state_fold_plain(*mats, slots)), fold_bytes(*mats), ops,
            library)
        if label.startswith("config 4"):
            main = dict(results["state_fold"])
    # the row of the kernels line: config 4's launch
    results["state_fold"] = main

    rows = features["rows"]
    spec = dq.Correlation("x0", "x1").scan_slot()
    slots = [resolve_slot(spec, features)]
    ki, kf = scan_reduce(slots, rows)
    pi, pf = scan_reduce_plain(slots, rows)
    torch.cuda.synchronize()
    if not torch.equal(ki, pi):
        raise AssertionError("the co-moment slot's count differs from the plain version")
    x, y = slots[0].vals, slots[0].vals2
    xx, yy = float((x * x).sum()), float((y * y).sum())
    scales = (float(x.abs().max()), float(y.abs().max()), math.sqrt(xx * yy), xx, yy)
    for col, scale in enumerate(scales):
        a, b = float(kf[0, col]), float(pf[0, col])
        if abs(a - b) > 1e-12 * max(scale, 1.0):
            raise AssertionError(f"co-moment slot column {col}: {a!r} vs {b!r}")
    n = rows.shape[0]
    sel = int(pi[0, 0])
    comoment = _new_results()
    _add(comoment, "scan_reduce", "co-moment slot", _max_abs_err(kf, pf),
         _time_kernel_ms(torch, lambda: scan_reduce(slots, rows)),
         _time_ms(torch, lambda: scan_reduce_plain(slots, rows)),
         19 * n + 7 * 8, 3 * n + 12 * sel)
    _print_kernel_totals(comoment, ["scan_reduce"], "co-moment slot")
    _print_kernel_totals(results, ["state_fold"], "incremental path")
    return results


def incremental_metrics(torch, dq, table: pa.Table, rows: int, device: str) -> dict:
    """Phase 6 (a), (b) and (e) without timings: the merged metrics of both
    batteries over ``table`` cut in partitions of ``rows``, on ``device``."""
    schema = dq.Dataset.from_arrow(table.slice(0, 1)).schema
    out = {}
    for analyzers in (incremental_battery(dq), every_state_battery(dq)):
        providers, _, _ = partition_runs(torch, dq, table, rows, analyzers, device,
                                         "incremental check")
        out.update(context_values(merged_run(torch, dq, schema, analyzers, providers,
                                             device, "incremental check")[0]))
    return out


def incremental_path(torch, dq, seed: int) -> tuple:
    """Phase 6 (with phase 2's K8 and co-moment checks at its shapes).
    Returns the K8 measurements and the launches of the merged refresh."""
    from deequ_tpu_torch.runners.engine import ScanEngine, to_device

    rows = INCREMENTAL_PARTITION_ROWS
    t0 = time.perf_counter()
    table = build_scan_data(rows * INCREMENTAL_PARTITIONS, INCREMENTAL_SEED + seed)
    print(f"[incremental data] {INCREMENTAL_PARTITIONS} x {rows} rows in "
          f"{time.perf_counter() - t0:.1f}s", flush=True)
    schema = dq.Dataset.from_arrow(table.slice(0, 1)).schema
    battery = incremental_battery(dq)

    # (a) the day partitions, (b) the merged refresh, twice (the first run
    # loads the kernel libraries)
    providers, repo, _ = partition_runs(torch, dq, table, rows, battery, "cuda",
                                        "incremental (a)",
                                        ("scan_reduce", "hll_registers", "kll_sample",
                                         "kll_compact"))
    merged_run(torch, dq, schema, battery, providers, "cuda", "incremental (b) first",
               INCREMENTAL_KERNELS)
    merged, launches = merged_run(torch, dq, schema, battery, providers, "cuda",
                                  "incremental (b)", INCREMENTAL_KERNELS)
    values = context_values(merged)
    if values[("Size", "*", None)] != float(rows * INCREMENTAL_PARTITIONS):
        raise AssertionError(f"merged Size {values[('Size', '*', None)]}")

    # phase 2 at this path's shapes
    engine = ScanEngine([dq.Correlation("x0", "x1")], torch.device("cuda"))
    first = next(dq.Dataset.from_arrow(table.slice(0, BATCH_ROWS)).batches(BATCH_ROWS))
    features = to_device(engine.builder.build(first), torch.device("cuda"))
    measured = check_fold_kernels(torch, dq, providers, battery, features)
    del features

    # (c) anomaly checks over the day history
    statuses = anomaly_days(dq, table, repo, rows, "cuda")
    print(f"[incremental (c)] steady day {statuses[0]}, quarter-size day {statuses[1]}",
          flush=True)

    # (d) through files: the same metrics bit for bit
    again = context_values(persisted_merge(dq, schema, battery, providers, "cuda"))
    if repr(again) != repr(values):
        raise AssertionError("metrics merged from persisted files differ from (b)'s")

    # phase 7 (b): the same days on the host tier, refreshed with these
    host_problems = host_tier_partitions(torch, dq, table, rows, providers)
    if host_problems:
        raise AssertionError("host tier (b) disagrees with the oracle:\n"
                             + "\n".join(host_problems))
    del providers, repo

    # (e) every persistable state type: partitions, merged, one full pass
    second = every_state_battery(dq)
    providers2, _, _ = partition_runs(torch, dq, table, rows, second, "cuda", "incremental (e)",
                                      ("scan_reduce", "dict_code_counts"))
    merged2, _ = merged_run(torch, dq, schema, second, providers2, "cuda", "incremental (e)",
                            ("state_fold", "kll_compact"))
    del providers2
    values2 = context_values(merged2)
    full = {}

    def full_run(monitor):
        full.update(context_values(dq.AnalysisRunner.do_analysis_run(
            dq.Dataset.from_arrow(table), second, batch_size=BATCH_ROWS, device="cuda",
            monitor=monitor)))

    _timed_run(torch, "incremental (e) full table", full_run, rows * INCREMENTAL_PARTITIONS,
               ("scan_reduce",))
    exact_keys = [k for k in values2 if k[0] != "KLLSketch"]
    problems = compare_metrics({k: values2[k] for k in exact_keys},
                               {k: full[k] for k in exact_keys}, 1e-12)
    oracle_problems, worst = check_incremental_oracle({**values, **values2}, table)
    problems += oracle_problems
    del table

    # the same phase on the CPU, at 2 x 5M rows, against the card
    small = build_scan_data(INCREMENTAL_CPU_PARTITION_ROWS * INCREMENTAL_PARTITIONS,
                            INCREMENTAL_SEED + seed)
    t0 = time.perf_counter()
    cpu = incremental_metrics(torch, dq, small, INCREMENTAL_CPU_PARTITION_ROWS, "cpu")
    print(f"[cpu] phase 6 at 2 x {INCREMENTAL_CPU_PARTITION_ROWS} rows on the CPU in "
          f"{time.perf_counter() - t0:.1f}s", flush=True)
    gpu = incremental_metrics(torch, dq, small, INCREMENTAL_CPU_PARTITION_ROWS, "cuda")
    problems += [f"cpu vs card: {p}" for p in compare_metrics(gpu, cpu, 1e-12)]
    if problems:
        raise AssertionError("incremental metrics disagree:\n" + "\n".join(problems))
    print(f"[incremental metrics] (b), (d) and (e) agree with the full-table run, the oracle "
          f"and the CPU run; largest KLL percentile rank error {worst:.6f} (limit "
          f"{2 * KLL_RELATIVE_ERROR:.6f}); Size {values[('Size', '*', None)]}", flush=True)
    return measured, launches


# ---------------------------------------------------------------------------
# the host ingest tier: phase 2's checks of K8's carry entry and K5's
# ingest entry, and phase 7
# ---------------------------------------------------------------------------


def host_partial_rows(dq, battery: list, data, batch_rows: int, n: int):
    """The host ingest tier's view of the first ``n`` batches of ``data``:
    its ``HostIngest`` on the card and each batch's packed partials (the
    non-KLL states as three host rows, the KLL samples)."""
    import torch

    from deequ_tpu_torch.analyzers.base import HostBatchContext
    from deequ_tpu_torch.runners.engine import HostIngest

    ingest = HostIngest(battery, torch.device("cuda"))
    token = object()
    packed = []
    for index, batch in enumerate(data.batches(batch_rows, pad_to_batch_size=False)):
        if index == n:
            break
        ctx = HostBatchContext(batch, batch_index=index, run_token=token)
        packed.append(ingest.pack([a.host_partial(ctx) for a in battery]))
    return ingest, packed


def check_carry_kernel(torch, dq, data, battery: list) -> dict:
    """Phase 2 for K8's carry entry at the host tier's chunk shape: the
    carry of config 2's battery (its identity states) and the host
    partials of 32 batches of 2^18 rows, 33 rows of state, bit for bit
    against the plain version, beside ``torch.amax`` of the stacked
    registers plus ``torch.sum`` of the stacked counts."""
    from deequ_tpu_torch.kernels.state_fold import state_fold_carry, state_fold_carry_plain

    results = _new_results()
    ingest, packed = host_partial_rows(dq, battery, data, HOST_BATCH_ROWS, CHUNK)
    parts = [torch.stack([rows[d] for rows, _ in packed]).cuda() for d in range(3)]
    got = [c.clone() for c in ingest.carry]
    want = [c.clone() for c in ingest.carry]
    state_fold_carry(got, parts, ingest.slots)
    state_fold_carry_plain(want, parts, ingest.slots)
    torch.cuda.synchronize()
    if not _same_bits(got, want):
        raise AssertionError("state_fold's carry entry differs from its plain version")
    scratch = [c.clone() for c in ingest.carry]
    nbytes = sum(p.numel() * p.element_size() + 2 * c.numel() * c.element_size()
                 for p, c in zip(parts, ingest.carry))
    _add(results, "state_fold_carry",
         f"config 2's battery, {len(ingest.slots)} slots, 1 + {len(packed)} rows", 0.0,
         _time_kernel_ms(torch, lambda: state_fold_carry(scratch, parts, ingest.slots)),
         _time_ms(torch, lambda: state_fold_carry_plain(scratch, parts, ingest.slots)),
         nbytes, sum(p.numel() for p in parts),
         _time_ms(torch, lambda: (torch.amax(parts[2], dim=0), torch.sum(parts[1], dim=0))))
    _print_kernel_totals(results, ["state_fold_carry"], "host tier, config 2")
    return results


def _ingest_bytes(sizes: list, samples: list, k: int, width: int) -> tuple:
    """Bytes and sorted items of K5's ingest of ``samples`` into a sketch
    with these level sizes: each sample's m float64 items read and m
    float32 items written, then the cascade's levels as
    :func:`_compact_bytes` counts them."""
    sizes = list(sizes)
    nbytes = items = 0
    for _, m, h, *_ in samples:
        level = min(int(h), len(sizes) - 1)
        nbytes += 12 * m + 40
        sizes[level] = min(sizes[level] + m, width)
        while level < len(sizes) - 1 and sizes[level] > k:
            n = sizes[level]
            nbytes += 4 * n + 4 * n + 4 * (n // 2)
            items += n
            sizes[level + 1] = min(sizes[level + 1] + n // 2, width)
            sizes[level] = n & 1
            level += 1
    return nbytes, items


def _ingest_chunk(dq, data, sketches: list, batch_rows: int, n: int) -> list:
    """The host samples the host tier folds into ``sketches`` in their first
    chunk: of the first ``n`` batches of ``batch_rows`` rows, ``[S][n]``."""
    _, packed = host_partial_rows(dq, sketches, data, batch_rows, n)
    return [[kll[j] for _, kll in packed] for j in range(len(sketches))]


def _kll_controls(chunk: list) -> dict:
    """Faulty versions of a chunk of host samples, for the rank limit's
    control: odd samples folded one level too high; the second half of the
    samples dropped; each sample's items replaced by its lower half, each
    item twice (a sampler that sees only the smaller half of a batch)."""
    def shifted(row):
        return [(it, m, h + (b % 2), nv, lo, hi) for b, (it, m, h, nv, lo, hi) in enumerate(row)]

    def lower(row):
        out = []
        for items, m, h, nv, lo, hi in row:
            low = np.full_like(items, np.inf)
            low[:2 * (m // 2)] = np.repeat(items[:m // 2], 2)
            out.append((low, 2 * (m // 2), h, nv, lo, hi))
        return out

    return {"odd samples at h + 1": [shifted(row) for row in chunk],
            "second half dropped": [row[:max(1, len(row) // 2)] for row in chunk],
            "lower half of each sample": [lower(row) for row in chunk]}


def check_ingest_kernels(torch, dq, data, table: pa.Table, battery: list) -> tuple:
    """Phase 2 for K5's ingest entry, each chunk stacked into fresh sketches
    and held bit for bit against the plain version:

    - the chunk phase 7 (c) folds: the host samples of config 3's numeric
      columns over the profile's batches of 2^20 rows (one chunk of 10 a
      sketch at 10M rows); timed beside ``torch.sort`` of one 4,096-item
      level, the ``kernels`` line's numbers. Its sketches must equal (c)'s
      bit for bit, so their compactor items are returned;
    - a full chunk of 32 samples of 2^18-row batches, timed;
    - an edge chunk (m = 0, m = 2k, h = 0, +-inf and beyond the float32
      range);
    - the rank limit's controls (:func:`_kll_controls` of (c)'s chunk):
      each one's largest percentile rank error is printed, and the biased
      sample must exceed ``HOST_KLL_RANK_LIMIT``.

    Returns the measurements and (c)'s compactor items by column."""
    from deequ_tpu_torch.analyzers.sketches import KLLSketch
    from deequ_tpu_torch.kernels.kll_compact import kll_compact_ingest, kll_compact_ingest_plain
    from deequ_tpu_torch.ops.kll import KLLSketchState, compactor_buffers, kll_init
    from deequ_tpu_torch.runners.engine import stack_samples

    results = _new_results()
    sketches = [a for a in battery if isinstance(a, KLLSketch)]
    k = sketches[0]._sketch_size()
    width = 4 * k
    batches = min(CHUNK, -(-data.num_rows // BATCH_ROWS))

    def fresh(n):
        return [torch.stack(list(col)).contiguous()
                for col in zip(*(kll_init(k, device="cuda").tensors() for _ in range(n)))]

    def ingest(chunk, label):
        fields = stack_samples(chunk, width, lambda t: t.cuda())
        got, want = fresh(len(chunk)), fresh(len(chunk))
        kll_compact_ingest(got, fields, k)
        kll_compact_ingest_plain(want, fields, k)
        torch.cuda.synchronize()
        if not _same_bits(got, want):
            raise AssertionError(f"kll_compact's ingest entry differs from its plain version "
                                 f"({label})")
        return fields, got, want

    def timed(into, chunk, label):
        fields, got, want = ingest(chunk, label)
        zero = [0] * got[1].shape[1]
        nbytes = ops = 0
        for row in chunk:
            b, n = _ingest_bytes(zero, row, k, width)
            nbytes, ops = nbytes + b, ops + n
        scratch = fresh(len(chunk))
        level = torch.from_numpy(np.tile(chunk[0][0][0][:2 * k], 2)).float().cuda()
        _add(into, "kll_compact_ingest", label, _max_abs_err(got[0], want[0]),
             _time_kernel_ms(torch, lambda: kll_compact_ingest(scratch, fields, k)),
             _time_ms(torch, lambda: kll_compact_ingest_plain(fresh(len(chunk)), fields, k),
                      reps=5, warmup=1),
             nbytes, ops, _time_ms(torch, lambda: torch.sort(level)))
        return got

    def sketch_states(leaves):
        return [KLLSketchState(*(leaf[i] for leaf in leaves), sketch_size=k)
                for i in range(leaves[0].shape[0])]

    # phase 7 (c)'s chunk: the kernels line's numbers
    chunk = _ingest_chunk(dq, data, sketches, BATCH_ROWS, batches)
    got = timed(results, chunk, f"phase 7 (c)'s chunk: {len(sketches)} numeric columns x "
                                f"{batches} samples of {BATCH_ROWS} rows")
    sound = {a.column: compactor_buffers(s) for a, s in zip(sketches, sketch_states(got))}
    # a full chunk of 32
    timed(_new_results(), _ingest_chunk(dq, data, sketches, HOST_BATCH_ROWS, CHUNK),
          f"a full chunk: {len(sketches)} numeric columns x {CHUNK} samples of "
          f"{HOST_BATCH_ROWS} rows")
    edges = ingest([edge_samples(k, CHUNK, 17)], "edge chunk")[1]
    print(f"[kll ingest edges] bit-exact on m in {{0, {2 * k}}}, h = 0 to 6, +-inf and "
          f"|v| > f32 max; level sizes {edges[1][0].tolist()[:10]}", flush=True)

    # the rank limit's controls, ranked as the profile ranks its percentiles
    ranks = {}
    for a in sketches:
        v = table[a.column].combine_chunks().to_numpy(zero_copy_only=False).astype(np.float64)
        ranks[a.column] = np.sort(np.clip(v, -3.4028234663852886e38,
                                          3.4028234663852886e38).astype(np.float32))

    def worst_rank(leaves):
        worst = 0.0
        for a, state in zip(sketches, sketch_states(leaves)):
            q = sorted(a.compute_metric_from(state).value.get().compute_percentiles())
            worst = max(worst, max(_rank_error(ranks[a.column], x, (i + 1) / 100)
                                   for i, x in enumerate(q)))
        return worst

    readings = {"sound": worst_rank(got)}
    for label, faulty in _kll_controls(chunk).items():
        readings[label] = worst_rank(ingest(faulty, f"control: {label}")[1])
    del ranks
    print(f"[kll rank limit] largest percentile rank error over {len(sketches)} columns of "
          f"(c)'s chunk: {json.dumps(readings)} (limit {HOST_KLL_RANK_LIMIT})", flush=True)
    if readings["sound"] > HOST_KLL_RANK_LIMIT or \
            readings["lower half of each sample"] <= HOST_KLL_RANK_LIMIT:
        raise AssertionError(f"the rank limit does not part the sound chunk from the biased "
                             f"one: {readings}")
    _print_kernel_totals(results, ["kll_compact_ingest"], "host tier, config 3")
    return results, sound


def _host_tier_report(label: str, monitor) -> None:
    print(f"[{label}] placement={monitor.placement} ingest_folds={monitor.ingest_folds} "
          f"pattern routes={monitor.pattern_routes}", flush=True)
    if monitor.placement != "host" or not monitor.ingest_folds:
        raise AssertionError(f"{label} did not run on the host tier: {monitor}")


def host_tier_verification(torch, dq, table: pa.Table, rows: int, device_metrics: dict) -> dict:
    """Phase 7 (a): BASELINE config 2 (phase 3's table and checks) with
    ``with_placement("host")`` and an ApproxQuantile of ``a``, in batches
    of 2^18 rows; held against phase 3's device-tier metrics (counts
    exact, moments within 1e-12), against the same run on
    ``device="cpu"`` bit for bit, and against the numpy oracle (the
    quantile within ``HOST_KLL_RANK_LIMIT`` in rank). Then once more in
    phase 3's batches of 2^20 rows, timed beside phase 3 like for like and
    held against its metrics. Returns the first run's launches."""
    quantile = dq.ApproxQuantile("a", 0.5, KLL_RELATIVE_ERROR)

    def run(monitor, device="cuda", batch_rows=HOST_BATCH_ROWS):
        return (dq.VerificationSuite.on_data(dq.Dataset.from_arrow(table), device=device)
                .add_check(build_check(dq, rows))
                .add_required_analyzers([dq.CountDistinct("cat_large"), quantile])
                .with_batch_size(batch_rows).with_placement("host").with_monitor(monitor)
                .run())

    def against_device_tier(metrics):
        return compare_metrics({k: v for k, v in metrics.items() if k in device_metrics},
                               device_metrics)

    result, monitor, launches = _timed_run(torch, "host tier (a)", run, rows, HOST_KERNELS)
    _host_tier_report("host tier (a)", monitor)
    gpu = metric_values(result)
    t0 = time.perf_counter()
    cpu = metric_values(run(dq.RunMonitor(), "cpu"))
    print(f"[cpu] host tier (a) on the CPU in {time.perf_counter() - t0:.1f}s", flush=True)
    problems = [f"cpu: {p}" for p in compare_metrics(gpu, cpu, 0.0)]
    problems += [f"device tier: {p}" for p in against_device_tier(gpu)]
    problems += compare_oracle(gpu, oracle(table))
    a = table["a"].combine_chunks()
    ranked = np.sort(a.to_numpy(zero_copy_only=False)[np.asarray(a.is_valid())]
                     .astype(np.float32))
    error = _rank_error(ranked, gpu[metric_key(quantile)], 0.5)
    if error > HOST_KLL_RANK_LIMIT:
        problems.append(f"ApproxQuantile(a, 0.5) rank error {error}")
    same, monitor, _ = _timed_run(torch, f"host tier (a) in batches of {BATCH_ROWS} rows",
                                  lambda m: run(m, batch_rows=BATCH_ROWS), rows, HOST_KERNELS)
    _host_tier_report(f"host tier (a) in batches of {BATCH_ROWS} rows", monitor)
    problems += [f"2^20-row batches, device tier: {p}"
                 for p in against_device_tier(metric_values(same))]
    if problems:
        raise AssertionError("host tier (a) disagrees:\n" + "\n".join(problems))
    print(f"[host tier (a) metrics] {len(gpu)} metrics equal the CPU run bit for bit, phase 3's "
          f"device tier and the oracle; median rank error {error:.6f} (limit "
          f"{HOST_KLL_RANK_LIMIT}); in 2^20-row batches equal to phase 3's device tier",
          flush=True)
    return launches


def host_tier_partitions(torch, dq, table: pa.Table, rows: int, device_providers: list) -> list:
    """Phase 7 (b): BASELINE config 4's day partitions on the host tier with
    ``save_states_with``, their saved states held bit for bit against the
    same runs on ``device="cpu"``; refreshed alone (bit for bit against
    the CPU's refresh) and merged with phase 6's device-tier states of the
    other day, every refresh against phase 6's numpy figures. Returns the
    problems."""
    schema = dq.Dataset.from_arrow(table.slice(0, 1)).schema
    battery = incremental_battery(dq)

    providers = partition_runs(torch, dq, table, rows, battery, "cuda", "host tier (b)",
                               HOST_KERNELS, placement="host")[0]
    t0 = time.perf_counter()
    cpu = partition_runs(torch, dq, table, rows, battery, "cpu", "", placement="host")[0]
    print(f"[cpu] host tier (b) partitions on the CPU in {time.perf_counter() - t0:.1f}s",
          flush=True)
    problems = [f"day {day}: {a} state differs from the CPU run's"
                for day, (g, c) in enumerate(zip(providers, cpu)) for a in battery
                if not same_state_bits(g.load(a), c.load(a))]
    cpu_refresh = context_values(merged_run(torch, dq, schema, battery, cpu, "cpu", "")[0])
    worst = 0.0
    for label, pair in (("host days", providers),
                        ("host day 0, device day 1", [providers[0], device_providers[1]]),
                        ("device day 0, host day 1", [device_providers[0], providers[1]])):
        merged, _ = merged_run(torch, dq, schema, battery, pair, "cuda",
                               f"host tier (b) refresh, {label}", INCREMENTAL_KERNELS)
        values = context_values(merged)
        if pair is providers and repr(values) != repr(cpu_refresh):
            problems.append("the refresh of the host days differs from the CPU's")
        found, err = check_incremental_oracle(values, table, HOST_KLL_RANK_LIMIT,
                                              battery_only=True)
        problems += [f"{label}: {p}" for p in found]
        worst = max(worst, err)
    print(f"[host tier (b) metrics] saved states and the host days' refresh equal the CPU "
          f"run's bit for bit; three refreshes agree with the oracle; largest KLL percentile "
          f"rank error {worst:.6f} (limit {HOST_KLL_RANK_LIMIT})", flush=True)
    return problems


def host_tier_profile(torch, dq, table: pa.Table, sketches: dict) -> dict:
    """Phase 7 (c): BASELINE config 3's profile with
    ``with_placement("host")`` in batches of 2^20 rows (the profile's
    default), held bit for bit against the same run on ``device="cpu"``,
    its KLL sketches bit for bit against phase 2's ingest of the same
    chunk (``sketches``), and against phase 4's oracle. Returns the run's
    launches."""
    def run(monitor, device="cuda"):
        return (dq.ColumnProfilerRunner.on_data(dq.Dataset.from_arrow(table), device=device)
                .with_batch_size(BATCH_ROWS).with_placement("host").with_monitor(monitor).run())

    profiles, monitor, launches = _timed_run(torch, "host tier (c)", run, table.num_rows,
                                             HOST_KERNELS)
    _host_tier_report("host tier (c)", monitor)
    gpu = profile_values(profiles)
    t0 = time.perf_counter()
    cpu = profile_values(run(dq.RunMonitor(), "cpu"))
    print(f"[cpu] host tier (c) on the CPU in {time.perf_counter() - t0:.1f}s", flush=True)
    problems = [f"cpu: {p}" for p in compare_profiles(gpu, cpu, 0.0)]
    problems += [f"{c}: KLL items differ from phase 2's ingest of (c)'s chunk"
                 for c, data in sketches.items() if gpu[c]["kll"][2] != data]
    found, worst = compare_profile_oracle(gpu, table, rank_limit=HOST_KLL_RANK_LIMIT)
    problems += found
    if problems:
        raise AssertionError("host tier (c) disagrees:\n" + "\n".join(problems))
    print(f"[host tier (c) metrics] {len(profiles.profiles)} column profiles equal the CPU run "
          f"bit for bit, {len(sketches)} KLL sketches phase 2's ingest, and agree with the "
          f"oracle; largest percentile rank error {worst:.6f} (limit {HOST_KLL_RANK_LIMIT})",
          flush=True)
    return launches


def _nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def _print_kernel_totals(measured: dict, names, path: str) -> None:
    for name in names:
        r = measured[name]
        print(f"[kernel {name} {path}] ms={r['ms']:.4f} plain_ms={r['plain_ms']:.4f} "
              f"library_ms={r['library_ms']} bound_ms={r['bound_ms']:.4f} ({r['bound_by']}) "
              f"max_abs_err={r['max_abs_err']:.3g}", flush=True)


def profile_path(torch, dq, table: pa.Table) -> tuple:
    """Phase 2 at the profile path's shapes, then phase 4, over the
    lineitem table. Returns the kernels' measurements at those shapes and
    the launch counts of the profile run."""
    from deequ_tpu_torch.analyzers import Histogram
    from deequ_tpu_torch.analyzers.grouping import DeviceFrequencyScan
    from deequ_tpu_torch.kernels import launch_counts, reset_launch_counts
    from deequ_tpu_torch.profiles import first_pass_analyzers
    from deequ_tpu_torch.runners.engine import ScanEngine, to_device

    device = torch.device("cuda")

    # phase 2 at the shapes of the profile's first pass, the one whose
    # battery holds every kernel
    probe = dq.Dataset.from_arrow(table)
    first_pass = first_pass_analyzers(probe, probe.schema.names, {})
    battery = [a for a in first_pass if not isinstance(a, Histogram)]
    battery += [DeviceFrequencyScan(a.column, probe.dictionary_size(a.column))
                for a in first_pass if isinstance(a, Histogram)]
    engine = ScanEngine(battery, device)
    features = to_device(engine.builder.build(next(probe.batches(BATCH_ROWS))), device)
    measured = check_kernels(torch, engine, features)
    check_kll_edges(torch, features["num:l_extendedprice"], features["rows"])
    del features
    _print_kernel_totals(measured, PROFILE_KERNELS, "profile path")
    ingest_measured, ingest_sketches = check_ingest_kernels(torch, dq, probe, table, first_pass)
    del probe

    # phase 4: the profile on the card, launch counts set to 0 just before
    data = dq.Dataset.from_arrow(table)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    monitor = dq.RunMonitor()
    reset_launch_counts()
    t0 = time.perf_counter()
    profiles = dq.ColumnProfilerRunner.on_data(data, device="cuda").with_monitor(monitor).run()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    phases = {k: round(v, 4) for k, v in monitor.phase_seconds.items()}
    print(f"[profile] {LINEITEM_ROWS} rows x {table.num_columns} columns in {seconds:.3f}s = "
          f"{LINEITEM_ROWS / seconds:.0f} rows/s; passes={monitor.passes} "
          f"batches={monitor.batches}; launches={launches}; peak device memory "
          f"{peak / 2**20:.1f} MiB; phases={phases}", flush=True)
    missing = [name for name in PROFILE_KERNELS if launches[name] == 0]
    if missing:
        raise AssertionError(f"the profile launched no {missing}")

    gpu = profile_values(profiles)
    t0 = time.perf_counter()
    cpu = profile_values(dq.ColumnProfilerRunner.on_data(data, device="cpu").run())
    print(f"[cpu] the same profile on the CPU in {time.perf_counter() - t0:.1f}s", flush=True)
    problems = compare_profiles(gpu, cpu)
    oracle_problems, worst_rank = compare_profile_oracle(gpu, table)
    if problems or oracle_problems:
        raise AssertionError("profiles disagree:\n" + "\n".join(problems + oracle_problems))
    numeric = sum(1 for v in list(gpu.values())[1:] if v["kll"] is not None)
    print(f"[profile metrics] {len(gpu) - 1} column profiles agree with the CPU run and the "
          f"oracle; {numeric} KLL sketches, largest percentile rank error {worst_rank:.6f} "
          f"(limit {2 * KLL_RELATIVE_ERROR:.6f})", flush=True)
    return measured, launches, ingest_measured, ingest_sketches


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2

    import deequ_tpu_torch as dq
    from deequ_tpu_torch.analyzers.grouping import DeviceFrequencyScan
    from deequ_tpu_torch.analyzers.base import ScanShareableAnalyzer
    from deequ_tpu_torch.kernels import build, launch_counts, reset_launch_counts
    from deequ_tpu_torch.runners.analysis_runner import collect_required_analyzers
    from deequ_tpu_torch.runners.engine import ScanEngine, to_device

    device = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    card = _nvidia_smi()
    print(f"[device] {kind}; nvidia-smi: {card}", flush=True)

    # phase 1: build every kernel, one nvcc per source in parallel
    t0 = time.perf_counter()
    reports = build.build(force=True)
    print(f"[build] {len(reports)} kernels in {time.perf_counter() - t0:.1f}s", flush=True)
    for name, report in reports.items():
        for line in report.splitlines():
            if "Compiling entry" in line or "registers" in line or "spill" in line:
                print(f"[ptxas {name}] {line.strip()}")

    # the data and the battery of the main path
    t0 = time.perf_counter()
    table = build_table(ROWS, args.seed)
    data = dq.Dataset.from_arrow(table)
    check = build_check(dq, ROWS)
    print(f"[data] {ROWS} rows in {time.perf_counter() - t0:.1f}s", flush=True)

    # phase 2: each kernel against its plain version at main-path shapes
    analyzers = list(dict.fromkeys(collect_required_analyzers([check])))
    battery = [a for a in analyzers if isinstance(a, ScanShareableAnalyzer)]
    battery += [DeviceFrequencyScan(c, data.dictionary_size(c)) for c in ("cat_small", "cat_large")]
    engine = ScanEngine(battery, device)
    first = next(data.batches(BATCH_ROWS))
    features = to_device(engine.builder.build(first), device)
    measured = check_kernels(torch, engine, features)
    del features
    _print_kernel_totals(measured, VERIFICATION_KERNELS, "verification path")
    carry_measured = check_carry_kernel(torch, dq, data, battery)

    # phase 3: the main path on the card, launch counts set to 0 just before
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    monitor = dq.RunMonitor()
    reset_launch_counts()
    t0 = time.perf_counter()
    result = (dq.VerificationSuite.on_data(data, device="cuda").add_check(check)
              .add_required_analyzer(dq.CountDistinct("cat_large"))
              .with_monitor(monitor).run())
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    phases = {k: round(v, 4) for k, v in monitor.phase_seconds.items()}
    print(f"[main] {ROWS} rows in {seconds:.3f}s = {ROWS / seconds:.0f} rows/s; "
          f"batches={monitor.batches}; launches={launches}; peak device memory "
          f"{peak / 2**20:.1f} MiB; phases={phases}", flush=True)
    print(f"[main placement] {monitor.placement}: the link probe read "
          f"{monitor.feed_bandwidth_mbps} MB/s", flush=True)
    missing = [name for name in VERIFICATION_KERNELS if launches[name] == 0]
    if missing:
        raise AssertionError(f"the verification path launched no {missing}")
    expected_batches = -(-ROWS // BATCH_ROWS)
    if monitor.batches != expected_batches or monitor.passes != 1:
        raise AssertionError(f"expected 1 pass of {expected_batches} batches, got {monitor}")

    gpu_metrics = metric_values(result)
    t0 = time.perf_counter()
    cpu_result = (dq.VerificationSuite.on_data(data, device="cpu").add_check(check)
                  .add_required_analyzer(dq.CountDistinct("cat_large")).run())
    print(f"[cpu] the same run on the CPU in {time.perf_counter() - t0:.1f}s", flush=True)
    problems = compare_metrics(gpu_metrics, metric_values(cpu_result))
    problems += compare_oracle(gpu_metrics, oracle(table))
    statuses = [r.status for r in result.check_results.values()]
    if statuses != [r.status for r in cpu_result.check_results.values()]:
        problems.append(f"check statuses differ: {statuses}")
    if problems:
        raise AssertionError("metrics disagree:\n" + "\n".join(problems))
    print(f"[metrics] {len(gpu_metrics)} metrics agree with the CPU run and the oracle; "
          f"check status {result.status.value}", flush=True)
    del data, result, cpu_result

    # phase 7 (a): the same table and checks on the host tier
    host_launches = host_tier_verification(torch, dq, table, ROWS, gpu_metrics)
    del table

    t0 = time.perf_counter()
    lineitem = build_lineitem(LINEITEM_ROWS, LINEITEM_SEED + args.seed)
    print(f"[lineitem] {LINEITEM_ROWS} rows x {lineitem.num_columns} columns in "
          f"{time.perf_counter() - t0:.1f}s", flush=True)
    profile_measured, profile_launches, ingest_measured, ingest_sketches = profile_path(
        torch, dq, lineitem)
    freq_measured, freq_launches = grouping_path(torch, dq, lineitem)
    # phase 7 (c): the profile on the host tier
    ingest_launches = host_tier_profile(torch, dq, lineitem, ingest_sketches)
    del lineitem
    fold_measured, fold_launches = incremental_path(torch, dq, args.seed)

    # K1-K3 as the verification path runs them, K4 and K5 as the profile
    # path does (the verification path runs no sketch); each with the
    # launches of its path's run
    def row(name, m, counts):
        return {
            "name": name,
            "route": "cuda",
            "source": f"deequ_tpu_torch/kernels/csrc/{KERNEL_SOURCES[name]}.cu",
            "replaces": TPU_KERNELS[name],
            "launches": counts[name],
            "max_abs_err": m[name]["max_abs_err"],
            "ms": m[name]["ms"],
            "plain_ms": m[name]["plain_ms"],
            "bound_ms": m[name]["bound_ms"],
            "bound_by": m[name]["bound_by"],
            "library_ms": m[name]["library_ms"],
        }

    kernels = [row(name, measured, launches) for name in VERIFICATION_KERNELS]
    kernels += [row(name, profile_measured, profile_launches)
                for name in PROFILE_KERNELS if name not in VERIFICATION_KERNELS]
    # K6 with the launches of the resident grouping run, K7 with those of
    # the non-resident one
    kernels.append(row("freq_keys", freq_measured, freq_launches["resident"]))
    kernels.append(row("freq_compact", freq_measured, freq_launches["compaction"]))
    # K8 with the launches of the merged refresh (b); its carry entry with
    # those of host tier (a), K5's ingest entry with those of host tier (c)
    kernels.append(row("state_fold", fold_measured, fold_launches))
    kernels.append(row("state_fold_carry", carry_measured, host_launches))
    kernels.append(row("kll_compact_ingest", ingest_measured, ingest_launches))
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
