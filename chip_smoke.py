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
   of two sketches;
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
   twice the sketch's relative error in rank).

Each main path runs with the kernels' launch counts set to 0 just before it
and read just after, and every kernel of the path must have been launched.
The last two lines of standard output are the ``{"kernels": [...]}`` table
and ``{"ok": true, "device": {...}}``; ``nvidia-smi``'s name and power
limit come on a line before them. Without a CUDA device the script exits
with code 2 and prints no result.
"""

from __future__ import annotations

import argparse
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
}
#: the kernels each main path must launch
VERIFICATION_KERNELS = ("scan_reduce", "hll_registers", "dict_code_counts")
PROFILE_KERNELS = tuple(TPU_KERNELS)


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
MOMENT_METRICS = ("Mean", "Sum", "StandardDeviation")


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


def compare_profile_oracle(got: dict, table: pa.Table, rtol: float = 1e-9) -> tuple:
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
        if max(errors) > 2 * KLL_RELATIVE_ERROR:
            problems.append(f"{name}: percentile rank error {max(errors)} > {2 * KLL_RELATIVE_ERROR}")
    return problems, worst_rank


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
    results = {name: {"ms": 0.0, "plain_ms": 0.0, "library_ms": None, "bound_ms": 0.0,
                      "max_abs_err": 0.0, "bound_by": "bytes"}
               for name in TPU_KERNELS}

    def add(name, label, err, kernel, plain, nbytes, ops, library=None):
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
# main
# ---------------------------------------------------------------------------


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


def profile_path(torch, dq, seed: int) -> tuple:
    """Phase 2 at the profile path's shapes, then phase 4. Returns the
    kernels' measurements at those shapes and the launch counts of the
    profile run."""
    from deequ_tpu_torch.analyzers import Histogram
    from deequ_tpu_torch.analyzers.grouping import DeviceFrequencyScan
    from deequ_tpu_torch.kernels import launch_counts, reset_launch_counts
    from deequ_tpu_torch.profiles import first_pass_analyzers
    from deequ_tpu_torch.runners.engine import ScanEngine, to_device

    device = torch.device("cuda")
    t0 = time.perf_counter()
    table = build_lineitem(LINEITEM_ROWS, LINEITEM_SEED + seed)
    print(f"[lineitem] {LINEITEM_ROWS} rows x {table.num_columns} columns in "
          f"{time.perf_counter() - t0:.1f}s", flush=True)

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
    del features, probe
    _print_kernel_totals(measured, TPU_KERNELS, "profile path")

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
    return measured, launches


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
    del data, result, cpu_result, table

    profile_measured, profile_launches = profile_path(torch, dq, args.seed)

    # K1-K3 as the verification path runs them, K4 and K5 as the profile
    # path does (the verification path runs no sketch); each with the
    # launches of its path's run
    def row(name, m, counts):
        return {
            "name": name,
            "route": "cuda",
            "source": f"deequ_tpu_torch/kernels/csrc/{name}.cu",
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
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
