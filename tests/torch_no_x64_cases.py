"""Cases of ``tests/test_torch_no_x64.py``: the program its 32-bit
subprocesses run (one per package) and the data and analyzers of each case,
built with either package. Imports neither package at module level, so a
subprocess of one package loads nothing of the other."""

from __future__ import annotations

import numpy as np
import pyarrow as pa

# The program both 32-bit processes run: argv is the package ("ref" or
# "port"), the directory of the persisted states and the stage ("main", or
# "load" to read back what the other package's 32-bit process wrote).
PROGRAM = r'''
import json, os, sys
os.environ["DEEQU_TPU_NO_X64"] = "1"
PKG, STORE, STAGE = sys.argv[1], sys.argv[2], sys.argv[3]
import numpy as np
import pyarrow as pa
if PKG == "ref":
    import jax
    jax.config.update("jax_platforms", "cpu")
    import deequ_tpu as m
    import deequ_tpu.analyzers as A
    import deequ_tpu.analyzers.state_provider as SP
    from deequ_tpu.analyzers.base import merge_states_batched as _merge
    from deequ_tpu.config import ACC_DTYPE, COUNT_DTYPE
    from deequ_tpu.data import Dataset
    from deequ_tpu.parallel import make_mesh
    from deequ_tpu.runners import AnalysisRunner, RunMonitor
    from deequ_tpu.service import VerificationService
    from deequ_tpu.service.placement import shape_qualified_signature
    RUN = {"placement": "device"}
    SVC = {"fleet": False}
    merge = lambda a, states: _merge(a, states)
    def leaf_dtypes(state):
        return [np.asarray(l).dtype.name for l in jax.tree_util.tree_leaves(state)]
    def same_mode():
        return [np.dtype(ACC_DTYPE).name, np.dtype(COUNT_DTYPE).name]
else:
    import torch
    import deequ_tpu_torch as m
    import deequ_tpu_torch.analyzers as A
    import deequ_tpu_torch.analyzers.state_provider as SP
    from deequ_tpu_torch.analyzers.base import merge_states_batched as _merge
    from deequ_tpu_torch.analyzers.states import leaves
    from deequ_tpu_torch.config import ACC_DTYPE, COUNT_DTYPE
    from deequ_tpu_torch.data import Dataset
    from deequ_tpu_torch.parallel import make_mesh as _make_mesh
    from deequ_tpu_torch.runners import AnalysisRunner, RunMonitor
    make_mesh = lambda n: _make_mesh(n, device="cpu")
    from deequ_tpu_torch.service import VerificationService
    from deequ_tpu_torch.service.placement import shape_qualified_signature
    RUN = {"placement": "device", "device": "cpu"}
    SVC = {"device": "cpu"}
    merge = lambda a, states: _merge(a, states, "cpu")
    def leaf_dtypes(state):
        return [str(t.dtype).replace("torch.", "") for t in leaves(state)]
    def same_mode():
        return [str(ACC_DTYPE).replace("torch.", ""), str(COUNT_DTYPE).replace("torch.", "")]
sys.path.insert(0, os.getcwd())
from tests.torch_no_x64_cases import (basic_items, basic_checks, battery, config2, config2_table,
                                     mesh_battery, persisted, stream_batch, stream_check)


def value(metric):
    v = metric.value
    if v.is_failure:
        return ["failure", type(v.exception).__name__]
    got = v.get()
    if hasattr(got, "buckets"):
        return [[[b.low_value, b.high_value, b.count] for b in got.buckets],
                list(got.parameters), [list(map(float, lv)) for lv in got.data]]
    if hasattr(got, "values"):
        return {k: [d.absolute, d.ratio] for k, d in sorted(got.values.items())}
    return got


def metrics(ctx):
    return {repr(a): value(mt) for a, mt in ctx.metric_map.items()}


def states_of(provider, analyzers):
    return {repr(a): leaf_dtypes(provider.load(a)) for a in analyzers
            if provider.load(a) is not None and a.name != "Histogram"}


out = {"mode": same_mode()}
if STAGE == "main":
    rng = np.random.default_rng(11)
    n = 20_000
    x = rng.normal(50.0, 4.0, n)
    data = Dataset.from_dict({"x": x, "y": rng.integers(0, 500, n)})
    an = battery(A)
    mem = SP.InMemoryStateProvider()
    ctx = AnalysisRunner.do_analysis_run(data, an, batch_size=4096, save_states_with=mem, **RUN)
    out["battery"] = {"metrics": metrics(ctx), "dtypes": states_of(mem, an)}

    table = config2_table()
    an = config2(A)
    for placement in ("device", "host"):
        mem = SP.InMemoryStateProvider()
        mon = RunMonitor()
        run = dict(RUN, placement=placement)
        ctx = AnalysisRunner.do_analysis_run(Dataset.from_arrow(table), an, batch_size=4096,
                                             save_states_with=mem, monitor=mon, **run)
        out["config2_" + placement] = {"metrics": metrics(ctx), "dtypes": states_of(mem, an),
                                       "placement": mon.placement}

    # the mesh: the host tier (a KLL sketch too) on 8 and 3 shards, the
    # device tier on 8
    for tier, n_dev, batch, an in (("host", 8, 1000, mesh_battery(A, True)),
                                   ("host", 3, 1000, mesh_battery(A, True)),
                                   ("device", 8, 8192, mesh_battery(A, False))):
        mem = SP.InMemoryStateProvider()
        run = dict(RUN, placement=tier)
        ctx = AnalysisRunner.do_analysis_run(Dataset.from_arrow(table), an, batch_size=batch,
                                             sharding=make_mesh(n_dev), save_states_with=mem,
                                             **run)
        out[f"mesh_{tier}_{n_dev}"] = {"metrics": metrics(ctx), "dtypes": states_of(mem, an)}

    mon = RunMonitor()
    items = Dataset.from_arrow(basic_items())
    builder = m.VerificationSuite.on_data(items, **({} if PKG == "ref" else {"device": "cpu"}))
    res = builder.add_checks(basic_checks(m)).with_monitor(mon).run()
    out["config1"] = {
        "status": res.status.value,
        "checks": [[c.description, r.status.value,
                    [[str(cr.constraint), cr.status.value, cr.message]
                     for cr in r.constraint_results]] for c, r in res.check_results.items()],
        "metrics": {repr(a): value(mt) for a, mt in res.metrics.items()},
        "device_freq_sets": mon.device_freq_sets,
    }

    ids = Dataset.from_dict({"id": np.arange(n, dtype=np.int64) % 15_000,
                             "z": rng.integers(0, 7, n)})
    mon = RunMonitor()
    an = [A.Uniqueness(["id"]), A.Distinctness(["id", "z"]), A.CountDistinct(["z"])]
    ctx = AnalysisRunner.do_analysis_run(ids, an, batch_size=4096, monitor=mon, **RUN)
    out["grouping"] = {"metrics": metrics(ctx), "device_freq_sets": mon.device_freq_sets}

    # persisted states: this process's blobs, and the 64-bit ones of both
    # packages loaded and merged here
    pdata, an = persisted(Dataset, A)
    AnalysisRunner.do_analysis_run(pdata, an, batch_size=4096,
                                   save_states_with=SP.FileSystemStateProvider(
                                       os.path.join(STORE, PKG + "32")), **RUN)
    loaded = {}
    for writer in ("ref64", "port64"):
        store = SP.FileSystemStateProvider(os.path.join(STORE, writer))
        own = SP.FileSystemStateProvider(os.path.join(STORE, PKG + "32"))
        got = {}
        for a in an:
            s = store.load(a)
            mine = own.load(a)
            got[repr(a)] = {
                "dtypes": leaf_dtypes(s),
                "metric": value(a.compute_metric_from(s)),
                "merged2": value(a.compute_metric_from(merge(a, [s, s]))),
                "merged2_dtypes": leaf_dtypes(merge(a, [s, s])),
                "mixed": value(a.compute_metric_from(merge(a, [mine, s]))),
            }
        loaded[writer] = got
    out["loaded64"] = loaded

    # two sessions, one coalesced device fold each batch
    os.environ["DEEQU_TPU_COALESCE"] = "1"
    os.environ["DEEQU_TPU_FAST_PATH_MAX_ROWS"] = "0"
    svc = VerificationService(workers=2, background_warm=False, **SVC)
    try:
        sessions = [svc.session(f"t{i}", "d", [stream_check(m)]) for i in range(2)]
        svc.router.note_ran(shape_qualified_signature(sessions[0]._analyzers, 1024), 0,
                            "device")
        handles = [s.ingest(stream_batch(i, b), wait=False) for b in range(2)
                   for i, s in enumerate(sessions)]
        for h in handles:
            h.result(120)
        out["stream"] = {
            "metrics": [{repr(a): value(mt) for a, mt in s.current().metrics.items()}
                        for s in sessions],
            "counters": svc.json_snapshot()["counters"].get("deequ_service_coalesced_folds_total"),
        }
    finally:
        svc.close()
else:
    # the other package's 32-bit blobs, loaded and merged with this one's
    pdata, an = persisted(Dataset, A)
    other = "port32" if PKG == "ref" else "ref32"
    store = SP.FileSystemStateProvider(os.path.join(STORE, other))
    got = {}
    for a in an:
        s = store.load(a)
        got[repr(a)] = {"dtypes": leaf_dtypes(s), "metric": value(a.compute_metric_from(s)),
                        "merged2": value(a.compute_metric_from(merge(a, [s, s])))}
    out["loaded32"] = got
print(json.dumps(out))
'''


# ---------------------------------------------------------------------------
# the cases' data and analyzers, built with either package (``A``: its
# ``analyzers`` module, ``m``: the package)
# ---------------------------------------------------------------------------

def battery(A):
    """The reference's own 32-bit battery (``tests/test_no_x64.py``)."""
    return [A.Size(), A.Completeness("x"), A.Mean("x"), A.Sum("x"), A.Minimum("x"),
            A.Maximum("x"), A.StandardDeviation("x"), A.ApproxCountDistinct("y")]


def config2_table(rows: int = 20_000, seed: int = 5) -> pa.Table:
    """BASELINE config 2's table at a CPU size: numeric columns with nulls
    and NaN, a categorical dictionary column with nulls."""
    rng = np.random.default_rng(seed)
    a = rng.normal(10.0, 3.0, rows)
    b = rng.normal(-2.0, 5.0, rows)
    b[rng.random(rows) < 0.001] = np.nan
    codes = rng.integers(0, 40, rows).astype(np.int32)
    return pa.table({
        "a": pa.array(a, mask=rng.random(rows) < 0.05),
        "b": pa.array(b, mask=rng.random(rows) < 0.05),
        "cat": pa.DictionaryArray.from_arrays(
            pa.array(codes, mask=rng.random(rows) < 0.03),
            pa.array([f"s{i:03d}" for i in range(40)])),
    })


def config2(A):
    """BASELINE config 2's analyzers: Completeness, Mean, StdDev,
    Histogram, with a where-filter."""
    return [A.Completeness("a"), A.Completeness("b"), A.Mean("a"), A.Mean("b"),
            A.StandardDeviation("a"), A.StandardDeviation("b", where="a > 10"),
            A.Histogram("cat")]


def mesh_battery(A, sketch: bool):
    """The mesh cases' analyzers: config 2's scalar ones, and on the host
    tier a KLL sketch (whose sharded states equal the reference's there;
    on the device tier the reference's sharded sketch is another)."""
    out = [A.Size(), A.Completeness("a"), A.Mean("a"), A.Sum("b"), A.Minimum("b"),
           A.Maximum("a"), A.StandardDeviation("a"), A.Correlation("a", "b"),
           A.ApproxCountDistinct("cat")]
    return out + [A.KLLSketch("a", A.KLLParameters(256, 0.64, 10))] if sketch else out


def basic_items() -> pa.Table:
    """BASELINE config 1's five items (examples/example_utils.py)."""
    from examples.example_utils import SAMPLE_ITEMS

    items = SAMPLE_ITEMS
    return pa.table({
        "id": pa.array([i.id for i in items], type=pa.int64()),
        "productName": pa.array([i.product_name for i in items], type=pa.string()),
        "description": pa.array([i.description for i in items], type=pa.string()),
        "priority": pa.array([i.priority for i in items], type=pa.string()),
        "numViews": pa.array([i.num_views for i in items], type=pa.int64()),
    })


def basic_checks(m):
    """BASELINE config 1's checks (examples/basic_example.py)."""
    return [
        m.Check(m.CheckLevel.ERROR, "integrity checks")
        .has_size(lambda size: size == 5)
        .is_complete("id")
        .is_unique("id")
        .is_complete("productName")
        .is_contained_in("priority", ["high", "low"])
        .is_non_negative("numViews"),
        m.Check(m.CheckLevel.WARNING, "distribution checks")
        .contains_url("description", lambda ratio: ratio >= 0.5)
        .has_approx_quantile("numViews", 0.5, lambda median: median <= 10),
    ]


def persisted(Dataset, A):
    """The persisted-state case's data and analyzers: one of each scalar,
    moment, co-moment, HLL and KLL state."""
    rng = np.random.default_rng(3)
    n = 9_000
    x = rng.normal(10.0, 3.0, n)
    data = Dataset.from_dict({"x": x, "y": 2 * x + rng.normal(0, 1, n),
                              "c": rng.integers(0, 2000, n)})
    return data, [A.Size(), A.Mean("x"), A.Sum("y"), A.Minimum("x"), A.Maximum("y"),
                  A.StandardDeviation("y"), A.Correlation("x", "y"),
                  A.ApproxCountDistinct("c"), A.KLLSketch("y", A.KLLParameters(256, 0.64, 10))]


def stream_batch(session: int, batch: int) -> pa.Table:
    """A micro-batch of the soak's table (x with nulls, y, k, v)."""
    rng = np.random.default_rng(1000 + 97 * session + batch)
    rows = 1000 - 100 * session
    return pa.table({
        "x": pa.array(rng.normal(size=rows), mask=rng.random(rows) < 0.05),
        "y": rng.normal(10.0, 2.0, size=rows),
        "k": rng.integers(0, 1000, size=rows),
        "v": rng.uniform(0, 1, size=rows),
    })


def stream_check(m):
    """chip_smoke's coalesced-fold battery (moments, co-moments, HLL, KLL)."""
    def yes(_):
        return True

    return (m.Check(m.CheckLevel.ERROR, "ingest battery")
            .has_size(lambda n: n > 0).is_complete("x")
            .has_mean("y", yes).has_standard_deviation("y", yes)
            .has_min("v", yes).has_max("v", yes).has_sum("v", yes)
            .has_approx_count_distinct("k", yes)
            .has_approx_quantile("v", 0.5, yes)
            .has_correlation("x", "y", yes))
