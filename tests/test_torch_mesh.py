"""Row-sharded runs of the PyTorch/CUDA port over a device mesh, against
the JAX reference on its 8 virtual CPU devices (tests/conftest.py).

The port runs on ``make_mesh(n, device="cpu")`` (n shards of the CPU) with
the plain versions of its kernels. Tolerances:

- counts, min, max, HLL registers, DataType counts bit for bit;
- KLL sketches bit for bit where the merge order and the shards' partials
  are the reference's (the collective merge, the host tier's sharded
  fold); on the device tier the sketch sees the whole batch in the port,
  so it is held bit for bit against the port's unsharded run and against
  the reference's sharded run as tests/test_parallel.py holds the
  reference's own (equal bucket-count sums);
- float64 sums and moments within 1e-12 relative (the reference's merges
  are XLA's, the port's PyTorch's); metric values within 1e-12 relative.
"""

from __future__ import annotations

import jax
import numpy as np
import pyarrow as pa
import pytest
import torch

import chip_smoke
import deequ_tpu.analyzers as J
import deequ_tpu.data as JD
import deequ_tpu.parallel as JP
import deequ_tpu_torch as dq
import deequ_tpu_torch.analyzers as T
import deequ_tpu_torch.parallel as TP
from deequ_tpu.analyzers.state_provider import InMemoryStateProvider as JInMemoryStateProvider
from deequ_tpu.profiles import ColumnProfilerRunner as JaxProfilerRunner
from deequ_tpu.runners import AnalysisRunner as JaxRunner
from deequ_tpu.runners.engine import ScanEngine as JaxScanEngine
from deequ_tpu.verification import VerificationSuite as JaxSuite
from deequ_tpu_torch.analyzers.state_provider import InMemoryStateProvider
from deequ_tpu_torch.convert import from_reference_stacked, to_reference, to_reference_stacked
from deequ_tpu_torch.runners import AnalysisRunner, RunMonitor

pytestmark = pytest.mark.mesh

CPU = torch.device("cpu")
RTOL = 1e-12
MOMENT_STATES = ("MeanState", "SumState", "StandardDeviationState", "CorrelationState")
MOMENT_METRICS = ("Mean", "Sum", "StandardDeviation", "Correlation")


def merge_battery(m):
    """The collective merge's battery: every kind of state the merge folds."""
    return [
        m.Mean("x"), m.StandardDeviation("x"), m.Sum("x"), m.Minimum("x"), m.Maximum("x"),
        m.Completeness("x"), m.ApproxCountDistinct("y"), m.DataType("s"),
        m.Correlation("x", "z"), m.KLLSketch("x", m.KLLParameters(64, 0.64, 10)),
    ]


def shard_table(d: int, rows: int = 600) -> pa.Table:
    rng = np.random.default_rng(100 + d)
    x = rng.normal(d, 1 + d / 4, rows)
    strs = [None if rng.random() < 0.1 else (str(int(v)) if v % 3 else f"s{v}")
            for v in rng.integers(0, 50, rows)]
    return pa.table({
        "x": pa.array(x, mask=rng.random(rows) < 0.1),
        "y": pa.array(rng.integers(0, 300, rows)),
        "z": pa.array(rng.normal(-d, 2, rows)),
        "s": pa.array(strs, type=pa.string()),
    })


def _assert_state(torch_state, jax_state) -> None:
    name, tl = to_reference(torch_state)
    jl = [np.asarray(x) for x in jax.tree_util.tree_leaves(jax_state)]
    assert len(tl) == len(jl), name
    for i, (a, b) in enumerate(zip(jl, tl)):
        if name in MOMENT_STATES and a.dtype == np.float64:
            scale = float(np.nan_to_num(np.abs(a), posinf=0.0).max()) if a.size else 0.0
            ok = np.isclose(a, b, rtol=0, atol=RTOL * max(scale, 1.0), equal_nan=True)
            assert ok.all(), (name, i, a, b)
        else:
            same = a.tobytes() == np.asarray(b, dtype=a.dtype).tobytes()
            if not same and a.dtype.kind == "f":  # NaN payloads aside
                same = np.array_equal(a, b, equal_nan=True) and np.array_equal(
                    np.signbit(a), np.signbit(b))
            assert same, (name, i, a, b)


@pytest.fixture(scope="module")
def shard_states():
    """Eight shards' reference states of the merge battery, each from its
    own table, as numpy leaves."""
    analyzers = merge_battery(J)
    out = []
    for d in range(8):
        states, _ = JaxScanEngine(analyzers).run(JD.Dataset.from_arrow(shard_table(d)))
        out.append([jax.tree_util.tree_map(np.asarray, s) for s in states])
    return out


def _stack_reference(per_shard, i):
    return jax.tree_util.tree_map(lambda *xs: np.stack(xs), *[s[i] for s in per_shard])


@pytest.mark.parametrize("n_dev,shards", [(8, 8), (4, 8), (3, 5), (2, 3), (4, 0)])
def test_collective_merge_matches_the_reference(shard_states, n_dev, shards):
    """The same stacked states through both packages' collective merge:
    meshes of 8 (the butterfly), 4 with 8 states (k = 2 per shard), 3 (the
    gather route, padded with identity states) and 2 (padded, k = 2); zero
    shards give the identity states."""
    jb, tb = merge_battery(J), merge_battery(T)
    if shards == 0:
        stacked_j = tuple(
            jax.tree_util.tree_map(lambda x: np.zeros((0,) + np.shape(x), np.asarray(x).dtype),
                                   a.init_state()) for a in jb)
    else:
        stacked_j = tuple(_stack_reference(shard_states[:shards], i) for i in range(len(jb)))
    merged_j = JP.collective_merge_states(jb, JP.make_mesh(n_dev), stacked_j)
    stacked_t = [
        from_reference_stacked(type(a.init_state()).__name__,
                               jax.tree_util.tree_leaves(st))
        for a, st in zip(jb, stacked_j)
    ] if shards else [TP.stack_identity_states([a], 0, CPU)[0] for a in tb]
    merged_t = TP.collective_merge_states(tb, TP.make_mesh(n_dev, device="cpu"), stacked_t)
    for t, j in zip(merged_t, merged_j):
        _assert_state(t, jax.tree_util.tree_map(np.asarray, j))
    # the stacked states carry back to the reference bit for bit
    for t, j in zip(stacked_t, stacked_j):
        name, leaves = to_reference_stacked(t)
        assert name == type(j).__name__
        for a, b in zip(leaves, jax.tree_util.tree_leaves(j)):
            assert a.shape == np.shape(b) and a.tobytes() == np.asarray(b).tobytes()


def _butterfly_inputs(n_dev: int, k: int):
    """Every state kind the butterfly folds, ``n_dev * k`` random states
    each (chip_smoke.fold_groups), stacked: the reference's analyzers, its
    stacked states, and the port's."""
    from deequ_tpu.analyzers import states as JS
    from deequ_tpu_torch.analyzers.base import stack_states

    groups = chip_smoke.fold_groups(T, n_dev * k, seed=100 * n_dev + k)
    analyzers = [a for a, _ in chip_smoke.fold_groups(J, 1, 0)]
    stacked_t = [stack_states(states, CPU) for _, states in groups]
    stacked_j = []
    for st in stacked_t:
        name, leaves = to_reference_stacked(st)
        stacked_j.append(getattr(JS, name)(*leaves))
    return analyzers, stacked_j, stacked_t


def _butterfly_plain_merge(stacked_t, n_dev: int):
    """Shard 0's row of ``state_fold_butterfly_plain``, unpacked."""
    from deequ_tpu_torch.analyzers.base import pack_stacked, unpack_stacked
    from deequ_tpu_torch.kernels.state_fold import state_fold_butterfly_plain

    mats, slots, places = pack_stacked(stacked_t)
    rows = state_fold_butterfly_plain(*mats, slots, n_dev)
    assert all(r.shape[0] == n_dev for r in rows)
    return unpack_stacked(stacked_t, places, [r[0] for r in rows])


@pytest.mark.parametrize("k", [1, 3])
@pytest.mark.parametrize("n_dev", [1, 2, 3, 4, 8])
def test_butterfly_plain_matches_the_reference_collective_merge(n_dev, k):
    """K8's butterfly in plain PyTorch against the reference's collective
    merge on its CPU mesh of n_dev devices, over every state kind it folds:
    the XOR rounds (2, 4, 8), the gather route (3) and one device."""
    analyzers, stacked_j, stacked_t = _butterfly_inputs(n_dev, k)
    merged_j = JP.collective_merge_states(analyzers, JP.make_mesh(n_dev), tuple(stacked_j))
    for t, j in zip(_butterfly_plain_merge(stacked_t, n_dev), merged_j):
        _assert_state(t, jax.tree_util.tree_map(np.asarray, j))


_SIXTEEN_DEVICES = """
import os, sys
os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=16"
import jax
jax.config.update("jax_platforms", "cpu")
import numpy as np
import chip_smoke
import deequ_tpu.analyzers as J
import deequ_tpu.parallel as JP
from deequ_tpu.analyzers import states as JS

data = np.load(sys.argv[1], allow_pickle=False)
names = [str(x) for x in data["names"]]
stacked = [getattr(JS, name)(*[data[f"{i}_{j}"] for j in range(int(data[f"{i}_n"]))])
           for i, name in enumerate(names)]
analyzers = [a for a, _ in chip_smoke.fold_groups(J, 1, 0)]
merged = JP.collective_merge_states(analyzers, JP.make_mesh(16), tuple(stacked))
out = {}
for i, state in enumerate(merged):
    for j, leaf in enumerate(jax.tree_util.tree_leaves(state)):
        out[f"{i}_{j}"] = np.asarray(leaf)
np.savez(sys.argv[2], **out)
"""


def test_butterfly_plain_matches_the_reference_collective_merge_on_16_devices(tmp_path):
    """n_dev 16, k 1 and 3: the reference's mesh of 16 CPU devices runs in a
    process of its own (this one has 8)."""
    import os
    import subprocess
    import sys
    from pathlib import Path

    root = Path(__file__).resolve().parent.parent
    for k in (1, 3):
        _, stacked_j, stacked_t = _butterfly_inputs(16, k)
        arrays = {"names": np.array([type(st).__name__ for st in stacked_j])}
        for i, st in enumerate(stacked_j):
            leaves = jax.tree_util.tree_leaves(st)
            arrays[f"{i}_n"] = np.array(len(leaves))
            arrays.update({f"{i}_{j}": np.asarray(leaf) for j, leaf in enumerate(leaves)})
        given, got = tmp_path / f"in{k}.npz", tmp_path / f"out{k}.npz"
        np.savez(given, **arrays)
        env = dict(os.environ, PYTHONPATH=str(root))
        env.pop("XLA_FLAGS", None)
        subprocess.run([sys.executable, "-c", _SIXTEEN_DEVICES, str(given), str(got)],
                       cwd=root, env=env, check=True, timeout=600)
        merged = np.load(got)
        for i, t in enumerate(_butterfly_plain_merge(stacked_t, 16)):
            n_leaves = len([key for key in merged.files if key.startswith(f"{i}_")])
            _assert_state(t, [merged[f"{i}_{j}"] for j in range(n_leaves)])


def test_merge_of_more_shards_than_devices_folds_all():
    """tests/test_parallel.py:151: 8 persisted Size states of 100 rows on a
    mesh of 4 fold all 8 (k = 2 per shard)."""
    a = T.Size()
    data = dq.Dataset.from_dict({"x": np.arange(100, dtype=np.float64)})
    provider = InMemoryStateProvider()
    AnalysisRunner.do_analysis_run(data, [a], device="cpu", save_states_with=provider)
    stacked = TP.stack_canonical_states([a], (provider.load(a),), 8)[0]
    stacked = type(stacked)(stacked.num_matches[:1].expand(8).clone())
    merged = TP.collective_merge_states([a], TP.make_mesh(4, device="cpu"), [stacked])
    assert int(merged[0].num_matches) == 800


# ---------------------------------------------------------------------------
# the sharded scan on both tiers
# ---------------------------------------------------------------------------


def scan_battery(m):
    return [
        m.Size(), m.Completeness("x"), m.Mean("x"), m.Sum("x"), m.StandardDeviation("x"),
        m.Minimum("x"), m.Maximum("x"), m.ApproxCountDistinct("y"), m.DataType("s"),
        m.Correlation("x", "z"), m.KLLSketch("x", m.KLLParameters(512, 0.64, 10)),
    ]


@pytest.fixture(scope="module")
def table():
    rng = np.random.default_rng(0)
    n = 40_000
    strs = [None if rng.random() < 0.05 else f"v{int(i)}" for i in rng.integers(0, 900, n)]
    return pa.table({
        "x": pa.array(rng.normal(5, 2, n), mask=rng.random(n) < 0.1),
        "y": pa.array(rng.integers(0, 500, n)),
        "z": pa.array(rng.normal(-1, 3, n)),
        "s": pa.array(strs, type=pa.string()),
    })


def _value(metric):
    v = metric.value
    if v.is_failure:
        return ("failure", type(v.exception).__name__)
    got = v.get()
    if hasattr(got, "buckets"):
        return ([(b.low_value, b.high_value, b.count) for b in got.buckets], got.parameters,
                got.data)
    if hasattr(got, "values"):
        return (got.number_of_bins, {k: (d.absolute, d.ratio) for k, d in got.values.items()})
    return got


def _assert_metric(name, a, b) -> None:
    if isinstance(a, float) and np.isnan(a):
        assert isinstance(b, float) and np.isnan(b), name
    elif isinstance(a, float) and name in MOMENT_METRICS:
        assert abs(a - b) <= RTOL * max(1.0, abs(a)), (name, a, b)
    else:
        assert a == b, (name, a, b)


def _kll_total(metric) -> int:
    return sum(b.count for b in metric.value.get().buckets)


@pytest.mark.parametrize("n_dev", [8, 3])
def test_host_tier_on_a_mesh_matches_the_reference(table, n_dev):
    """The host tier over a mesh in both packages: the states (KLL items
    and HLL registers included) equal the reference's, as do the metrics;
    the pass ends in one collective merge."""
    jb, tb = scan_battery(J), scan_battery(T)
    jp, tp = JInMemoryStateProvider(), InMemoryStateProvider()
    jr = JaxRunner.do_analysis_run(JD.Dataset.from_arrow(table), jb, batch_size=1000,
                                   placement="host", sharding=JP.make_mesh(n_dev),
                                   save_states_with=jp)
    monitor = RunMonitor()
    tr = AnalysisRunner.do_analysis_run(dq.Dataset.from_arrow(table), tb, batch_size=1000,
                                        placement="host",
                                        sharding=TP.make_mesh(n_dev, device="cpu"),
                                        save_states_with=tp, monitor=monitor)
    assert monitor.placement == "host" and "collective_merge" in monitor.phase_seconds
    for ja, ta in zip(jb, tb):
        _assert_metric(ja.name, _value(jr.metric(ja)), _value(tr.metric(ta)))
        _assert_state(tp.load(ta), jax.tree_util.tree_map(np.asarray, jp.load(ja)))


def test_device_tier_on_a_mesh_matches_the_reference_and_the_unsharded_run(table):
    """tests/test_parallel.py:61: the sharded device tier equals the
    single-device run (the reference's sharded run too, within 1e-12; its
    KLL in bucket-count sums), and the port's sketch is its unsharded
    run's bit for bit."""
    jb, tb = scan_battery(J), scan_battery(T)
    data = dq.Dataset.from_arrow(table)
    jr = JaxRunner.do_analysis_run(JD.Dataset.from_arrow(table), jb, batch_size=8192,
                                   sharding=JP.make_mesh(8))
    monitor = RunMonitor()
    sharded = AnalysisRunner.do_analysis_run(data, tb, batch_size=8192, device="cpu",
                                             placement="device", monitor=monitor,
                                             sharding=TP.make_mesh(8, device="cpu"))
    plain = AnalysisRunner.do_analysis_run(data, tb, batch_size=8192, device="cpu",
                                           placement="device")
    assert monitor.placement == "device" and monitor.batches == 5
    for ja, ta in zip(jb, tb):
        if isinstance(ta, T.KLLSketch):
            assert _kll_total(sharded.metric(ta)) == _kll_total(jr.metric(ja))
            assert _value(sharded.metric(ta)) == _value(plain.metric(ta))
            continue
        _assert_metric(ja.name, _value(jr.metric(ja)), _value(sharded.metric(ta)))
        _assert_metric(ta.name, _value(plain.metric(ta)), _value(sharded.metric(ta)))


def test_odd_batch_sizes_pad_to_the_mesh_quantum():
    """tests/test_parallel.py:76: 333-row batches round up to the quantum."""
    data = dq.Dataset.from_dict({"x": np.arange(1000, dtype=np.float64)})
    monitor = RunMonitor()
    ctx = AnalysisRunner.do_analysis_run(data, [T.Size(), T.Mean("x")], batch_size=333,
                                         device="cpu", monitor=monitor,
                                         sharding=TP.make_mesh(8, device="cpu"))
    assert ctx.metric(T.Size()).value.get() == 1000.0
    assert ctx.metric(T.Mean("x")).value.get() == pytest.approx(499.5)
    assert monitor.batches == 3  # 336-row batches


def test_two_shard_hll_equals_the_unsharded_registers():
    """tests/test_parallel.py:174: HLL registers shard on the row axis."""
    data = dq.Dataset.from_dict({"y": np.arange(4000) % 137})
    a = T.ApproxCountDistinct("y")
    plain = AnalysisRunner.do_analysis_run(data, [a], device="cpu").metric(a).value.get()
    sharded = AnalysisRunner.do_analysis_run(
        data, [a], device="cpu", sharding=TP.make_mesh(2, device="cpu")).metric(a).value.get()
    assert plain == sharded and abs(plain - 137.0) <= 7


def test_host_placement_on_a_mesh_matches_the_device_tier(table):
    """tests/test_parallel.py:238: host partials folded over the mesh give
    the device tier's metrics (the sketch within twice its rank error)."""
    tb = scan_battery(T)
    data = dq.Dataset.from_arrow(table)
    host = AnalysisRunner.do_analysis_run(data, tb, batch_size=4096, placement="host",
                                          device="cpu", sharding=TP.make_mesh(8, device="cpu"))
    dev = AnalysisRunner.do_analysis_run(data, tb, batch_size=4096, placement="device",
                                         device="cpu")
    for a in tb:
        hv, dv = host.metric(a).value, dev.metric(a).value
        assert hv.is_success == dv.is_success, a
        if isinstance(a, T.KLLSketch):
            assert _kll_total(host.metric(a)) == _kll_total(dev.metric(a))
        elif isinstance(hv.get(), float):
            assert hv.get() == pytest.approx(dv.get(), rel=1e-9), a


def test_verification_suite_with_sharding_matches_the_reference(table):
    """``with_sharding`` on both builders: the same metrics and statuses."""
    def checks(m):
        return (m.Check(m.CheckLevel.ERROR, "mesh")
                .has_size(lambda n: n == 40_000).is_complete("y")
                .has_mean("x", lambda v: 4 < v < 6).has_standard_deviation("x", lambda v: v > 1)
                .has_approx_count_distinct("y", lambda v: v > 400)
                .has_approx_quantile("x", 0.5, lambda v: 4 < v < 6))

    import deequ_tpu as jdq

    jr = (JaxSuite.on_data(JD.Dataset.from_arrow(table)).add_check(checks(jdq))
          .with_sharding(JP.make_mesh(4)).with_placement("host").with_batch_size(2048).run())
    monitor = RunMonitor()
    tr = (dq.VerificationSuite.on_data(dq.Dataset.from_arrow(table), device="cpu")
          .add_check(checks(dq)).with_sharding(TP.make_mesh(4, device="cpu"))
          .with_placement("host").with_batch_size(2048).with_monitor(monitor).run())
    assert monitor.placement == "host" and "collective_merge" in monitor.phase_seconds
    assert tr.status.value == jr.status.value == "Success"
    jm = {(a.name, a.instance): _value(m) for a, m in jr.metrics.items()}
    tm = {(a.name, a.instance): _value(m) for a, m in tr.metrics.items()}
    assert jm.keys() == tm.keys()
    for key in jm:
        _assert_metric(key[0], jm[key], tm[key])


def test_profiler_with_sharding_matches_the_reference_and_the_unsharded_profile(table):
    """``ColumnProfilerRunner.with_sharding``: the profile over a mesh of 4
    equals the reference's sharded profile (its sketches in bucket-count
    sums) and the port's unsharded profile (sketches bit for bit)."""
    small = table.slice(0, 6000)

    def summary(profiles):
        out = {}
        for name, p in profiles.profiles.items():
            out[name] = (p.completeness, p.approximate_num_distinct_values, p.data_type,
                         getattr(p, "mean", None), getattr(p, "minimum", None),
                         getattr(p, "maximum", None), getattr(p, "sum", None),
                         getattr(p, "std_dev", None))
        return out

    jp = (JaxProfilerRunner.on_data(JD.Dataset.from_arrow(small)).with_batch_size(2048)
          .with_placement("device").with_sharding(JP.make_mesh(4)).run())
    tp = (dq.ColumnProfilerRunner.on_data(dq.Dataset.from_arrow(small), device="cpu")
          .with_batch_size(2048).with_placement("device")
          .with_sharding(TP.make_mesh(4, device="cpu")).run())
    plain = (dq.ColumnProfilerRunner.on_data(dq.Dataset.from_arrow(small), device="cpu")
             .with_batch_size(2048).with_placement("device").run())
    js, ts, ps = summary(jp), summary(tp), summary(plain)
    assert js.keys() == ts.keys() == ps.keys()
    for name in js:
        for j, t, p in zip(js[name], ts[name], ps[name]):
            if isinstance(j, float):
                assert t == pytest.approx(j, rel=RTOL, nan_ok=True), name
                assert t == pytest.approx(p, rel=RTOL, nan_ok=True), name
            else:
                assert j == t == p, name
        tk, pk = tp.profiles[name], plain.profiles[name]
        if getattr(tk, "kll", None) is not None:
            assert tk.kll.buckets == pk.kll.buckets, name


# ---------------------------------------------------------------------------
# the mesh's plumbing
# ---------------------------------------------------------------------------


def test_make_mesh_repeats_devices_in_blocks():
    mesh = TP.make_mesh(8, device="cpu")
    assert mesh.size == 8 and mesh.home == CPU and mesh.groups() == [(CPU, list(range(8)))]
    two = TP.make_mesh(devices=[CPU, CPU, CPU], num_devices=2)
    assert two.size == 2
    with pytest.raises(ValueError):
        TP.Mesh([])


def test_a_mesh_on_the_card_needs_a_card():
    if torch.cuda.is_available():
        assert TP.make_mesh(2).home.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            TP.make_mesh(2)


def test_shard_features_split_the_rows_contiguously():
    rows = torch.ones(12, dtype=torch.bool)
    feats = TP.shard_features({"rows": rows, "num:x": torch.arange(12.0)},
                              TP.make_mesh(3, device="cpu"))
    assert feats["num:x"].shape == (3, 4) and feats["num:x"][1].tolist() == [4, 5, 6, 7]
    with pytest.raises(ValueError):
        TP.shard_features({"rows": torch.ones(10, dtype=torch.bool)},
                          TP.make_mesh(4, device="cpu"))


def test_sharded_update_equals_the_engine_pass(table):
    """``sharded_update`` is the device tier's per-batch mesh update."""
    from deequ_tpu_torch.runners.engine import ScanEngine, to_device

    tb = [T.Size(), T.Mean("x"), T.ApproxCountDistinct("y")]
    data = dq.Dataset.from_arrow(table.slice(0, 8192))
    engine = ScanEngine(tb, CPU)
    features = to_device(engine.builder.build(next(data.batches(8192))), CPU)
    update = TP.sharded_update(tb, TP.make_mesh(4, device="cpu"))
    states = update([a.init_state(CPU) for a in tb], features)
    ctx = AnalysisRunner.do_analysis_run(data, tb, batch_size=8192, device="cpu",
                                         sharding=TP.make_mesh(4, device="cpu"))
    for a, st in zip(tb, states):
        assert a.compute_metric_from(st).value.get() == ctx.metric(a).value.get()


def test_mismatched_device_and_mesh_raise():
    data = dq.Dataset.from_dict({"x": np.arange(10, dtype=np.float64)})
    mesh = TP.Mesh([torch.device("cuda", 0)])
    with pytest.raises(ValueError, match="does not match"):
        AnalysisRunner.do_analysis_run(data, [T.Size()], device="cpu", sharding=mesh)


def _nan_column() -> np.ndarray:
    x = np.arange(1000, dtype=np.float64)
    x[::3] = np.nan
    x[1::7] = np.inf
    return x


@pytest.mark.parametrize("batch", [4, 333])
@pytest.mark.parametrize("n_dev", [8, 3])
@pytest.mark.parametrize("placement", ["device", "host"])
def test_max_and_min_of_a_nan_column_over_a_mesh_equal_the_unsharded_runs(placement, n_dev,
                                                                          batch):
    """A column with NaN and +inf: Maximum is NaN (NaN propagates) and
    Minimum 2.0 (NaN never wins a min) over a mesh of 8 and of 3 shards on
    both tiers, as in the port's unsharded run and the reference's. The
    reference's sharded device tier gives inf or -inf here (its GSPMD
    ``sharded_update`` drops NaN in the cross-device max): a fault of the
    reference, which the port is not held to."""
    x = _nan_column()
    ja, ta = [J.Maximum("x"), J.Minimum("x")], [T.Maximum("x"), T.Minimum("x")]
    runs = {
        "port sharded": AnalysisRunner.do_analysis_run(
            dq.Dataset.from_dict({"x": x}), ta, batch_size=batch, device="cpu",
            placement=placement, sharding=TP.make_mesh(n_dev, device="cpu")),
        "port": AnalysisRunner.do_analysis_run(dq.Dataset.from_dict({"x": x}), ta,
                                               batch_size=batch, device="cpu",
                                               placement=placement),
    }
    reference = JaxRunner.do_analysis_run(JD.Dataset.from_dict({"x": x}), ja, batch_size=batch,
                                          placement=placement)
    reference_sharded = JaxRunner.do_analysis_run(JD.Dataset.from_dict({"x": x}), ja,
                                                  batch_size=batch, placement=placement,
                                                  sharding=JP.make_mesh(n_dev))
    for label, ctx in runs.items():
        assert np.isnan(ctx.metric(ta[0]).value.get()), label
        assert ctx.metric(ta[1]).value.get() == 2.0, label
    assert np.isnan(reference.metric(ja[0]).value.get())
    assert reference.metric(ja[1]).value.get() == 2.0
    if placement == "device":
        assert not np.isnan(reference_sharded.metric(ja[0]).value.get())
    else:
        assert np.isnan(reference_sharded.metric(ja[0]).value.get())
