"""The coalesced fold of the PyTorch/CUDA port (``fold_sessions_coalesced``
and the stacked entries of ``scan_reduce`` and ``hll_registers``) against
the JAX reference, against the port's own one-batch fold, and the
coalescer's routing and keys.

Both packages run on the CPU over the same pyarrow tables, one padded
batch per session in one pow2 bucket: the reference's
``fold_sessions_coalesced`` vmaps its fused update over the sessions; the
port's runs the stacked kernels' plain versions. Tolerances: counts, min,
max and HLL registers bit for bit; float64 sums and moments within 1e-12
relative (the reference's reductions are XLA's, the port's PyTorch's).
KLL sketches are held bit for bit to the reference's SERIAL device-tier
fold of the same batch: the reference's vmapped KLL is another valid
sketch of the data, not the serial one (its tests/test_coalesce.py:8-11).
"""

from __future__ import annotations

import jax
import numpy as np
import pyarrow as pa
import pytest
import torch

import deequ_tpu  # noqa: F401 - x64 config
import deequ_tpu.analyzers as J
import deequ_tpu.data as JD
import deequ_tpu.analyzers.states as JS
import deequ_tpu_torch as dq
import deequ_tpu_torch.analyzers as T
import deequ_tpu_torch.analyzers.states as TS
from deequ_tpu.runners import engine as jengine
from deequ_tpu.runners.features import FeatureBuilder as JFeatureBuilder
from deequ_tpu.service.coalesce import build_fold_plan as jbuild_fold_plan
from deequ_tpu_torch.convert import from_reference, to_reference
from deequ_tpu_torch.kernels.hll_registers import (
    hll_registers_plain,
    hll_registers_stacked,
    hll_registers_stacked_plain,
)
from deequ_tpu_torch.kernels.scan_reduce import (
    KIND_CLASSES,
    KIND_COMOMENTS,
    KIND_COUNTS,
    KIND_MOMENTS,
    Slot,
    scan_reduce_plain,
    scan_reduce_stacked,
    scan_reduce_stacked_plain,
)
from deequ_tpu_torch.runners import engine as tengine
from deequ_tpu_torch.runners.features import FeatureBuilder
from deequ_tpu_torch.service.coalesce import build_fold_plan

CPU = torch.device("cpu")
RTOL = 1e-12
BUCKET = 1024
MOMENT_STATES = ("MeanState", "SumState", "StandardDeviationState", "CorrelationState")


def table(rows: int, seed: int) -> pa.Table:
    """The streaming soak's four columns (tools/ingest_soak.py) plus a
    string column: nulls in x, NaN and +-0.0 in v."""
    rng = np.random.default_rng(seed)
    v = rng.normal(size=rows)
    v[rng.random(rows) < 0.02] = np.nan
    v[rng.random(rows) < 0.02] = -0.0
    s = [None if rng.random() < 0.05 else f"s{int(i)}" for i in rng.integers(0, 300, rows)]
    return pa.table({
        "x": pa.array(rng.normal(size=rows), mask=rng.random(rows) < 0.05),
        "y": rng.normal(10.0, 2.0, size=rows),
        "k": rng.integers(0, 500, size=rows),
        "v": pa.array(v),
        "s": pa.array(s),
    })


def battery(m):
    """Every kind of the coalesced path: counts, a where-filter, moments,
    a class-count slot, co-moments, HLL and a KLL sketch."""
    return [
        m.Size(), m.Completeness("x"), m.Mean("y"), m.StandardDeviation("y"),
        m.Sum("v"), m.Minimum("v"), m.Maximum("v"), m.Mean("y", where="x > 0"),
        m.MaxLength("s"), m.DataType("s"), m.Correlation("x", "y"),
        m.ApproxCountDistinct("k"), m.ApproxQuantile("v", 0.5),
    ]


def _assert_state(torch_state, jax_state, what) -> None:
    name, tl = to_reference(torch_state)
    jl = [np.asarray(x) for x in jax.tree_util.tree_leaves(jax_state)]
    assert len(tl) == len(jl), (what, name)
    for i, (a, b) in enumerate(zip(jl, tl)):
        if name in MOMENT_STATES and a.dtype == np.float64:
            scale = float(np.nan_to_num(np.abs(a), posinf=0.0).max()) if a.size else 0.0
            ok = np.isclose(a, b, rtol=0, atol=RTOL * max(scale, 1.0), equal_nan=True)
            assert ok.all(), (what, name, i, a, b)
        else:
            same = a.tobytes() == np.asarray(b, dtype=a.dtype).tobytes()
            if not same and a.dtype.kind == "f":  # NaN payloads aside
                same = np.array_equal(a, b, equal_nan=True) and np.array_equal(
                    np.signbit(a), np.signbit(b))
            assert same, (what, name, i, a, b)


def _assert_same(got, want, what) -> None:
    """Two port states bit for bit (NaN payloads aside)."""
    assert type(got) is type(want), what
    for a, b in zip(TS.leaves(got), TS.leaves(want)):
        assert a.dtype == b.dtype and a.shape == b.shape, what
        assert torch.equal(a, b) or (torch.equal(torch.isnan(a), torch.isnan(b)) and torch.equal(
            torch.nan_to_num(a, nan=0.0), torch.nan_to_num(b, nan=0.0))), (what, a, b)


def _sessions(width: int, seed: int):
    """``width`` ragged micro-batches of one bucket (1 to BUCKET rows)."""
    rng = np.random.default_rng(seed)
    sizes = [int(rng.integers(1, BUCKET + 1)) for _ in range(width)]
    sizes[0] = BUCKET  # a full batch beside the ragged ones
    return [table(n, seed * 100 + w) for w, n in enumerate(sizes)]


def _port_coalesced(tables):
    tb = tuple(battery(T))
    program = tengine._fused_program(tb)
    builder = FeatureBuilder([s for a in tb for s in a.feature_specs()])
    feats = [builder.build(next(iter(dq.Dataset.from_arrow(t).batches(BUCKET)))) for t in tables]
    return tb, tengine.fold_sessions_coalesced([program] * len(tables), feats, CPU)


@pytest.mark.parametrize("width", [1, 3, 16])
def test_coalesced_fold_matches_the_reference(width):
    """Against the reference's coalesced fold (every state but the KLL
    sketch) and its serial device-tier fold of each session (every state,
    the sketch bit for bit)."""
    tables = _sessions(width, seed=width)
    tb, got = _port_coalesced(tables)
    jb = tuple(battery(J))
    jbuilder = JFeatureBuilder([s for a in jb for s in a.feature_specs()])
    jfeats = [jbuilder.build(next(iter(JD.Dataset.from_arrow(t).batches(BUCKET))))
              for t in tables]
    want = jengine.fold_sessions_coalesced([jengine._fused_program(jb, None)] * width, jfeats)
    for w in range(width):
        for a, g, s in zip(tb, got[w], want[w]):
            if not isinstance(a, T.ApproxQuantile):
                _assert_state(g, s, (w, a))
    for w in (0, width - 1):
        serial, _ = jengine.ScanEngine(list(jb), placement="device").run(
            JD.Dataset.from_arrow(tables[w]), batch_size=BUCKET)
        for a, g, s in zip(tb, got[w], serial):
            _assert_state(g, s, (w, a))


@pytest.mark.parametrize("width", [1, 5])
def test_coalesced_fold_equals_the_one_batch_fold(width):
    """Each session's coalesced states are the port's own one-batch
    device-tier fold of its batch, bit for bit."""
    tables = _sessions(width, seed=40 + width)
    tb, got = _port_coalesced(tables)
    for w, t in enumerate(tables):
        serial = tengine.ScanEngine(list(tb), CPU, placement="device").run(
            dq.Dataset.from_arrow(t), batch_size=BUCKET)
        for a, g, s in zip(tb, got[w], serial):
            _assert_same(g, s, (w, a))


def _stacked_slots(width: int, n: int, seed: int):
    """Every slot kind over ``[W, n]`` arrays, with NaN and signed zeros."""
    rng = np.random.default_rng(seed)
    vals = rng.normal(size=(width, n))
    vals[rng.random((width, n)) < 0.05] = np.nan
    vals[rng.random((width, n)) < 0.05] = -0.0
    vals[rng.random((width, n)) < 0.05] = 0.0

    def mask(p):
        return torch.from_numpy(rng.random((width, n)) < p)

    rows = mask(0.9)
    lengths = torch.from_numpy(rng.integers(0, 40, (width, n)).astype(np.int32))
    codes = torch.from_numpy(rng.integers(-1, 6, (width, n)).astype(np.int32))
    x, y = torch.from_numpy(vals), torch.from_numpy(rng.normal(3.0, 1.0, (width, n)))
    slots = [
        Slot(KIND_COUNTS),
        Slot(KIND_COUNTS, where=mask(0.5), sel=mask(0.7)),
        Slot(KIND_MOMENTS, sel=mask(0.8), vals=x),
        Slot(KIND_MOMENTS, where=mask(0.3), sel=mask(0.9), vals=lengths),
        Slot(KIND_CLASSES, vals=codes),
        Slot(KIND_COMOMENTS, sel=mask(0.9), vals=torch.nan_to_num(x), vals2=y, sel2=mask(0.8)),
    ]
    return slots, rows


def _row(slot: Slot, w: int) -> Slot:
    return Slot(slot.kind, *(None if t is None else t[w].contiguous()
                             for t in (slot.where, slot.sel, slot.vals, slot.vals2, slot.sel2)))


@pytest.mark.parametrize("width,n", [(1, 100), (3, 4096), (16, 1000)])
def test_stacked_plain_versions_equal_one_session_calls(width, n):
    """Row w of each stacked plain version is the one-session plain call on
    session w's arrays; the wrappers route CPU tensors to them."""
    slots, rows = _stacked_slots(width, n, seed=n + width)
    got_i, got_f = scan_reduce_stacked(slots, rows)
    want = scan_reduce_stacked_plain(slots, rows)
    assert torch.equal(got_i, want[0]) and torch.equal(got_f.isnan(), want[1].isnan())
    for w in range(width):
        one_i, one_f = scan_reduce_plain([_row(s, w) for s in slots], rows[w].contiguous())
        assert torch.equal(got_i[w], one_i)
        assert torch.equal(torch.nan_to_num(got_f[w]), torch.nan_to_num(one_f))
        assert torch.equal(torch.signbit(got_f[w]), torch.signbit(one_f))
    rng = np.random.default_rng(n)
    keys = torch.from_numpy(rng.integers(0, 1 << 15, (width, n)).astype(np.uint16))
    present, where = torch.from_numpy(rng.random((width, n)) < 0.9), rows.clone()
    regs = hll_registers_stacked(keys, rows, where, present)
    assert torch.equal(regs, hll_registers_stacked_plain(keys, rows, where, present))
    for w in range(width):
        assert torch.equal(regs[w], hll_registers_plain(keys[w], rows[w], where[w], present[w]))


@pytest.mark.parametrize("bad", ["1-d rows", "mask shape", "keys dtype"])
def test_stacked_entries_validate_their_inputs(bad):
    slots, rows = _stacked_slots(2, 64, seed=1)
    with pytest.raises((ValueError, TypeError)):
        if bad == "1-d rows":
            scan_reduce_stacked(slots, rows[0])
        elif bad == "mask shape":
            scan_reduce_stacked([Slot(KIND_COUNTS, where=rows[:, :10])], rows)
        else:
            hll_registers_stacked(rows.to(torch.int32), rows, None, rows)


def _plan_case(name):
    """(port analyzers, reference analyzers, schema table) of a routing case."""
    t = table(64, seed=9)
    return {
        "transparent": ([T.Size(), T.Mean("y"), T.ApproxCountDistinct("k")],
                        [J.Size(), J.Mean("y"), J.ApproxCountDistinct("k")]),
        "moments": ([T.Size(), T.StandardDeviation("y")], [J.Size(), J.StandardDeviation("y")]),
        "sketch": ([T.Size(), T.ApproxQuantile("v", 0.5)], [J.Size(), J.ApproxQuantile("v", 0.5)]),
        "grouping": ([T.Size(), T.Uniqueness(["k"])], [J.Size(), J.Uniqueness(["k"])]),
        "missing column": ([T.Size(), T.Mean("nope")], [J.Size(), J.Mean("nope")]),
        "string mean": ([T.Mean("s")], [J.Mean("s")]),
        "histogram": ([T.Histogram("k")], [J.Histogram("k")]),
        "exact quantile": ([T.ApproxQuantile("v", 0.5, 0.0)], [J.ApproxQuantile("v", 0.5, 0.0)]),
    }[name], t


@pytest.mark.parametrize("case", ["transparent", "moments", "sketch", "grouping",
                                  "missing column", "string mean", "histogram",
                                  "exact quantile"])
def test_fold_plans_route_as_the_reference(case):
    """The same batteries get a plan (and the same fast-path verdict) in
    both packages; grouping batteries and failing preconditions get none
    (the serial path)."""
    (tb, jb), t = _plan_case(case)
    plan = build_fold_plan(tb, dq.Dataset.from_arrow(t).schema)
    jplan = jbuild_fold_plan(jb, JD.Dataset.from_arrow(t).schema)
    assert (plan is None) == (jplan is None), case
    if plan is not None:
        assert plan.fast_ok == jplan.fast_ok, case
    assert (plan is None) == (case in ("grouping", "missing column", "string mean",
                                       "histogram", "exact quantile"))


def test_equal_signatures_with_different_slot_layouts_get_different_keys():
    """Mean("a"), Sum("a") share one deduplicated slot; Mean("a"), Sum("b")
    need two. Their analyzers' signatures agree, so only the layout keeps
    their folds out of one stacked launch."""
    t = pa.table({"a": np.arange(8.0), "b": np.arange(8.0) * 2})
    schema = dq.Dataset.from_arrow(t).schema
    one = build_fold_plan([T.Mean("a"), T.Sum("a")], schema)
    two = build_fold_plan([T.Mean("a"), T.Sum("b")], schema)
    assert one.signatures == two.signatures
    assert one.layout != two.layout
    assert len(one.program().bundles[0]) == 1 and len(two.program().bundles[0]) == 2


def _edge_states(cls_name: str, seed: int):
    """A pair of states of a transparent class with NaN, +-0.0 and inf."""
    rng = np.random.default_rng(seed)
    f = [np.nan, -0.0, 0.0, np.inf, -np.inf, float(rng.normal())]

    def pick():
        return np.float64(f[int(rng.integers(0, len(f)))])

    def count():
        return np.int64(rng.integers(0, 1000))

    leaves = {
        "NumMatches": lambda: [count()],
        "NumMatchesAndCount": lambda: [count(), count()],
        "MeanState": lambda: [pick(), count()],
        "SumState": lambda: [pick(), count()],
        "MinState": lambda: [pick(), count()],
        "MaxState": lambda: [pick(), count()],
        "DataTypeHistogram": lambda: [rng.integers(0, 99, 5).astype(np.int64)],
        "ApproxCountDistinctState": lambda: [rng.integers(0, 30, 512).astype(np.int32)],
        "FrequencyCountsState": lambda: [rng.integers(0, 99, 7).astype(np.int64), count()],
    }[cls_name]
    return leaves(), leaves()


TRANSPARENT = sorted(c.__name__ for c in TS.IDENTITY_TRANSPARENT_STATES)


@pytest.mark.parametrize("cls_name", TRANSPARENT)
def test_host_merge_equals_merge_and_the_reference(cls_name):
    """``host_merge`` gives the port's ``merge`` bits and the reference's
    ``host_merge`` bits, on edge values (NaN, +-0.0, +-inf)."""
    jcls = getattr(JS, cls_name)
    assert TS.identity_merge_transparent(getattr(TS, cls_name))
    assert JS.identity_merge_transparent(jcls)
    for seed in range(12):
        la, lb = _edge_states(cls_name, seed)
        a, b = from_reference(cls_name, la), from_reference(cls_name, lb)
        got = TS.host_merge(a, b)
        _assert_same(got, a.merge(b), cls_name)
        _assert_state(got, JS.host_merge(jcls(*la), jcls(*lb)), cls_name)


@pytest.mark.parametrize("cls_name", ["StandardDeviationState", "CorrelationState",
                                      "KLLSketchState"])
def test_host_merge_refuses_other_states(cls_name):
    state = T.StandardDeviation("y").init_state(CPU)
    if cls_name == "CorrelationState":
        state = T.Correlation("x", "y").init_state(CPU)
    elif cls_name == "KLLSketchState":
        state = T.KLLSketch("y").init_state(CPU)
    assert not TS.identity_merge_transparent(type(state))
    with pytest.raises(TypeError):
        TS.host_merge(state, state)


def test_warmth_follows_the_first_launch():
    """A battery is warm once its program has launched in this process;
    the coalesced fold counts as a launch."""
    tb = (T.Size(), T.Maximum("y"), T.Minimum("x", where="y > 11.5"))
    assert not tengine.fused_program_is_cached(tb)
    builder = FeatureBuilder([s for a in tb for s in a.feature_specs()])
    feats = builder.build(next(iter(dq.Dataset.from_arrow(table(10, 1)).batches(BUCKET))))
    tengine.fold_sessions_coalesced([tengine._fused_program(tb)], [feats], CPU)
    assert tengine.fused_program_is_cached(list(tb) + [T.Uniqueness(["k"])])


def test_scan_signatures_ignore_columns_but_not_kinds():
    sig = tengine._scan_signature
    assert sig(T.Maximum("y")) == sig(T.Maximum("x"))
    assert sig(T.Maximum("y")) != sig(T.Minimum("y"))
    assert sig(T.Maximum("y")) != sig(T.Maximum("y", where="x > 0"))
    assert sig(T.ApproxQuantile("y", 0.5)) != sig(T.KLLSketch("y", T.KLLParameters(256)))


def test_batteries_with_different_layouts_never_share_a_launch(monkeypatch):
    """Sessions of Mean("a"), Sum("a") and of Mean("a"), Sum("b") fold in
    separate coalesced launches (their keys differ), and each session's
    metrics equal its serial folds bit for bit."""
    from deequ_tpu_torch.service import VerificationService

    def check(second):
        return dq.Check(dq.CheckLevel.ERROR, second).has_mean("a", lambda v: True) \
            .has_sum(second, lambda v: True)

    rng = np.random.default_rng(2)
    batches = [pa.table({"a": rng.normal(size=500), "b": rng.normal(size=500)})
               for _ in range(8)]
    out = {}
    for coalesce in ("1", "0"):
        monkeypatch.setenv("DEEQU_TPU_COALESCE", coalesce)
        monkeypatch.setenv("DEEQU_TPU_FAST_PATH_MAX_ROWS", "0")
        with VerificationService(workers=1, device="cpu", background_warm=False) as svc:
            sess = [svc.session(f"t{i}", "d", [check("a" if i % 2 else "b")])
                    for i in range(4)]
            handles = [s.ingest(batches[2 * i + b], wait=False)
                       for b in range(2) for i, s in enumerate(sess)]
            for h in handles:
                h.result(60)
            out[coalesce] = [{repr(a): m.value.get() for a, m in s.current().metrics.items()}
                             for s in sess]
            if coalesce == "1":
                counters = svc.json_snapshot()["counters"]
                assert counters["deequ_service_coalesced_folds_total"] == 8
                assert set(counters["deequ_service_coalesce_width_total"]) <= {
                    "width=1", "width=2"}
    assert out["1"] == out["0"]


def test_a_group_merges_into_the_persisted_states_on_the_service_device(monkeypatch):
    """A coalesced group merges its deltas into the sessions' persisted
    states with one ``merge_states_batched_many`` call on the service's
    device (one ``state_fold`` launch for the group's scalar states), and
    only where a state was persisted: the first folds merge nothing."""
    import deequ_tpu_torch.analyzers.base as base
    from deequ_tpu_torch.service import VerificationService

    calls = []
    merge = base.merge_states_batched_many

    def recording_merge(groups, device=None):
        calls.append((len(groups), device))
        return merge(groups, device)

    monkeypatch.setattr(base, "merge_states_batched_many", recording_merge)
    monkeypatch.setenv("DEEQU_TPU_COALESCE", "1")
    monkeypatch.setenv("DEEQU_TPU_FAST_PATH_MAX_ROWS", "0")
    check = dq.Check(dq.CheckLevel.ERROR, "c").has_mean("a", lambda v: True) \
        .has_standard_deviation("a", lambda v: True).has_approx_count_distinct("b", lambda v: True)
    rng = np.random.default_rng(3)
    with VerificationService(workers=1, device="cpu", background_warm=False) as svc:
        sess = [svc.session(f"t{i}", "d", [check]) for i in range(4)]
        for s in sess:
            s.ingest(pa.table({"a": rng.normal(size=300), "b": rng.integers(0, 50, 300)}),
                     wait=True, timeout=60)
        assert calls == []
        handles = [s.ingest(pa.table({"a": rng.normal(size=300),
                                      "b": rng.integers(0, 50, 300)}), wait=False)
                   for s in sess]
        for h in handles:
            h.result(60)
        counters = svc.json_snapshot()["counters"]
        assert counters["deequ_service_coalesced_folds_total"] == 8
        # one call per launch of the second round (the first round's four
        # launches merged nothing)
        assert len(calls) == sum(counters["deequ_service_coalesce_width_total"].values()) - 4
        assert {device for _, device in calls} == {svc.device}
        assert sum(n for n, _ in calls) == 4 * 3
