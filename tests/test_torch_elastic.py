"""The elastic mesh of the PyTorch/CUDA port against the JAX reference
(ports of tests/test_elastic_mesh.py:97-152 and :335-548): a shard lost
mid-pass is salvaged, the mesh re-shards one ladder rung down and the lost
batches replay; both packages take the same injected faults, count the
same losses, re-shards and salvaged states, and end with the same metrics
(within 1e-9 relative, KLL sketches in bucket-count sums), equal to the
fault-free run's. The port runs on ``make_mesh(8, device="cpu")``.

The checkpoint cases (:262-333): a checkpoint taken on one mesh shape
resumes on a smaller one and on the plain host tier, in both packages,
with the fault-free run's metrics (the same tolerances); a resumed mesh
seeds the canonical merge into shard 0 (``ElasticMeshFold.seed``). The
device tier's pass-level re-shard (:154-172), which runs through the
reliability wrapper, is held in ``tests/test_torch_reliability.py``
(``test_pass_level_reshard_on_device_path``)."""

from __future__ import annotations

import logging

import numpy as np
import pyarrow as pa
import pytest
import torch

import deequ_tpu.analyzers as J
import deequ_tpu.data as JD
import deequ_tpu.parallel as JP
import deequ_tpu.reliability as JR
import deequ_tpu_torch as dq
import deequ_tpu_torch.analyzers as T
import deequ_tpu_torch.parallel as TP
import deequ_tpu_torch.reliability as TR
from deequ_tpu.runners import AnalysisRunner as JaxRunner
from deequ_tpu.runners.engine import RunMonitor as JaxMonitor
from deequ_tpu_torch.exceptions import ShardLossError, ShardStallError
from deequ_tpu_torch.parallel import elastic, health
from deequ_tpu_torch.runners import AnalysisRunner, RunMonitor
from deequ_tpu_torch.runners.engine import ScanEngine

pytestmark = pytest.mark.mesh

ROWS = 24_000
BATCH = 512
CPU = torch.device("cpu")


def battery(m):
    return [
        m.Size(), m.Completeness("x"), m.Mean("x"), m.Sum("x"), m.StandardDeviation("x"),
        m.Maximum("x"), m.ApproxCountDistinct("y"), m.KLLSketch("x", m.KLLParameters(256, 0.64, 10)),
    ]


@pytest.fixture(scope="module")
def table():
    rng = np.random.default_rng(17)
    return pa.table({
        "x": pa.array(rng.normal(5, 2, ROWS), mask=rng.random(ROWS) < 0.1),
        "y": pa.array(rng.integers(0, 700, ROWS)),
    })


@pytest.fixture(scope="module")
def clean(table):
    """The fault-free run: the port's mesh-free host tier."""
    tb = battery(T)
    ctx = AnalysisRunner.do_analysis_run(dq.Dataset.from_arrow(table), tb, batch_size=BATCH,
                                         placement="host", device="cpu")
    return [ctx.metric(a) for a in tb]


def _values(metrics, analyzers):
    out = []
    for a, m in zip(analyzers, metrics):
        assert m.value.is_success, a
        v = m.value.get()
        out.append(sum(b.count for b in v.buckets) if hasattr(v, "buckets") else v)
    return out


def assert_parity(want, got, rel=1e-9):
    for w, g in zip(want, got):
        if isinstance(w, int):
            assert w == g
        else:
            assert g == pytest.approx(w, rel=rel)


def lossy_runs(table, *specs):
    """The same run with the same faults in both packages: (reference's
    metrics, monitor, fired), (port's metrics, monitor, fired)."""
    jb, tb = battery(J), battery(T)
    jmon, tmon = JaxMonitor(), RunMonitor()
    with JR.inject(*(JR.FaultSpec(**s) for s in specs)) as jinj:
        jr = JaxRunner.do_analysis_run(JD.Dataset.from_arrow(table), jb, batch_size=BATCH,
                                       sharding=JP.make_mesh(8), placement="host",
                                       monitor=jmon)
    with TR.inject(*(TR.FaultSpec(**s) for s in specs)) as tinj:
        tr = AnalysisRunner.do_analysis_run(dq.Dataset.from_arrow(table), tb, batch_size=BATCH,
                                            sharding=TP.make_mesh(8, device="cpu"),
                                            placement="host", monitor=tmon)
    return ((_values([jr.metric(a) for a in jb], jb), jmon, jinj.fired),
            (_values([tr.metric(a) for a in tb], tb), tmon, tinj.fired))


def _same_counters(jmon, tmon):
    for name in ("shard_losses", "mesh_reshards", "salvaged_states"):
        assert getattr(jmon, name) == getattr(tmon, name), name
    assert list(jmon.degraded) == list(tmon.degraded)


def test_single_loss_salvages_reshards_and_replays(table, clean):
    (jv, jmon, jfired), (tv, tmon, tfired) = lossy_runs(
        table, dict(site="sharded_fold", kind="mesh_loss", at=2, shard=5))
    assert len(tfired) == len(jfired) == 1 and tfired[0].startswith("sharded_fold")
    assert (tmon.shard_losses, tmon.mesh_reshards, tmon.salvaged_states) == (1, 1, 7)
    assert "mesh:8->4" in tmon.degraded
    _same_counters(jmon, tmon)
    assert_parity(jv, tv)
    assert_parity(_values(clean, battery(T)), tv)


def test_loss_during_the_collective_merge_recovers(table, clean):
    (jv, jmon, _), (tv, tmon, tfired) = lossy_runs(
        table, dict(site="collective_merge", kind="mesh_loss", at=1, shard=2))
    assert tfired and tmon.shard_losses == 1 and tmon.mesh_reshards == 1
    _same_counters(jmon, tmon)
    assert_parity(jv, tv)
    assert_parity(_values(clean, battery(T)), tv)


def test_second_loss_walks_the_ladder_to_host_mode(table, clean, monkeypatch):
    monkeypatch.setenv(elastic.MESH_LADDER_ENV, "8,4")
    (jv, jmon, _), (tv, tmon, tfired) = lossy_runs(
        table, dict(site="sharded_fold", kind="mesh_loss", at=1, shard=7),
        dict(site="sharded_fold", kind="mesh_loss", at=2, shard=0))
    assert len(tfired) == 2 and tmon.shard_losses == 2 and tmon.mesh_reshards == 2
    assert "mesh:8->4" in tmon.degraded and "mesh:host" in tmon.degraded
    _same_counters(jmon, tmon)
    assert_parity(jv, tv)
    assert_parity(_values(clean, battery(T)), tv)


def test_shard_stall_recovers_like_a_loss(table, clean):
    assert issubclass(ShardStallError, ShardLossError)
    (jv, jmon, _), (tv, tmon, _) = lossy_runs(
        table, dict(site="sharded_fold", kind="shard_stall", at=2, shard=3))
    assert tmon.shard_losses == 1 and tmon.mesh_reshards == 1
    _same_counters(jmon, tmon)
    assert_parity(jv, tv)


def test_a_missed_heartbeat_reshards_before_the_fold(table):
    """A due heartbeat whose probe declares a shard dead takes the salvage
    path before the chunk folds: the chunk then folds on the rebuilt mesh,
    and the merge equals the fault-free fold."""
    from deequ_tpu_torch.parallel.dcn import host_partials, stack_partials

    tb = battery(T)
    partials = host_partials(tb, dq.Dataset.from_arrow(table.slice(0, 16 * BATCH)), BATCH)
    flags = np.ones(16, dtype=bool)
    want = TP.ElasticMeshFold(tb, TP.make_mesh(8, device="cpu"), heartbeat_s=3600.0)
    want.fold(stack_partials(tb, partials), flags, range(16))
    tmon = RunMonitor()
    got = TP.ElasticMeshFold(tb, TP.make_mesh(8, device="cpu"), monitor=tmon,
                             heartbeat_s=3600.0)
    got._gate._last -= 7200.0
    with TR.inject(TR.FaultSpec("shard_probe", "mesh_loss", at=4, shard=3)) as inj:
        got.fold(stack_partials(tb, partials), flags, range(16))
    assert inj.fired and got.mesh.size == 4 and not got.pending_replay
    assert tmon.shard_losses == 1 and "mesh:8->4" in tmon.degraded
    assert_parity(_values([a.compute_metric_from(st) for a, st in zip(tb, want.finish())], tb),
                  _values([a.compute_metric_from(st) for a, st in zip(tb, got.finish())], tb))


def test_replayed_batches_recontribute_dictionary_entries():
    """tests/test_elastic_mesh.py:505: the canary values live only in
    batches 20-23, shard 5's slice of the first chunk; losing shard 5 at
    the second fold replays them under a fresh memo token."""
    rows, batch = 24_000, 512
    values = [f"canary{i % 200}" if 20 <= i // batch <= 23 else f"base{i % 300}"
              for i in range(rows)]
    data = dq.Dataset.from_arrow(pa.table({"d": pa.array(values).dictionary_encode()}))
    a = T.ApproxCountDistinct("d")
    clean = AnalysisRunner.do_analysis_run(data, [a], batch_size=batch, placement="host",
                                           sharding=TP.make_mesh(8, device="cpu"))
    mon = RunMonitor()
    with TR.inject(TR.FaultSpec("sharded_fold", "mesh_loss", at=2, shard=5)) as inj:
        lossy = AnalysisRunner.do_analysis_run(data, [a], batch_size=batch, placement="host",
                                               sharding=TP.make_mesh(8, device="cpu"),
                                               monitor=mon)
    assert inj.fired and mon.shard_losses >= 1
    assert lossy.metric(a).value.get() == clean.metric(a).value.get()


# ---------------------------------------------------------------------------
# the health probe, the knobs, the elastic units
# ---------------------------------------------------------------------------


def test_probe_reports_an_injected_dead_shard():
    mesh = TP.make_mesh(4, device="cpu")
    assert TP.probe_shards(mesh) == []
    with TR.inject(TR.FaultSpec("shard_probe", "mesh_loss", at=3, shard=2)):
        assert TP.probe_shards(mesh) == [2]
    assert TP.probe_devices([CPU, CPU]) == []


def test_a_stalled_probe_declares_the_unconfirmed_shards():
    with TR.inject(TR.FaultSpec("shard_probe", "stall", at=2, delay_s=1.0)):
        assert TP.probe_shards(TP.make_mesh(3, device="cpu"), deadline_s=0.2) == [1, 2]


def test_heartbeat_gate_is_time_gated():
    gate = TP.HeartbeatGate(interval_s=3600.0)
    assert not gate.due()
    gate._last -= 7200.0
    assert gate.due()
    assert gate.check(TP.make_mesh(2, device="cpu")) == []
    assert not gate.due()


def test_disabled_heartbeat_is_never_due(monkeypatch):
    monkeypatch.setenv(health.HEARTBEAT_ENV, "0")
    assert health.shard_heartbeat_s() is None
    gate = health.HeartbeatGate()
    gate._last -= 7200.0
    assert not gate.due()


def test_mesh_ladder_parses_and_warns(monkeypatch, caplog):
    monkeypatch.setenv(elastic.MESH_LADDER_ENV, "4,2")
    assert elastic.mesh_ladder() == JP.elastic.mesh_ladder() == (4, 2)
    monkeypatch.setenv(elastic.MESH_LADDER_ENV, "eight,four")
    monkeypatch.setattr(elastic, "_ENV_WARNED", False)
    with caplog.at_level(logging.WARNING, logger=elastic.__name__):
        assert elastic.mesh_ladder() == elastic.DEFAULT_MESH_LADDER
    assert any("DEEQU_TPU_MESH_LADDER" in r.message for r in caplog.records)


def test_heartbeat_knob_warns_and_falls_back(monkeypatch, caplog):
    from deequ_tpu_torch import utils

    monkeypatch.setenv(health.HEARTBEAT_ENV, "5s")
    monkeypatch.setattr(utils, "_ENV_WARNED", set())
    with caplog.at_level(logging.WARNING, logger=utils.__name__):
        assert health.shard_heartbeat_s() == health.DEFAULT_HEARTBEAT_S
    assert any("DEEQU_TPU_SHARD_HEARTBEAT_S" in r.message for r in caplog.records)
    monkeypatch.setenv(health.HEARTBEAT_ENV, "2.5")
    assert health.shard_heartbeat_s() == JP.health.shard_heartbeat_s() == 2.5


def test_batch_quantum_is_the_references_and_ladder_independent():
    assert len({TP.mesh_batch_quantum(n) for n in (1, 2, 4, 8)}) == 1
    for n in (1, 2, 3, 4, 6, 8):
        assert TP.mesh_batch_quantum(n) == JP.mesh_batch_quantum(n)


def test_next_rung():
    for ladder, survivors in [((8, 4, 2, 1), 7), ((8, 4, 2, 1), 4), ((8, 4, 2, 1), 1),
                              ((8, 4), 3), ((8, 4, 2, 1), 0)]:
        assert TP.next_rung(ladder, survivors) == JP.next_rung(ladder, survivors)


def _shard_states(analyzers, n, seed=3):
    rng = np.random.default_rng(seed)
    out = []
    for d in range(n):
        data = dq.Dataset.from_dict({"x": rng.normal(d, 1, 10 * (d + 1) + 50)})
        out.append(tuple(ScanEngine(analyzers, CPU).run(data)))
    return out


def _stacked(per_shard):
    from deequ_tpu_torch.analyzers.base import stack_states

    return tuple(stack_states([s[i] for s in per_shard]) for i in range(len(per_shard[0])))


def test_salvage_drops_exactly_the_lost_shards():
    analyzers = [T.Size(), T.Mean("x")]
    per_shard = _shard_states(analyzers, 4)
    shard_states, salvaged = TP.salvage_stacked_states(analyzers, _stacked(per_shard), lost=[1])
    assert salvaged == [0, 2, 3]
    assert [int(s[0].num_matches) for s in shard_states] == \
        [int(per_shard[i][0].num_matches) for i in (0, 2, 3)]


def test_host_merge_equals_the_collective_merge():
    analyzers = [T.Size(), T.Mean("x"), T.StandardDeviation("x"), T.Sum("x")]
    per_shard = _shard_states(analyzers, 5)
    collective = TP.collective_merge_states(analyzers, TP.make_mesh(4, device="cpu"),
                                            _stacked(per_shard))
    salvage = TP.host_merge_states(analyzers, per_shard)
    for a, c, s in zip(analyzers, collective, salvage):
        assert a.compute_metric_from(s).value.get() == pytest.approx(
            a.compute_metric_from(c).value.get(), rel=1e-12)


def test_the_device_salvage_merge_equals_the_host_merge_bit_for_bit():
    import chip_smoke

    analyzers = [T.Size(), T.Mean("x"), T.StandardDeviation("x"), T.Sum("x"),
                 T.ApproxCountDistinct("x"), T.KLLSketch("x", T.KLLParameters(64, 0.64, 10))]
    per_shard = _shard_states(analyzers, 5)
    host = TP.host_merge_states(analyzers, per_shard)
    device = elastic.device_merge_states(analyzers, per_shard, CPU)
    for a, h, d in zip(analyzers, host, device):
        assert chip_smoke.same_state_bits(d, h), a
    empty = elastic.device_merge_states(analyzers, [], CPU)
    assert int(empty[0].num_matches) == 0


def test_a_loss_no_rung_fits_fails_a_mesh_on_one_card(caplog):
    """Every shard on one card and no rung left: the loss raises
    ``MeshExhaustedError`` and the fold stays off the host; a CPU mesh in
    the same place drops to host mode (the reference's behaviour)."""
    from deequ_tpu_torch.exceptions import MeshExhaustedError

    analyzers = [T.Size()]
    card = TP.ElasticMeshFold(analyzers, TP.make_mesh(8, device="cpu"), ladder=(8,),
                              heartbeat_s=3600.0)
    card.mesh = TP.Mesh([torch.device("cuda")] * 8)
    with caplog.at_level(logging.ERROR), pytest.raises(MeshExhaustedError, match="cuda"):
        card._recover(ShardLossError([5], "sharded_fold"))
    assert not card.host_mode and card.mesh.size == 8
    cpu = TP.ElasticMeshFold(analyzers, TP.make_mesh(8, device="cpu"), ladder=(8,),
                             heartbeat_s=3600.0)
    with caplog.at_level(logging.ERROR):
        cpu._recover(ShardLossError([5], "sharded_fold"))
    assert cpu.host_mode


def test_stack_canonical_round_trip():
    analyzers = [T.Size(), T.Sum("x")]
    per_shard = _shard_states(analyzers, 1)
    stacked = TP.stack_canonical_states(analyzers, per_shard[0], 4)
    shards, _ = TP.salvage_stacked_states(analyzers, stacked, lost=[])
    merged = TP.host_merge_states(analyzers, shards)
    assert int(merged[0].num_matches) == int(per_shard[0][0].num_matches)
    assert float(merged[1].total) == float(per_shard[0][1].total)


def test_shard_loss_listeners_hear_the_lost_devices(table):
    heard = []
    TP.add_shard_loss_listener(heard.append)
    try:
        with TR.inject(TR.FaultSpec("sharded_fold", "mesh_loss", at=1, shard=6)):
            AnalysisRunner.do_analysis_run(dq.Dataset.from_arrow(table), [T.Size()],
                                           batch_size=BATCH, placement="host",
                                           sharding=TP.make_mesh(8, device="cpu"))
    finally:
        TP.remove_shard_loss_listener(heard.append)
    assert heard == [[CPU]]


@pytest.mark.parametrize("big,small,batch", [(8, 4, BATCH), (4, 1, BATCH), (8, None, BATCH),
                                             (8, None, 500)])
def test_a_checkpoint_resumes_on_a_smaller_mesh_or_the_plain_host_tier(
        table, clean, big, small, batch):
    """Interrupted at the second chunk fold on a mesh of ``big`` shards, the
    run resumes on ``small`` shards (None: the plain host tier) from the
    checkpoint of the first chunk, in both packages; a batch size that is
    no multiple of the ladder's quantum rounds alike on both sides."""
    from deequ_tpu.analyzers.state_provider import InMemoryStateProvider as JMemory
    from deequ_tpu_torch.analyzers.state_provider import InMemoryStateProvider

    def resumed(pkg, runner, data, analyzers, make, memory, monitor_cls, kw):
        ckpt = pkg.IngestCheckpointer(memory(), every=8)
        with pkg.inject(pkg.FaultSpec("ingest_fold", "interrupt", at=2)):
            with pytest.raises(KeyboardInterrupt):
                runner.do_analysis_run(data, analyzers, batch_size=batch, sharding=make(big),
                                       placement="host", checkpointer=ckpt, **kw)
        assert ckpt.saves
        mon = monitor_cls()
        ctx = runner.do_analysis_run(data, analyzers, batch_size=batch,
                                     sharding=make(small) if small else None,
                                     placement="host", checkpointer=ckpt, monitor=mon, **kw)
        assert mon.resumed_at_batch == ckpt.saves[-1][0] > 0
        return [ctx.metric(a) for a in analyzers]

    jb, tb = battery(J), battery(T)
    jv = _values(resumed(JR, JaxRunner, JD.Dataset.from_arrow(table), jb, JP.make_mesh, JMemory,
                         JaxMonitor, {}), jb)
    tv = _values(resumed(TR, AnalysisRunner, dq.Dataset.from_arrow(table), tb,
                         lambda n: TP.make_mesh(n, device="cpu"), InMemoryStateProvider,
                         RunMonitor, {"device": "cpu"}), tb)
    assert_parity(jv, tv)
    assert_parity(_values(clean, tb), tv)
