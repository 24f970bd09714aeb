"""Session migration and host-loss recovery in the PyTorch/CUDA port
(``deequ_tpu_torch.cluster.worker`` and ``.front``) against the JAX
reference, in-process on the CPU: the cases of
``tests/test_cluster_migration.py`` run through both packages (``m`` is
either package, its services on the CPU); scripted membership changes give
both packages the same metrics and the same ``deequ_service_cluster_*``
counters; a partition flushed by one package's worker is adopted by the
other's; and ``HostLossError``, the worker's ``/statusz`` section and the
cluster knobs are the reference's.

Tolerances: across the packages and against an unmoved session, the
moments (Mean, StandardDeviation) agree within 1e-12 relative and
everything else exactly; the counters are equal.
"""

import math
import os
import time

import numpy as np
import pytest

from torch_pairs import pair, reference_isolated  # noqa: F401 (autouse)

pytestmark = pytest.mark.cluster

NAMES = {
    "ApproxCountDistinct": "analyzers:ApproxCountDistinct",
    "Check": "checks:Check",
    "CheckLevel": "checks:CheckLevel",
    "FaultSpec": "reliability.faults:FaultSpec",
    "FrontTier": "cluster:FrontTier",
    "HeartbeatMembership": "cluster:HeartbeatMembership",
    "HostLossError": "cluster:HostLossError",
    "LocalWorker": "cluster:LocalWorker",
    "SchemaDriftError": "exceptions:SchemaDriftError",
    "Sum": "analyzers:Sum",
    "VerificationService": "service:VerificationService",
    "classify_failure": "reliability.isolation:classify_failure",
    "cluster": "cluster",
    "config": "config",
    "exceptions": "exceptions",
    "faults": "reliability.faults",
    "inject": "reliability.faults:inject",
    "session_partition": "cluster:session_partition",
}
REF, PORT = pair(NAMES)

MOMENTS = ("Mean", "StandardDeviation")
COUNTERS = ("routes", "migrations", "host_losses", "ring_moves", "sessions_recovered",
            "replayed_folds", "journal_flushes")


@pytest.fixture(params=[REF, PORT], ids=["jax", "torch"])
def m(request):
    return request.param


def make_check(m):
    return m.Check(m.CheckLevel.ERROR, "mig").is_complete("id").has_size(lambda n: n > 0)


def batch(i, rows=16):
    base = i * rows
    return {
        "id": np.arange(base, base + rows, dtype=np.float64),
        "v": np.ones(rows, dtype=np.float64),
    }


def metric_map(result):
    return {
        (type(a).__name__, str(getattr(a, "column", "")), m.name): m.value
        for a, m in result.metrics.items()
    }


@pytest.fixture()
def store_root(tmp_path):
    return str(tmp_path / "store")


def make_worker(m, host_id, store_root, hb_root=None, ttl_s=5.0):
    service = m.VerificationService(workers=1, background_warm=False,
                                    partition_store=store_root, **m.svc)
    membership = None
    if hb_root is not None:
        membership = m.HeartbeatMembership(hb_root, host_id=host_id,
                                           heartbeat_period_s=0.1, ttl_s=ttl_s)
    return m.LocalWorker(host_id, service, membership=membership)


# ---------------------------------------------------------------------------
# the reference's cases (tests/test_cluster_migration.py), both packages
# ---------------------------------------------------------------------------

class TestContractMigration:
    def test_flush_writes_contract_beside_partition_states(self, m, store_root):
        """The flush that moves states into the partition store writes the
        checksummed schema contract beside them."""
        worker = make_worker(m, "w0", store_root)
        session = worker.open_session("t", "events", [make_check(m)])
        session.ingest(batch(0))
        name = worker.flush("t", "events")
        assert name == "session-t" == m.session_partition("t")
        provider = worker.service.partition_store.provider("events", name)
        assert os.path.exists(os.path.join(provider.path, "schema-contract.json"))
        worker.close()

    def test_migrated_session_enforces_original_contract(self, m, store_root):
        """A session adopted on a new host rejects a batch whose schema
        drifted from the ORIGINAL session's contract: the re-opened session
        loads the migrated contract instead of recapturing one from the
        drifted producer's first batch."""
        source = make_worker(m, "w0", store_root)
        source.open_session("t", "events", [make_check(m)])
        source.ingest("t", "events", batch(0))
        assert source.release("t", "events") == "session-t"
        source.close()

        target = make_worker(m, "w1", store_root)
        adopted = target.adopt_session("t", "events", [make_check(m)])
        assert adopted._contract is not None  # loaded, not recaptured
        drifted = {"id": np.arange(16, dtype=np.float64)}  # column "v" dropped
        with pytest.raises(m.SchemaDriftError):
            adopted.ingest(drifted)
        adopted.ingest(batch(1))
        assert adopted.batches_ingested == 1
        size = [mt for a, mt in adopted.current().metrics.items()
                if type(a).__name__ == "Size"][0]
        assert size.value.get() == 32.0  # 16 before the migration + 16 after
        target.close()


class TestFrontTierMigration:
    def test_graceful_migration_preserves_metrics(self, m, store_root):
        front = m.FrontTier()
        front.add_worker(make_worker(m, "w0", store_root))
        front.add_worker(make_worker(m, "w1", store_root))
        front.open_session("t", "events", [make_check(m)])
        for i in range(3):
            front.ingest("t", "events", batch(i))
        placed = front.placement("t", "events")
        other = [h for h in front.workers if h != placed][0]
        before = metric_map(front.workers[placed].service.get_session("t", "events").current())
        front.remove_worker(placed)  # the drain moves the session gracefully
        assert front.placement("t", "events") == other
        after = metric_map(front.workers[other].service.get_session("t", "events").current())
        assert after == before
        assert front.metrics.counter_value("deequ_service_cluster_migrations_total") >= 1
        front.close()

    def test_host_loss_recovers_by_salvage_plus_replay(self, m, store_root):
        """The last flush's states from the store plus the journaled folds
        replayed equal the lost session, fold for fold."""
        front = m.FrontTier()
        front.add_worker(make_worker(m, "w0", store_root))
        front.add_worker(make_worker(m, "w1", store_root))
        front.open_session("t", "events", [make_check(m)])
        for i in range(2):
            front.ingest("t", "events", batch(i))
        front.flush("t", "events")  # fold boundary: the journal clears
        for i in range(2, 5):
            front.ingest("t", "events", batch(i))  # journaled, unflushed

        victim = front.placement("t", "events")
        assert front.handle_host_loss(victim) == [("t", "events")]
        survivor = front.placement("t", "events")
        assert survivor != victim

        oracle = m.VerificationService(workers=1, background_warm=False, **m.svc)
        session = oracle.session("t", "oracle", [make_check(m)])
        for i in range(5):
            session.ingest(batch(i))
        want = metric_map(session.current())
        got = metric_map(front.workers[survivor].service.get_session("t", "events").current())
        assert got == want
        c = front.metrics.counter_value
        assert c("deequ_service_cluster_host_losses_total") == 1
        assert c("deequ_service_cluster_sessions_recovered_total") == 1
        assert c("deequ_service_cluster_replayed_folds_total") == 3
        oracle.close()
        front.close()

    def test_loss_with_no_survivors_raises_typed(self, m, store_root):
        front = m.FrontTier()
        front.add_worker(make_worker(m, "w0", store_root))
        front.open_session("t", "events", [make_check(m)])
        with pytest.raises(m.HostLossError):
            front.handle_host_loss("w0")

    def test_membership_sweep_drives_recovery(self, m, store_root, tmp_path):
        """A worker that stops beating is declared lost by the TTL scan and
        its sessions recover."""
        hb = str(tmp_path / "hb")
        front = m.FrontTier(membership=m.HeartbeatMembership(hb, ttl_s=0.4))
        w0 = make_worker(m, "w0", store_root, hb_root=hb, ttl_s=0.4)
        w1 = make_worker(m, "w1", store_root, hb_root=hb, ttl_s=0.4)
        front.add_worker(w0)
        front.add_worker(w1)
        front.open_session("t", "events", [make_check(m)])
        front.ingest("t", "events", batch(0))
        victim_id = front.placement("t", "events")
        victim = front.workers[victim_id]
        victim.membership.stop()  # the "crash": beats stop, the service lives
        time.sleep(0.8)  # let the TTL lapse
        assert front.check_membership() == [victim_id]
        assert front.placement("t", "events") != victim_id
        # the survivor replays the only (journaled, never flushed) fold
        assert front.metrics.counter_value("deequ_service_cluster_replayed_folds_total") == 1
        front.close()
        victim.service.close()


class TestJournalBound:
    def test_force_flush_bounds_replay_memory(self, m, store_root, monkeypatch):
        """At DEEQU_TPU_CLUSTER_JOURNAL_MAX_FOLDS the front tier
        force-flushes the session (AFTER the fold commits) and clears the
        journal."""
        monkeypatch.setenv("DEEQU_TPU_CLUSTER_JOURNAL_MAX_FOLDS", "2")
        front = m.FrontTier()
        for name in ("w0", "w1"):
            front.add_worker(make_worker(m, name, store_root))
        front.open_session("t", "events", [make_check(m)])
        for i in range(5):
            front.ingest("t", "events", batch(i))
        # folds 2 and 4 hit the bound and flushed; only fold 5 is journaled
        assert len(front._journal[("t", "events")]) == 1
        assert front.metrics.counter_value("deequ_service_cluster_journal_flushes_total") == 2
        victim = front.placement("t", "events")
        front.handle_host_loss(victim)
        survivor = front.workers[front.placement("t", "events")]
        session = survivor.service.get_session("t", "events")
        assert front.metrics.counter_value("deequ_service_cluster_replayed_folds_total") == 1
        sizes = [mt.value.get() for a, mt in session.current().metrics.items()
                 if type(a).__name__ == "Size"]
        assert sizes == [80.0]  # flushed states + replay = every fold
        front.close()

    def test_default_bound_via_config_reexport(self, m):
        assert m.config.CLUSTER_JOURNAL_MAX_FOLDS_ENV == "DEEQU_TPU_CLUSTER_JOURNAL_MAX_FOLDS"
        assert m.cluster.cluster_journal_max_folds() == m.cluster.DEFAULT_CLUSTER_JOURNAL_MAX_FOLDS


# ---------------------------------------------------------------------------
# one script of membership changes through both packages
# ---------------------------------------------------------------------------

SESSIONS = 6
BATCHES = 6


def battery_check(m):
    def yes(_):
        return True

    return (m.Check(m.CheckLevel.ERROR, "cluster battery")
            .is_complete("v").has_size(lambda n: n > 0)
            .has_mean("v", yes).has_standard_deviation("v", yes)
            .has_approx_count_distinct("v", yes))


def soak_batch(i, b, rows=64):
    """tools/cluster_soak.py's data: integer-valued float64s, unique per
    (session, batch)."""
    base = i * 100_000_000 + b * rows
    return {"v": np.arange(base, base + rows, dtype=np.float64)}


def key(i):
    return (f"tenant-{i % 4}", f"stream-{i}")


def values(result):
    return {str(a): mt.value.get() for a, mt in result.metrics.items()}


def same_values(got, want):
    """Exact, but the moments within 1e-12 relative."""
    if set(got) != set(want):
        return False
    for name, w in want.items():
        g = got[name]
        if name.startswith(MOMENTS):
            if not math.isclose(g, w, rel_tol=1e-12, abs_tol=0.0):
                return False
        elif g != w:
            return False
    return True


#: each script: the steps after two workers w0, w1 joined and the
#: sessions opened; ("ingest", b0, b1) streams batches [b0, b1) of every
#: session, one session after another
SCRIPTS = {
    "join": [("ingest", 0, 2), ("flush",), ("ingest", 2, 4), ("join", "w2"), ("ingest", 4, 6)],
    "drain": [("ingest", 0, 3), ("remove", "w0"), ("ingest", 3, 6)],
    "loss": [("ingest", 0, 2), ("flush",), ("ingest", 2, 5), ("lose", "w1"), ("ingest", 5, 6)],
    "sweep": [("ingest", 0, 3), ("lose", "w0"), ("ingest", 3, 6)],
    "journal bound": [("bound", 2), ("ingest", 0, 5), ("lose", "w0"), ("ingest", 5, 6)],
    "join, drain, loss": [("ingest", 0, 2), ("flush",), ("ingest", 2, 3), ("join", "w2"),
                          ("ingest", 3, 4), ("remove", "w0"), ("ingest", 4, 5), ("lose", "w2"),
                          ("ingest", 5, 6)],
}


def run_script(m, script, root, monkeypatch):
    """Drive ``script`` through ``m``'s front tier; a loss is declared by an
    injected ``host_loss`` fault at ``host_heartbeat`` and recovered by the
    membership sweep. Returns each session's metric values and the
    cluster counters."""
    store, hb = os.path.join(root, "store"), os.path.join(root, "hb")
    workers = {}

    def worker(h):
        workers[h] = make_worker(m, h, store, hb_root=hb, ttl_s=3600)
        return workers[h]

    for step in script:
        if step[0] == "bound":
            monkeypatch.setenv("DEEQU_TPU_CLUSTER_JOURNAL_MAX_FOLDS", str(step[1]))
    front = m.FrontTier(membership=m.HeartbeatMembership(hb, ttl_s=3600))
    try:
        front.add_worker(worker("w0"))
        front.add_worker(worker("w1"))
        for i in range(SESSIONS):
            front.open_session(*key(i), [battery_check(m)], required_analyzers=[m.Sum("v")])
        for step in script:
            if step[0] == "ingest":
                for i in range(SESSIONS):
                    for b in range(step[1], step[2]):
                        front.ingest(*key(i), soak_batch(i, b))
            elif step[0] == "flush":
                front.flush_all()
            elif step[0] == "join":
                front.add_worker(worker(step[1]))
            elif step[0] == "remove":
                front.remove_worker(step[1])
            elif step[0] == "lose":
                with m.inject(m.FaultSpec("host_heartbeat", "host_loss", match=step[1])):
                    assert front.check_membership() == [step[1]]
        got = [values(front.workers[front.placement(*key(i))].service
                      .get_session(*key(i)).current()) for i in range(SESSIONS)]
        counters = {c: front.metrics.counter_value(f"deequ_service_cluster_{c}_total")
                    for c in COUNTERS}
        placements = [front.placement(*key(i)) for i in range(SESSIONS)]
    finally:
        front.close()
        for w in workers.values():
            w.close()
    return got, counters, placements


def unmoved(m):
    """Each session streamed whole through one service."""
    with m.VerificationService(workers=1, background_warm=False, **m.svc) as svc:
        out = []
        for i in range(SESSIONS):
            session = svc.session(*key(i), [battery_check(m)], required_analyzers=[m.Sum("v")])
            for b in range(BATCHES):
                session.ingest(soak_batch(i, b))
            out.append(values(session.current()))
    return out


@pytest.mark.parametrize("name", [n for n in SCRIPTS if n != "join, drain, loss"])
def test_a_script_gives_the_references_metrics_and_counters(name, tmp_path, monkeypatch):
    ref = run_script(REF, SCRIPTS[name], str(tmp_path / "jax"), monkeypatch)
    port = run_script(PORT, SCRIPTS[name], str(tmp_path / "torch"), monkeypatch)
    assert port[1] == ref[1], "counters"
    assert port[2] == ref[2], "placements"
    want = unmoved(PORT)
    for i in range(SESSIONS):
        assert same_values(port[0][i], ref[0][i]), (i, port[0][i], ref[0][i])
        assert same_values(port[0][i], want[i]), (i, port[0][i], want[i])
    assert port[1]["routes"] == SESSIONS * (1 + BATCHES)
    if name != "drain":
        assert port[1]["host_losses"] + port[1]["migrations"] >= 1


def test_a_loss_after_an_adoption_replays_onto_the_last_flush(tmp_path, monkeypatch):
    """Sessions that moved (a join, a drain) and were then lost before their
    next flush. The port's adopted sessions keep their folds apart from the
    flushed partition (``cluster.worker.AdoptedStates``), so the recovery
    replays the journal onto the last flush and every session equals its
    unmoved run. The reference's adopted sessions persist each fold into the
    partition's directory, so its replay adds folds the partition already
    holds (ROADMAP C): its counters are the port's, its Size is larger."""
    script = SCRIPTS["join, drain, loss"]
    ref = run_script(REF, script, str(tmp_path / "jax"), monkeypatch)
    port = run_script(PORT, script, str(tmp_path / "torch"), monkeypatch)
    assert port[1] == ref[1] and port[2] == ref[2]
    assert port[1]["replayed_folds"] >= 1
    want = unmoved(PORT)
    for i in range(SESSIONS):
        assert same_values(port[0][i], want[i]), (i, port[0][i], want[i])
    size = "Size(where=None, name='Size')"
    rows = BATCHES * 64
    assert [r[size] for r in port[0]] == [rows] * SESSIONS
    assert any(r[size] > rows for r in ref[0])


# ---------------------------------------------------------------------------
# partitions cross between the packages
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("source,target", [(REF, PORT), (PORT, REF)], ids=["jax->torch", "torch->jax"])
def test_a_flushed_partition_is_adopted_by_the_other_package(source, target, store_root):
    """A worker of one package releases a session (its states and contract
    flushed into the shared store); a worker of the other adopts it and
    streams on. The result equals one unmoved session of the target."""
    def check(ns):
        return [battery_check(ns)]

    w0 = make_worker(source, "w0", store_root)
    w0.open_session("t", "events", check(source), required_analyzers=[source.Sum("v")])
    for b in range(3):
        w0.ingest("t", "events", soak_batch(0, b))
    assert w0.release("t", "events") == "session-t"
    w0.close()
    w1 = make_worker(target, "w1", store_root)
    adopted = w1.adopt_session("t", "events", check(target),
                               required_analyzers=[target.Sum("v")])
    assert adopted._contract is not None and adopted.rows_ingested == 3 * 64
    for b in range(3, BATCHES):
        w1.ingest("t", "events", soak_batch(0, b))
    got = values(adopted.current())
    assert w1.session_stats("t", "events") == {
        "host": "w1", "batches": 3, "rows": BATCHES * 64,
        "bytes": adopted.bytes_ingested}
    w1.close()
    with target.VerificationService(workers=1, background_warm=False, **target.svc) as svc:
        session = svc.session("t", "x", check(target), required_analyzers=[target.Sum("v")])
        for b in range(BATCHES):
            session.ingest(soak_batch(0, b))
        want = values(session.current())
    assert same_values(got, want), (got, want)


# ---------------------------------------------------------------------------
# the typed loss, the worker's /statusz section, the knobs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("args", [
    ("w1", "cluster_front", "no surviving workers to recover onto"),
    ("w7", "host_heartbeat", ""), ("", "", ""), ("w/2", "", "missed beats"),
])
def test_host_loss_error_is_the_references(args):
    got, want = PORT.HostLossError(*args), REF.HostLossError(*args)
    assert type(got).__name__ == type(want).__name__ == "HostLossError"
    assert str(got) == str(want)
    assert (got.host, got.lost, got.site) == (want.host, want.lost, want.site)
    assert isinstance(got, PORT.exceptions.ShardLossError)
    assert PORT.exceptions.HostLossError is PORT.HostLossError
    assert REF.exceptions.HostLossError is REF.HostLossError
    assert PORT.classify_failure(got) == REF.classify_failure(want) == "mesh"


def test_an_injected_host_loss_is_the_references():
    got = PORT.faults._make_error("host_loss", "host_heartbeat", "w3")
    want = REF.faults._make_error("host_loss", "host_heartbeat", "w3")
    assert type(got).__name__ == type(want).__name__ and str(got) == str(want)
    assert {"host_heartbeat", "ring_rebalance"} <= set(PORT.faults.KNOWN_FAULT_SITES)
    assert PORT.faults.FAULT_KINDS == REF.faults.FAULT_KINDS


def test_the_workers_statusz_section_is_the_references(tmp_path):
    sections = {}
    for ns in (REF, PORT):
        root = str(tmp_path / ns.name)
        svc = ns.VerificationService(workers=1, background_warm=False, **ns.svc)
        assert svc.statusz.snapshot()["planes"]["cluster"] == {"attached": False}
        membership = ns.HeartbeatMembership(os.path.join(root, "hb"), ttl_s=30.0)
        worker = ns.LocalWorker("w0", svc, membership=membership)
        ns.HeartbeatMembership(os.path.join(root, "hb"), host_id="w9").beat()
        worker.start()
        for i in (2, 0, 1):
            worker.open_session(*key(i), [battery_check(ns)])
        worker.open_session("t", "closed", [battery_check(ns)])
        svc.get_session("t", "closed").close()
        sections[ns.name] = svc.statusz.snapshot()["planes"]["cluster"]
        worker.close()
    assert sections["torch"] == sections["jax"] == {
        "attached": True, "host": "w0", "members": ["w0", "w9"],
        "sessions": ["tenant-0/stream-0", "tenant-1/stream-1", "tenant-2/stream-2"]}


@pytest.mark.parametrize("name", [
    "CLUSTER_VNODES_ENV", "CLUSTER_HEARTBEAT_ENV", "CLUSTER_HOST_TTL_ENV",
    "CLUSTER_LEASE_TTL_ENV", "CLUSTER_JOURNAL_MAX_FOLDS_ENV",
])
def test_the_cluster_knobs_are_the_references(name, monkeypatch):
    assert getattr(PORT.config, name) == getattr(REF.config, name)
    env = getattr(PORT.config, name)
    monkeypatch.setenv(env, "7")
    port = {"CLUSTER_VNODES_ENV": PORT.cluster.ring_vnodes,
            "CLUSTER_HEARTBEAT_ENV": PORT.cluster.heartbeat_s,
            "CLUSTER_HOST_TTL_ENV": PORT.cluster.host_ttl_s,
            "CLUSTER_JOURNAL_MAX_FOLDS_ENV": PORT.cluster.cluster_journal_max_folds}
    if name in port:
        assert port[name]() == 7
    else:
        from deequ_tpu_torch.repository.lease import lease_ttl_s

        assert lease_ttl_s() == 7.0
