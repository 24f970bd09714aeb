"""The fleet scheduler and the service's mesh route in the PyTorch/CUDA
port (``deequ_tpu_torch.service.fleet``, the scheduler's leases, the
coalescer's mesh fold) against the JAX reference: the cases of
``tests/test_fleet.py`` run through both packages on the same script and
seed (``m`` is either package).

The reference shards over the conftest's 8 virtual CPU devices with
``fleet=True``; the port over ``fleet_devices=8``, 8 shards of the CPU
device (``device="cpu"``), its form of those virtual devices. The packing
is pure Python: both packages' ``snapshot()``s are equal after every
script. Metrics use an exact battery (integer-valued sums, counts,
minimum, maximum), so they are equal bit for bit at any shard split, in
both packages. ``mesh_substrate`` differs by design: the port counts
distinct devices, never logical shards, so 8 shards of one device are one
chip where the reference counts its 8 virtual devices.
"""

from __future__ import annotations

import time

import numpy as np
import pytest

from torch_pairs import pair, reference_isolated  # noqa: F401 (autouse)

pytestmark = pytest.mark.fleet

NAMES = {
    "Check": "checks:Check",
    "CheckLevel": "checks:CheckLevel",
    "CheckStatus": "checks:CheckStatus",
    "Completeness": "analyzers:Completeness",
    "Dataset": "data:Dataset",
    "FaultSpec": "reliability:FaultSpec",
    "FleetScheduler": "service.fleet:FleetScheduler",
    "PartitionStateStore": "repository:PartitionStateStore",
    "PlacementRouter": "service:PlacementRouter",
    "Size": "analyzers:Size",
    "VerificationService": "service:VerificationService",
    "VerificationSuite": "verification:VerificationSuite",
    "fleet": "service.fleet",
    "inject": "reliability:inject",
    "make_mesh": "parallel:make_mesh",
    "mesh_substrate": "service:mesh_substrate",
    "shape_qualified_signature": "service:shape_qualified_signature",
}
REF, PORT = pair(NAMES)
#: the service keywords that put each package's fleet over 8 shards
REF.fleet_svc = {"fleet": True}
PORT.fleet_svc = {"fleet": True, "device": "cpu", "fleet_devices": 8}
#: the keywords of a service without a fleet
REF.single_svc = {"fleet": False}
PORT.single_svc = {"device": "cpu", "fleet": False}

WAIT_S = 120


@pytest.fixture(params=[REF, PORT], ids=["jax", "torch"])
def m(request):
    return request.param


def exact_checks(m):
    """A battery whose merges are exact at any shard split."""
    return [
        m.Check(m.CheckLevel.ERROR, "fleet parity")
        .has_size(lambda n: n > 0)
        .is_complete("x")
        .has_min("x", lambda v: v >= 0)
        .has_max("x", lambda v: v < 1000)
        .has_sum("x", lambda s: s > 0),
    ]


def exact_data(m, rows: int = 100_000, seed: int = 0):
    rng = np.random.default_rng(seed)
    return m.Dataset.from_dict({"x": rng.integers(0, 1000, rows).astype(np.float64)})


def stream_table(seed: int, rows: int = 8192):
    import pyarrow as pa

    r = np.random.default_rng(seed)
    return pa.table({"x": r.integers(0, 1000, rows).astype(np.float64)})


def values(result):
    return {repr(a): m.value.get() for a, m in result.metrics.items() if m.value.is_success}


class _Dev:
    """A stand-in device for the packing scripts (both packages take any
    object in their table)."""

    def __init__(self, i):
        self.id = i
        self.device_kind = "fake"


def fake_fleet(m, n: int = 8):
    return m.FleetScheduler(devices=[_Dev(i) for i in range(n)])


# ---------------------------------------------------------------------------
# packing: every script through both packages, the snapshots equal
# ---------------------------------------------------------------------------

def _script_halves(fleet):
    fleet.acquire("a")
    fleet.acquire("b")
    a, b = fleet.devices_of("a"), fleet.devices_of("b")
    assert len(a) == len(b) == 4 and not set(a) & set(b)
    return [a, b]


def _script_pairs(fleet):
    for t in "abcd":
        fleet.acquire(t)
    slices = [set(fleet.devices_of(t)) for t in "abcd"]
    assert all(len(s) == 2 for s in slices)
    assert all(not slices[i] & slices[j] for i in range(4) for j in range(i + 1, 4))
    return [fleet.devices_of(t) for t in "abcd"]


def _script_sticky(fleet):
    fleet.acquire("a")
    gen = fleet.snapshot()["generation"]
    fleet.release("a")
    assert fleet.snapshot()["generation"] == gen
    kept = fleet.devices_of("a")
    assert kept
    evicted = fleet.evict_idle()
    assert evicted == 1 and not fleet.devices_of("a")
    return [gen, kept, evicted]


def _script_repacks_counter(fleet):
    fleet.acquire("a")
    fleet.acquire("b")
    fleet.mark_unhealthy([7])
    counted = fleet.metrics.counter_value("deequ_service_fleet_repacks_total")
    assert counted == float(fleet.snapshot()["repacks"]) == 3.0
    return [counted]


def _script_idle_reclaimed(fleet):
    for t in "abcd":
        fleet.acquire(t)
    for t in "abcd":
        fleet.release(t)
    for t in "abc":
        fleet._last_seen[t] = time.monotonic() - fleet.IDLE_TTL_S - 1
    before = fleet.devices_of("d")
    assert len(before) == 2
    fleet.acquire("e")
    assert set(fleet.snapshot()["tenants"]) == {"d", "e"}
    assert len(fleet.devices_of("d")) == len(fleet.devices_of("e")) == 4
    return [before, fleet.devices_of("d"), fleet.devices_of("e")]


def _script_loss(fleet):
    fleet.acquire("a")
    fleet.acquire("b")
    fleet.mark_unhealthy([5])
    snap = fleet.snapshot()
    assert 5 not in snap["healthy"]
    assert all(5 not in p for p in snap["assignment"].values())
    a, b = fleet.devices_of("a"), fleet.devices_of("b")
    assert a and b and not set(a) & set(b)
    return [fleet.metrics.counter_value("deequ_service_fleet_shard_losses_total")]


def _script_peek(fleet):
    fleet.acquire("a")
    out = []
    for t in ("b", "c", "d"):
        predicted = fleet.peek(t)
        granted = fleet.acquire(t)
        assert predicted.positions == granted.positions, t
        out.append((predicted.positions, granted.n_dev, granted.generation))
    return out


def _script_wrap(fleet):
    for i in range(5):
        fleet.acquire(f"t{i}")
    assert all(fleet.devices_of(f"t{i}") for i in range(5))
    return [fleet.devices_of(f"t{i}") for i in range(5)]


PACKING_SCRIPTS = {
    "halves": (8, _script_halves),
    "pairs": (8, _script_pairs),
    "sticky release": (8, _script_sticky),
    "repacks counter": (8, _script_repacks_counter),
    "idle reclaimed": (8, _script_idle_reclaimed),
    "loss": (8, _script_loss),
    "peek is acquire": (8, _script_peek),
    "wrap": (2, _script_wrap),
}


@pytest.mark.parametrize("script", list(PACKING_SCRIPTS))
def test_packing_script_snapshots_equal_the_references(script):
    n, run = PACKING_SCRIPTS[script]
    seen = {}
    for ns in (REF, PORT):
        fleet = fake_fleet(ns, n)
        try:
            observed = run(fleet)
            seen[ns.name] = (observed, fleet.snapshot(), fleet.repacks)
        finally:
            fleet.close()
    assert seen["torch"] == seen["jax"]


def test_slice_sizes_are_the_references():
    grid = [(h, t) for h in range(0, 17) for t in range(0, 10)]
    assert ([PORT.FleetScheduler._slice_size(h, t) for h, t in grid]
            == [REF.FleetScheduler._slice_size(h, t) for h, t in grid])
    size = PORT.FleetScheduler._slice_size
    assert (size(8, 1), size(8, 2), size(8, 3), size(8, 5), size(7, 2), size(0, 1)) == (
        8, 4, 2, 1, 2, 0)


# ---------------------------------------------------------------------------
# mesh-qualified warmth keys
# ---------------------------------------------------------------------------

@pytest.fixture
def cold_programs(monkeypatch):
    """The port's program caches empty, so no earlier test's sharded launch
    makes a battery warm here."""
    from deequ_tpu_torch.runners import engine
    from deequ_tpu_torch.utils import BoundedLRU

    monkeypatch.setattr(engine, "_PROGRAM_CACHE", BoundedLRU(256))
    monkeypatch.setattr(engine, "_WARM_BATTERIES", BoundedLRU(256))
    return engine


def test_signature_carries_mesh_shape(m):
    battery = [m.Size(), m.Completeness("x")]
    sig = m.shape_qualified_signature
    plain = sig(battery, 4096)
    at8, at4 = sig(battery, 4096, 8), sig(battery, 4096, 4)
    assert plain != at8 != at4
    assert ("__mesh__", 8) in at8 and ("__mesh__", 4) in at4
    assert sig(battery, 4096, 1) == plain and sig(battery, 4096, None) == plain
    assert sig(battery, 4096, m.make_mesh(4, **m.dev)) == at4


def test_submesh_misses_on_full_mesh_warmth(m, cold_programs):
    battery = [m.Size(), m.Completeness("x")]
    router = m.PlacementRouter(background_warm=False)
    try:
        sig8 = m.shape_qualified_signature(battery, 4096, 8)
        sig4 = m.shape_qualified_signature(battery, 4096, 4)
        router.note_ran(sig8, worker_id=0, placement="device")
        assert router.is_warm(sig8)
        assert not router.is_warm(sig4)
        assert router.decide(sig4) == "host"
    finally:
        router.close()


def test_lease_qualifies_like_its_device_count(m):
    fleet = m.FleetScheduler(devices=list(range(8)))
    try:
        lease = fleet.acquire("a")
        assert ("__mesh__", lease.n_dev) in m.shape_qualified_signature([m.Size()], 1024, lease)
    finally:
        fleet.close()


def test_only_the_sharded_path_of_that_width_warms_a_mesh_signature(cold_programs):
    """The port's warmth is "launched in this process": a mesh signature
    reads warm only once the sharded path of its width launched (K1's and
    K2's stacked entries and K8), never from a launch of the one-device
    program or of another width."""
    from deequ_tpu_torch.runners.engine import warm_fused_program

    battery = [PORT.Size(), PORT.Completeness("x")]
    router = PORT.PlacementRouter(background_warm=False, device="cpu")
    data = exact_data(PORT, rows=64)
    sig1, sig4, sig8 = (PORT.shape_qualified_signature(battery, 1024, n) for n in (1, 4, 8))
    try:
        assert not any(router.is_warm(s) for s in (sig1, sig4, sig8))
        warm_fused_program(battery, data, batch_size=1024, device="cpu")
        assert router.is_warm(sig1) and not router.is_warm(sig8) and not router.is_warm(sig4)
        warm_fused_program(battery, data, batch_size=1024, device="cpu",
                           mesh=PORT.make_mesh(8, device="cpu"))
        assert router.is_warm(sig8) and not router.is_warm(sig4)
    finally:
        router.close()


# ---------------------------------------------------------------------------
# sub-mesh parity, the escape hatch, stream folds, the mid-stream loss
# ---------------------------------------------------------------------------

def _batch_jobs(m, checks, data_a, data_b):
    def run_alone(data):
        with m.VerificationService(workers=2, background_warm=False, **m.fleet_svc) as svc:
            assert svc.fleet.peek("solo").n_dev == 8  # alone -> every shard
            return values(svc.verify(data, checks, tenant="solo", timeout=WAIT_S))

    alone = (run_alone(data_a), run_alone(data_b))
    with m.VerificationService(workers=4, background_warm=False, **m.fleet_svc) as svc:
        ha = svc.submit_verification(data_a, checks, tenant="a")
        hb = svc.submit_verification(data_b, checks, tenant="b")
        ra, rb = ha.result(WAIT_S), hb.result(WAIT_S)
        positions = (svc.fleet.devices_of("a"), svc.fleet.devices_of("b"))
    return alone, (values(ra), values(rb)), positions


def test_batch_jobs_on_disjoint_submeshes_bit_exact():
    seen = {}
    for ns in (REF, PORT):
        checks = exact_checks(ns)
        alone, packed, (pos_a, pos_b) = _batch_jobs(
            ns, checks, exact_data(ns, seed=1), exact_data(ns, seed=2))
        assert len(pos_a) == len(pos_b) == 4 and not set(pos_a) & set(pos_b)
        assert packed == alone
        seen[ns.name] = (packed, pos_a, pos_b)
    assert seen["torch"] == seen["jax"]


def test_single_chip_escape_hatch_bit_exact(monkeypatch):
    seen = {}
    for ns in (REF, PORT):
        checks = exact_checks(ns)
        data = exact_data(ns, seed=3)
        monkeypatch.delenv("DEEQU_TPU_FLEET", raising=False)
        with ns.VerificationService(workers=2, background_warm=False, **ns.fleet_svc) as svc:
            sharded = values(svc.verify(data, checks, tenant="a", timeout=WAIT_S))
        monkeypatch.setenv("DEEQU_TPU_FLEET", "0")
        kw = {k: v for k, v in ns.fleet_svc.items() if k != "fleet"}
        with ns.VerificationService(workers=2, background_warm=False, **kw) as svc:
            assert svc.fleet is None
            single = values(svc.verify(data, checks, tenant="a", timeout=WAIT_S))
        assert sharded == single
        seen[ns.name] = single
    assert seen["torch"] == seen["jax"]


def _stream(m, fleet: bool, batches: int = 3):
    svc_kw = m.fleet_svc if fleet else m.single_svc
    with m.VerificationService(workers=2, background_warm=False, **svc_kw) as svc:
        session = svc.session("t-a", "stream", exact_checks(m))
        for b in range(batches):
            session.ingest(stream_table(b))
        folds = svc.metrics.counter_value("deequ_service_fleet_stream_folds_total")
        return values(session.current()), folds


def test_mesh_stream_folds_bit_exact_vs_single_chip(monkeypatch):
    monkeypatch.setenv("DEEQU_TPU_FLEET_STREAM_MIN_ROWS", "0")
    seen = {}
    for ns in (REF, PORT):
        fleet_metrics, fleet_folds = _stream(ns, fleet=True)
        single_metrics, single_folds = _stream(ns, fleet=False)
        assert fleet_folds == 3.0 and not single_folds
        assert fleet_metrics == single_metrics
        seen[ns.name] = fleet_metrics
    assert seen["torch"] == seen["jax"]


def test_shard_loss_mid_stream_recovers_and_repacks(monkeypatch):
    monkeypatch.setenv("DEEQU_TPU_FLEET_STREAM_MIN_ROWS", "0")
    seen = {}
    for ns in (REF, PORT):
        with ns.VerificationService(workers=2, background_warm=False, **ns.fleet_svc) as svc:
            session = svc.session("t-a", "stream", exact_checks(ns))
            session.ingest(stream_table(0))
            with ns.inject(ns.FaultSpec("sharded_fold", "mesh_loss", at=1, shard=2)) as inj:
                session.ingest(stream_table(1))
            assert inj.fired
            session.ingest(stream_table(2))
            snap = svc.fleet.snapshot()
            cum = values(session.current())
            losses = svc.metrics.counter_value("deequ_service_fleet_shard_losses_total")
        assert session.batches_ingested == 3
        assert len(snap["healthy"]) < 8
        single, _ = _stream(ns, fleet=False)
        assert cum == single
        seen[ns.name] = (snap["healthy"], snap["assignment"], losses, cum)
    assert seen["torch"] == seen["jax"]


def test_shards_of_one_device_lose_one_position(cold_programs):
    """On a table of 8 shards of ONE device every entry is the same device:
    losing position 2 of tenant b's 4-shard lease drops exactly the table
    position that lease maps it to, never every position of the device."""
    checks = exact_checks(PORT)
    with PORT.VerificationService(workers=2, background_warm=False, **PORT.fleet_svc) as svc:
        assert len(set(svc.fleet._devices)) == 1
        for tenant in ("a", "b"):
            svc.fleet.acquire(tenant)
            svc.fleet.release(tenant)
        lease_b = svc.fleet.devices_of("b")
        with PORT.inject(PORT.FaultSpec("sharded_fold", "mesh_loss", at=1, shard=2)) as inj:
            # a cold battery runs on the host tier's elastic fold
            result = svc.verify(exact_data(PORT, seed=4), checks, tenant="b", timeout=WAIT_S)
        assert inj.fired
        snap = svc.fleet.snapshot()
        assert snap["healthy"] == [p for p in range(8) if p != lease_b[2]]
        assert svc.metrics.counter_value("deequ_service_fleet_shard_losses_total") == 1.0
        assert set(svc.fleet.devices_of("a")) | set(svc.fleet.devices_of("b")) <= set(
            snap["healthy"])
        later = svc.verify(exact_data(PORT, seed=4), checks, tenant="a", timeout=WAIT_S)
    with PORT.VerificationService(workers=2, background_warm=False, **PORT.single_svc) as svc:
        want = values(svc.verify(exact_data(PORT, seed=4), checks, tenant="b", timeout=WAIT_S))
    assert values(result) == values(later) == want


def test_a_loss_on_a_mesh_of_another_owner_names_no_shared_device():
    """A loss on a mesh that is not this fleet's names devices only; a
    device the table holds once names its position (the reference's rule
    on distinct devices), a device shared by several shards names none."""
    from deequ_tpu_torch.parallel.elastic import LostShards

    fleet = PORT.FleetScheduler(devices=["cpu"] * 4)
    try:
        fleet._on_elastic_loss(LostShards(["cpu"]))
        assert fleet.snapshot()["healthy"] == [0, 1, 2, 3]
        other = PORT.FleetScheduler(devices=[_Dev(0), _Dev(1)])
        fleet._on_elastic_loss(LostShards(["cpu"], [1], other._token))
        assert fleet.snapshot()["healthy"] == [0, 1, 2, 3]
        fleet._on_elastic_loss(LostShards(["cpu"], [1], fleet._token))
        assert fleet.snapshot()["healthy"] == [0, 2, 3]
        other.close()
        distinct = PORT.FleetScheduler(devices=[_Dev(0), _Dev(1)])
        distinct._on_elastic_loss(LostShards([distinct._devices[1]]))
        assert distinct.snapshot()["healthy"] == [0]
        distinct.close()
    finally:
        fleet.close()


def test_note_shard_loss_probes_each_position_once():
    """The post-job backstop probes each healthy position once and drops
    only the position an injected ``shard_probe`` fault names."""
    fleet = PORT.FleetScheduler(devices=PORT.make_mesh(8, device="cpu").devices)
    try:
        fleet.acquire("a")
        with PORT.inject(PORT.FaultSpec("shard_probe", "mesh_loss", at=1, shard=3)):
            fleet.note_shard_loss()
        assert fleet.snapshot()["healthy"] == [0, 1, 2, 4, 5, 6, 7]
        fleet.note_shard_loss()
        assert len(fleet.snapshot()["healthy"]) == 7
    finally:
        fleet.close()


# ---------------------------------------------------------------------------
# defaults, an explicit mesh, the substrate, partition scans under the fleet
# ---------------------------------------------------------------------------

def test_cpu_backend_defaults_off(monkeypatch):
    monkeypatch.delenv("DEEQU_TPU_FLEET", raising=False)
    eight = PORT.make_mesh(8, device="cpu").devices
    assert not REF.fleet.fleet_enabled()
    assert not PORT.fleet.fleet_enabled() and not PORT.fleet.fleet_enabled(eight)
    monkeypatch.setenv("DEEQU_TPU_FLEET", "1")
    assert REF.fleet.fleet_enabled() and PORT.fleet.fleet_enabled(eight)
    assert not PORT.fleet.fleet_enabled(eight[:1])  # one shard: nothing to pack
    monkeypatch.setenv("DEEQU_TPU_FLEET", "0")
    assert not REF.fleet.fleet_enabled() and not PORT.fleet.fleet_enabled(eight)
    with PORT.VerificationService(workers=1, background_warm=False, device="cpu",
                                  fleet_devices=8) as svc:
        assert svc.fleet is None
    monkeypatch.setenv("DEEQU_TPU_FLEET", "1")
    with PORT.VerificationService(workers=1, background_warm=False, device="cpu",
                                  fleet_devices=8) as svc:
        assert svc.fleet is not None and svc.fleet.snapshot()["healthy"] == list(range(8))


def test_explicit_mesh_disables_fleet(m):
    with m.VerificationService(workers=1, background_warm=False, fleet=True,
                               mesh=m.make_mesh(2, **m.dev), **m.dev) as svc:
        assert svc.fleet is None


def test_explicit_mesh_runs_jobs_and_sessions_over_it():
    """``mesh=`` shards every job over that mesh and turns coalescing off:
    a session's folds take the serial path (no coalesced width), and both
    equal the one-device runs."""
    checks = exact_checks(PORT)
    data = exact_data(PORT, seed=5)
    with PORT.VerificationService(workers=2, background_warm=False, device="cpu",
                                  mesh=PORT.make_mesh(8, device="cpu")) as svc:
        got = values(svc.verify(data, checks, tenant="a", timeout=WAIT_S))
        session = svc.session("t", "s", exact_checks(PORT))
        for b in range(3):
            session.ingest(stream_table(b))
        cum = values(session.current())
        assert not svc.metrics.counter_value("deequ_service_coalesce_width_total")
    with PORT.VerificationService(workers=2, background_warm=False, device="cpu") as svc:
        assert got == values(svc.verify(data, checks, tenant="a", timeout=WAIT_S))
    single, _ = _stream(PORT, fleet=False)
    assert cum == single


def test_mesh_substrate_names_the_substrate():
    ref = REF.mesh_substrate()
    assert (ref["substrate"], ref["backend"], ref["chip_count"]) == ("cpu-virtual", "cpu", 8)
    port = PORT.mesh_substrate(PORT.make_mesh(8, device="cpu").devices)
    assert set(port) == set(ref)
    assert (port["substrate"], port["backend"]) == (ref["substrate"], ref["backend"])
    # 8 shards of one device are one chip
    assert port["chip_count"] == 1
    assert PORT.mesh_substrate()["substrate"] == "cpu-virtual"


def _parts(m, seeds=(71, 72), rows: int = 2048):
    out = {}
    for name, seed in zip(("p1", "p2"), seeds):
        rng = np.random.default_rng(seed)
        out[name] = m.Dataset.from_dict({
            "id": np.arange(rows, dtype=np.int64) + seed * 1_000_000,
            "v": rng.normal(10.0, 2.0, rows),
            "cat": np.array(["a", "b", "c", "d"])[rng.integers(0, 4, rows)],
        })
    return out


def test_fleet_submits_partition_scans_on_sub_mesh(tmp_path):
    """Fresh-partition scans ride the tenant's fleet sub-mesh with metrics
    equal to the one-device run (``tests/test_incremental.py``'s case)."""
    seen = {}
    for ns in (REF, PORT):
        checks = [ns.Check(ns.CheckLevel.ERROR, "fleet").has_size(lambda n: n > 0)
                  .is_complete("v")]
        store = ns.PartitionStateStore(str(tmp_path / ns.name / "fleet"))
        with ns.VerificationService(workers=2, background_warm=False, partition_store=store,
                                    **ns.fleet_svc) as svc:
            r = svc.verify_partitioned("tbl", _parts(ns), checks, tenant="ten", timeout=WAIT_S)
            assert r.status == ns.CheckStatus.SUCCESS
            assert svc.metrics.counter_value("deequ_service_fleet_leases_total") >= 1
        ref = ns.VerificationSuite.verify_partitioned(
            ns.PartitionStateStore(str(tmp_path / ns.name / "ref")), "tbl", _parts(ns), checks,
            **ns.dev)
        assert r.metrics[ns.Size()].value.get() == ref.metrics[ns.Size()].value.get() == 4096.0
        seen[ns.name] = values(r)
    assert seen["torch"] == seen["jax"]
