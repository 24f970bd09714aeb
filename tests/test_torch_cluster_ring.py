"""The cluster tier's routing and liveness primitives in the PyTorch/CUDA
port (``deequ_tpu_torch.cluster.ring`` and ``.membership``) against the
JAX reference: the port's ring hashes and routes every key as the
reference's does (so a front tier of either package sends a session to
the same host), moves the same keys on membership changes, and the cases
of ``tests/test_cluster_ring.py`` run through both packages (``m`` is
either package).

Tolerance: none. Hashes, routes and moved-key lists are equal exactly.
"""

import time

import pytest

from torch_pairs import pair, reference_isolated  # noqa: F401 (autouse)

pytestmark = pytest.mark.cluster

NAMES = {
    "FaultSpec": "reliability.faults:FaultSpec",
    "HashRing": "cluster:HashRing",
    "HeartbeatMembership": "cluster:HeartbeatMembership",
    "HostLossError": "cluster:HostLossError",
    "inject": "reliability.faults:inject",
    "ring_vnodes": "cluster:ring_vnodes",
    "stable_hash": "cluster.ring:stable_hash",
}
REF, PORT = pair(NAMES)

#: 10,000 session keys of the front tier's shape ``tenant/dataset``, with
#: a few of other shapes (empty, non-ASCII, a host-point look-alike)
PARITY_KEYS = [f"tenant-{i % 97}/stream-{i}" for i in range(9_996)] + [
    "", "/", "tenant-ü/datensätze", "w0#3",
]
KEYS = [f"tenant-{i % 7}/stream-{i}" for i in range(400)]


@pytest.fixture(params=[REF, PORT], ids=["jax", "torch"])
def m(request):
    return request.param


# ---------------------------------------------------------------------------
# the port routes as the reference routes
# ---------------------------------------------------------------------------

def test_stable_hash_is_the_references_for_every_key():
    assert len(PARITY_KEYS) == 10_000
    assert [PORT.stable_hash(k) for k in PARITY_KEYS] == [REF.stable_hash(k) for k in PARITY_KEYS]


@pytest.mark.parametrize("vnodes", [1, 16, 64])
@pytest.mark.parametrize("n_hosts", [1, 2, 3, 4, 5])
def test_route_is_the_references(n_hosts, vnodes):
    hosts = [f"w{i}" for i in range(n_hosts)]
    ref, port = REF.HashRing(hosts, vnodes=vnodes), PORT.HashRing(hosts, vnodes=vnodes)
    assert port.hosts == ref.hosts and len(port) == len(ref) == n_hosts
    assert port._points == ref._points and port._owners == ref._owners
    assert [port.route(k) for k in PARITY_KEYS] == [ref.route(k) for k in PARITY_KEYS]


@pytest.mark.parametrize("vnodes", [1, 16, 64])
def test_moved_keys_after_add_and_remove_are_the_references(vnodes):
    moves = {}
    for ns in (REF, PORT):
        base = ns.HashRing(["w0", "w1", "w2"], vnodes=vnodes)
        grown = base.snapshot()
        grown.add_host("w3")
        shrunk = grown.snapshot()
        shrunk.remove_host("w1")
        moves[ns.name] = (grown.moved_keys(PARITY_KEYS, base),
                          shrunk.moved_keys(PARITY_KEYS, grown),
                          base.moved_keys(KEYS, ns.HashRing(vnodes=vnodes)))
    assert moves["torch"] == moves["jax"]
    added, removed, from_empty = moves["torch"]
    assert added and all(dst == "w3" for _src, dst in added.values())
    assert removed and all(src == "w1" for src, _dst in removed.values())
    assert all(src == "" for src, _dst in from_empty.values())


# ---------------------------------------------------------------------------
# the reference's cases (tests/test_cluster_ring.py), through both packages
# ---------------------------------------------------------------------------

class TestHashRing:
    def test_routing_is_deterministic_across_instances(self, m):
        """Every front-tier replica must route identically: the ring is a
        pure function of (host set, vnodes), with no process salt."""
        a = m.HashRing(["w0", "w1", "w2"], vnodes=64)
        b = m.HashRing(["w2", "w0", "w1"], vnodes=64)  # order must not matter
        assert [a.route(k) for k in KEYS] == [b.route(k) for k in KEYS]

    def test_distribution_is_roughly_balanced(self, m):
        ring = m.HashRing(["w0", "w1", "w2", "w3"], vnodes=64)
        counts = {h: 0 for h in ring.hosts}
        for k in KEYS:
            counts[ring.route(k)] += 1
        share = len(KEYS) / len(counts)
        for host, n in counts.items():
            assert 0.4 * share <= n <= 1.8 * share, (host, counts)

    def test_add_host_moves_only_a_fraction(self, m):
        """The consistent-hashing contract: adding one host re-homes ~1/N
        of the keys, and every moved key lands ON the new host."""
        before = m.HashRing(["w0", "w1", "w2"], vnodes=64)
        after = before.snapshot()
        after.add_host("w3")
        moved = after.moved_keys(KEYS, before)
        assert 0 < len(moved) < len(KEYS) // 2
        assert all(dst == "w3" for _src, dst in moved.values())

    def test_remove_host_moves_only_its_keys(self, m):
        before = m.HashRing(["w0", "w1", "w2"], vnodes=64)
        after = before.snapshot()
        after.remove_host("w1")
        moved = after.moved_keys(KEYS, before)
        assert moved, "w1 owned some of 400 keys"
        for key, (src, dst) in moved.items():
            assert src == "w1" and dst != "w1", (key, src, dst)
        unmoved = [k for k in KEYS if k not in moved]
        assert all(after.route(k) == before.route(k) for k in unmoved)

    def test_empty_ring_raises_lookup_error(self, m):
        with pytest.raises(LookupError):
            m.HashRing().route("t/d")

    def test_vnodes_env_knob(self, m, monkeypatch):
        monkeypatch.setenv("DEEQU_TPU_CLUSTER_VNODES", "8")
        assert m.ring_vnodes() == 8
        assert m.HashRing(["w0"]).vnodes == 8
        monkeypatch.setenv("DEEQU_TPU_CLUSTER_VNODES", "not-a-number")
        assert m.ring_vnodes() == 64  # warn-once keep-default parser

    def test_ring_rebalance_fault_site_is_live(self, m):
        """Chaos plans can fail the re-hash mid-membership-change."""
        ring = m.HashRing(["w0"])
        with m.inject(m.FaultSpec(site="ring_rebalance", kind="host_loss", at=1)):
            with pytest.raises(m.HostLossError):
                ring.add_host("w1")
        assert ring.hosts == ("w0",)


class TestHeartbeatMembership:
    def test_beat_then_scan_alive(self, m, tmp_path):
        mem = m.HeartbeatMembership(str(tmp_path), host_id="w0", ttl_s=5.0)
        mem.beat()
        alive, lost = m.HeartbeatMembership(str(tmp_path), ttl_s=5.0).scan()
        assert alive == ["w0"] and lost == []

    def test_ttl_expiry_declares_lost_and_retire_clears(self, m, tmp_path):
        mem = m.HeartbeatMembership(str(tmp_path), host_id="w0", ttl_s=0.1)
        mem.beat()
        time.sleep(0.25)
        reader = m.HeartbeatMembership(str(tmp_path), ttl_s=0.1)
        alive, lost = reader.scan()
        assert alive == [] and lost == ["w0"]
        reader.retire("w0")
        assert reader.scan() == ([], [])

    def test_background_beater_keeps_host_alive(self, m, tmp_path):
        mem = m.HeartbeatMembership(str(tmp_path), host_id="w0",
                                    heartbeat_period_s=0.05, ttl_s=0.3)
        mem.start()
        try:
            time.sleep(0.5)  # several TTLs: only the beater keeps it alive
            alive, lost = m.HeartbeatMembership(str(tmp_path), ttl_s=0.3).scan()
            assert alive == ["w0"] and lost == []
        finally:
            mem.stop()

    def test_host_heartbeat_fault_declares_host_lost(self, m, tmp_path):
        """An injected host_loss fault at the heartbeat probe declares a
        LIVE host dead: the drills' loss path without killing anything."""
        for host in ("w0", "w1"):
            m.HeartbeatMembership(str(tmp_path), host_id=host, ttl_s=30.0).beat()
        reader = m.HeartbeatMembership(str(tmp_path), ttl_s=30.0)
        with m.inject(m.FaultSpec(site="host_heartbeat", kind="host_loss", match="w1")):
            alive, lost = reader.scan()
        assert alive == ["w0"] and lost == ["w1"]

    def test_torn_beat_files_are_skipped(self, m, tmp_path):
        (tmp_path / "host-evil.json").write_text("{not json")
        mem = m.HeartbeatMembership(str(tmp_path), host_id="w0", ttl_s=5.0)
        mem.beat()
        assert list(mem.members()) == ["w0"]


# ---------------------------------------------------------------------------
# the beat files are the contract between the packages
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("writer,reader", [(REF, PORT), (PORT, REF)], ids=["jax->torch", "torch->jax"])
def test_one_packages_beats_are_read_by_the_other(writer, reader, tmp_path):
    """A front tier of either package scans the workers of both: the beat
    file's name, fields and atomic rename are the reference's."""
    for host in ("w0", "w/1"):
        writer.HeartbeatMembership(str(tmp_path), host_id=host, ttl_s=30.0).beat()
    scan = reader.HeartbeatMembership(str(tmp_path), ttl_s=30.0)
    assert sorted(scan.members()) == ["w/1", "w0"]
    assert scan.scan() == (["w/1", "w0"], [])
    assert not [p for p in tmp_path.iterdir() if ".tmp." in p.name]
    scan.retire("w/1")
    assert writer.HeartbeatMembership(str(tmp_path), ttl_s=30.0).scan() == (["w0"], [])
