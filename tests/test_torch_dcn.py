"""The cross-process fold and merge of the PyTorch/CUDA port
(``deequ_tpu_torch.parallel.dcn``) over gloo on the CPU: worlds of 2 and
4 processes (the butterfly's XOR rounds) and 3 (the gather route), each
spawned with ``torch.multiprocessing`` over a ``FileStore`` in the test's
directory. The processes run ``dcn.worker_main``, which imports only torch
and the port. Each rank folds its contiguous share of a table's host
partials and merges across the group; every rank's states must equal, bit
for bit, the in-process mesh of the same size over the same assignment of
partials (``sharded_ingest_fold`` and ``collective_merge_states``). A
second case kills one peer before the merge: the survivor's merge fails
within its deadline, and its salvaged states plus the dead peer's replayed
partials equal the fold of every partial. Every join has its own timeout
of 60 s; a hang fails the test."""

from __future__ import annotations

import numpy as np
import pyarrow as pa
import pytest
import torch
import torch.multiprocessing as mp

import chip_smoke
import deequ_tpu_torch as dq
import deequ_tpu_torch.analyzers as T
import deequ_tpu_torch.parallel as TP
from deequ_tpu_torch.parallel import dcn

pytestmark = pytest.mark.mesh

CPU = torch.device("cpu")
JOIN_S = 60
BATCH = 1024


def battery():
    return [T.Size(), T.Completeness("x"), T.Mean("x"), T.StandardDeviation("x"),
            T.Minimum("x"), T.Maximum("x"), T.ApproxCountDistinct("y"), T.Correlation("x", "z"),
            T.KLLSketch("x", T.KLLParameters(64, 0.64, 10))]


def partials_of(analyzers):
    rng = np.random.default_rng(5)
    n = 8 * BATCH + 300
    table = pa.table({"x": pa.array(rng.normal(3, 2, n), mask=rng.random(n) < 0.1),
                      "y": pa.array(rng.integers(0, 400, n)),
                      "z": pa.array(rng.normal(0, 1, n))})
    return dcn.host_partials(analyzers, dq.Dataset.from_arrow(table), BATCH)


def assignment(n_partials: int, world: int) -> list:
    local = -(-n_partials // world)
    return [list(range(r * local, min(n_partials, (r + 1) * local))) for r in range(world)]


def run_world(tmp_path, world: int, job: dict) -> list:
    """Spawn the world, join every process within ``JOIN_S`` seconds, and
    return each rank's output (None for a rank that wrote none)."""
    job_path = tmp_path / "job.pt"
    torch.save(job, job_path)
    ctx = mp.get_context("spawn")
    procs = []
    for rank in range(world):
        p = ctx.Process(target=dcn.worker_main,
                        args=(rank, world, str(tmp_path / "store"), str(job_path),
                              str(tmp_path / f"out{rank}.pt")))
        p.start()
        procs.append(p)
    hung = []
    for rank, p in enumerate(procs):
        p.join(JOIN_S)
        if p.is_alive():
            hung.append(rank)
            p.kill()
            p.join(5)
    assert not hung, f"ranks {hung} did not finish within {JOIN_S} s"
    out = []
    for rank in range(world):
        path = tmp_path / f"out{rank}.pt"
        out.append(torch.load(path, weights_only=False) if path.exists() else None)
    return out


def in_process_merge(analyzers, partials, shares):
    """The mesh of ``len(shares)`` shards in one process: shard r folds the
    partials of ``shares[r]`` (a chunk padded with flagged-off partials),
    then the collective merge."""
    world = len(shares)
    local = max(len(s) for s in shares)
    chunk, flags = [], []
    for share in shares:
        rows = [partials[j] for j in share]
        chunk += rows + [partials[0]] * (local - len(rows))
        flags += [True] * len(rows) + [False] * (local - len(rows))
    mesh = TP.make_mesh(world, device="cpu")
    states = TP.sharded_ingest_fold(analyzers, mesh, TP.stack_identity_states(analyzers, world,
                                                                               CPU),
                                    dcn.stack_partials(analyzers, chunk), np.array(flags))
    return TP.collective_merge_states(analyzers, mesh, states)


@pytest.mark.parametrize("world", [2, 3, 4])
def test_every_rank_merges_to_the_in_process_mesh(tmp_path, world):
    analyzers = battery()
    partials = partials_of(analyzers)
    shares = assignment(len(partials), world)
    out = run_world(tmp_path, world, {
        "analyzers": analyzers, "partials": [[partials[j] for j in s] for s in shares],
        "device": "cpu", "backend": "gloo", "deadline_s": 30.0})
    want = in_process_merge(analyzers, partials, shares)
    for rank, got in enumerate(out):
        assert got is not None and not got["salvaged"], (rank, got)
        assert got["world"] == world
        for a, g, w in zip(analyzers, got["states"], want):
            assert chip_smoke.same_state_bits(g, w), (rank, a)


def test_a_killed_peer_leaves_a_survivor_that_salvages_and_replays(tmp_path):
    analyzers = battery()
    partials = partials_of(analyzers)
    shares = assignment(len(partials), 2)
    out = run_world(tmp_path, 2, {
        "analyzers": analyzers, "partials": [[partials[j] for j in s] for s in shares],
        "device": "cpu", "backend": "gloo", "deadline_s": 10.0, "die": 1})
    survivor, dead = out
    assert dead is None
    assert survivor["salvaged"] and survivor["reason"].startswith("collective merge")
    want = in_process_merge(analyzers, partials, [list(range(len(partials)))])
    for a, g, w in zip(analyzers, survivor["states"], want):
        assert chip_smoke.same_state_bits(g, w), a


class _EchoPeer:
    """A group of two in this process: rank 0, whose partner sends back
    what it is sent; ``fail`` makes every exchange raise."""

    def __init__(self, monkeypatch, fail: bool):
        import torch.distributed as dist

        self.fail = fail
        for name, value in (("is_initialized", lambda: True), ("get_world_size", lambda: 2),
                            ("get_rank", lambda: 0), ("get_backend", lambda *_: "gloo"),
                            ("P2POp", self.P2POp),
                            ("batch_isend_irecv", self.batch_isend_irecv),
                            ("broadcast", self.broadcast)):
            monkeypatch.setattr(dist, name, value)

    class P2POp:
        def __init__(self, op, tensor, peer):
            self.op, self.tensor, self.peer = op, tensor, peer

    def batch_isend_irecv(self, ops):
        if self.fail:
            raise RuntimeError("Connection closed by peer")
        for send, recv in zip(ops[::2], ops[1::2]):
            recv.tensor.copy_(send.tensor)
        return []

    def broadcast(self, tensor, src):
        if self.fail:
            raise RuntimeError("Connection closed by peer")


@pytest.mark.parametrize("failing", [None, "exchange", "kernel"])
def test_only_a_failed_exchange_counts_as_a_lost_peer(monkeypatch, failing):
    """A failed exchange is a lost peer, ``(None, reason)``, which the
    caller salvages; a merge kernel that fails raises as itself, so the
    work never moves to a salvage because of the device."""
    import deequ_tpu_torch.kernels.state_fold as K

    analyzers = battery()
    partials = partials_of(analyzers)
    mesh = TP.make_mesh(1, device="cpu")
    local = dcn.salvage_local_states(dcn.fold_partials(
        analyzers, mesh, TP.stack_identity_states(analyzers, 1, CPU), partials))
    _EchoPeer(monkeypatch, fail=failing == "exchange")
    if failing == "kernel":
        def broken(*_):
            raise RuntimeError("state_fold: CUDA error: an illegal memory access")

        monkeypatch.setattr(K, "state_fold", broken)
        with pytest.raises(RuntimeError, match="illegal memory access"):
            dcn.merge_host_states(analyzers, local, device="cpu", deadline_s=30.0)
        return
    merged, reason = dcn.merge_host_states(analyzers, local, device="cpu", deadline_s=30.0)
    if failing == "exchange":
        assert merged is None and reason.startswith("collective merge failed")
        assert "Connection closed by peer" in reason
        return
    assert reason is None
    want = in_process_merge(analyzers, partials + partials,
                            [list(range(len(partials))),
                             list(range(len(partials), 2 * len(partials)))])
    for a, g, w in zip(analyzers, merged, want):
        assert chip_smoke.same_state_bits(g, w), a


def test_merge_outside_a_group_is_the_local_states():
    analyzers = [T.Size()]
    state = analyzers[0].init_state(CPU)
    merged, reason = dcn.merge_host_states(analyzers, [state], device="cpu")
    assert reason is None and int(merged[0].num_matches) == 0


def test_initialize_refuses_an_unknown_backend(tmp_path):
    with pytest.raises(ValueError, match="backend"):
        dcn.initialize_dcn(str(tmp_path / "store"), 1, 0, backend="mpi")


def test_with_deadline_reports_a_hang_and_an_error():
    import time

    _, _, timed_out = dcn.with_deadline(lambda: time.sleep(5), 0.1)
    assert timed_out
    value, err, timed_out = dcn.with_deadline(lambda: 1 / 0, 5)
    assert value is None and isinstance(err, ZeroDivisionError) and not timed_out
