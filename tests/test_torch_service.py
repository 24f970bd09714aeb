"""The streaming verification service of the PyTorch/CUDA port
(``deequ_tpu_torch.service``) against the JAX reference's service.

Both packages run on the CPU (the reference with ``fleet=False``: the
single-chip path is the one compared; the port with ``device="cpu"``) over
the same pyarrow micro-batches, with the same knobs. Both routers are made
warm first, so every serial fold runs on the device tier as the coalesced
folds do. Tolerances: counts, min, max and HLL-derived metrics bit for
bit; float64 sums and moments within 1e-12 relative; KLL quantiles bit for
bit against the reference's SERIAL folds (its coalesced KLL is another
valid sketch, not the serial one). Every wait is bounded.
"""

from __future__ import annotations

import ast
import math
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pyarrow as pa
import pytest
import torch

import chip_smoke
import deequ_tpu
import deequ_tpu.analyzers as J
import deequ_tpu.data as JD
import deequ_tpu_torch as dq
import deequ_tpu_torch.analyzers as T
from deequ_tpu.runners import AnalysisRunner as JaxRunner
from deequ_tpu.service import VerificationService as JService
from deequ_tpu.service.placement import shape_qualified_signature as jsignature
from deequ_tpu_torch import kernels
from deequ_tpu_torch.analyzers.state_provider import FileSystemStateProvider
from deequ_tpu_torch.exceptions import SchemaDriftError
from deequ_tpu_torch.reliability import FaultSpec, inject
from deequ_tpu_torch.reliability.faults import KNOWN_FAULT_SITES
from deequ_tpu_torch.runners.analysis_runner import collect_required_analyzers
from deequ_tpu_torch.repository import PartitionStateStore
from deequ_tpu_torch.service import (
    JobFailed,
    SessionClosed,
    VerificationService,
)
from deequ_tpu_torch.service.placement import shape_qualified_signature
from deequ_tpu_torch.service.streaming import _session_batch_size

REPO = Path(__file__).resolve().parent.parent
RTOL = 1e-12
MOMENT_METRICS = ("Mean", "Sum", "StandardDeviation", "Correlation")
WAIT_S = 60
#: chip_smoke phase 8's checks: the reference's soak battery with the
#: moments, co-moments, HLL and KLL constraints of the coalesced path
soak_check = chip_smoke.stream_check


@pytest.fixture(autouse=True)
def _knobs(monkeypatch):
    for var in ("DEEQU_TPU_COALESCE", "DEEQU_TPU_FAST_PATH_MAX_ROWS",
                "DEEQU_TPU_COALESCE_MAX_WIDTH"):
        monkeypatch.delenv(var, raising=False)


def table(rows: int, seed: int) -> pa.Table:
    """The soak's table (tools/ingest_soak.py): x, y, k, v; nulls in x."""
    rng = np.random.default_rng(seed)
    return pa.table({
        "x": pa.array(rng.normal(size=rows), mask=rng.random(rows) < 0.05),
        "y": rng.normal(10.0, 2.0, size=rows),
        "k": rng.integers(0, 1000, size=rows),
        "v": rng.uniform(0, 1, size=rows),
    })


def _value(metric):
    v = metric.value
    if v.is_failure:
        return ("failure", type(v.exception).__name__)
    return v.get()


def _metrics(session) -> dict:
    return {repr(a): _value(m) for a, m in session.current().metrics.items()}


def _assert_metrics(got: dict, want: dict, exact=(), skip=()) -> None:
    """Metric maps by analyzer repr (equal in both packages): moments
    within 1e-12, the rest bit for bit; ``skip``: analyzer names left out."""
    assert set(got) == set(want)
    for key, w in want.items():
        name = key.split("(")[0]
        if name in skip:
            continue
        g = got[key]
        if isinstance(w, float) and math.isnan(w):
            assert isinstance(g, float) and math.isnan(g), key
        elif isinstance(w, float) and name in MOMENT_METRICS and name not in exact:
            assert abs(g - w) <= RTOL * max(1.0, abs(w)), (key, g, w)
        else:
            assert g == w, (key, g, w)


#: sessions x micro-batches: ragged rows, two buckets (512 and 1024)
SIZES = [[1000, 700, 400], [1024, 1, 900], [513, 1000, 300], [64, 1024, 1024]]


def _stream(service, check_fn, warm_fn, pipelined=True):
    sessions = [service.session(f"t{i}", "d", [check_fn()]) for i in range(len(SIZES))]
    warm_fn(service, sessions[0]._analyzers)
    handles = []
    for b in range(3):
        for i, s in enumerate(sessions):
            data = table(SIZES[i][b], seed=1000 + 97 * i + b)
            if pipelined:
                handles.append(s.ingest(data, wait=False))
            else:
                s.ingest(data, timeout=WAIT_S)
    for h in handles:
        h.result(WAIT_S)
    return sessions


def _warm_port(service, analyzers):
    for rows in (512, 1024):
        service.router.note_ran(shape_qualified_signature(analyzers, rows), 0, "device")


def _warm_ref(service, analyzers):
    for rows in (512, 1024):
        service.router.note_ran(jsignature(analyzers, rows), 0, "device")


def _port_run(coalesce: str, monkeypatch):
    monkeypatch.setenv("DEEQU_TPU_COALESCE", coalesce)
    monkeypatch.setenv("DEEQU_TPU_FAST_PATH_MAX_ROWS", "0")
    with VerificationService(workers=2, device="cpu", background_warm=False) as svc:
        sessions = _stream(svc, lambda: soak_check(dq), _warm_port)
        counters = svc.json_snapshot()["counters"]
        return [_metrics(s) for s in sessions], counters, [s.batches_ingested for s in sessions]


def _ref_run(coalesce: str, monkeypatch):
    monkeypatch.setenv("DEEQU_TPU_COALESCE", coalesce)
    monkeypatch.setenv("DEEQU_TPU_FAST_PATH_MAX_ROWS", "0")
    svc = JService(workers=2, background_warm=False, fleet=False)
    try:
        sessions = _stream(svc, lambda: soak_check(deequ_tpu), _warm_ref)
        return [_metrics(s) for s in sessions]
    finally:
        svc.close()


@pytest.mark.parametrize("coalesce", ["0", "1"])
def test_service_matches_the_reference_service(coalesce, monkeypatch):
    """Four sessions x three pipelined micro-batches in two buckets, with
    coalescing off (serial folds) and on (every fold on the coalesced
    device route), against the reference's service with the same knobs
    and against its serial folds."""
    got, counters, batches = _port_run(coalesce, monkeypatch)
    assert batches == [3] * len(SIZES)
    serial = _ref_run("0", monkeypatch)
    for g, w in zip(got, serial):
        _assert_metrics(g, w)
    if coalesce == "1":
        assert counters["deequ_service_coalesced_folds_total"] == 12
        assert counters["deequ_service_fold_route_total"] == {"route=device": 12.0}
        # the reference's coalesced KLL is not its serial one
        for g, w in zip(got, _ref_run("1", monkeypatch)):
            _assert_metrics(g, w, skip=("ApproxQuantile",))
        # coalesced and serial folds of the port agree bit for bit
        for g, w in zip(got, _port_run("0", monkeypatch)[0]):
            _assert_metrics(g, w, exact=MOMENT_METRICS)
    else:
        assert "deequ_service_fold_route_total" not in counters


def test_fast_path_matches_the_serial_fold(monkeypatch):
    """An identity-transparent battery takes the host fast path, whose
    host_merge gives the serial fold's metrics bit for bit."""
    def check():
        return (dq.Check(dq.CheckLevel.ERROR, "fast").has_size(lambda n: n > 0)
                .is_complete("x").has_min("v", lambda v: True)
                .has_approx_count_distinct("k", lambda v: True))

    out = {}
    for coalesce in ("1", "0"):
        monkeypatch.setenv("DEEQU_TPU_COALESCE", coalesce)
        with VerificationService(workers=2, device="cpu", background_warm=False) as svc:
            sessions = _stream(svc, check, _warm_port)
            out[coalesce] = [_metrics(s) for s in sessions]
            routes = svc.json_snapshot()["counters"].get("deequ_service_fold_route_total")
            assert routes == ({"route=fast": 12.0} if coalesce == "1" else None)
    for g, w in zip(out["1"], out["0"]):
        _assert_metrics(g, w, exact=MOMENT_METRICS)


def test_per_session_fifo_under_coalescing(monkeypatch):
    """Pipelined folds of many sessions drain across sessions and
    buckets, yet each session commits in submission order: its
    cumulative Size grows batch by batch."""
    monkeypatch.setenv("DEEQU_TPU_COALESCE", "1")
    monkeypatch.setenv("DEEQU_TPU_FAST_PATH_MAX_ROWS", "0")
    with VerificationService(workers=4, device="cpu", background_warm=False) as svc:
        sess = [svc.session(f"t{i}", "fifo", [soak_check(dq)]) for i in range(6)]
        handles = []
        for b in range(5):
            for i, s in enumerate(sess):
                rows = 300 if (i + b) % 2 else 1500  # buckets 1024 and 2048
                handles.append(s.ingest(table(rows, seed=10 * i + b), wait=False))
        for h in handles:
            h.result(WAIT_S)
        for s in sess:
            sizes = [m.value.get() for r in s.results for a, m in r.metrics.items()
                     if a.name == "Size"]
            assert len(sizes) == 5 and sizes == sorted(sizes)
        assert svc.metrics.counter_value("deequ_service_coalesced_folds_total") == 30


def test_fault_in_a_coalesced_launch_quarantines_its_owner_only(monkeypatch):
    """An injected fault at ``coalesced_fold`` fails the joint launch; the
    bisection isolates the owning session, whose fold alone fails, while
    its siblings commit."""
    monkeypatch.setenv("DEEQU_TPU_COALESCE", "1")
    monkeypatch.setenv("DEEQU_TPU_FAST_PATH_MAX_ROWS", "0")
    with VerificationService(workers=1, device="cpu", background_warm=False) as svc:
        sess = [svc.session(f"t{i}", "chaos", [soak_check(dq)]) for i in range(4)]
        with inject(FaultSpec("coalesced_fold", "poison", every=1, count=None,
                              match="t2/chaos")):
            handles = [s.ingest(table(512, seed=i), wait=False) for i, s in enumerate(sess)]
            outcomes = []
            for h in handles:
                try:
                    h.result(WAIT_S)
                    outcomes.append("ok")
                except JobFailed:
                    outcomes.append("failed")
        assert outcomes == ["ok", "ok", "failed", "ok"]
        assert [s.batches_ingested for s in sess] == [1, 1, 0, 1]
        assert svc.metrics.counter_value("deequ_service_coalesce_quarantined_total") == 1


@pytest.mark.parametrize("coalesce", ["0", "1"])
def test_drift_is_rejected_before_the_fold(coalesce, monkeypatch):
    monkeypatch.setenv("DEEQU_TPU_COALESCE", coalesce)
    with VerificationService(workers=1, device="cpu", background_warm=False) as svc:
        s = svc.session("t", "drift", [soak_check(dq)])
        s.ingest(table(256, seed=1), timeout=WAIT_S)
        before = _metrics(s)
        with pytest.raises(SchemaDriftError):
            s.ingest(table(256, seed=2).drop_columns(["k"]), timeout=WAIT_S)
        assert s.batches_ingested == 1
        assert _metrics(s) == before
        assert svc.metrics.counter_value("deequ_service_drift_rejections_total") == 1


def test_closed_sessions_refuse_typed(tmp_path):
    with VerificationService(workers=1, device="cpu", background_warm=False) as svc:
        s = svc.session("t", "closed", [soak_check(dq)])
        s.ingest(table(100, seed=3), timeout=WAIT_S)
        s.close()
        assert s.closed
        with pytest.raises(SessionClosed):
            s.ingest(table(100, seed=4))
        with pytest.raises(SessionClosed):
            svc.session("t", "closed")
        assert svc.get_session("t", "closed") is None
        assert svc.get_session("t", "closed", include_closed=True) is s
        # a service without a partition store flushes nowhere; a closed
        # session still flushes its states into a store it is given
        assert svc.partition_store is None and s.flush_to_partition() is None
        store = PartitionStateStore(str(tmp_path / "store"))
        assert s.flush_to_partition(store) == "session-t"
        assert store.get("closed", "session-t").num_rows == 100


def _reference_stream(state_root, batches):
    svc = JService(workers=1, background_warm=False, fleet=False, state_root=state_root)
    try:
        s = svc.session("tenant/a", "d", [soak_check(deequ_tpu)])
        for data in batches:
            s.ingest(data, timeout=WAIT_S)
        return _metrics(s)
    finally:
        svc.close()


def _port_stream(state_root, batches):
    with VerificationService(workers=1, device="cpu", background_warm=False,
                             state_root=state_root) as svc:
        s = svc.session("tenant/a", "d", [soak_check(dq)])
        for data in batches:
            s.ingest(data, timeout=WAIT_S)
        return _metrics(s)


@pytest.mark.parametrize("first", ["jax", "torch"])
def test_a_session_resumes_across_packages(first, tmp_path, monkeypatch):
    """States one package's session persisted under ``state_root`` (the
    v2 blobs and the schema contract) resume in the other package's
    session, whose cumulative metrics are the reference's over all
    batches."""
    monkeypatch.setenv("DEEQU_TPU_COALESCE", "0")
    batches = [table(n, seed=70 + i) for i, n in enumerate((800, 1000, 600))]
    run = {"jax": _reference_stream, "torch": _port_stream}
    run[first](str(tmp_path / "shared"), batches[:2])
    other = "torch" if first == "jax" else "jax"
    got = run[other](str(tmp_path / "shared"), batches[2:])
    want = _reference_stream(str(tmp_path / "alone"), batches)
    _assert_metrics(got, want)
    drifted = table(10, seed=5).drop_columns(["v"])
    with pytest.raises((SchemaDriftError, JobFailed)):
        _port_stream(str(tmp_path / "shared"), [drifted])


def _routed_verify(svc, data, checks):
    """``svc.verify`` and the route it took: the router's
    ``placement_routed`` decisions and the engine passes' tiers, read from
    the flight recorder's spans of this job."""
    from deequ_tpu_torch.observability.recorder import recorder

    recorder().clear()
    result = svc.verify(data, checks, timeout=WAIT_S)
    spans = recorder().spans()
    decisions = [ev["attrs"]["decision"] for s in spans for ev in s.events
                 if ev["name"] == "placement_routed"]
    tiers = [s.attrs["tier"] for s in spans if s.name == "engine_pass"]
    return result, decisions, tiers


def test_one_shot_verification_matches_a_direct_run(monkeypatch):
    """A one-shot job equals a direct run on the tier the router sent it
    to. The router's route depends on the process's program cache (a
    battery is warm once its program has launched), so each case makes its
    own: an empty cache (cold: the host tier, while the kernels would warm)
    and then the battery warmed explicitly first (warm: the device tier)."""
    from deequ_tpu_torch.runners import engine
    from deequ_tpu_torch.utils import BoundedLRU

    data = table(3000, seed=8)
    checks = [soak_check(dq)]
    for case, tier in (("cold", "host"), ("warm", "device")):
        monkeypatch.setattr(engine, "_PROGRAM_CACHE", BoundedLRU(256))
        monkeypatch.setattr(engine, "_WARM_BATTERIES", BoundedLRU(256))
        if case == "warm":
            engine.warm_fused_program(collect_required_analyzers(checks),
                                      dq.Dataset.from_arrow(data),
                                      batch_size=_session_batch_size(3000, None), device="cpu")
        with VerificationService(workers=2, device="cpu", background_warm=False) as svc:
            got, decisions, tiers = _routed_verify(svc, dq.Dataset.from_arrow(data), checks)
            assert "deequ_service_jobs_completed_total" in svc.prometheus_text()
        assert decisions == (["host"] if case == "cold" else ["auto"]), case
        assert tiers == [tier], case
        want = dq.VerificationSuite.on_data(dq.Dataset.from_arrow(data), device="cpu") \
            .add_check(soak_check(dq)).with_placement(tier).run()
        assert got.status == want.status, case
        assert ({repr(a): _value(m) for a, m in got.metrics.items()}
                == {repr(a): _value(m) for a, m in want.metrics.items()}), case
    assert _session_batch_size(3000, None) == 4096


@pytest.mark.parametrize("kwargs,item", [
    ({"mesh": 8}, "A5"), ({"fleet": True, "fleet_devices": 8}, "A5"),
    ({"catalog": "catalog-root"}, "A6"),
])
def test_planes_not_ported_raise_naming_their_item(kwargs, item, tmp_path):
    """Every plane these cases name is ported now: each builds and runs a
    job (the mesh and the fleet, A5b; the catalog, A6), and /statusz
    carries no placeholder section for them."""
    if "mesh" in kwargs or "fleet" in kwargs:
        from deequ_tpu_torch.parallel import make_mesh

        if "mesh" in kwargs:
            kwargs = {"mesh": make_mesh(kwargs["mesh"], device="cpu")}
        with VerificationService(device="cpu", background_warm=False, **kwargs) as svc:
            assert (svc.fleet is None) == ("mesh" in kwargs)
            assert (svc.mesh is not None) == ("mesh" in kwargs)
            got = svc.verify(dq.Dataset.from_arrow(table(3000, seed=2)), [soak_check(dq)],
                             tenant="t", timeout=WAIT_S)
            planes = svc.statusz.snapshot()["planes"]
            assert "mesh" not in planes and "fleet" not in planes
            if svc.fleet is not None:
                assert svc.fleet.devices_of("t") == tuple(range(8))
        want = dq.VerificationSuite.on_data(dq.Dataset.from_arrow(table(3000, seed=2)),
                                            device="cpu").add_check(soak_check(dq)).run()
        assert got.status == want.status
        assert ({repr(a): _value(m) for a, m in got.metrics.items() if "Size" in repr(a)}
                == {repr(a): _value(m) for a, m in want.metrics.items() if "Size" in repr(a)})
        return
    # the tenant catalog is ported: a root path builds the plane, and a
    # tenant registered there materializes its session from its document
    root = str(tmp_path / kwargs["catalog"])
    with VerificationService(device="cpu", background_warm=False, catalog=root) as svc:
        svc.catalog_plane.catalog.register("acme", {"checks": [
            {"name": "c", "constraints": [{"kind": "size", "min": 1}]}]})
        session = svc.catalog_plane.ensure_session("acme", "d")
        assert session.ingest(table(100, seed=1), timeout=WAIT_S).status.value == "Success"
        assert svc.statusz.snapshot()["planes"]["catalog"] == {
            "enabled": True, "tenant_versions": {"acme": 1}}


@pytest.mark.parametrize("form", ["store", "path", "env"])
def test_the_partition_store_is_a_store_a_path_or_the_env(form, tmp_path, monkeypatch):
    """``partition_store=`` takes a store or a path, and None reads
    ``DEEQU_TPU_PARTITION_STORE`` (the reference's three forms)."""
    root = str(tmp_path / "store")
    monkeypatch.delenv("DEEQU_TPU_PARTITION_STORE", raising=False)
    with VerificationService(device="cpu") as svc:
        assert svc.partition_store is None
    if form == "env":
        monkeypatch.setenv("DEEQU_TPU_PARTITION_STORE", root)
        kwargs = {}
    else:
        kwargs = {"partition_store": PartitionStateStore(root) if form == "store" else root}
    with VerificationService(device="cpu", **kwargs) as svc:
        assert isinstance(svc.partition_store, PartitionStateStore)
        assert svc.partition_store.path == root


@pytest.mark.parametrize("call,item", [("watch_metrics", "A6")])
def test_service_entry_points_not_ported_raise(call, item, tmp_path):
    """The fleet watch is ported: ``watch_metrics`` registers a standing
    watch that the next harvest scores."""
    from deequ_tpu_torch.analyzers import Size
    from deequ_tpu_torch.repository import InMemoryMetricsRepository, ResultKey

    with VerificationService(workers=1, device="cpu", background_warm=False) as svc:
        repo = InMemoryMetricsRepository()
        ctx = dq.AnalysisRunner.do_analysis_run(dq.Dataset.from_arrow(table(64, seed=2)),
                                                [Size()], device="cpu")
        now_ms = int(time.time() * 1000)
        for day in range(5):  # inside the watch's twelve-month window
            repo.save(ResultKey(now_ms - (5 - day) * 86_400_000), ctx)
        spec = getattr(svc, call)("t", repo, [Size()])
        assert spec.tenant == "t" and svc.fleetwatch.harvest_now().series_scored == 1


def _partitions(m, seeds):
    return {f"2026-07-{s:02d}": m.Dataset.from_arrow(table(1024, seed=s)) for s in seeds}


@pytest.mark.parametrize("call", ["submit_partitioned_verification", "verify_partitioned"])
def test_partitioned_verification_through_the_service(call, tmp_path):
    """The service's incremental entry points against the reference's
    service: the same plans (scan, then full reuse) and the reference's
    metrics, and the delta planner's counters on the export plane per
    tenant."""
    got = {}
    for name, service, m in (("jax", JService, deequ_tpu), ("torch", VerificationService, dq)):
        kw = {"fleet": False} if name == "jax" else {"device": "cpu"}
        with service(workers=2, background_warm=False,
                     partition_store=str(tmp_path / name), **kw) as svc:
            def verify(parts, svc=svc, m=m):
                if call == "verify_partitioned" or name == "jax":
                    return svc.verify_partitioned("tbl", parts, [soak_check(m)], tenant="ten",
                                                  batch_size=1024, timeout=WAIT_S)
                return svc.submit_partitioned_verification(
                    "tbl", parts, [soak_check(m)], tenant="ten",
                    batch_size=1024).result(WAIT_S)

            first = verify(_partitions(m, (1, 2)))
            second = verify(_partitions(m, (1, 2)))
            counters = svc.json_snapshot()["counters"]
        assert first.incremental.plan.scan == ["2026-07-01", "2026-07-02"]
        assert second.incremental.plan.fully_reused
        assert counters["deequ_service_partitions_scanned_total"] == {"tenant=ten": 2.0}
        assert counters["deequ_service_partitions_reused_total"] == {"tenant=ten": 2.0}
        got[name] = ({repr(a): _value(mt) for a, mt in second.metrics.items()},
                     second.status.value)
    _assert_metrics(got["torch"][0], got["jax"][0])
    assert got["torch"][1] == got["jax"][1]


def test_sessions_flush_into_the_store_when_they_close(tmp_path, monkeypatch):
    """A closing session flushes its cumulative states as partition
    ``session-<tenant>``, which incremental verification then reuses beside
    a new partition: the merged metrics equal a direct run over the
    session's batches and the new one."""
    monkeypatch.setenv("DEEQU_TPU_COALESCE", "0")
    store = PartitionStateStore(str(tmp_path / "store"))
    frames = [table(700, seed=31), table(500, seed=32)]
    with VerificationService(workers=2, device="cpu", background_warm=False,
                             partition_store=store) as svc:
        s = svc.session("ten", "streamed", [soak_check(dq)])
        for frame in frames:
            s.ingest(frame, timeout=WAIT_S)
        s.close()
        assert store.list_partitions("streamed") == ["session-ten"]
        manifest = store.get("streamed", "session-ten")
        assert manifest.num_rows == 1200
        day2 = table(300, seed=33)
        result = svc.verify_partitioned(
            "streamed", {"session-ten": None, "day2": dq.Dataset.from_arrow(day2)},
            [soak_check(dq)], checksums={"session-ten": manifest.content_checksum},
            tenant="ten", timeout=WAIT_S)
    assert result.incremental.plan.reuse == ["session-ten"]
    assert result.incremental.plan.scan == ["day2"]
    direct = dq.VerificationSuite.on_data(
        dq.Dataset.from_arrow(pa.concat_tables(frames + [day2])), device="cpu") \
        .add_check(soak_check(dq)).run()
    # KLL sketches of a different fold order hold their rank envelope only
    _assert_metrics({repr(a): _value(mt) for a, mt in result.metrics.items()},
                    {repr(a): _value(mt) for a, mt in direct.metrics.items()},
                    skip=("ApproxQuantile",))


def test_the_service_runs_on_the_card_by_default():
    if torch.cuda.is_available():
        VerificationService(workers=1).close()
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            VerificationService(workers=1)


def test_fault_sites_are_planted_and_registered():
    """Every ``fault_point(site)`` planted in the port names a registered
    site, and every registered site is planted."""
    planted = set()
    for path in (REPO / "deequ_tpu_torch").rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            if (isinstance(node, ast.Call) and getattr(node.func, "id", None) == "fault_point"
                    and node.args and isinstance(node.args[0], ast.Constant)):
                planted.add(node.args[0].value)
    assert planted == set(KNOWN_FAULT_SITES)


def test_a_battery_whose_kernels_fail_to_build_fails_and_is_never_served_by_the_host(
        tmp_path, monkeypatch):
    """A background warm that cannot build the battery's kernels (here an
    ``nvcc`` that rejects every source) fails every later job of the
    battery with the build error; none of them runs on the host tier."""
    import os
    import time

    from deequ_tpu_torch.exceptions import DeviceFailureException
    from deequ_tpu_torch.kernels import build as kernel_build
    from deequ_tpu_torch.runners import engine
    from deequ_tpu_torch.verification import VerificationSuite

    nvcc = tmp_path / "bin" / "nvcc"
    nvcc.parent.mkdir()
    nvcc.write_text("#!/bin/sh\necho 'nvcc: broken compiler' >&2\nexit 1\n")
    nvcc.chmod(0o755)
    monkeypatch.setenv("PATH", f"{nvcc.parent}{os.pathsep}{os.environ['PATH']}")
    monkeypatch.setattr(kernel_build, "BUILD_DIR", tmp_path / "build")
    # the warm of a CUDA service builds the kernels at its first launch;
    # on the CPU the warm asks for the build itself
    monkeypatch.setattr(engine, "warm_fused_program",
                        lambda *args, **kwargs: kernel_build.build(force=True))
    placements = []
    run = VerificationSuite.do_verification_run

    def recording_run(*args, **kwargs):
        placements.append(kwargs.get("placement"))
        return run(*args, **kwargs)

    monkeypatch.setattr(VerificationSuite, "do_verification_run", recording_run)
    # a column no other test reads, so the battery is cold in this process
    data = dq.Dataset.from_arrow(pa.table({"unbuilt": np.arange(500.0)}))
    checks = [dq.Check(dq.CheckLevel.ERROR, "c").has_mean("unbuilt", lambda v: True)]
    with VerificationService(workers=1, device="cpu", background_warm=True) as svc:
        # the cold battery's first job runs on the host tier while the warm builds
        svc.verify(data, checks, timeout=WAIT_S)
        deadline = time.monotonic() + WAIT_S
        while (svc.metrics.counter_value("deequ_service_warm_failures_total") < 1
               and time.monotonic() < deadline):
            time.sleep(0.01)
        assert svc.metrics.counter_value("deequ_service_warm_failures_total") == 1
        assert placements == ["host"]
        for _ in range(2):
            with pytest.raises(JobFailed, match="broken compiler") as failed:
                svc.verify(data, checks, timeout=WAIT_S)
            assert isinstance(failed.value.__cause__, DeviceFailureException)
        assert placements == ["host"]


def test_launch_counts_survive_concurrent_workers():
    """The launch counters are bumped from the service's worker threads:
    no increment is lost under a short switch interval."""
    kernels.reset_launch_counts()
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda: [kernels.count_launch("scan_reduce_stacked")
                                                    for _ in range(2000)])
                   for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(30)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    assert kernels.launch_counts()["scan_reduce_stacked"] == 16 * 2000
    kernels.reset_launch_counts()


def _dictionary_table():
    values = [f"c{i % 12}" for i in range(500)] + [None] * 7
    return pa.table({"c": pa.array(values).dictionary_encode()})


def test_histogram_takes_the_reference_field_order():
    """``Histogram(column, binning_func, max_detail_bins)``: a positional
    binning function binds to ``binning_func`` and runs on the host path,
    with the reference's metric; the repr and equality are the
    reference's, and ``Histogram("c", None, 7)`` gives the reference's
    metric."""
    def fn(v):
        return v

    h = T.Histogram("c", fn)
    assert h.binning_func is fn and h.max_detail_bins == 1000
    assert repr(T.Histogram("c", None, 7)) == repr(J.Histogram("c", None, 7))
    assert T.Histogram("c", None, 7) == T.Histogram("c", max_detail_bins=7)
    data = _dictionary_table()
    binned = dq.AnalysisRunner.do_analysis_run(
        dq.Dataset.from_arrow(data), [h], device="cpu").metric(h).value.get()
    jh = J.Histogram("c", fn)
    want_binned = JaxRunner.do_analysis_run(
        JD.Dataset.from_arrow(data), [jh]).metric(jh).value.get()
    assert binned.number_of_bins == want_binned.number_of_bins == 13
    assert ({k: (v.absolute, v.ratio) for k, v in binned.values.items()}
            == {k: (v.absolute, v.ratio) for k, v in want_binned.values.items()})
    got = dq.AnalysisRunner.do_analysis_run(
        dq.Dataset.from_arrow(data), [T.Histogram("c", None, 7)], device="cpu"
    ).metric(T.Histogram("c", None, 7)).value.get()
    want = JaxRunner.do_analysis_run(
        JD.Dataset.from_arrow(data), [J.Histogram("c", None, 7)]
    ).metric(J.Histogram("c", None, 7)).value.get()
    assert got.number_of_bins == want.number_of_bins == 13
    assert ({k: (v.absolute, v.ratio) for k, v in got.values.items()}
            == {k: (v.absolute, v.ratio) for k, v in want.values.items()})
    assert len(got.values) == 7


def test_histogram_states_keep_the_reference_file_names(tmp_path):
    """The persisted state key is the reference's repr, so a Histogram's
    state written by the port loads in the reference and back."""
    from deequ_tpu.analyzers.state_provider import FileSystemStateProvider as JProvider

    data = _dictionary_table()
    th, jh = T.Histogram("c", None, 7), J.Histogram("c", None, 7)
    path = str(tmp_path / "states")
    dq.AnalysisRunner.do_analysis_run(dq.Dataset.from_arrow(data), [th], device="cpu",
                                      save_states_with=FileSystemStateProvider(path))
    loaded = JProvider(path).load(jh)
    assert loaded is not None and loaded.num_rows == 507
    assert FileSystemStateProvider(path).load(th).num_rows == 507


def test_backpressure_admits_waiters_in_arrival_order():
    """Submitters parked on a full queue are admitted oldest first, and a
    newcomer that would block queues behind them instead of barging."""
    from deequ_tpu_torch.service.scheduler import JobScheduler

    gate = threading.Event()
    sched = JobScheduler(workers=1, max_queue_depth=1)
    admitted = []
    try:
        first = sched.submit(lambda ctx: gate.wait(WAIT_S))
        deadline = 0
        while sched.pending() and deadline < 1000:  # the worker holds the first job
            threading.Event().wait(0.005)
            deadline += 1
        queued = sched.submit(lambda ctx: "queued")

        def park(name):
            sched.submit(lambda ctx: name, block_s=WAIT_S)
            admitted.append(name)

        threads = [threading.Thread(target=park, args=(name,)) for name in ("a", "b", "c")]
        for t in threads:
            t.start()
            while len(sched._space_waiters) < threads.index(t) + 1:
                threading.Event().wait(0.005)
        gate.set()
        for t in threads:
            t.join(WAIT_S)
        assert not any(t.is_alive() for t in threads)
        assert admitted == ["a", "b", "c"]
        assert first.result(WAIT_S) is True and queued.result(WAIT_S) == "queued"
    finally:
        gate.set()
        sched.shutdown(timeout=WAIT_S)


def test_the_exporter_serves_the_metrics_plane():
    import json
    import urllib.request

    with VerificationService(workers=1, device="cpu") as svc:
        s = svc.session("t", "export", [soak_check(dq)])
        s.ingest(table(200, seed=6), timeout=WAIT_S)
        exporter = svc.start_exporter()
        assert svc.start_exporter() is exporter
        base = f"http://127.0.0.1:{exporter.port}"
        with urllib.request.urlopen(base + "/metrics", timeout=WAIT_S) as r:
            text = r.read().decode()
        with urllib.request.urlopen(base + "/metrics.json", timeout=WAIT_S) as r:
            snapshot = json.loads(r.read())
        assert "deequ_service_stream_batches_total" in text
        assert snapshot["counters"]["deequ_service_stream_batches_total"] == {
            "dataset=export,tenant=t": 1.0}
