"""Chaos soak of the PyTorch/CUDA port: drive the whole verification
service under injected faults.

    python3 -m tools.torch_chaos_soak [--jobs J] [--stream-batches B]
        [--rows R] [--seed S] [--workers W] [--no-cluster-drill]
        [--device cuda|cpu]

One drill that arms the port's seeded fault injector
(``deequ_tpu_torch.reliability.faults``) with a mixed plan (device
failures, OOMs, per-analyzer faults, worker deaths, streaming-fold
crashes, corrupt states, drifted batches) and pushes a burst of one-shot
verification jobs and a streaming session through one
``VerificationService(device=<--device>)``. Then it runs one drill for
each plane (repository, partition store, fleet watch, mesh, ingest,
coalescer, fleet, catalog, row gate, tuning, ``/statusz`` and, unless
``--no-cluster-drill``, the multi-process cluster), writes a summarized
trace artifact, and checks the invariants:

1. every job terminates: a result or a typed ``ServiceError``, never a
   hung handle;
2. every completed verification carries a metric for every analyzer
   (an injected analyzer fault degrades to a typed ``Failure``);
3. device faults never kill a run: the run fails over to the host tier
   and the placement router learns (``device_failures_learned``);
4. the streaming session folded exactly the ingests that returned a
   result (no double folds from retries, no silent drops);

and every drill's own verdict. Each broken invariant is named in
``failed_invariants``; the JSON summary is the last line of stdout and
the exit code is 0 only when ``ok``.

This is the port of ``tools/chaos_soak.py``: the same data, battery,
fault plan, drills, invariants and summary keys. Its meshes lie on
``--device``: the mesh drill runs 4 shards and the fleet drill a table of
8 shards (``make_mesh(n, device=...)``), so on one card neither is
skipped, where the reference skips them below 2 devices. ``--device``
defaults to ``cuda``: without a card the soak raises; pass ``--device
cpu`` to run the kernels' plain versions on the CPU.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Dict

#: the mesh drill's shards and the fleet drill's device table, on the
#: soak's device
MESH_DRILL_SHARDS = 4
FLEET_DRILL_DEVICES = 8


def _build_data(rows: int, seed: int):
    import numpy as np

    from deequ_tpu_torch.data import Dataset

    rng = np.random.default_rng(seed)
    return Dataset.from_dict(
        {
            "x": rng.normal(size=rows),
            "y": rng.normal(10.0, 2.0, size=rows),
            "cat": [f"c{i % 13}" for i in range(rows)],
        }
    )


def _checks():
    from deequ_tpu_torch.checks import Check, CheckLevel

    return [
        Check(CheckLevel.ERROR, "chaos battery")
        .has_size(lambda n: n > 0)
        .is_complete("x")
        .has_mean("y", lambda m: 5.0 < m < 15.0)
        .has_standard_deviation("y", lambda s: s > 0)
        .has_approx_count_distinct("cat", lambda c: c > 0),
    ]


def default_plan(seed: int):
    """The mixed fault plan: every major site with seeded probabilities,
    and one deterministic per-analyzer fault so isolation is always hit.
    ``seed`` is the injector's (``install(plan, seed=seed)``)."""
    from deequ_tpu_torch.reliability import FaultSpec

    return [
        FaultSpec("device_update", "device", p=0.10, count=None),
        FaultSpec("device_update", "oom", p=0.04, count=None),
        FaultSpec("host_partial", "poison", p=0.01, count=3),
        FaultSpec("analyzer", "analyzer", match="StandardDeviation", p=0.25, count=None),
        FaultSpec("worker", "worker_death", p=0.08, count=None),
        FaultSpec("stream_fold", "worker_death", p=0.10, count=None),
        FaultSpec("compile", "stall", p=0.2, count=2, delay_s=0.05),
        # data-plane integrity: a corrupt persisted state at load time
        # degrades exactly the analyzer that needed it; a drifted
        # micro-batch is rejected before the fold
        FaultSpec("state_load", "corrupt", p=0.05, count=3),
        FaultSpec("stream_fold", "drift", p=0.08, count=2),
        # the repository drill's second read sees a whole-file corruption
        FaultSpec("repository_load", "corrupt", at=2, count=1),
    ]


def run_soak(
    jobs: int = 30,
    stream_batches: int = 8,
    rows: int = 4096,
    seed: int = 0,
    workers: int = 4,
    specs=None,
    cluster_drill: bool = False,
    device="cuda",
) -> Dict:
    """Run the soak on ``device`` and return its summary (the module
    docstring lists the invariants). ``cluster_drill=True`` also runs the
    multi-process kill-one drill (``tools/torch_cluster_soak.py``), which
    spawns interpreters; the CLI turns it on."""
    import tempfile

    from deequ_tpu_torch.config import resolve_device
    from deequ_tpu_torch.exceptions import SchemaDriftError
    from deequ_tpu_torch.reliability import WorkerCrash, clear, install
    from deequ_tpu_torch.runners.analysis_runner import collect_required_analyzers
    from deequ_tpu_torch.service import ServiceError, VerificationService

    device = resolve_device(device)
    checks = _checks()
    n_analyzers = len(dict.fromkeys(collect_required_analyzers(checks)))
    data = _build_data(rows, seed)
    injector = install(specs if specs is not None else default_plan(seed), seed=seed)
    t0 = time.perf_counter()
    summary: Dict = {
        "jobs": jobs, "stream_batches": stream_batches, "seed": seed,
        "device": str(device),
        "succeeded": 0, "typed_failures": 0, "untyped_failures": 0,
        "unterminated": 0, "incomplete_metric_maps": 0,
        "degraded_metrics": 0, "stream_folds_ok": 0, "drift_rejects": 0,
    }
    state_root = tempfile.mkdtemp(prefix="torch-chaos-soak-states-")
    try:
        with VerificationService(
            workers=workers, max_queue_depth=jobs + stream_batches + 8,
            background_warm=False, device=device,
            # filesystem-backed session states: the streaming folds run
            # the checksummed state path and its state_load site
            state_root=state_root,
        ) as service:
            handles = [
                service.submit_verification(
                    data, checks, tenant=f"t{i % 3}",
                    max_retries=2, retry_on=(WorkerCrash,),
                )
                for i in range(jobs)
            ]
            session = service.session("chaos", "stream", checks, max_retries=0)
            stream_results = []
            for b in range(stream_batches):
                batch = _build_data(512, seed + 1000 + b)
                try:
                    stream_results.append(session.ingest(batch, timeout=120))
                except SchemaDriftError:
                    # an injected drift fires before the fold: the batch is
                    # rejected typed and must not count as folded
                    summary["drift_rejects"] += 1
                    stream_results.append(None)
                except ServiceError:
                    stream_results.append(None)
            summary["job_metrics"] = []
            for handle in handles:
                try:
                    result = handle.result(timeout=180)
                except ServiceError:
                    summary["typed_failures"] += 1
                    continue
                except TimeoutError:
                    summary["unterminated"] += 1
                    continue
                except Exception:  # noqa: BLE001 - an invariant breach
                    summary["untyped_failures"] += 1
                    continue
                summary["succeeded"] += 1
                if len(result.metrics) != n_analyzers:
                    summary["incomplete_metric_maps"] += 1
                summary["degraded_metrics"] += sum(
                    1 for m in result.metrics.values() if m.value.is_failure
                )
                summary["job_metrics"].append(_metric_values(result))
            summary["stream_folds_ok"] = sum(1 for r in stream_results if r is not None)
            # the session folded exactly the ingests that returned a result
            summary["stream_fold_parity"] = (
                session.batches_ingested == summary["stream_folds_ok"]
            )
            summary["repo_drill"] = _repository_drill(data, state_root, device)
            summary["partition_drill"] = _partition_drill(data, state_root, device)
            summary["fleetwatch_drill"] = _fleetwatch_drill(data, state_root, device)
            summary["mesh_drill"] = _mesh_drill(data, device)
            summary["ingest_drill"] = _ingest_drill(service)
            summary["coalesce_drill"] = _coalesce_drill(service)
            summary["fleet_drill"] = _fleet_drill(device)
            summary["catalog_drill"] = _catalog_drill(device)
            summary["row_gate_drill"] = _row_gate_drill(service)
            summary["tuning_drill"] = _tuning_drill(service)
            from tools.torch_tuning_report import controller_report

            summary["tuning_report"] = controller_report(service)
            summary["statusz_drill"] = _statusz_drill(service)
            summary["faults_fired"] = len(injector.fired)
            snapshot = service.json_snapshot()["counters"]
            summary["device_failures_learned"] = snapshot.get(
                "deequ_service_device_failures_total", 0
            )
    finally:
        clear()
    if cluster_drill:
        # after clear(): the drill's worker processes never see this
        # process's fault plan, only their own injected loss
        summary["cluster_drill"] = _cluster_drill(device)
    summary.update(_write_trace_artifact(state_root))
    summary["seconds"] = round(time.perf_counter() - t0, 2)
    invariants = {
        "unterminated": summary["unterminated"] == 0,
        "untyped_failures": summary["untyped_failures"] == 0,
        "incomplete_metric_maps": summary["incomplete_metric_maps"] == 0,
        "stream_fold_parity": bool(summary["stream_fold_parity"]),
        "jobs_accounted": summary["succeeded"] + summary["typed_failures"] == jobs,
        "repo_drill": summary["repo_drill"]["ok"],
        "partition_drill": summary["partition_drill"]["ok"],
        "fleetwatch_drill": summary["fleetwatch_drill"]["ok"],
        "mesh_drill": summary["mesh_drill"]["ok"],
        "ingest_drill": summary["ingest_drill"]["ok"],
        "coalesce_drill": summary["coalesce_drill"]["ok"],
        "fleet_drill": summary["fleet_drill"]["ok"],
        "catalog_drill": summary["catalog_drill"]["ok"],
        "row_gate_drill": summary["row_gate_drill"]["ok"],
        "tuning_drill": summary["tuning_drill"]["ok"],
        "statusz_drill": summary["statusz_drill"]["ok"],
    }
    if "cluster_drill" in summary:
        invariants["cluster_drill"] = summary["cluster_drill"]["ok"]
    summary["failed_invariants"] = sorted(
        name for name, held in invariants.items() if not held
    )
    summary["ok"] = not summary["failed_invariants"]
    if not summary["ok"]:
        print("chaos soak invariants BROKEN: " + ", ".join(summary["failed_invariants"]),
              file=sys.stderr, flush=True)
    return summary


def _metric_values(result) -> Dict:
    """One verification's metrics, ``"Name(instance)"`` -> value (None for
    a failure metric)."""
    return {
        f"{m.name}({m.instance})": m.value.get() if m.value.is_success else None
        for m in result.metrics.values()
    }


def skipped_drills(summary: Dict) -> list:
    """The drills of ``summary`` that reported themselves skipped."""
    return sorted(
        name for name, value in summary.items()
        if name.endswith("_drill") and isinstance(value, dict) and value.get("skipped")
    )


def _statusz_drill(service) -> Dict:
    """The ops snapshot must stay schema-valid, and cover every plane, on
    a service that just absorbed the soak's faults: asserted through the
    public snapshot and validator, as an operator's probe sees it."""
    from deequ_tpu_torch.service.statusz import REQUIRED_PLANES, validate_statusz

    try:
        doc = service.statusz.snapshot()
        problems = validate_statusz(doc)
    except Exception as exc:  # noqa: BLE001 - a crash is the finding
        return {"ok": False, "error": repr(exc)}
    planes = sorted(doc.get("planes") or {})
    return {
        "ok": not problems,
        "planes": planes,
        "missing_planes": sorted(set(REQUIRED_PLANES) - set(planes)),
        "problems": problems,
    }


def _mesh_drill(data, device) -> Dict:
    """Kill-one-shard drill: a small battery over a mesh of
    ``MESH_DRILL_SHARDS`` shards on ``device`` takes an injected
    ``mesh_loss`` on its fold and must finish with the clean sharded run's
    metrics (salvage and re-shard down the ladder), the loss visible on
    the RunMonitor. ``inject`` swaps the soak's plan out for the drill's
    and restores it after; the clean run, whose job is to define the
    ground truth, runs under an empty plan (the reference's runs under the
    soak's, where a ``host_partial`` poison degrades its Mean and the
    drill's comparison raises)."""
    from deequ_tpu_torch.analyzers import Completeness, Mean, Size
    from deequ_tpu_torch.parallel import make_mesh
    from deequ_tpu_torch.reliability import FaultSpec, inject
    from deequ_tpu_torch.runners import AnalysisRunner, RunMonitor

    n_dev = MESH_DRILL_SHARDS
    analyzers = [Size(), Completeness("x"), Mean("x")]
    with inject():
        clean = AnalysisRunner.do_analysis_run(
            data, analyzers, batch_size=256, sharding=make_mesh(n_dev, device=device),
            placement="host",
        )
    mon = RunMonitor()
    with inject(FaultSpec("sharded_fold", "mesh_loss", at=1, shard=n_dev - 1)) as inj:
        lossy = AnalysisRunner.do_analysis_run(
            data, analyzers, batch_size=256, sharding=make_mesh(n_dev, device=device),
            placement="host", monitor=mon,
        )
    parity = all(
        abs(clean.metric(a).value.get() - lossy.metric(a).value.get())
        <= 1e-9 * max(1.0, abs(clean.metric(a).value.get()))
        for a in analyzers
    )
    return {
        "devices": n_dev,
        "faults_fired": len(inj.fired),
        "shard_losses": mon.shard_losses,
        "mesh_reshards": mon.mesh_reshards,
        "salvaged_states": mon.salvaged_states,
        "degraded": list(mon.degraded),
        "parity": parity,
        "ok": parity and mon.shard_losses >= 1 and mon.mesh_reshards >= 1,
    }


def _cluster_drill(device) -> Dict:
    """Multi-host kill-one drill as real processes
    (``tools/torch_cluster_soak.py --drill kill-one``, at the reference's
    sizes, its workers on ``device``): the verdict is that tool's gate,
    plus at least one recovered session. An environment that cannot spawn
    the workers reports ``skipped`` with ``ok`` True."""
    import subprocess

    cmd = [
        sys.executable, "-m", "tools.torch_cluster_soak", "--drill", "kill-one",
        "--sessions", "4", "--batches", "4", "--rows", "1024", "--device", str(device),
    ]
    try:
        proc = subprocess.run(
            cmd, capture_output=True, text=True, timeout=420,
            cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        )
    except subprocess.TimeoutExpired:
        return {"ok": False, "skipped": False, "reason": "drill timed out"}
    report: Dict = {}
    lines = proc.stdout.strip().splitlines()
    if lines:
        try:
            report = json.loads(lines[-1])
        except ValueError:
            pass
    if proc.returncode == 2 or report.get("skipped"):
        return {"ok": True, "skipped": True,
                "reason": report.get("reason") or proc.stderr[-200:]}
    counters = report.get("counters", {})
    ok = (
        proc.returncode == 0
        and bool(report.get("ok"))
        and not report.get("parity_failures", ["missing report"])
        and counters.get("deequ_service_cluster_sessions_recovered_total", 0) >= 1
    )
    return {
        "ok": ok,
        "skipped": False,
        "rc": proc.returncode,
        "victim": report.get("victim"),
        "recovered_hosts": report.get("recovered_hosts"),
        "host_losses": counters.get("deequ_service_cluster_host_losses_total"),
        "sessions_recovered": counters.get("deequ_service_cluster_sessions_recovered_total"),
        "replayed_folds": counters.get("deequ_service_cluster_replayed_folds_total"),
    }


def _fleet_drill(device) -> Dict:
    """Fleet drill: two tenants stream on disjoint slices of a table of
    ``FLEET_DRILL_DEVICES`` shards on ``device`` and take an injected
    ``mesh_loss`` on the third sharded fold. The fleet must re-pack them
    onto the survivors with no sheds, and each tenant's cumulative metrics
    must equal a clean one-device run's exactly (the battery's merges are
    exact integer sums)."""
    import numpy as np
    import pyarrow as pa

    from deequ_tpu_torch.checks import Check, CheckLevel
    from deequ_tpu_torch.reliability import FaultSpec, inject
    from deequ_tpu_torch.service import VerificationService

    def fleet_checks():
        return [
            Check(CheckLevel.ERROR, "fleet soak")
            .has_size(lambda n: n > 0)
            .is_complete("x")
            .has_min("x", lambda v: v >= 0)
            .has_sum("x", lambda s: s > 0),
        ]

    def table(tenant_seed: int, batch: int, rows: int = 4096):
        r = np.random.default_rng(1000 * tenant_seed + batch)
        return pa.table({"x": r.integers(0, 997, rows).astype(np.float64)})

    tenants = ("fleet-a", "fleet-b")
    batches = 4
    out: Dict = {"devices": FLEET_DRILL_DEVICES}
    os.environ["DEEQU_TPU_FLEET_STREAM_MIN_ROWS"] = "0"
    os.environ["DEEQU_TPU_FAST_PATH_MAX_ROWS"] = "0"
    try:
        # the loss fires on the third sharded fold: mid-soak, after both
        # tenants folded at least once on their first slices
        with inject(FaultSpec("sharded_fold", "mesh_loss", at=3, shard=1)) as inj:
            with VerificationService(
                workers=4, background_warm=False, fleet=True, device=device,
                fleet_devices=FLEET_DRILL_DEVICES,
            ) as svc:
                sessions = {t: svc.session(t, "soak", fleet_checks()) for t in tenants}
                slices_before = {}
                for b in range(batches):
                    for i, t in enumerate(tenants):
                        sessions[t].ingest(table(i, b))
                    if b == 0:
                        slices_before = {t: svc.fleet.devices_of(t) for t in tenants}
                snapshot = svc.fleet.snapshot()
                cumulative = {
                    t: {repr(a): m.value.get()
                        for a, m in sessions[t].current().metrics.items()
                        if m.value.is_success}
                    for t in tenants
                }
                committed = {t: sessions[t].batches_ingested for t in tenants}
                shed = svc.metrics.counter_value("deequ_service_jobs_shed_total")
                mesh_folds = svc.metrics.counter_value("deequ_service_fleet_stream_folds_total")
        # the clean one-device reference per tenant, fleet off; inject()
        # with no spec keeps the soak's faults out of the ground truth
        with inject():
            with VerificationService(workers=2, background_warm=False, fleet=False,
                                     device=device) as ref_svc:
                parity = {}
                for i, t in enumerate(tenants):
                    ref = ref_svc.session(t, "soak", fleet_checks())
                    for b in range(batches):
                        ref.ingest(table(i, b))
                    parity[t] = cumulative[t] == {
                        repr(a): m.value.get()
                        for a, m in ref.current().metrics.items()
                        if m.value.is_success
                    }
    finally:
        os.environ.pop("DEEQU_TPU_FLEET_STREAM_MIN_ROWS", None)
        os.environ.pop("DEEQU_TPU_FAST_PATH_MAX_ROWS", None)
    disjoint_before = bool(slices_before.get(tenants[0])) and not (
        set(slices_before[tenants[0]]) & set(slices_before[tenants[1]])
    )
    repacked_assignment = snapshot["assignment"]
    disjoint_after = not (
        set(repacked_assignment.get(tenants[0], ()))
        & set(repacked_assignment.get(tenants[1], ()))
    )
    out.update({
        "fault_fired": bool(inj.fired),
        "slices_before": {t: list(p) for t, p in slices_before.items()},
        "assignment_after": repacked_assignment,
        "healthy_after": snapshot["healthy"],
        "repacks": snapshot["repacks"],
        "shed": shed or 0,
        "mesh_stream_folds": mesh_folds or 0,
        "committed": committed,
        "parity": parity,
    })
    out["ok"] = (
        bool(inj.fired)
        and disjoint_before and disjoint_after
        and len(snapshot["healthy"]) < FLEET_DRILL_DEVICES  # the loss stuck
        and (out["shed"] or 0) == 0
        and all(committed[t] == batches for t in tenants)
        and all(parity.values())
    )
    return out


def _catalog_drill(device) -> Dict:
    """Tenant-catalog corruption drill: a catalog-driven session takes a
    real torn write as its tenant's newest document version, then an
    injected ``catalog_load`` corruption of a good new version. Both
    degrade to the last good version (the session keeps folding, each bad
    version is quarantined with exactly one counter bump), and a later
    good edit still hot-reloads."""
    import tempfile

    import numpy as np

    from deequ_tpu_torch.reliability import FaultSpec, inject
    from deequ_tpu_torch.service import TenantCatalog, VerificationService
    from deequ_tpu_torch.service.scheduler import Priority

    def doc(priority="normal"):
        return {
            "checks": [{"name": "drill", "constraints": [
                {"kind": "complete", "column": "id"},
                {"kind": "size", "min": 1},
            ]}],
            "row_gate": {"columns": [
                {"name": "id", "type": "int", "nullable": False},
            ]},
            "priority": priority,
        }

    def frame(start=0, rows=256):
        return {"id": np.arange(start, start + rows)}

    out: Dict = {}
    root = tempfile.mkdtemp(prefix="torch-chaos-catalog-")
    with inject():
        catalog = TenantCatalog(os.path.join(root, "catalog"))
        catalog.register("drill", doc())
        with VerificationService(workers=2, background_warm=False, catalog=catalog,
                                 device=device) as svc:
            plane = svc.catalog_plane
            plane.poll_s = 0.0  # every boundary polls
            session = plane.ensure_session("drill", "stream")
            ok0 = session.ingest(frame(0)).status.name == "SUCCESS"

            # (1) a real torn write lands as the newest version
            torn = os.path.join(catalog.path, "t-drill", "v00000077.json")
            with open(torn, "w") as fh:
                fh.write('{"torn": tru')
            for _ in range(3):  # repeated boundaries: one bump, not 3
                plane.on_fold_boundary(session)
            ok1 = session.ingest(frame(256)).status.name == "SUCCESS"
            torn_bumps = svc.metrics.counter_value(
                "deequ_service_catalog_quarantined_total", tenant="drill")

            # (2) an injected corruption of a good new version
            catalog.register("drill", doc(priority="high"))
            with inject(FaultSpec("catalog_load", "corrupt", at=1)) as inj:
                plane.on_fold_boundary(session)
            ok2 = session.ingest(frame(512)).status.name == "SUCCESS"
            injected_bumps = svc.metrics.counter_value(
                "deequ_service_catalog_quarantined_total", tenant="drill") - torn_bumps

            # (3) the next good edit still hot-reloads
            catalog.register("drill", doc(priority="low"))
            plane.on_fold_boundary(session)
            ok3 = session.ingest(frame(768)).status.name == "SUCCESS"
            out.update({
                "folds_ok": [ok0, ok1, ok2, ok3],
                "torn_bumps": torn_bumps,
                "injected_fired": len(inj.fired),
                "injected_bumps": injected_bumps,
                "quarantine_files": sorted(os.listdir(catalog.path + ".quarantine")),
                "priority_after": session.priority.name,
            })
    out["ok"] = (
        all(out["folds_ok"])
        and out["torn_bumps"] == 1
        and out["injected_fired"] == 1 and out["injected_bumps"] == 1
        and len(out["quarantine_files"]) == 2
        and out["priority_after"] == Priority.LOW.name
    )
    return out


def _row_gate_drill(service) -> Dict:
    """Row-gate drill on the live service: a gated session takes (1) an
    injected ``row_gate`` corruption, which surfaces typed with nothing
    folded while the session keeps folding after; (2) a partly bad frame
    whose clean rows fold while the rejects land in the quarantine
    sidecar; (3) an all-bad frame, which raises ``FrameQuarantinedError``
    with nothing folded."""
    import tempfile

    import numpy as np

    from deequ_tpu_torch.checks import Check, CheckLevel
    from deequ_tpu_torch.exceptions import MetricCalculationRuntimeException
    from deequ_tpu_torch.ingest import FrameQuarantinedError, QuarantineSidecar, RowGate
    from deequ_tpu_torch.reliability import FaultSpec, inject
    from deequ_tpu_torch.schema import RowLevelSchema

    checks = [Check(CheckLevel.ERROR, "row-gate drill")
              .has_size(lambda n: n > 0).is_complete("id")]
    schema = RowLevelSchema().with_int_column("id", is_nullable=False)
    sidecar = QuarantineSidecar(tempfile.mkdtemp(prefix="torch-chaos-rowgate-"))
    gate = RowGate(schema, sidecar=sidecar, metrics=service.metrics)
    out: Dict = {}
    with inject():
        session = service.session("rowgate-drill", "stream", checks, row_gate=gate)
        # (1) injected corruption: typed, nothing folds, the session survives
        with inject(FaultSpec("row_gate", "corrupt", at=1)) as inj:
            try:
                session.ingest({"id": np.arange(64)})
                out["injected_typed"] = False
            except MetricCalculationRuntimeException:
                out["injected_typed"] = True
        out["injected_fired"] = len(inj.fired)
        out["committed_after_fault"] = session.batches_ingested

        # (2) nulls in a non-nullable column reject; the clean rows fold
        mixed = {"id": np.array([1.0, np.nan, 3.0, np.nan, 5.0])}
        r = session.ingest(mixed)
        out["partial_status"] = r.status.name
        out["committed_after_partial"] = session.batches_ingested
        quarantined = sidecar.read_all("rowgate-drill", "stream")
        out["quarantined_rows"] = int(quarantined.num_rows) if quarantined is not None else 0

        # (3) an all-bad frame: typed, nothing folds
        try:
            session.ingest({"id": np.array([np.nan, np.nan])})
            out["full_reject_typed"] = False
        except FrameQuarantinedError:
            out["full_reject_typed"] = True
        out["committed_final"] = session.batches_ingested
        out["rejected_counter"] = service.metrics.counter_value(
            "deequ_service_rowgate_rejected_rows_total",
            tenant="rowgate-drill", dataset="stream",
        )
    out["ok"] = (
        out["injected_typed"] and out["injected_fired"] == 1
        and out["committed_after_fault"] == 0
        and out["partial_status"] == "SUCCESS"
        and out["committed_after_partial"] == 1
        and out["quarantined_rows"] == 2
        and out["full_reject_typed"]
        and out["committed_final"] == 1
        and out["rejected_counter"] == 4
    )
    return out


def _coalesce_drill(service) -> Dict:
    """Coalescing drill on the live service: four sessions' folds are
    forced onto the coalesced device launch
    (``DEEQU_TPU_FAST_PATH_MAX_ROWS=0``) and an injected ``coalesced_fold``
    poison matching one session fires on every launch. Group bisection
    must quarantine exactly that session (typed ``JobFailed``, nothing
    committed) while the three others commit."""
    import numpy as np
    import pyarrow as pa

    from deequ_tpu_torch.reliability import FaultSpec, inject
    from deequ_tpu_torch.service.errors import JobFailed

    checks = _checks()
    out: Dict = {}
    os.environ["DEEQU_TPU_FAST_PATH_MAX_ROWS"] = "0"
    try:
        with inject(FaultSpec("coalesced_fold", "poison", every=1, count=None,
                              match="coalesce-drill-2/stream")):
            sessions = [service.session(f"coalesce-drill-{i}", "stream", checks)
                        for i in range(4)]
            handles = []
            for i, s in enumerate(sessions):
                r = np.random.default_rng(40 + i)
                table = pa.table({
                    "x": r.normal(size=512),
                    "y": r.normal(10.0, 2.0, size=512),
                    "cat": pa.array([f"c{j % 13}" for j in range(512)]),
                })
                handles.append(s.ingest(table, wait=False))
            outcomes = []
            for h in handles:
                try:
                    h.result(120)
                    outcomes.append("ok")
                except JobFailed:
                    outcomes.append("quarantined")
                except Exception:  # noqa: BLE001 - the verdict below
                    outcomes.append("untyped")
    finally:
        os.environ.pop("DEEQU_TPU_FAST_PATH_MAX_ROWS", None)
    out["outcomes"] = outcomes
    out["committed"] = [s.batches_ingested for s in sessions]
    out["quarantined_counter"] = service.metrics.counter_value(
        "deequ_service_coalesce_quarantined_total")
    out["ok"] = (outcomes == ["ok", "ok", "quarantined", "ok"]
                 and out["committed"] == [1, 1, 0, 1])
    return out


def _tuning_drill(service) -> Dict:
    """Self-tuning guardrail drill on the live service: a planted
    mis-calibration (``fast_path_max_rows=0`` tuned in, every small fold
    sent to the device route) must be demoted by the controller's
    never-below-static floor, and the recovered burst's sessions/s must
    not fall below half the static burst's. Three bursts through one
    session (static, poisoned, recovered), on wall clocks. ``inject()``
    swaps the soak's faults out: a crashed fold would spoil the timings.
    The static burst starts from the crossover router's seeds (the
    reference's drill keeps the soak's fitted rates, with which the
    static folds can already take the device route; then the planted
    knob changes no route and nothing demotes)."""
    import time as _time

    import numpy as np
    import pyarrow as pa

    from deequ_tpu_torch.checks import Check, CheckLevel
    from deequ_tpu_torch.reliability import inject
    from deequ_tpu_torch.tuning import knobs

    controller = getattr(service, "tuning_controller", None)
    out: Dict = {}
    if controller is None:
        # DEEQU_TPU_AUTOTUNE=0: no controller to drill
        out["skipped"] = "autotune disabled"
        out["ok"] = True
        return out

    checks = [Check(CheckLevel.ERROR, "tuning drill")
              .is_complete("x").has_mean("y", lambda m: 5.0 < m < 15.0)]
    session = service.session("tuning-drill", "stream", checks)
    rng = np.random.default_rng(77)
    table = pa.table({"x": rng.normal(size=8192), "y": rng.normal(10.0, 2.0, size=8192)})

    def burst(n: int) -> float:
        t0 = _time.perf_counter()
        for _ in range(n):
            session.ingest(table, timeout=120)
        return n / (_time.perf_counter() - t0)

    # verdicts must land within the drill's bursts; the operator's env is
    # restored after
    saved = os.environ.get(knobs.TUNING_MIN_SAMPLES_ENV)
    os.environ[knobs.TUNING_MIN_SAMPLES_ENV] = "8"
    try:
        with inject():
            knobs.clear_tuned()  # the floor is measured at true static
            # ... on the router's seeds too: the soak's folds of a few rows
            # (the row gate's, the catalog's) fit host rates of a few
            # thousand rows/s, which send the static folds to the device
            # route the drill means to plant
            service.coalescer.router.reset()
            session.ingest(table, timeout=120)  # warm the static route
            out["static_sessions_per_s"] = burst(24)
            demotions_before = service.metrics.counter_value(
                "deequ_service_tuning_demotions_total")
            knobs.set_tuned("fast_path_max_rows", 0, source="drill")
            out["poisoned_sessions_per_s"] = burst(24)
            out["recovered_sessions_per_s"] = burst(24)
            out["demoted"] = not knobs.tuned_snapshot()
            out["floor_demotions"] = service.metrics.counter_value(
                "deequ_service_tuning_demotions_total") - demotions_before
            out["decisions"] = [d["verdict"] for d in controller.snapshot()["decisions"]]
    finally:
        knobs.clear_tuned()
        if saved is None:
            os.environ.pop(knobs.TUNING_MIN_SAMPLES_ENV, None)
        else:
            os.environ[knobs.TUNING_MIN_SAMPLES_ENV] = saved
    out["ok"] = (
        out.get("demoted", False)
        and out.get("floor_demotions", 0) >= 1
        # the recovered burst runs the static route again: half the static
        # burst's rate would mean the guardrail did not restore it
        and out.get("recovered_sessions_per_s", 0.0)
        >= 0.5 * out.get("static_sessions_per_s", float("inf"))
    )
    return out


def _ingest_drill(service) -> Dict:
    """Arrow ingestion-plane drill on the live service: a truncated
    stream and a checksum-corrupted payload must both end typed
    (``FeedDisconnectError`` / ``MalformedFrameError``), with complete
    leading frames committed and nothing else folded; an injected
    ``frame_corrupt`` at ``frame_decode`` rejects the second frame."""
    import io

    import numpy as np
    import pyarrow as pa

    from deequ_tpu_torch.exceptions import FeedDisconnectError, MalformedFrameError
    from deequ_tpu_torch.ingest import fold_stream
    from deequ_tpu_torch.integrity import checksum_bytes
    from deequ_tpu_torch.reliability import FaultSpec, inject

    checks = _checks()

    def frame_table(seed: int, rows: int = 512):
        r = np.random.default_rng(seed)
        return pa.table({
            "x": r.normal(size=rows),
            "y": r.normal(10.0, 2.0, size=rows),
            "cat": pa.array([f"c{i % 13}" for i in range(rows)]),
        })

    # encode frame by frame so the drill knows each frame's byte boundary
    tables = [frame_table(s) for s in (1, 2, 3)]
    sink = io.BytesIO()
    boundaries = []
    with pa.ipc.new_stream(sink, tables[0].schema) as writer:
        for t in tables:
            for b in t.to_batches():
                writer.write_batch(b)
            boundaries.append(sink.tell())
    payload = sink.getvalue()

    out: Dict = {}
    with inject():  # deterministic outcomes: the soak's plan swapped out
        # 1. a clean fold: all three frames commit
        clean = service.session("ingest-drill", "clean", checks)
        report = fold_stream(clean, payload, source="drill")
        out["clean_frames"] = report.frames
        baseline = clean.batches_ingested

        # 2. a disconnect inside frame 3: frames 1-2 commit, the torn
        # tail ends typed and never folds
        cut = boundaries[1] + (boundaries[2] - boundaries[1]) // 2
        torn = service.session("ingest-drill", "torn", checks)
        try:
            fold_stream(torn, payload[:cut], complete=False, source="drill")
            out["disconnect_typed"] = False
        except FeedDisconnectError:
            out["disconnect_typed"] = True
        except MalformedFrameError:
            out["disconnect_typed"] = False
        out["torn_committed"] = torn.batches_ingested

        # 3. one flipped byte inside a buffer body decodes silently in
        # Arrow IPC; the declared digest catches it and nothing folds
        bad = bytearray(payload)
        bad[boundaries[0] + 32] ^= 0xFF
        corrupt = service.session("ingest-drill", "corrupt", checks)
        try:
            fold_stream(corrupt, bytes(bad), checksum=checksum_bytes(payload), source="drill")
            out["corrupt_typed"] = False
        except MalformedFrameError:
            out["corrupt_typed"] = True
        out["corrupt_committed"] = corrupt.batches_ingested

    # 4. an injected frame_corrupt: the second frame is rejected typed,
    # the first one's fold stays committed
    injected = service.session("ingest-drill", "injected", checks)
    with inject(FaultSpec("frame_decode", "frame_corrupt", at=2)) as inj:
        try:
            fold_stream(injected, payload, source="drill")
            out["injected_typed"] = False
        except MalformedFrameError:
            out["injected_typed"] = True
    out["injected_committed"] = injected.batches_ingested
    out["injected_fired"] = len(inj.fired)

    out["ok"] = (
        out["clean_frames"] == 3 and baseline == 3
        and out["disconnect_typed"] and out["torn_committed"] == 2
        and out["corrupt_typed"] and out["corrupt_committed"] == 0
        and out["injected_typed"] and out["injected_committed"] == 1
    )
    return out


def _partition_drill(data, tmpdir: str, device) -> Dict:
    """Incremental-verification corruption drill: a partitioned table's
    stored states take (1) a flipped byte inside one partition's state
    blob and (2) a schema change that flips the contract fingerprint. The
    corrupt partition quarantines and re-scans alone (its siblings are
    reused, the metrics equal the clean merge), and the stale fingerprint
    invalidates without a crash."""
    import glob

    from deequ_tpu_torch.analyzers import Completeness, Mean, Size, Sum
    from deequ_tpu_torch.data import Dataset
    from deequ_tpu_torch.reliability import inject
    from deequ_tpu_torch.repository.partition_store import (
        PartitionStateStore,
        partition_quarantined_total,
    )
    from deequ_tpu_torch.runners import RunMonitor
    from deequ_tpu_torch.runners.incremental import run_incremental

    out: Dict = {}
    with inject():
        store = PartitionStateStore(os.path.join(tmpdir, "partition-store"))
        analyzers = [Size(), Completeness("x"), Mean("x"), Sum("y")]
        rows = int(data.num_rows)
        third = rows // 3
        parts = {f"p{i}": Dataset.from_arrow(data.arrow.slice(i * third, third))
                 for i in range(3)}
        clean_ctx, first = run_incremental(store, "drill", parts, analyzers,
                                           batch_size=third, device=device)
        out["first_scan"] = list(first.plan.scan)

        # (1) corrupt one partition's Mean blob; the rollup cache goes
        # first so the merge reads the partition blobs
        store.rollup_invalidate("drill")
        [blob] = glob.glob(os.path.join(store.path, "ds-drill", "*", "p-p1",
                                        "Mean-*-state.npz"))
        with open(blob, "rb") as fh:
            raw = bytearray(fh.read())
        raw[len(raw) // 2] ^= 0xFF
        with open(blob, "wb") as fh:
            fh.write(bytes(raw))
        before = partition_quarantined_total()
        mon = RunMonitor()
        ctx, rep = run_incremental(store, "drill", parts, analyzers, batch_size=third,
                                   monitor=mon, device=device)
        out["corrupt_reason"] = rep.plan.reasons.get("p1")
        out["corrupt_rescans"] = list(rep.plan.scan)
        out["corrupt_reused"] = sorted(rep.plan.reuse)
        out["quarantined"] = partition_quarantined_total() - before
        parity = all(ctx.metric(a).value.get() == clean_ctx.metric(a).value.get()
                     for a in analyzers)
        out["parity"] = parity

        # (2) the same names over a changed schema: every partition
        # invalidates typed
        renamed = {
            name: Dataset.from_arrow(d.arrow.rename_columns(
                ["x2" if c == "x" else c for c in d.arrow.column_names]))
            for name, d in parts.items()
        }
        ctx2, rep2 = run_incremental(store, "drill", renamed, [Size(), Completeness("x2")],
                                     batch_size=third, device=device)
        out["stale_reasons"] = sorted(set(rep2.plan.reasons.values()))
        out["ok"] = (
            out["corrupt_reason"] == "corrupt-state"
            and out["corrupt_rescans"] == ["p1"]
            and out["corrupt_reused"] == ["p0", "p2"]
            and out["quarantined"] >= 1
            and parity
            and out["stale_reasons"] == ["stale-fingerprint"]
        )
    return out


def _fleetwatch_drill(data, tmpdir: str, device) -> Dict:
    """Fleet-watch poisoned-history drill: two tenants' partitioned metric
    histories under a standing watch; after a clean harvest, one tenant's
    stored history takes a flipped byte. That tenant quarantines typed
    (the report and the export counter), the other tenant's flags equal
    the clean harvest's, and the flagged anomaly's flight dump parses."""
    import glob

    from deequ_tpu_torch.analyzers import Mean, Size
    from deequ_tpu_torch.metrics import DoubleMetric, Entity, Success
    from deequ_tpu_torch.reliability import inject
    from deequ_tpu_torch.repository import PartitionedMetricsRepository, ResultKey
    from deequ_tpu_torch.runners import AnalysisRunner
    from deequ_tpu_torch.runners.context import AnalyzerContext
    from deequ_tpu_torch.service import VerificationService

    out: Dict = {}
    flight_dir = os.path.join(tmpdir, "fleetwatch-flight")
    prior_flight = os.environ.get("DEEQU_TPU_FLIGHT_DIR")
    os.environ["DEEQU_TPU_FLIGHT_DIR"] = flight_dir
    try:
        with inject():
            steady = AnalysisRunner.do_analysis_run(data, [Size(), Mean("x")], device=device)
            wild = AnalyzerContext({
                Size(): steady.metric(Size()),
                Mean("x"): DoubleMetric(Entity.COLUMN, "Mean", "x", Success(9999.0)),
            })
            now = int(time.time() * 1000)
            day = 86_400_000
            repos = {}
            for tenant in ("drill-flagging", "drill-poisoned"):
                repo = PartitionedMetricsRepository(os.path.join(tmpdir, f"fw-{tenant}"))
                for d in range(20):
                    repo.save(ResultKey(now - (20 - d) * day), steady)
                repo.save(ResultKey(now), wild if tenant == "drill-flagging" else steady)
                repos[tenant] = repo
            with VerificationService(workers=2, background_warm=False, fleet=False,
                                     device=device) as svc:
                for tenant, repo in repos.items():
                    svc.watch_metrics(tenant, repo, [Size(), Mean("x")])
                clean = svc.fleetwatch.harvest_now()
                # poison one stored entry of one tenant: valid JSON that
                # fails its checksum, the shape of bit rot
                poisoned = repos["drill-poisoned"]
                entry = sorted(glob.glob(os.path.join(poisoned.path, "*", "e-*.json")))[-1]
                with open(entry) as fh:
                    raw = fh.read()
                i = raw.index("Mean") + 1
                with open(entry, "w") as fh:
                    fh.write(raw[:i] + ("X" if raw[i] != "X" else "Y") + raw[i + 1:])
                after = svc.fleetwatch.harvest_now()
                quarantine_counter = svc.metrics.counter_value(
                    "deequ_service_anomaly_quarantined_total", tenant="drill-poisoned")
        clean_flags = [f for f in clean.flagged if f[0] == "drill-flagging"]
        after_flags = [f for f in after.flagged if f[0] == "drill-flagging"]
        dump_ok = False
        for path in glob.glob(os.path.join(flight_dir, "*.jsonl")):
            with open(path) as fh:
                records = [json.loads(line) for line in fh]
            header = records[0]
            if any(f.get("kind") == "AnomalyFlagged" for f in header.get("failures", [])) \
                    and header.get("trace_id"):
                dump_ok = True
        out.update({
            "clean_quarantined": list(clean.quarantined_tenants),
            "after_quarantined": list(after.quarantined_tenants),
            "clean_flagged": len(clean_flags),
            "after_flagged": len(after_flags),
            "quarantine_counter": quarantine_counter,
            "flight_dump_parses": dump_ok,
        })
        out["ok"] = bool(
            clean.quarantined_tenants == []
            and after.quarantined_tenants == ["drill-poisoned"]
            and quarantine_counter == 1
            and clean_flags and after_flags == clean_flags
            and dump_ok
        )
    finally:
        if prior_flight is None:
            os.environ.pop("DEEQU_TPU_FLIGHT_DIR", None)
        else:
            os.environ["DEEQU_TPU_FLIGHT_DIR"] = prior_flight
    return out


def _write_trace_artifact(tmpdir: str) -> Dict:
    """Leave a summarized trace artifact behind after every soak: the
    flight recorder's ring as a Chrome trace, and
    ``tools/torch_trace_summarize.py``'s summary (critical path,
    self-times, degradations) beside it; both paths go into the summary."""
    from deequ_tpu_torch.observability import export as obs_export
    from deequ_tpu_torch.observability import trace as obs_trace

    if not obs_trace.enabled():
        return {"trace_artifact": None}
    try:
        artifact = obs_export.write_chrome_trace(os.path.join(tmpdir, "chaos-trace.json"))
        from tools.torch_trace_summarize import summarize

        text = summarize(artifact)
        summary_path = artifact + ".summary.txt"
        with open(summary_path, "w") as fh:
            fh.write(text + "\n")
        print(text, file=sys.stderr, flush=True)
        degradation_lines = sum(1 for line in text.splitlines() if line.startswith("  +"))
        return {
            "trace_artifact": artifact,
            "trace_summary": summary_path,
            "trace_degradations": degradation_lines,
        }
    except Exception:  # noqa: BLE001 - the verdict must not hang on the post-mortem
        import traceback

        traceback.print_exc()
        return {"trace_artifact": None}


def _repository_drill(data, tmpdir: str, device) -> Dict:
    """Corruption drill on the filesystem metrics repository, inside the
    armed plan: two history entries saved, one byte flipped inside one,
    then three reads. The flipped entry is quarantined while the other
    keeps serving; the plan's ``repository_load`` corruption (at the
    second read) serves an empty history for that read only, so the third
    read recovers the surviving entry. The entries' metrics come from a
    run under an empty plan (in the reference's, a poisoned Mean leaves
    no "Mean" in the file to flip, and the drill raises)."""
    from deequ_tpu_torch.analyzers import Completeness, Mean
    from deequ_tpu_torch.repository import ResultKey
    from deequ_tpu_torch.repository.fs import FileSystemMetricsRepository, quarantined_total
    from deequ_tpu_torch.runners import AnalysisRunner

    from deequ_tpu_torch.reliability import inject

    path = os.path.join(tmpdir, "soak-repo.json")
    repo = FileSystemMetricsRepository(path)
    with inject():
        ctx = AnalysisRunner.do_analysis_run(data, [Mean("x"), Completeness("x")],
                                             device=device)
    before = quarantined_total()
    repo.save(ResultKey(1), ctx)
    repo.save(ResultKey(2), ctx)
    with open(path) as fh:
        raw = fh.read()
    i = raw.index("Mean") + 1
    with open(path, "w") as fh:
        fh.write(raw[:i] + ("X" if raw[i] != "X" else "Y") + raw[i + 1:])
    survivors = [len(repo._read_all()) for _ in range(3)]
    quarantined = quarantined_total() - before
    return {
        "survivors_per_read": survivors,
        "quarantined": quarantined,
        "ok": survivors[-1] == 1 and quarantined >= 1,
    }


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--jobs", type=int, default=30)
    parser.add_argument("--stream-batches", type=int, default=8)
    parser.add_argument("--rows", type=int, default=4096)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--workers", type=int, default=4)
    parser.add_argument("--no-cluster-drill", action="store_true",
                        help="skip the multi-process kill-one cluster drill")
    parser.add_argument("--device", default="cuda",
                        help="the service's device (default cuda; cpu runs the plain "
                             "versions of the kernels)")
    args = parser.parse_args(argv)
    summary = run_soak(
        jobs=args.jobs, stream_batches=args.stream_batches, rows=args.rows,
        seed=args.seed, workers=args.workers,
        cluster_drill=not args.no_cluster_drill, device=args.device,
    )
    print(json.dumps(summary), flush=True)
    return 0 if summary["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
