"""The port's multi-process cluster soak (``tools/torch_cluster_soak.py``)
on the CPU, at the sizes of the reference's ``tests/test_cluster_soak.py``
and held to its gates: real worker PROCESSES, each a whole
``VerificationService(device="cpu")`` with an HTTP ingest endpoint, routed
by the port's front tier over one shared partition store. Marked slow, as
the reference's is (it spawns several interpreters). On the card,
``chip_smoke.py`` phase 15 runs the tool at a cluster's load with
``--device cuda``; in-process, ``tests/test_torch_cluster_migration.py``
holds the tier against the reference."""

import json
import subprocess
import sys
from pathlib import Path

import pytest

pytestmark = [pytest.mark.slow, pytest.mark.cluster]

REPO = Path(__file__).resolve().parent.parent
PLANES = ("scheduler", "tuning", "cluster", "catalog", "fleetwatch", "partition_store")


def run_soak(*args):
    out = subprocess.run(
        [sys.executable, "-m", "tools.torch_cluster_soak", *args, "--device", "cpu"],
        cwd=REPO, capture_output=True, text=True, timeout=420,
    )
    lines = [line for line in out.stdout.splitlines() if line.strip()]
    assert lines, out.stderr[-2000:]
    return out.returncode, json.loads(lines[-1])


def test_two_process_soak_bit_exact_parity():
    """Throughput across 2 worker processes with the parity gate: every
    session's final Sum and Size equal the closed-form oracle EXACTLY."""
    rc, report = run_soak("--procs", "2", "--sessions", "6", "--batches", "6", "--rows", "2048")
    assert rc == 0, report
    assert report["ok"] and not report["skipped"], report
    assert report["parity_failures"] == []
    assert report["sessions_per_s"] > 0 and report["rows_per_s"] > 0
    assert report["counters"]["deequ_service_cluster_routes_total"] == 6 * (1 + 6)
    obs = report["observability"]
    assert obs["ok"], obs
    assert obs["journals"] >= 2
    assert obs["cross_process_ingest_traces"] >= 1
    assert obs["statusz_problems"] == []
    for plane in PLANES:
        assert plane in obs["statusz_planes"]
    workers = report["workers"]
    assert sorted(workers) == ["w0", "w1"]
    assert sum(w["sessions"] for w in workers.values()) == 6
    # every fold is accounted for by a tier; nothing launches on the CPU
    folds = sum(w["device_folds"] + w["host_folds"] + w["fast_folds"] for w in workers.values())
    assert folds == 6 * 6
    assert not any(n for w in workers.values() for n in w["launches"].values())


def test_kill_one_worker_recovers_with_typed_counters():
    """The SIGKILL drill: one worker dies mid-stream; its sessions are
    re-hashed to the survivor, adopted from their last flushed partition
    and their journaled folds replayed (exact parity), and the typed
    counters prove the recovery ran."""
    rc, report = run_soak("--drill", "kill-one", "--sessions", "4", "--batches", "4",
                          "--rows", "1024")
    assert rc == 0, report
    assert report["ok"], report
    assert report["parity_failures"] == []
    assert report["recovered_hosts"] == [report["victim"]]
    for src, dst in report["rehomed"].values():
        assert src == report["victim"] and dst != src
    counters = report["counters"]
    assert counters["deequ_service_cluster_host_losses_total"] >= 1
    assert counters["deequ_service_cluster_sessions_recovered_total"] >= 1
    assert counters["deequ_service_cluster_replayed_folds_total"] >= 1
    assert report["victim_journal_spans"] >= 1
    assert 0 < report["recovery_s"] < 30
    obs = report["observability"]
    assert obs["ok"], obs
    assert obs["statusz_problems"] == []
