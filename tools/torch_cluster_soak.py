"""Multi-process cluster soak of the PyTorch/CUDA port: N worker PROCESSES,
one service.

    python3 -m tools.torch_cluster_soak [--procs N] [--sessions S]
        [--batches B] [--rows R] [--device cuda|cpu]
    python3 -m tools.torch_cluster_soak --drill kill-one [--sessions S]
        [--batches B] [--rows R] [--device cuda|cpu]

The port's cluster tier (``deequ_tpu_torch.cluster``) driven with real
OS-process workers: each worker runs a whole
``VerificationService(device=<--device>)`` (its scheduler, coalescer, HTTP
ingest endpoint and metrics exporter) against ONE shared partition store,
and the parent drives the real :class:`~deequ_tpu_torch.cluster.front.
FrontTier` over HTTP-fronted worker adapters: session keys route on the
consistent-hash ring, micro-batches POST as Arrow IPC to the ring-chosen
worker's ``/ingest/v1/...`` endpoint, fold boundaries flush into the store
(the session protocol travels over a file-RPC), and losses recover by
adoption plus journal replay. Workers start as fresh interpreters
(``sys.executable -m tools.torch_cluster_soak --worker I``): each opens
its own CUDA context and loads the kernels the checkout built (building
them at first use when none are built); the parent never touches the
card. ``--device`` defaults to ``cuda``; without a card pass ``--device
cpu`` (the kernels' plain versions then run).

Two modes, both printing ONE JSON line last (exit 0 = pass, 1 = the
verdict failed, 2 = the environment cannot run the scenario: skipped):

- **throughput** (the default): S sessions stream B exact-sum batches
  each, concurrently, across N worker processes. Reports
  ``sessions_per_s`` and ``rows_per_s`` and gates on PARITY: every
  session's final Sum and Size equal the closed-form oracle EXACTLY
  (integer-valued float64 data below 2**53 makes the sums independent of
  fold order; a configuration whose sums could reach 2**53 is refused).
- **kill-one drill** (``--drill kill-one``): sessions stream and flush
  mid-window, then the parent SIGKILLs one worker. The membership scan
  declares it lost, the ring re-hashes to the survivor, every orphaned
  session is adopted from its last flushed partition and the journaled
  folds replay. The verdict asserts exact parity, the typed
  ``deequ_service_cluster_*`` counters that prove recovery ran, and a
  non-empty span journal of the VICTIM (a SIGKILLed worker still leaves
  its worker-side spans behind). ``recovery_s`` runs from the SIGKILL to
  the last replayed fold.

Both modes run with the observability plane on: every process journals
its spans (``DEEQU_TPU_TRACE_JOURNAL``), the trace context rides the
file-RPC (``trace`` field) and the Arrow ingest wire (``X-Deequ-Trace``),
and after the run the per-host journals merge into ONE Perfetto trace
(``merged.trace.json``). The verdict requires a cross-process ingest
trace (a trace_id whose front-side ``cluster_ingest`` span and worker-side
spans live in different journals) and a worker's ``/statusz`` that
validates with all six ops planes present.

Every worker's ``stats`` reply also carries its kernel launches
(``deequ_tpu_torch.kernels.launch_counts()``; real launches only, so
all 0 on the CPU) and its folds by tier: device-tier folds (coalesced
launches and device-tier passes), host-tier folds and fast-path folds.
The report lists them per worker (``workers``), and the drill the
survivor's launches after the recovery (``survivor_launches_after_
recovery``), so that a run on the card shows which kernels its folds
ran. A worker runs its battery once on its device before it takes traffic,
so its first fold is not charged the context's start-up and the kernels'
load in the coalescer's crossover model. The coalescer's host fast path
takes the soak battery's folds below that model's crossover (about
143,000 rows at its static seeds: three analyzers at 2e7 rows/s against
20 ms of fixed device cost); rows above it reach the device.
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import subprocess
import sys
import tempfile
import threading
import time
from collections import Counter

DEFAULT_SESSIONS = 8
DEFAULT_BATCHES = 8
DEFAULT_ROWS = 4_096
WORKER_BOOT_TIMEOUT_S = 180.0
CTL_TIMEOUT_S = 300.0
#: the distance between two sessions' value ranges
SESSION_STRIDE = 100_000_000
#: float64 holds every integer below this exactly
EXACT_LIMIT = 2 ** 53


# --------------------------------------------------------------------------
# shared: the exact-sum battery and deterministic per-session data
# --------------------------------------------------------------------------

def _battery_checks():
    from deequ_tpu_torch.checks import Check, CheckLevel

    return [
        Check(CheckLevel.ERROR, "cluster-soak")
        .is_complete("v")
        .has_size(lambda n: n > 0)
    ]


def _required_analyzers():
    from deequ_tpu_torch.analyzers import Sum

    return [Sum("v")]


def _batch_values(session_index: int, batch_index: int, rows: int):
    """Integer-valued float64s, unique per (session, batch): sums are
    EXACT in any fold order (every partial sum below 2**53), which is what
    lets the parity gate demand bit-equality across process counts."""
    import numpy as np

    base = session_index * SESSION_STRIDE + batch_index * rows
    return np.arange(base, base + rows, dtype=np.float64)


def _oracle(session_index: int, batches: int, rows: int) -> dict:
    total = 0
    for b in range(batches):
        base = session_index * SESSION_STRIDE + b * rows
        total += (2 * base + rows - 1) * rows // 2
    return {"sum": float(total), "size": float(batches * rows)}


def _check_exact(sessions: int, batches: int, rows: int) -> None:
    """Refuse a configuration whose sums could leave float64's exact
    integers (the parity gate would then hold rounding to fold order)."""
    if batches * rows > SESSION_STRIDE:
        raise ValueError(f"{batches} x {rows} rows overlap the next session's values")
    largest = (sessions - 1) * SESSION_STRIDE + batches * rows
    if largest * batches * rows >= EXACT_LIMIT:
        raise ValueError(
            f"{sessions} sessions x {batches} x {rows} rows: a session's sum can reach "
            f"2**53, where float64 sums stop being exact in every fold order"
        )


def _session_key(i: int):
    return (f"tenant-{i % 4}", f"stream-{i}")


# --------------------------------------------------------------------------
# worker process
# --------------------------------------------------------------------------

def _count_fold_tiers(service) -> Counter:
    """Tally the tier of every fold the service finishes. The scheduler
    reports each finished job's resolved placement to the router's
    ``note_ran`` ("device" for a device-tier pass or a coalesced launch,
    "host" for a host-tier pass, None for a fast-path fold)."""
    tally: Counter = Counter()
    note_ran = service.router.note_ran

    def counting(signature, worker_id, placement=None):
        tally[placement] += 1
        note_ran(signature, worker_id, placement)

    service.router.note_ran = counting
    return tally


def _warm(device: str, rows: int) -> None:
    """Run the battery once on ``device``, outside the service: the CUDA
    context, the kernels' libraries and the battery's program are then
    ready before the first fold is timed."""
    import pyarrow as pa

    from deequ_tpu_torch.data import Dataset
    from deequ_tpu_torch.verification import VerificationSuite

    table = pa.table({"v": _batch_values(0, 0, rows)})
    (VerificationSuite.on_data(Dataset.from_arrow(table), device=device)
     .add_checks(_battery_checks()).add_required_analyzers(_required_analyzers())
     .with_placement("device").run())


def run_worker(worker_id: int, run_dir: str, device: str, rows: int) -> None:
    """One cluster worker process: a full service plane and a file-RPC
    control loop. The control files (``ctl/<host>-<seq>.json`` ->
    ``ack/<same>.json``) carry the session protocol the HTTP ingest
    endpoint does not: open / adopt / flush / release / stats / stop."""
    from deequ_tpu_torch import kernels
    from deequ_tpu_torch.cluster import HeartbeatMembership, LocalWorker
    from deequ_tpu_torch.service import VerificationService

    host_id = f"w{worker_id}"
    store_root = os.path.join(run_dir, "store")
    _warm(device, rows)
    kernels.reset_launch_counts()
    service = VerificationService(
        workers=2, background_warm=False, partition_store=store_root, device=device
    )
    tiers = _count_fold_tiers(service)
    exporter = service.start_exporter("127.0.0.1", 0)
    membership = HeartbeatMembership(os.path.join(run_dir, "hb"), host_id=host_id,
                                     heartbeat_period_s=0.2)
    worker = LocalWorker(host_id, service, membership=membership)
    worker.start()

    port_path = os.path.join(run_dir, f"port-{host_id}.json")
    with open(port_path + ".tmp", "w", encoding="utf-8") as fh:
        fh.write(json.dumps({"port": exporter.port, "pid": os.getpid()}))
    os.replace(port_path + ".tmp", port_path)

    ctl_dir = os.path.join(run_dir, "ctl")
    ack_dir = os.path.join(run_dir, "ack")
    os.makedirs(ctl_dir, exist_ok=True)
    os.makedirs(ack_dir, exist_ok=True)

    def session_values(tenant: str, dataset: str) -> dict:
        session = service.get_session(tenant, dataset)
        if session is None:
            return {}
        res = session.current()
        out = {str(a): float(m.value.get()) for a, m in res.metrics.items()}
        out["_batches"] = float(session.batches_ingested)
        out["_rows"] = float(session.rows_ingested)
        return out

    def worker_stats() -> dict:
        return {
            "launches": kernels.launch_counts(),
            "device_folds": tiers["device"],
            "host_folds": tiers["host"],
            "fast_folds": int(service.metrics.counter_value(
                "deequ_service_fast_path_folds_total")),
        }

    def handle(op: dict) -> dict:
        kind = op["op"]
        tenant, dataset = op.get("tenant", ""), op.get("dataset", "")
        # the file-RPC carries the front tier's serialized trace context:
        # the worker-side protocol span parents into the front's trace,
        # one trace_id across the process hop
        trace = op.get("trace")
        if kind == "open":
            worker.open_session(tenant, dataset, _battery_checks(), trace_ctx=trace,
                                required_analyzers=_required_analyzers())
            return {"ok": True}
        if kind == "adopt":
            worker.adopt_session(tenant, dataset, _battery_checks(),
                                 partition=op.get("partition") or None, trace_ctx=trace,
                                 required_analyzers=_required_analyzers())
            return {"ok": True}
        if kind == "flush":
            return {"ok": True, "partition": worker.flush(tenant, dataset, trace_ctx=trace)}
        if kind == "release":
            return {"ok": True, "partition": worker.release(tenant, dataset, trace_ctx=trace)}
        if kind == "stats":
            return {"ok": True, "values": session_values(tenant, dataset),
                    "worker": worker_stats()}
        if kind == "stop":
            return {"ok": True, "stopping": True}
        return {"ok": False, "error": f"unknown op {kind!r}"}

    idle_deadline = time.monotonic() + 600
    prefix = f"{host_id}-"
    while time.monotonic() < idle_deadline:
        handled = False
        try:
            names = sorted(os.listdir(ctl_dir))
        except OSError:
            names = []
        for name in names:
            if not name.startswith(prefix) or not name.endswith(".json"):
                continue
            path = os.path.join(ctl_dir, name)
            try:
                with open(path, encoding="utf-8") as fh:
                    op = json.load(fh)
            except (OSError, ValueError):
                continue  # mid-write; the next poll sees the whole file
            try:
                result = handle(op)
            except Exception as exc:  # noqa: BLE001 - reported to the parent
                result = {"ok": False, "error": repr(exc)}
            ack = os.path.join(ack_dir, name)
            with open(ack + ".tmp", "w", encoding="utf-8") as fh:
                fh.write(json.dumps(result))
            os.replace(ack + ".tmp", ack)
            os.unlink(path)
            handled = True
            idle_deadline = time.monotonic() + 600
            if result.get("stopping"):
                worker.close(wait=False)
                os._exit(0)  # noqa: SLF001 - fast teardown by design
        if not handled:
            time.sleep(0.02)
    os._exit(0)  # noqa: SLF001 - the parent went away


# --------------------------------------------------------------------------
# parent: an HTTP-fronted worker adapter speaking the LocalWorker protocol
# --------------------------------------------------------------------------

class HttpWorker:
    """The front tier's view of a REMOTE worker process: the
    :class:`~deequ_tpu_torch.cluster.worker.LocalWorker` protocol over the
    worker's HTTP ingest endpoint (the data plane) and the file-RPC
    control files (the session plane). Checks live worker-side; the spec
    arguments the front tier forwards are ignored here by design."""

    def __init__(self, host_id: str, run_dir: str, port: int, pid: int):
        self.host_id = host_id
        self.run_dir = run_dir
        self.port = port
        self.pid = pid
        self._seq = 0
        self._seq_lock = threading.Lock()

    def start(self) -> None:  # heartbeats run worker-side
        pass

    def _ctl(self, op: str, timeout_s: float = CTL_TIMEOUT_S, **fields):
        with self._seq_lock:
            self._seq += 1
            name = f"{self.host_id}-{self._seq:06d}.json"
        ctl = os.path.join(self.run_dir, "ctl", name)
        ack = os.path.join(self.run_dir, "ack", name)
        with open(ctl + ".tmp", "w", encoding="utf-8") as fh:
            fh.write(json.dumps({"op": op, **fields}))
        os.replace(ctl + ".tmp", ctl)
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            if os.path.exists(ack):
                try:
                    with open(ack, encoding="utf-8") as fh:
                        result = json.load(fh)
                except (OSError, ValueError):
                    time.sleep(0.02)
                    continue
                os.unlink(ack)
                if not result.get("ok"):
                    raise RuntimeError(f"{self.host_id} {op} failed: {result.get('error')}")
                return result
            time.sleep(0.02)
        raise TimeoutError(f"{self.host_id} did not ack {op}")

    def open_session(self, tenant, dataset, checks=(), trace_ctx=None, **kw):
        self._ctl("open", tenant=tenant, dataset=dataset, trace=trace_ctx)

    def adopt_session(self, tenant, dataset, checks=(), partition=None, trace_ctx=None, **kw):
        self._ctl("adopt", tenant=tenant, dataset=dataset, partition=partition, trace=trace_ctx)

    def flush(self, tenant, dataset, partition=None, trace_ctx=None):
        return self._ctl("flush", tenant=tenant, dataset=dataset,
                         trace=trace_ctx).get("partition")

    def release(self, tenant, dataset, trace_ctx=None):
        return self._ctl("release", tenant=tenant, dataset=dataset,
                         trace=trace_ctx).get("partition")

    def stats(self, tenant, dataset) -> dict:
        return self._ctl("stats", tenant=tenant, dataset=dataset).get("values", {})

    def worker_stats(self) -> dict:
        """Kernel launches and folds by tier since the worker booted."""
        return self._ctl("stats").get("worker", {})

    def statusz(self) -> dict:
        import urllib.request

        url = f"http://127.0.0.1:{self.port}/statusz"
        with urllib.request.urlopen(url, timeout=30) as resp:
            return json.loads(resp.read())

    def ingest(self, tenant, dataset, data, trace_ctx=None, **kw):
        import http.client

        import pyarrow as pa

        from deequ_tpu_torch.ingest.arrow_stream import encode_ipc_stream
        from deequ_tpu_torch.observability.trace import TRACE_HEADER

        body = encode_ipc_stream(pa.table(data))
        headers = {"Content-Length": str(len(body))}
        if trace_ctx:
            # the Arrow data plane carries the trace too: the worker's
            # ingest_request span joins the front's trace_id
            headers[TRACE_HEADER] = trace_ctx
        conn = http.client.HTTPConnection("127.0.0.1", self.port, timeout=CTL_TIMEOUT_S)
        try:
            conn.request("POST", f"/ingest/v1/{tenant}/{dataset}", body=body, headers=headers)
            resp = conn.getresponse()
            payload = resp.read()
            if resp.status != 200:
                raise RuntimeError(f"ingest on {self.host_id} -> {resp.status}: "
                                   f"{payload[:200]!r}")
            return json.loads(payload)
        finally:
            conn.close()

    def close(self, **kw) -> None:
        try:
            self._ctl("stop", timeout_s=10)
        except (RuntimeError, TimeoutError, OSError):
            pass
        try:
            os.kill(self.pid, signal.SIGKILL)
        except OSError:
            pass


# --------------------------------------------------------------------------
# parent orchestration
# --------------------------------------------------------------------------

def _journal_dir(run_dir: str) -> str:
    return os.path.join(run_dir, "journal")


def _enable_front_journal(run_dir: str) -> None:
    """Journal the PARENT's spans (the front tier runs in this process)
    beside the workers': the merged trace needs both halves of every hop.
    Must run before the first front-tier span finishes (the flight
    recorder reads the env once, lazily)."""
    os.makedirs(_journal_dir(run_dir), exist_ok=True)
    os.environ["DEEQU_TPU_TRACE_JOURNAL"] = _journal_dir(run_dir)
    os.environ["DEEQU_TPU_TRACE_HOST"] = "front"


def _spawn_cluster(procs: int, run_dir: str, device: str, rows: int):
    """Spawn the worker processes; returns (popen list, HttpWorker list)
    or raises TimeoutError when the environment cannot boot them."""
    os.makedirs(os.path.join(run_dir, "ctl"), exist_ok=True)
    os.makedirs(os.path.join(run_dir, "ack"), exist_ok=True)
    os.makedirs(_journal_dir(run_dir), exist_ok=True)
    env = dict(os.environ)
    env["DEEQU_TPU_TRACE_JOURNAL"] = _journal_dir(run_dir)
    logs = []
    children = []
    for i in range(procs):
        # stderr to a file: a worker's log must never fill a pipe nobody
        # reads while it runs
        log = open(os.path.join(run_dir, f"worker-w{i}.log"), "wb")
        logs.append(log)
        children.append(subprocess.Popen(
            [sys.executable, "-m", "tools.torch_cluster_soak", "--worker", str(i),
             "--dir", run_dir, "--device", device, "--rows", str(rows)],
            stdout=subprocess.DEVNULL, stderr=log,
            env={**env, "DEEQU_TPU_TRACE_HOST": f"w{i}"},
            cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        ))
    for log in logs:
        log.close()
    workers = []
    deadline = time.monotonic() + WORKER_BOOT_TIMEOUT_S
    for i in range(procs):
        host_id = f"w{i}"
        port_path = os.path.join(run_dir, f"port-{host_id}.json")
        while not os.path.exists(port_path):
            if time.monotonic() > deadline or children[i].poll() is not None:
                if children[i].poll() is not None:
                    with open(os.path.join(run_dir, f"worker-{host_id}.log"), "rb") as fh:
                        detail = fh.read().decode(errors="replace")[-400:]
                else:
                    detail = "boot timeout"
                raise TimeoutError(f"worker {host_id} never came up: {detail}")
            time.sleep(0.05)
        with open(port_path, encoding="utf-8") as fh:
            boot = json.load(fh)
        workers.append(HttpWorker(host_id, run_dir, boot["port"], boot["pid"]))
    return children, workers


def _build_front(workers, run_dir: str, ttl_s: float = 2.0):
    from deequ_tpu_torch.cluster import FrontTier, HeartbeatMembership

    front = FrontTier(membership=HeartbeatMembership(os.path.join(run_dir, "hb"), ttl_s=ttl_s))
    for worker in workers:
        front.add_worker(worker)
    return front


def _parity(front, sessions: int, batches: int, rows: int):
    """Hold every session's final metrics to the closed-form oracle,
    EXACTLY (integer-valued sums are independent of fold order)."""
    failures = []
    for i in range(sessions):
        tenant, dataset = _session_key(i)
        host = front.placement(tenant, dataset)
        values = front.workers[host].stats(tenant, dataset)
        want = _oracle(i, batches, rows)
        got_sum = next((v for k, v in values.items() if k.startswith("Sum(")), None)
        got_size = next((v for k, v in values.items() if k.startswith("Size(")), None)
        if got_sum != want["sum"] or got_size != want["size"]:
            failures.append({
                "session": f"{tenant}/{dataset}", "host": host,
                "got_sum": got_sum, "want_sum": want["sum"],
                "got_size": got_size, "want_size": want["size"],
            })
    return failures


def _counters(front) -> dict:
    names = [
        "deequ_service_cluster_routes_total",
        "deequ_service_cluster_migrations_total",
        "deequ_service_cluster_host_losses_total",
        "deequ_service_cluster_ring_moves_total",
        "deequ_service_cluster_sessions_recovered_total",
        "deequ_service_cluster_replayed_folds_total",
    ]
    return {n: front.metrics.counter_value(n) for n in names}


def _held_sessions(front, sessions: int) -> dict:
    """Sessions placed on each live host."""
    held = Counter(front.placement(*_session_key(i)) for i in range(sessions))
    return {host: held.get(host, 0) for host in sorted(front.workers)}


def _observability_verdict(run_dir: str, worker) -> dict:
    """The cross-process assertions, evaluated from artifacts: merge every
    per-host span journal into ONE Perfetto trace, demand at least one
    ingest whose front-side ``cluster_ingest`` span and worker-side spans
    share a trace_id across journals, and validate a live worker's
    ``/statusz`` (all six ops planes)."""
    import glob

    from deequ_tpu_torch.observability.export import load_journal, merge_journals
    from deequ_tpu_torch.service.statusz import validate_statusz

    journals = sorted(glob.glob(os.path.join(_journal_dir(run_dir), "spans-*.jsonl")))
    merged_path = None
    front_ingest = set()
    worker_traces = {}
    hosts_by_trace = {}
    if journals:
        merged_path = os.path.join(run_dir, "merged.trace.json")
        merge_journals(journals, out_path=merged_path)
        for path in journals:
            header, spans, _skipped = load_journal(path)
            host = header.get("host") or os.path.basename(path)
            for s in spans:
                tid = s.get("trace_id")
                if not tid:
                    continue
                hosts_by_trace.setdefault(tid, set()).add(host)
                if host == "front" and s.get("name") == "cluster_ingest":
                    front_ingest.add(tid)
                elif host != "front":
                    worker_traces.setdefault(tid, set()).add(host)
    cross = [t for t, h in hosts_by_trace.items() if len(h) >= 2]
    cross_ingest = [t for t in front_ingest if worker_traces.get(t)]

    problems = []
    planes = []
    try:
        doc = worker.statusz()
        problems = validate_statusz(doc)
        planes = sorted(doc.get("planes") or {})
    except Exception as exc:  # noqa: BLE001 - reported in the verdict
        problems = [f"statusz fetch failed: {exc!r}"]
    return {
        "ok": bool(cross_ingest) and not problems,
        "journals": len(journals),
        "merged_trace": merged_path,
        "cross_process_traces": len(cross),
        "cross_process_ingest_traces": len(cross_ingest),
        "statusz_planes": planes,
        "statusz_problems": problems,
    }


def _skipped(exc: BaseException) -> int:
    print(json.dumps({"ok": False, "skipped": True, "reason": str(exc)}))
    return 2


def _reap(children) -> None:
    for child in children:
        if child.poll() is None:
            child.kill()
        child.wait()


def run_throughput(procs: int, sessions: int, batches: int, rows: int, device: str) -> int:
    from concurrent.futures import ThreadPoolExecutor

    _check_exact(sessions, batches, rows)
    run_dir = tempfile.mkdtemp(prefix="torch-cluster-soak-")
    _enable_front_journal(run_dir)
    children = []
    try:
        try:
            children, workers = _spawn_cluster(procs, run_dir, device, rows)
        except (TimeoutError, OSError) as exc:
            return _skipped(exc)
        front = _build_front(workers, run_dir)
        for i in range(sessions):
            front.open_session(*_session_key(i))

        def drive(i: int):
            tenant, dataset = _session_key(i)
            for b in range(batches):
                front.ingest(tenant, dataset, {"v": _batch_values(i, b, rows)})

        started = time.monotonic()
        with ThreadPoolExecutor(max_workers=sessions) as pool:
            for future in [pool.submit(drive, i) for i in range(sessions)]:
                future.result()
        elapsed = time.monotonic() - started

        front.flush_all()
        failures = _parity(front, sessions, batches, rows)
        obs = _observability_verdict(run_dir, workers[0])
        held = _held_sessions(front, sessions)
        report = {
            "ok": not failures and obs["ok"], "skipped": False,
            "mode": "throughput", "device": device,
            "procs": procs, "sessions": sessions, "batches": batches,
            "rows": rows, "elapsed_s": elapsed,
            "sessions_per_s": sessions / elapsed,
            "folds_per_s": sessions * batches / elapsed,
            "rows_per_s": sessions * batches * rows / elapsed,
            "parity_failures": failures,
            "counters": _counters(front),
            "observability": obs,
            "workers": {w.host_id: {"sessions": held[w.host_id], **w.worker_stats()}
                        for w in workers},
        }
        front.close()
        print(json.dumps(report))
        return 0 if report["ok"] else 1
    finally:
        _reap(children)


def _journal_spans(run_dir: str, host: str) -> int:
    try:
        with open(os.path.join(_journal_dir(run_dir), f"spans-{host}.jsonl"),
                  encoding="utf-8") as fh:
            return sum(1 for line in fh if '"span_id"' in line)
    except OSError:
        return 0


def run_kill_one(sessions: int, batches: int, rows: int, device: str) -> int:
    _check_exact(sessions, batches, rows)
    run_dir = tempfile.mkdtemp(prefix="torch-cluster-drill-")
    _enable_front_journal(run_dir)
    children = []
    try:
        try:
            children, workers = _spawn_cluster(2, run_dir, device, rows)
        except (TimeoutError, OSError) as exc:
            return _skipped(exc)
        front = _build_front(workers, run_dir, ttl_s=1.5)
        for i in range(sessions):
            front.open_session(*_session_key(i))

        half = max(1, batches // 2)
        for i in range(sessions):
            tenant, dataset = _session_key(i)
            for b in range(half):
                front.ingest(tenant, dataset, {"v": _batch_values(i, b, rows)})
            # fold boundary: states and contract reach the shared store and
            # the journal clears; the victim's folds survive by this
            front.flush(tenant, dataset)
        for i in range(sessions):
            tenant, dataset = _session_key(i)
            for b in range(half, batches):
                front.ingest(tenant, dataset, {"v": _batch_values(i, b, rows)})

        placements_before = {_session_key(i): front.placement(*_session_key(i))
                             for i in range(sessions)}
        victim = sorted(set(placements_before.values()))[0]
        victim_sessions = [k for k, h in placements_before.items() if h == victim]
        survivor = next(w for w in workers if w.host_id != victim)
        survivor_before = survivor.worker_stats()
        killed_at = time.monotonic()
        os.kill(front.workers[victim].pid, signal.SIGKILL)

        # wait out the heartbeat TTL, then let the membership sweep find
        # the corpse and run the recovery (ring re-hash, adopt, replay)
        deadline = time.monotonic() + 30
        recovered = []
        while time.monotonic() < deadline and not recovered:
            time.sleep(0.3)
            recovered = front.check_membership()
        # SIGKILL -> every orphaned session adopted and replayed (the
        # replay is synchronous in the sweep); the heartbeat TTL, the
        # detection floor, dominates it
        recovery_s = time.monotonic() - killed_at
        survivor_after = survivor.worker_stats()

        moved = {f"{k[0]}/{k[1]}": [placements_before[k], front.placement(*k)]
                 for k in victim_sessions}
        failures = _parity(front, sessions, batches, rows)
        counters = _counters(front)
        # the worker-side flight dump: a SIGKILLed worker cannot export,
        # but its line-buffered span journal survives the kill
        victim_spans = _journal_spans(run_dir, victim)
        obs = _observability_verdict(run_dir, survivor)
        ok = (
            not failures
            and recovered == [victim]
            and all(src != dst for src, dst in moved.values())
            and counters["deequ_service_cluster_host_losses_total"] >= 1
            and counters["deequ_service_cluster_sessions_recovered_total"] >= len(victim_sessions)
            and counters["deequ_service_cluster_replayed_folds_total"] >= len(victim_sessions)
            and victim_spans >= 1
            and obs["ok"]
        )
        before_launches = survivor_before.get("launches", {})
        report = {
            "ok": ok, "skipped": False, "mode": "kill-one", "device": device,
            "sessions": sessions, "batches": batches, "rows": rows,
            "victim": victim, "recovered_hosts": recovered,
            "victim_sessions": len(victim_sessions), "rehomed": moved,
            "recovery_s": recovery_s,
            "parity_failures": failures, "counters": counters,
            "victim_journal_spans": victim_spans,
            "observability": obs,
            "survivor": survivor.host_id,
            "survivor_before_kill": survivor_before,
            "survivor_after_recovery": survivor_after,
            "survivor_launches_after_recovery": {
                name: n - before_launches.get(name, 0)
                for name, n in survivor_after.get("launches", {}).items()
            },
        }
        front.close()
        print(json.dumps(report))
        return 0 if ok else 1
    finally:
        _reap(children)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--worker", type=int, default=None, help=argparse.SUPPRESS)
    parser.add_argument("--dir", default=None, help=argparse.SUPPRESS)
    parser.add_argument("--procs", type=int, default=2)
    parser.add_argument("--sessions", type=int, default=DEFAULT_SESSIONS)
    parser.add_argument("--batches", type=int, default=DEFAULT_BATCHES)
    parser.add_argument("--rows", type=int, default=DEFAULT_ROWS)
    parser.add_argument("--device", default="cuda", help="the workers' device (default cuda)")
    parser.add_argument("--drill", choices=["kill-one"], default=None)
    args = parser.parse_args()

    if args.worker is not None:
        run_worker(args.worker, args.dir, args.device, args.rows)
        return 0
    if args.drill == "kill-one":
        return run_kill_one(args.sessions, args.batches, args.rows, args.device)
    return run_throughput(args.procs, args.sessions, args.batches, args.rows, args.device)


if __name__ == "__main__":
    sys.exit(main())
