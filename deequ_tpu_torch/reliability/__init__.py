"""Fault tolerance for the verification engine (the reference's
``deequ_tpu/reliability/``, ported):

- :mod:`.faults`: deterministic, seeded fault injection at named engine
  and service sites (``fault_point``), so every recovery path below is
  exercised on demand;
- :mod:`.isolation`: analyzer isolation by battery bisection (exactly the
  faulty analyzers degrade to typed ``Failure`` metrics), the device to
  host tier failover for device failures (a CUDA error, a stall), OOM
  batch bisection and the pass-level re-shard of a mesh after an escaped
  shard loss; a fault of the package's own kernels raises instead;
- :mod:`.checkpoint`: resumable ingest: a pass's states persist every
  ``every`` batches through a state provider, and an interrupted run
  given a checkpointer over the same provider resumes from the last
  checkpoint, on the device tier, the host tier or a mesh
  (``do_analysis_run(..., checkpointer=)``,
  ``VerificationRunBuilder.checkpoint_with``);
- :mod:`.watchdog`: deadline monitoring for device and host passes: a
  pass that HANGS (rather than throws) is abandoned with a typed
  ``ScanStallError``, stops at its next batch boundary, and its battery
  takes the same failover and placement probation as a thrown device
  fault.
"""

from .checkpoint import (
    IngestCheckpointer,
    ResumePoint,
    battery_fingerprint,
)
from .faults import (
    FAULT_SEED_ENV,
    FAULTS_ENV,
    FaultInjector,
    FaultSpec,
    InjectedInterrupt,
    WorkerCrash,
    active_injector,
    clear,
    fault_point,
    inject,
    install,
)
from .isolation import (
    ResilientScanOutcome,
    classify_failure,
    run_scan_resilient,
)
from .watchdog import (
    SCAN_DEADLINE_ENV,
    RateTracker,
    failover_pass,
    join_abandoned_passes,
    rate_key,
    rate_tracker,
    run_with_deadline,
    scan_deadline_s,
)

__all__ = [
    "FaultSpec", "FaultInjector", "InjectedInterrupt", "WorkerCrash",
    "inject", "install", "clear", "fault_point", "active_injector",
    "FAULTS_ENV", "FAULT_SEED_ENV",
    "IngestCheckpointer", "ResumePoint", "battery_fingerprint",
    "ResilientScanOutcome", "classify_failure", "run_scan_resilient",
    "SCAN_DEADLINE_ENV", "RateTracker", "rate_tracker",
    "run_with_deadline", "scan_deadline_s", "rate_key", "join_abandoned_passes",
    "failover_pass",
]
