"""Fault injection (:mod:`.faults`) and resumable ingest checkpoints
(:mod:`.checkpoint`).

An :class:`IngestCheckpointer` persists a pass's states every ``every``
batches through a state provider; an interrupted run given a checkpointer
over the same provider resumes from the last checkpoint, on the device
tier, the host tier or a mesh (``do_analysis_run(..., checkpointer=)``,
``VerificationRunBuilder.checkpoint_with``). The reference's analyzer
isolation, tier failover and watchdog (``deequ_tpu/reliability/``) are not
ported (ROADMAP A6): in this package a device failure raises.
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

__all__ = [
    "FaultSpec", "FaultInjector", "InjectedInterrupt", "WorkerCrash",
    "inject", "install", "clear", "fault_point", "active_injector",
    "FAULTS_ENV", "FAULT_SEED_ENV",
    "IngestCheckpointer", "ResumePoint", "battery_fingerprint",
]
