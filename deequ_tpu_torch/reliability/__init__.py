"""Fault injection for the streaming service (:mod:`.faults`).

The reference's analyzer isolation, tier failover, watchdog and resumable
checkpoints (``deequ_tpu/reliability/``) are not ported (ROADMAP A3, A6):
in this package a device failure raises.
"""

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
]
