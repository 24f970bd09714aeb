"""Horizontal scale-out tier: N worker processes, one service (the
reference's ``deequ_tpu/cluster/``).

The single-host service plane (``deequ_tpu_torch.service``) is complete
per host: scheduler, coalescer, placement, drift, export. This package
makes MANY of those hosts act as one service:

- :mod:`~deequ_tpu_torch.cluster.ring`: consistent-hash routing of session
  keys with virtual nodes; membership changes move ~1/N of the keys, and
  every front-tier replica (of either package) routes identically;
- :mod:`~deequ_tpu_torch.cluster.worker`: the per-host worker protocol
  (open / ingest / flush / release / adopt) over a whole
  VerificationService on its device; adoption resumes a session from the
  shared partition store, contract and all;
- :mod:`~deequ_tpu_torch.cluster.membership`: file-heartbeat liveness with
  a typed :class:`~deequ_tpu_torch.exceptions.HostLossError`;
- :mod:`~deequ_tpu_torch.cluster.front`: the routing, migration and
  recovery brain: sessions move hosts only at fold boundaries (flush on
  the old host, adopt on the new, through the partition store), and a
  lost host's sessions recover as salvage from the store plus journal
  replay, exactly;
- the multi-writer partition store is fenced by the compaction lease
  (:mod:`deequ_tpu_torch.repository.lease`): appends are lock-free atomic
  renames from any host, compaction is elected.

The multi-process drill is ``tools/torch_cluster_soak.py``.
"""

from __future__ import annotations

from .front import (
    CLUSTER_JOURNAL_MAX_FOLDS_ENV,
    DEFAULT_CLUSTER_JOURNAL_MAX_FOLDS,
    FrontTier,
    cluster_journal_max_folds,
)
from .membership import (
    DEFAULT_HEARTBEAT_S,
    DEFAULT_HOST_TTL_S,
    HEARTBEAT_ENV,
    HOST_TTL_ENV,
    HeartbeatMembership,
    HostLossError,
    heartbeat_s,
    host_ttl_s,
)
from .ring import DEFAULT_VNODES, VNODES_ENV, HashRing, ring_vnodes
from .worker import LocalWorker, session_partition

__all__ = [
    "CLUSTER_JOURNAL_MAX_FOLDS_ENV",
    "DEFAULT_CLUSTER_JOURNAL_MAX_FOLDS",
    "DEFAULT_HEARTBEAT_S",
    "DEFAULT_HOST_TTL_S",
    "DEFAULT_VNODES",
    "HEARTBEAT_ENV",
    "HOST_TTL_ENV",
    "VNODES_ENV",
    "FrontTier",
    "HashRing",
    "HeartbeatMembership",
    "HostLossError",
    "LocalWorker",
    "cluster_journal_max_folds",
    "describe_cluster_series",
    "heartbeat_s",
    "host_ttl_s",
    "ring_vnodes",
    "session_partition",
]


def describe_cluster_series(metrics) -> None:
    """Register help text for the cluster tier's counter series on a
    :class:`~deequ_tpu_torch.service.metrics.ServiceMetrics` (deliberately
    unrolled literal calls: the export-plane convention that keeps every
    exported name greppable)."""
    metrics.describe(
        "deequ_service_cluster_routes_total",
        "Session-key routing decisions made by the front tier's hash ring.",
    )
    metrics.describe(
        "deequ_service_cluster_migrations_total",
        "Sessions legally moved between hosts at fold boundaries "
        "(flush-on-old / adopt-on-new through the partition store).",
    )
    metrics.describe(
        "deequ_service_cluster_host_losses_total",
        "Worker hosts declared lost (missed heartbeats past the TTL or "
        "an injected host_loss fault).",
    )
    metrics.describe(
        "deequ_service_cluster_ring_moves_total",
        "Session keys whose ring arc re-homed across membership changes.",
    )
    metrics.describe(
        "deequ_service_cluster_sessions_recovered_total",
        "Sessions re-opened on a survivor after a host loss (adopted "
        "from the partition store).",
    )
    metrics.describe(
        "deequ_service_cluster_replayed_folds_total",
        "Journaled folds replayed into recovered sessions (the window "
        "between the dead host's last flush and its loss).",
    )
    metrics.describe(
        "deequ_service_cluster_journal_flushes_total",
        "Force-flushes triggered by a session's replay journal reaching "
        "DEEQU_TPU_CLUSTER_JOURNAL_MAX_FOLDS payloads (bounds replay "
        "memory for producers that never flush).",
    )
