"""Failure taxonomy for metric computation.

Mirrors the reference's typed exception hierarchy
(`analyzers/runners/MetricCalculationException.scala:19-78`): every analyzer
error is captured as a Failure *metric*, never an aborted run — partial
results are a feature (`analyzers/Analyzer.scala:94-103`).
"""

from __future__ import annotations


class MetricCalculationException(Exception):
    """Base for all metric-calculation failures."""


class MetricCalculationPreconditionException(MetricCalculationException):
    """Schema precondition failed before any data was scanned."""


class MetricCalculationRuntimeException(MetricCalculationException):
    """Failure while computing the metric from data."""


class NoSuchColumnException(MetricCalculationPreconditionException):
    pass


class WrongColumnTypeException(MetricCalculationPreconditionException):
    pass


class NoColumnsSpecifiedException(MetricCalculationPreconditionException):
    pass


class NumberOfSpecifiedColumnsException(MetricCalculationPreconditionException):
    pass


class IllegalAnalyzerParameterException(MetricCalculationPreconditionException):
    pass


class EmptyStateException(MetricCalculationRuntimeException):
    """All input values were null/filtered — no state to finalize."""


class DeviceFailureException(MetricCalculationRuntimeException):
    """The device tier failed for infrastructure reasons (a CUDA error, a
    lost device) rather than anything about the data or the analyzer."""


class DeviceOOMException(DeviceFailureException):
    """The device ran out of memory executing a pass."""


class PoisonedBatchException(MetricCalculationRuntimeException):
    """A specific input batch cannot be processed. Carries the batch index
    so operators can quarantine the slice."""

    def __init__(self, batch_index: int, message: str = ""):
        self.batch_index = batch_index
        super().__init__(
            f"batch {batch_index} is poisoned{': ' + message if message else ''}"
        )


class AnalyzerFaultException(MetricCalculationRuntimeException):
    """A fault attributable to ONE analyzer inside a fused battery."""


class SchemaDriftError(MetricCalculationRuntimeException):
    """A streaming micro-batch's schema drifted from the session's
    :class:`~deequ_tpu_torch.service.drift.SchemaContract` (column added,
    dropped or retyped beyond a compatible widening). Raised BEFORE the
    batch folds, so persisted states are never contaminated by
    mixed-schema merges. Carries the structured drift list."""

    def __init__(self, session: str, drifts):
        self.session = session
        self.drifts = list(drifts)
        super().__init__(
            f"schema drift in session {session}: " + "; ".join(self.drifts)
        )


class ScanStallError(DeviceFailureException):
    """A pass exceeded its watchdog deadline without finishing or failing.
    The port has no watchdog yet (ROADMAP A6); the service's scheduler
    retries this type, as the reference's does."""

    def __init__(self, site: str, deadline_s: float, waited_s: float):
        self.site = site
        self.deadline_s = deadline_s
        self.waited_s = waited_s
        super().__init__(
            f"scan watchdog: {site} pass exceeded its {deadline_s:.1f}s "
            f"deadline (waited {waited_s:.1f}s)"
        )


class ShardLossError(DeviceFailureException):
    """A shard of a device mesh was lost mid-pass: a dead device, a dead
    process of a cross-process group, or a heartbeat-declared stall. The
    surviving shards' states are mergeable by construction, so the elastic
    layer (:mod:`deequ_tpu_torch.parallel.elastic`) salvages them, rebuilds
    the mesh over the survivors one ladder rung down and resumes the fold.

    ``lost`` holds the mesh positions (indices into ``mesh.devices``)
    declared dead; ``survivors`` optionally carries the surviving devices."""

    def __init__(self, lost, site: str = "", survivors=None, detail: str = ""):
        self.lost = tuple(int(i) for i in lost)
        self.site = site
        self.survivors = None if survivors is None else list(survivors)
        super().__init__(
            f"mesh shard loss at {site or '<mesh>'}: shard(s) "
            f"{list(self.lost)} lost"
            + (f": {detail}" if detail else "")
        )


class ShardStallError(ShardLossError):
    """A shard stopped making progress (its heartbeat probe exceeded
    ``DEEQU_TPU_SHARD_HEARTBEAT_S``) without raising: declared lost after
    the probe deadline and handled exactly like a thrown shard loss."""


class MeshExhaustedError(RuntimeError):
    """No rung of the re-shard ladder fits the surviving devices. The
    elastic fold then drops to host mode, unless every shard of the mesh
    lay on one card: there this escapes it and the run fails."""


def wrap_if_necessary(exception: BaseException) -> MetricCalculationException:
    """Wrap arbitrary errors into the taxonomy
    (reference `MetricCalculationException.scala:70-78`)."""
    if isinstance(exception, MetricCalculationException):
        return exception
    wrapped = MetricCalculationRuntimeException(str(exception))
    wrapped.__cause__ = exception
    return wrapped


class CorruptStateError(MetricCalculationRuntimeException, ValueError):
    """A persisted payload (a state blob, a repository entry) failed its
    integrity check: the stored xxhash64 content checksum does not match
    the bytes read, or the payload is structurally torn. Consumers treat
    it as recoverable: a corrupt state degrades the analyzers that needed
    it to Failure metrics, a corrupt repository entry is quarantined."""

    def __init__(self, kind: str, source: str, detail: str = ""):
        self.kind = kind
        self.source = source
        super().__init__(
            f"corrupt {kind} at {source}"
            + (f": {detail}" if detail else "")
        )


class UnsupportedFormatVersionError(Exception):
    """A persisted payload (metrics-history JSON or .npz state blob) carries
    a format version this build does not understand; raised instead of
    misreading a newer layout."""

    def __init__(self, kind: str, found: int, supported: int):
        self.kind = kind
        self.found = found
        self.supported = supported
        super().__init__(
            f"{kind} format version {found} is not supported by this build "
            f"(max supported: {supported}). Upgrade deequ_tpu_torch to read this "
            f"payload, or re-materialize it with the current build."
        )
