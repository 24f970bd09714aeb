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


class MalformedFrameError(MetricCalculationRuntimeException, ValueError):
    """A frame on the ingestion plane failed to decode: torn Arrow IPC
    bytes, a schema message that is not a schema, or a payload whose
    declared checksum does not match the bytes received. Raised BEFORE
    anything folds, so a corrupt producer can never contaminate a
    session's persisted states — the frame is rejected typed and the
    stream position it occupied is reported for operator triage."""

    def __init__(self, source: str, detail: str = "", frame_index: int = -1):
        self.source = source
        self.frame_index = int(frame_index)
        where = f" (frame {frame_index})" if frame_index >= 0 else ""
        super().__init__(
            f"malformed ingest frame from {source}{where}"
            + (f": {detail}" if detail else "")
        )


class FeedDisconnectError(MetricCalculationRuntimeException):
    """An ingest stream ended mid-frame: the producer disconnected, the
    socket died, or the payload was truncated below its declared length.
    Frames that decoded COMPLETELY before the disconnect have already
    folded (each is one atomic micro-batch merge); the torn tail frame
    never touches state. Carries how far the stream got so a resuming
    producer knows what committed."""

    def __init__(self, source: str, frames_decoded: int = 0,
                 bytes_read: int = 0, detail: str = ""):
        self.source = source
        self.frames_decoded = int(frames_decoded)
        self.bytes_read = int(bytes_read)
        super().__init__(
            f"ingest feed from {source} disconnected mid-frame after "
            f"{frames_decoded} complete frame(s), {bytes_read} byte(s)"
            + (f": {detail}" if detail else "")
        )


class FeedStallError(DeviceFailureException):
    """The feed pipeline that stages a device pass's host-to-device copies
    (``ingest.prefetch``) stopped delivering batches: a wedged copy thread
    or a starved source. A ``DeviceFailureException``: the pipeline exists
    only on the device tier, so ``classify_failure`` fails the pass over to
    the host tier, whose chunk iteration shares none of it."""

    def __init__(self, site: str, detail: str = ""):
        self.site = site
        super().__init__(
            f"ingest feed pipeline stalled at {site}"
            + (f": {detail}" if detail else "")
        )


class ScanStallError(DeviceFailureException):
    """A device or host-tier pass exceeded its watchdog deadline without
    finishing or failing (``reliability.watchdog``). A
    ``DeviceFailureException``: ``classify_failure`` maps it to the tier
    failover (the battery re-runs on the host tier with fresh states), the
    service's placement router puts the battery on probation, and its
    scheduler retries an escaped stall."""

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


class HostLossError(ShardLossError):
    """A cluster WORKER HOST died (missed heartbeats past the TTL, or a
    cross-host collective hung past its deadline). The cluster-tier
    sibling of a mesh shard loss, and deliberately a
    :class:`ShardLossError` subclass so anything routing on the
    mesh-recoverable family treats it identically; but it names a HOST ID,
    not mesh positions: recovery is the front tier's job
    (:mod:`deequ_tpu_torch.cluster.front`: re-hash the ring range to
    survivors, re-open the dead host's sessions from the partition store,
    replay unflushed folds), not the elastic mesh ladder's."""

    def __init__(self, host: str, site: str = "", detail: str = "",
                 survivors=None):
        self.host = str(host)
        self.lost = ()
        self.site = site
        self.survivors = None if survivors is None else list(survivors)
        # bypass ShardLossError's shard-index message: a host loss names
        # a host id, and "shard(s) [] lost" would read as a no-op
        Exception.__init__(
            self,
            f"cluster host {self.host or '<host>'} lost"
            + (f" at {site}" if site else "")
            + (f": {detail}" if detail else ""),
        )


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
