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


class IllegalAnalyzerParameterException(MetricCalculationPreconditionException):
    pass


class EmptyStateException(MetricCalculationRuntimeException):
    """All input values were null/filtered — no state to finalize."""


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
