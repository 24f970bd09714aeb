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
