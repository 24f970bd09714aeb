from .analysis_runner import AnalysisRunner
from .builder import Analysis, AnalysisRunBuilder
from .context import AnalyzerContext
from .engine import RunMonitor, ScanEngine
from .exceptions import (
    EmptyStateException,
    MetricCalculationException,
    MetricCalculationPreconditionException,
    MetricCalculationRuntimeException,
    NoSuchColumnException,
    WrongColumnTypeException,
    wrap_if_necessary,
)
from .incremental import (
    DeltaPlan,
    IncrementalRunReport,
    PartitionInput,
    contract_fingerprint,
    profile_partitioned,
    run_incremental,
    suggest_partitioned,
)

__all__ = [
    "Analysis",
    "AnalysisRunBuilder",
    "AnalysisRunner",
    "AnalyzerContext",
    "DeltaPlan",
    "EmptyStateException",
    "IncrementalRunReport",
    "PartitionInput",
    "contract_fingerprint",
    "profile_partitioned",
    "run_incremental",
    "suggest_partitioned",
    "MetricCalculationException",
    "MetricCalculationPreconditionException",
    "MetricCalculationRuntimeException",
    "NoSuchColumnException",
    "RunMonitor",
    "ScanEngine",
    "WrongColumnTypeException",
    "wrap_if_necessary",
]
