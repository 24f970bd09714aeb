"""deequ_tpu_torch: "unit tests for data" on PyTorch and CUDA.

A port of ``deequ_tpu`` (JAX) to PyTorch with hand-written CUDA kernels for
Hopper GPUs. One verification run, or one pass of the column profiler,
reads the data once: per batch the host builds features, and seven kernels
reduce them on the device — ``scan_reduce`` (all scalar reductions of the
battery, DataType's class counts and Correlation's co-moments included, in
one launch),
``hll_registers`` (HLL++ registers), ``dict_code_counts`` (per-code counts
of dictionary columns), ``kll_sample`` and ``kll_compact`` (the KLL
quantile sketch's batch pre-collapse and its compaction cascade), and
``freq_keys`` and ``freq_compact`` (the frequency table of grouping sets
of any cardinality: per-row group keys, and their sort-merge into a
sorted table of counts). States persist (``analyzers/state_provider.py``,
in the JAX package's file layout), and metrics refresh from merged states
with no data pass: an eighth kernel, ``state_fold``, folds the states of
many partitions in one launch. Entry
points run on ``device="cuda"`` unless the caller passes ``device="cpu"``,
which runs the kernels' plain PyTorch versions.

The package imports neither JAX nor ``deequ_tpu``.
"""

from .analyzers import (
    ApproxCountDistinct,
    ApproxQuantile,
    ApproxQuantiles,
    Completeness,
    Compliance,
    Correlation,
    CountDistinct,
    DataType,
    Distinctness,
    Entropy,
    Histogram,
    KLLParameters,
    KLLSketch,
    Maximum,
    MaxLength,
    Mean,
    Minimum,
    MinLength,
    PatternMatch,
    Patterns,
    Size,
    StandardDeviation,
    Sum,
    Uniqueness,
    UniqueValueRatio,
)
from .checks import Check, CheckLevel, CheckStatus
from .constraints import ConstrainableDataTypes, ConstraintStatus
from .data import Dataset
from .profiles import ColumnProfiler, ColumnProfilerRunner, ColumnProfiles
from .runners import AnalysisRunner, AnalyzerContext, RunMonitor
from .verification import VerificationResult, VerificationSuite

__all__ = [
    "AnalysisRunner",
    "AnalyzerContext",
    "ApproxCountDistinct",
    "ApproxQuantile",
    "ApproxQuantiles",
    "Check",
    "CheckLevel",
    "CheckStatus",
    "ColumnProfiler",
    "ColumnProfilerRunner",
    "ColumnProfiles",
    "Completeness",
    "Compliance",
    "Correlation",
    "ConstrainableDataTypes",
    "ConstraintStatus",
    "CountDistinct",
    "DataType",
    "Dataset",
    "Distinctness",
    "Entropy",
    "Histogram",
    "KLLParameters",
    "KLLSketch",
    "MaxLength",
    "Maximum",
    "Mean",
    "MinLength",
    "Minimum",
    "PatternMatch",
    "Patterns",
    "RunMonitor",
    "Size",
    "StandardDeviation",
    "Sum",
    "Uniqueness",
    "UniqueValueRatio",
    "VerificationResult",
    "VerificationSuite",
]
