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
many partitions in one launch. Constraint suggestion
(``deequ_tpu_torch.suggestions``) profiles a training split and verifies
the suggested check on the rest through the same passes. Entry
points run on ``device="cuda"`` unless the caller passes ``device="cpu"``,
which runs the kernels' plain PyTorch versions.

The top level exports the reference's public names (``deequ_tpu``'s
``__all__``) and its ``__version__``, so code moves between the packages
by changing the package name and adding ``device=``. The package imports
neither JAX nor ``deequ_tpu``.
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
    MutualInformation,
    PatternMatch,
    Patterns,
    Size,
    StandardDeviation,
    Sum,
    Uniqueness,
    UniqueValueRatio,
)
from . import observability  # noqa: F401  (tracing and the flight recorder)
from .checks import Check, CheckLevel, CheckStatus
from .constraints import ConstrainableDataTypes, ConstraintStatus
from .data import ColumnKind, Dataset, Schema
from .metrics import (
    BucketDistribution,
    BucketValue,
    Distribution,
    DistributionValue,
    DoubleMetric,
    Entity,
    Failure,
    HistogramMetric,
    KeyedDoubleMetric,
    KLLMetric,
    Metric,
    Success,
)
from .profiles import ColumnProfiler, ColumnProfilerRunner, ColumnProfiles
from .repository import (
    AnalysisResult,
    FileSystemMetricsRepository,
    InMemoryMetricsRepository,
    MetricsRepository,
    ResultKey,
)
from .runners import AnalysisRunner, AnalyzerContext, RunMonitor
from .verification import (
    AnomalyCheckConfig,
    VerificationResult,
    VerificationRunBuilder,
    VerificationSuite,
)

#: the reference's version: the port follows its public surface
__version__ = "0.1.0"

__all__ = [
    "AnalysisResult",
    "AnalysisRunner",
    "AnalyzerContext",
    "AnomalyCheckConfig",
    "ApproxCountDistinct",
    "ApproxQuantile",
    "ApproxQuantiles",
    "BucketDistribution",
    "BucketValue",
    "Check",
    "CheckLevel",
    "CheckStatus",
    "ColumnKind",
    "ColumnProfiler",
    "ColumnProfilerRunner",
    "ColumnProfiles",
    "Completeness",
    "Compliance",
    "ConstrainableDataTypes",
    "ConstraintStatus",
    "Correlation",
    "CountDistinct",
    "Dataset",
    "DataType",
    "Distinctness",
    "Distribution",
    "DistributionValue",
    "DoubleMetric",
    "Entity",
    "Entropy",
    "Failure",
    "FileSystemMetricsRepository",
    "Histogram",
    "HistogramMetric",
    "InMemoryMetricsRepository",
    "KeyedDoubleMetric",
    "KLLMetric",
    "KLLParameters",
    "KLLSketch",
    "Maximum",
    "MaxLength",
    "Mean",
    "Metric",
    "MetricsRepository",
    "Minimum",
    "MinLength",
    "MutualInformation",
    "observability",
    "PatternMatch",
    "Patterns",
    "ResultKey",
    "RunMonitor",
    "Schema",
    "Size",
    "StandardDeviation",
    "Success",
    "Sum",
    "Uniqueness",
    "UniqueValueRatio",
    "VerificationResult",
    "VerificationRunBuilder",
    "VerificationSuite",
    "__version__",
]
