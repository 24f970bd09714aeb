"""deequ_tpu_torch: "unit tests for data" on PyTorch and CUDA.

A port of ``deequ_tpu`` (JAX) to PyTorch with hand-written CUDA kernels for
Hopper GPUs. One verification run reads the data once: per batch the host
builds features, and three kernels reduce them on the device —
``scan_reduce`` (all scalar reductions of the battery in one launch),
``hll_registers`` (HLL++ registers) and ``dict_code_counts`` (per-code
counts of dictionary columns). Entry points run on ``device="cuda"`` unless
the caller passes ``device="cpu"``, which runs the kernels' plain PyTorch
versions.

The package imports neither JAX nor ``deequ_tpu``.
"""

from .analyzers import (
    ApproxCountDistinct,
    Completeness,
    Compliance,
    CountDistinct,
    Distinctness,
    Entropy,
    Histogram,
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
from .constraints import ConstraintStatus
from .data import Dataset
from .runners import AnalysisRunner, AnalyzerContext, RunMonitor
from .verification import VerificationResult, VerificationSuite

__all__ = [
    "AnalysisRunner",
    "AnalyzerContext",
    "ApproxCountDistinct",
    "Check",
    "CheckLevel",
    "CheckStatus",
    "Completeness",
    "Compliance",
    "ConstraintStatus",
    "CountDistinct",
    "Dataset",
    "Distinctness",
    "Entropy",
    "Histogram",
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
