"""Re-export shim; the taxonomy lives in `deequ_tpu_torch.exceptions`."""

from ..exceptions import (  # noqa: F401
    EmptyStateException,
    IllegalAnalyzerParameterException,
    MetricCalculationException,
    MetricCalculationPreconditionException,
    MetricCalculationRuntimeException,
    NoColumnsSpecifiedException,
    NoSuchColumnException,
    WrongColumnTypeException,
    wrap_if_necessary,
)
