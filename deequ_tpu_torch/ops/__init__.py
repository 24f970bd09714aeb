"""Host-side numeric helpers of the scan features: xxhash64 and the HLL++
register math. The device kernels live in ``deequ_tpu_torch.kernels``;
``freq_compact`` (the reference's ``ops.freq_compact``, K7) is re-exported
from there."""

from ..kernels.freq_compact import freq_compact  # noqa: F401
