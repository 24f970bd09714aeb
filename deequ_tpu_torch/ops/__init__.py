"""Host-side numeric helpers of the scan features: xxhash64 and the HLL++
register math. The device kernels live in ``deequ_tpu_torch.kernels``."""
