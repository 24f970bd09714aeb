// Helpers shared by the scan kernels of deequ_tpu_torch.
//
// Ordering rules the kernels must reproduce exactly (they are the JAX
// reference's, deequ_tpu/analyzers/simple.py and states.py):
//   - Minimum follows the NaN-largest order: NaN never wins, and a min over
//     no non-NaN value is NaN (the identity of MinState). CUDA's fmin/fmax
//     DROP NaN, so neither is used: every order is coded by hand.
//   - Maximum propagates NaN (any NaN gives NaN); its identity is -inf.
//   - Signed zeros: -0.0 wins a min and +0.0 wins a max, whatever the
//     order of the operands (XLA's min/max do the same).
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

// a < b in the order min uses on non-NaN values: -0.0 sorts below +0.0
__device__ __forceinline__ double dq_min_z(double a, double b) {
  return (b < a || (b == a && signbit(b))) ? b : a;
}

// max on non-NaN values: +0.0 sorts above -0.0
__device__ __forceinline__ double dq_max_z(double a, double b) {
  return (b > a || (b == a && !signbit(b))) ? b : a;
}

// pairwise min under the NaN-largest order: NaN is the identity
__device__ __forceinline__ double dq_min_nan_largest(double a, double b) {
  if (isnan(a)) return b;
  if (isnan(b)) return a;
  return dq_min_z(a, b);
}

// pairwise max with IEEE NaN propagation
__device__ __forceinline__ double dq_max_nan(double a, double b) {
  if (isnan(a) || isnan(b)) return nan("");
  return dq_max_z(a, b);
}

// number of blocks that keeps every SM busy with a grid-stride loop
inline int dq_grid_for(long long n, int rows_per_block, int max_blocks) {
  long long blocks = (n + rows_per_block - 1) / rows_per_block;
  if (blocks < 1) blocks = 1;
  if (blocks > max_blocks) blocks = max_blocks;
  return (int)blocks;
}
