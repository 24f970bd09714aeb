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

// The merge rules of the mergeable states, shared by scan_reduce's fold of
// block partials and by state_fold. Each follows the JAX reference's
// expression order (deequ_tpu/analyzers/states.py: StandardDeviationState
// .merge :348-355, CorrelationState.merge :382) with every operation
// rounded on its own: the _rn intrinsics are never contracted into fused
// multiply-adds, so the result equals the port's PyTorch merge
// (analyzers/states.py merge_moments / merge_comoments) bit for bit.
struct DqMoments {
  double n, avg, m2;
};

struct DqComoments {
  double n, x_avg, y_avg, ck, x_mk, y_mk;
};

// Chan's rule on (n, avg, m2); both 0 when n is 0
__device__ __forceinline__ DqMoments dq_merge_moments(const DqMoments& a, const DqMoments& b) {
  const double n = __dadd_rn(a.n, b.n);
  const double safe_n = n == 0.0 ? 1.0 : n;
  const double delta = __dsub_rn(b.avg, a.avg);
  const double avg = __ddiv_rn(__dadd_rn(__dmul_rn(a.avg, a.n), __dmul_rn(b.avg, b.n)), safe_n);
  const double m2 = __dadd_rn(
      __dadd_rn(a.m2, b.m2),
      __ddiv_rn(__dmul_rn(__dmul_rn(__dmul_rn(delta, delta), a.n), b.n), safe_n));
  DqMoments out;
  out.n = n;
  out.avg = n == 0.0 ? 0.0 : avg;
  out.m2 = n == 0.0 ? 0.0 : m2;
  return out;
}

// Chan's rule on the co-moments (n, x_avg, y_avg, ck, x_mk, y_mk)
__device__ __forceinline__ DqComoments dq_merge_comoments(const DqComoments& a,
                                                          const DqComoments& b) {
  const double n = __dadd_rn(a.n, b.n);
  const double safe_n = n == 0.0 ? 1.0 : n;
  const double dx = __dsub_rn(b.x_avg, a.x_avg);
  const double dy = __dsub_rn(b.y_avg, a.y_avg);
  const double frac = __ddiv_rn(__dmul_rn(a.n, b.n), safe_n);
  const double x_avg =
      __ddiv_rn(__dadd_rn(__dmul_rn(a.x_avg, a.n), __dmul_rn(b.x_avg, b.n)), safe_n);
  const double y_avg =
      __ddiv_rn(__dadd_rn(__dmul_rn(a.y_avg, a.n), __dmul_rn(b.y_avg, b.n)), safe_n);
  const double ck = __dadd_rn(__dadd_rn(a.ck, b.ck), __dmul_rn(__dmul_rn(dx, dy), frac));
  const double x_mk = __dadd_rn(__dadd_rn(a.x_mk, b.x_mk), __dmul_rn(__dmul_rn(dx, dx), frac));
  const double y_mk = __dadd_rn(__dadd_rn(a.y_mk, b.y_mk), __dmul_rn(__dmul_rn(dy, dy), frac));
  DqComoments out;
  out.n = n;
  out.x_avg = n == 0.0 ? 0.0 : x_avg;
  out.y_avg = n == 0.0 ? 0.0 : y_avg;
  out.ck = n == 0.0 ? 0.0 : ck;
  out.x_mk = n == 0.0 ? 0.0 : x_mk;
  out.y_mk = n == 0.0 ? 0.0 : y_mk;
  return out;
}

// number of blocks that keeps every SM busy with a grid-stride loop
inline int dq_grid_for(long long n, int rows_per_block, int max_blocks) {
  long long blocks = (n + rows_per_block - 1) / rows_per_block;
  if (blocks < 1) blocks = 1;
  if (blocks > max_blocks) blocks = max_blocks;
  return (int)blocks;
}
