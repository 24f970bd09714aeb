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

// a < b in the order min uses on non-NaN values: -0.0 sorts below +0.0.
// Each rule has a float64 and a float32 overload: the 32-bit accumulator
// mode (DEEQU_TPU_NO_X64) instantiates the kernels on float.
template <class T>
__device__ __forceinline__ T dq_min_z(T a, T b) {
  return (b < a || (b == a && signbit(b))) ? b : a;
}

// max on non-NaN values: +0.0 sorts above -0.0
template <class T>
__device__ __forceinline__ T dq_max_z(T a, T b) {
  return (b > a || (b == a && !signbit(b))) ? b : a;
}

// pairwise min under the NaN-largest order: NaN is the identity
template <class T>
__device__ __forceinline__ T dq_min_nan_largest(T a, T b) {
  if (isnan(a)) return b;
  if (isnan(b)) return a;
  return dq_min_z(a, b);
}

// pairwise max with IEEE NaN propagation
template <class T>
__device__ __forceinline__ T dq_max_nan(T a, T b) {
  if (isnan(a) || isnan(b)) return (T)nan("");
  return dq_max_z(a, b);
}

// the arithmetic of the merge rules, each operation rounded on its own
__device__ __forceinline__ double dq_add(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ double dq_sub(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ double dq_mul(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ double dq_div(double a, double b) { return __ddiv_rn(a, b); }
__device__ __forceinline__ float dq_add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float dq_sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float dq_mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float dq_div(float a, float b) { return __fdiv_rn(a, b); }

// The merge rules of the mergeable states, shared by scan_reduce's fold of
// block partials and by state_fold. Each follows the JAX reference's
// expression order (deequ_tpu/analyzers/states.py: StandardDeviationState
// .merge :348-355, CorrelationState.merge :382) with every operation
// rounded on its own: the _rn intrinsics are never contracted into fused
// multiply-adds, so the result equals the port's PyTorch merge
// (analyzers/states.py merge_moments / merge_comoments) bit for bit.
template <class T>
struct DqMomentsT {
  T n, avg, m2;
};

template <class T>
struct DqComomentsT {
  T n, x_avg, y_avg, ck, x_mk, y_mk;
};

typedef DqMomentsT<double> DqMoments;
typedef DqComomentsT<double> DqComoments;

// Chan's rule on (n, avg, m2); both 0 when n is 0
template <class T>
__device__ __forceinline__ DqMomentsT<T> dq_merge_moments(const DqMomentsT<T>& a,
                                                          const DqMomentsT<T>& b) {
  const T zero = 0;
  const T n = dq_add(a.n, b.n);
  const T safe_n = n == zero ? (T)1 : n;
  const T delta = dq_sub(b.avg, a.avg);
  const T avg = dq_div(dq_add(dq_mul(a.avg, a.n), dq_mul(b.avg, b.n)), safe_n);
  const T m2 = dq_add(dq_add(a.m2, b.m2),
                      dq_div(dq_mul(dq_mul(dq_mul(delta, delta), a.n), b.n), safe_n));
  DqMomentsT<T> out;
  out.n = n;
  out.avg = n == zero ? zero : avg;
  out.m2 = n == zero ? zero : m2;
  return out;
}

// Chan's rule on the co-moments (n, x_avg, y_avg, ck, x_mk, y_mk)
template <class T>
__device__ __forceinline__ DqComomentsT<T> dq_merge_comoments(const DqComomentsT<T>& a,
                                                              const DqComomentsT<T>& b) {
  const T zero = 0;
  const T n = dq_add(a.n, b.n);
  const T safe_n = n == zero ? (T)1 : n;
  const T dx = dq_sub(b.x_avg, a.x_avg);
  const T dy = dq_sub(b.y_avg, a.y_avg);
  const T frac = dq_div(dq_mul(a.n, b.n), safe_n);
  const T x_avg = dq_div(dq_add(dq_mul(a.x_avg, a.n), dq_mul(b.x_avg, b.n)), safe_n);
  const T y_avg = dq_div(dq_add(dq_mul(a.y_avg, a.n), dq_mul(b.y_avg, b.n)), safe_n);
  const T ck = dq_add(dq_add(a.ck, b.ck), dq_mul(dq_mul(dx, dy), frac));
  const T x_mk = dq_add(dq_add(a.x_mk, b.x_mk), dq_mul(dq_mul(dx, dx), frac));
  const T y_mk = dq_add(dq_add(a.y_mk, b.y_mk), dq_mul(dq_mul(dy, dy), frac));
  DqComomentsT<T> out;
  out.n = n;
  out.x_avg = n == zero ? zero : x_avg;
  out.y_avg = n == zero ? zero : y_avg;
  out.ck = n == zero ? zero : ck;
  out.x_mk = n == zero ? zero : x_mk;
  out.y_mk = n == zero ? zero : y_mk;
  return out;
}

// number of blocks that keeps every SM busy with a grid-stride loop
inline int dq_grid_for(long long n, int rows_per_block, int max_blocks) {
  long long blocks = (n + rows_per_block - 1) / rows_per_block;
  if (blocks < 1) blocks = 1;
  if (blocks > max_blocks) blocks = max_blocks;
  return (int)blocks;
}
