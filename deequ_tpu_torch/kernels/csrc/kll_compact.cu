// K5 kll_compact: append to a KLL sketch's levels and run its compaction
// cascade, in one thread block per sketch.
//
// Replaces the state algebra of the JAX reference's KLL
// (deequ_tpu/ops/kll.py): _append_level :111, the single-level compactor
// _make_compact_level :147, and the cascades _compact_cascade_from :204
// (after kll_update's append, :233) and _compact_cascade :182 (after
// kll_merge's appends, :327).
//
// The state is float32 items[L][C] (C = 4k, +inf past each level's size),
// int32 sizes[L] and parity[L], and the scalars ticks, count, g_min and
// g_max; the kernel updates it in place (the wrapper hands it a copy).
//
//  - update mode: append the m samples of K4 (kll_sample.cu) at level h,
//    both read from K4's device outputs, then compact level h, h+1, ...
//    while a level below the top holds more than k items; ticks += 1,
//    count += n, and g_min / g_max take K4's min and max.
//  - merge mode: append each level of sketch b to the same level of a, XOR
//    the parities, then sweep levels 0 .. L-2 once, compacting every level
//    that holds more than k items; the scalars add, and min / max combine.
//    The stacked merge (the collective merge of the reference's B11,
//    deequ_tpu/parallel/__init__.py:266: a round of the butterfly, a step
//    of every shard's local fold) merges M pairs (a[i], b[i]) in one
//    launch, one block a pair; the one-pair merge is its M = 1 case.
//  - ingest mode (the host ingest tier; kll_ingest_sampled of the
//    reference, ops/kll.py:284, applied once per host partial in batch
//    order): S sketches of one shape, stacked, take a chunk of B host
//    samples each, one block per sketch. For each sample b in order: its
//    float64 items are clipped to +-FLT_MAX and rounded to float32
//    (__double2float_rn), m of them are appended at level h (clipped to
//    the level's free capacity, up to 2k at a time: the host sampler picks
//    up to two levels denser than fits), the cascade runs up from h, ticks
//    gains 1, count gains nv, and g_min / g_max take the sample's min and
//    max. The sketches update in place.
//
// Appends drop items past a level's capacity C and do not count them.
// Compacting a level sorts its n items, promotes every second one from the
// parity offset (n / 2 of them) to the next level, keeps the odd tail (0 or
// 1 item) at the front of the level, and flips the parity. The sort must
// give the reference's layout: -0.0 and +0.0 compare equal and keep their
// order, so the block sorts (key, position) pairs, a uint64 per item, with
// a bitonic network in shared memory (8 bytes per item: 64 KB at k = 2048),
// or in device scratch when the level is too large for shared memory.
//
// Min and max follow the reference's rules on signed zeros (common.cuh).
//
// Bound on the card: bytes, and little of them: a compaction reads a level
// of at most 4k items and writes half of them; an ingest chunk reads its B
// samples of 4k float64 items once (32 x 64 KiB per sketch at k = 2048). The kernel is latency-bound
// (one block, a bitonic network of log2(n)^2 / 2 synchronised steps), which
// suits a function called once per sketch per batch.
#include <float.h>
#include <math_constants.h>

#include "common.cuh"

#define KC_THREADS 1024
#define KC_MAX_LEVELS 64
// dynamic shared memory a level sort may take (of the 227 KB of a block)
#define KC_SMEM_LIMIT (192 * 1024)

struct KcState {
  float* items;
  int* sizes;
  int* parity;
  int* ticks;
  long long* count;
  double* g_min;
  double* g_max;
};

// order-preserving uint32 image of a float32 item; -0.0 maps to +0.0
__device__ __forceinline__ uint32_t kc_key(float x) {
  uint32_t b = __float_as_uint(x);
  if ((b & 0x7fffffffu) == 0u) b = 0u;
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

__host__ __device__ inline long long kc_pow2_at_least(long long n) {
  long long p = 1;
  while (p < n) p <<= 1;
  return p;
}

// ascending bitonic sort of buf[0, p), p a power of two, by the whole block
__device__ void kc_sort(unsigned long long* buf, int p) {
  for (int size = 2; size <= p; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int i = threadIdx.x; i < p / 2; i += blockDim.x) {
        const int lo = 2 * i - (i & (stride - 1));
        const int hi = lo + stride;
        const bool ascending = (lo & size) == 0;
        const unsigned long long a = buf[lo];
        const unsigned long long b = buf[hi];
        if ((a > b) == ascending) {
          buf[lo] = b;
          buf[hi] = a;
        }
      }
      __syncthreads();
    }
  }
}

// compact level lvl into lvl + 1 (sizes and parity live in shared memory)
__device__ void kc_compact(float* items, int C, int* s_sizes, int* s_parity, int lvl,
                           unsigned long long* buf, float* s_tail) {
  const int n = s_sizes[lvl];
  float* row = items + (long long)lvl * C;
  float* next = row + C;
  const int p = (int)kc_pow2_at_least(n);
  for (int i = threadIdx.x; i < p; i += blockDim.x) {
    buf[i] = i < n ? ((unsigned long long)kc_key(row[i]) << 32) | (unsigned)i : ~0ull;
  }
  __syncthreads();
  kc_sort(buf, p);
  const int n2 = n - (n & 1);
  const int off = s_parity[lvl];
  const int size_next = s_sizes[lvl + 1];
  const int written = min(n2 / 2, C - size_next);
  for (int j = threadIdx.x; j < written; j += blockDim.x) {
    next[size_next + j] = row[(unsigned)(buf[off + 2 * j] & 0xffffffffu)];
  }
  if (threadIdx.x == 0) {
    *s_tail = (n & 1) ? row[(unsigned)(buf[n2] & 0xffffffffu)] : CUDART_INF_F;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < n; i += blockDim.x) row[i] = i == 0 ? *s_tail : CUDART_INF_F;
  if (threadIdx.x == 0) {
    s_sizes[lvl] = n & 1;
    s_parity[lvl] = 1 - off;
    s_sizes[lvl + 1] = size_next + written;
  }
  __syncthreads();
}

// append src[0, m) to level lvl, dropping what exceeds the capacity
__device__ void kc_append(float* items, int C, int* s_sizes, int lvl, const float* src, int m) {
  const int size = s_sizes[lvl];
  const int written = max(0, min(m, C - size));
  float* row = items + (long long)lvl * C;
  for (int j = threadIdx.x; j < written; j += blockDim.x) row[size + j] = src[j];
  __syncthreads();
  if (threadIdx.x == 0) s_sizes[lvl] = size + written;
  __syncthreads();
}

// append m float64 items at level lvl, each clipped to the finite float32
// range and rounded to nearest, dropping what exceeds the capacity
__device__ void kc_append_f64(float* items, int C, int* s_sizes, int lvl, const double* src,
                              int m) {
  const int size = s_sizes[lvl];
  const int written = max(0, min(m, C - size));
  float* row = items + (long long)lvl * C;
  for (int j = threadIdx.x; j < written; j += blockDim.x) {
    double x = src[j];
    x = x > (double)FLT_MAX ? (double)FLT_MAX : (x < -(double)FLT_MAX ? -(double)FLT_MAX : x);
    row[size + j] = __double2float_rn(x);
  }
  __syncthreads();
  if (threadIdx.x == 0) s_sizes[lvl] = size + written;
  __syncthreads();
}

__device__ void kc_store(const KcState& st, int L, const int* s_sizes, const int* s_parity) {
  for (int l = threadIdx.x; l < L; l += blockDim.x) {
    st.sizes[l] = s_sizes[l];
    st.parity[l] = s_parity[l];
  }
}

__global__ void __launch_bounds__(KC_THREADS)
kc_update(KcState st, int L, int C, int k, const float* __restrict__ samples,
          const int* __restrict__ meta, const double* __restrict__ minmax,
          unsigned long long* gbuf) {
  extern __shared__ unsigned long long smem[];
  __shared__ int s_sizes[KC_MAX_LEVELS];
  __shared__ int s_parity[KC_MAX_LEVELS];
  __shared__ float s_tail;
  unsigned long long* buf = gbuf != nullptr ? gbuf : smem;
  for (int l = threadIdx.x; l < L; l += blockDim.x) {
    s_sizes[l] = st.sizes[l];
    s_parity[l] = st.parity[l];
  }
  __syncthreads();
  const int m = meta[0];
  const int h = min(meta[1], L - 1);  // h <= 31 < L for any int32 count
  kc_append(st.items, C, s_sizes, h, samples, m);
  for (int lvl = h; lvl < L - 1 && s_sizes[lvl] > k; ++lvl) {
    kc_compact(st.items, C, s_sizes, s_parity, lvl, buf, &s_tail);
  }
  kc_store(st, L, s_sizes, s_parity);
  if (threadIdx.x == 0) {
    *st.ticks = (int)((unsigned)*st.ticks + 1u);
    *st.count += meta[2];
    *st.g_min = dq_min_z(*st.g_min, minmax[0]);
    *st.g_max = dq_max_z(*st.g_max, minmax[1]);
  }
}

// block i: pair i of the stacked sketches a (updated in place; items
// [M, L, C], sizes and parity [M, L], the scalars [M]) and b (the same
// shapes, read only): sketch a[i] becomes the merge of a[i] and b[i]
__global__ void __launch_bounds__(KC_THREADS)
kc_merge(KcState st, const float* __restrict__ b_items, const int* __restrict__ b_sizes,
         const int* __restrict__ b_parity, const int* __restrict__ b_ticks,
         const long long* __restrict__ b_count, const double* __restrict__ b_g_min,
         const double* __restrict__ b_g_max, int L, int C, int k,
         unsigned long long* gbuf, long long gbuf_stride) {
  extern __shared__ unsigned long long smem[];
  __shared__ int s_sizes[KC_MAX_LEVELS];
  __shared__ int s_parity[KC_MAX_LEVELS];
  __shared__ float s_tail;
  const long long i = blockIdx.x;
  float* items = st.items + i * L * C;
  int* sizes = st.sizes + i * L;
  int* parity = st.parity + i * L;
  b_items += i * L * C;
  b_sizes += i * L;
  b_parity += i * L;
  unsigned long long* buf = gbuf != nullptr ? gbuf + i * gbuf_stride : smem;
  for (int l = threadIdx.x; l < L; l += blockDim.x) {
    s_sizes[l] = sizes[l];
    s_parity[l] = parity[l] ^ b_parity[l];
  }
  __syncthreads();
  for (int lvl = 0; lvl < L; ++lvl) {
    kc_append(items, C, s_sizes, lvl, b_items + (long long)lvl * C, b_sizes[lvl]);
  }
  for (int lvl = 0; lvl < L - 1; ++lvl) {
    if (s_sizes[lvl] > k) kc_compact(items, C, s_sizes, s_parity, lvl, buf, &s_tail);
  }
  for (int l = threadIdx.x; l < L; l += blockDim.x) {
    sizes[l] = s_sizes[l];
    parity[l] = s_parity[l];
  }
  if (threadIdx.x == 0) {
    st.ticks[i] = (int)((unsigned)st.ticks[i] + (unsigned)b_ticks[i]);
    st.count[i] += b_count[i];
    st.g_min[i] = dq_min_z(st.g_min[i], b_g_min[i]);
    st.g_max[i] = dq_max_z(st.g_max[i], b_g_max[i]);
  }
}

// block s: sketch s of the stacked state (items [S, L, C], sizes and parity
// [S, L], the scalars [S]) takes its B samples (items [S, B, C] float64, m,
// h [S, B] int32, nv [S, B] int64, mn, mx [S, B] float64) in order
__global__ void __launch_bounds__(KC_THREADS)
kc_ingest(KcState st, int L, int C, int k, int B, const double* __restrict__ p_items,
          const int* __restrict__ p_m, const int* __restrict__ p_h,
          const long long* __restrict__ p_nv, const double* __restrict__ p_min,
          const double* __restrict__ p_max, unsigned long long* gbuf, long long gbuf_stride) {
  extern __shared__ unsigned long long smem[];
  __shared__ int s_sizes[KC_MAX_LEVELS];
  __shared__ int s_parity[KC_MAX_LEVELS];
  __shared__ float s_tail;
  const int s = blockIdx.x;
  float* items = st.items + (long long)s * L * C;
  int* sizes = st.sizes + (long long)s * L;
  int* parity = st.parity + (long long)s * L;
  unsigned long long* buf = gbuf != nullptr ? gbuf + (long long)s * gbuf_stride : smem;
  for (int l = threadIdx.x; l < L; l += blockDim.x) {
    s_sizes[l] = sizes[l];
    s_parity[l] = parity[l];
  }
  __syncthreads();
  for (int b = 0; b < B; ++b) {
    const long long at = (long long)s * B + b;
    const int h = max(0, min(p_h[at], L - 1));
    kc_append_f64(items, C, s_sizes, h, p_items + at * C, p_m[at]);
    for (int lvl = h; lvl < L - 1 && s_sizes[lvl] > k; ++lvl) {
      kc_compact(items, C, s_sizes, s_parity, lvl, buf, &s_tail);
    }
    if (threadIdx.x == 0) {
      st.ticks[s] = (int)((unsigned)st.ticks[s] + 1u);
      st.count[s] += p_nv[at];
      st.g_min[s] = dq_min_z(st.g_min[s], p_min[at]);
      st.g_max[s] = dq_max_z(st.g_max[s], p_max[at]);
    }
  }
  for (int l = threadIdx.x; l < L; l += blockDim.x) {
    sizes[l] = s_sizes[l];
    parity[l] = s_parity[l];
  }
}

// uint64 entries of device scratch a level sort needs: 0 when it fits in
// shared memory
extern "C" long long kll_compact_scratch(int C) {
  const long long p = kc_pow2_at_least(C);
  return p * 8 <= KC_SMEM_LIMIT ? 0 : p;
}

static cudaError_t kc_prepare(const void* kernel, int C, unsigned long long* gbuf,
                              size_t* smem) {
  const long long p = kc_pow2_at_least(C);
  if (kll_compact_scratch(C) > 0) {
    *smem = 0;
    return gbuf == nullptr ? cudaErrorInvalidValue : cudaSuccess;
  }
  *smem = (size_t)p * 8;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)*smem);
}

static bool kc_bad_shape(int L, int C, int k) {
  return L < 2 || L > KC_MAX_LEVELS || C < 1 || k < 1;
}

// gbuf: uint64[kll_compact_scratch(C)] of device scratch, or null when that
// is 0
extern "C" int kll_compact_update_launch(float* items, int* sizes, int* parity, int* ticks,
                                         long long* count, double* g_min, double* g_max,
                                         int L, int C, int k, const float* samples,
                                         const int* meta, const double* minmax,
                                         unsigned long long* gbuf, void* stream) {
  if (kc_bad_shape(L, C, k)) return (int)cudaErrorInvalidValue;
  size_t smem = 0;
  cudaError_t err = kc_prepare((const void*)kc_update, C, gbuf, &smem);
  if (err != cudaSuccess) return (int)err;
  KcState st = {items, sizes, parity, ticks, count, g_min, g_max};
  kc_update<<<1, KC_THREADS, smem, (cudaStream_t)stream>>>(
      st, L, C, k, samples, meta, minmax, smem > 0 ? nullptr : gbuf);
  return (int)cudaGetLastError();
}

// the stacked merge: M pairs, one block each; gbuf: uint64[M *
// kll_compact_scratch(C)] of device scratch, or null when that is 0
extern "C" int kll_compact_merge_stacked_launch(
    float* items, int* sizes, int* parity, int* ticks, long long* count, double* g_min,
    double* g_max, const float* b_items, const int* b_sizes, const int* b_parity,
    const int* b_ticks, const long long* b_count, const double* b_g_min, const double* b_g_max,
    int M, int L, int C, int k, unsigned long long* gbuf, void* stream) {
  if (kc_bad_shape(L, C, k) || M < 1) return (int)cudaErrorInvalidValue;
  size_t smem = 0;
  cudaError_t err = kc_prepare((const void*)kc_merge, C, gbuf, &smem);
  if (err != cudaSuccess) return (int)err;
  KcState st = {items, sizes, parity, ticks, count, g_min, g_max};
  kc_merge<<<M, KC_THREADS, smem, (cudaStream_t)stream>>>(
      st, b_items, b_sizes, b_parity, b_ticks, b_count, b_g_min, b_g_max, L, C, k,
      smem > 0 ? nullptr : gbuf, kll_compact_scratch(C));
  return (int)cudaGetLastError();
}

// the merge of one pair: the stacked merge with M = 1
extern "C" int kll_compact_merge_launch(float* items, int* sizes, int* parity, int* ticks,
                                        long long* count, double* g_min, double* g_max,
                                        const float* b_items, const int* b_sizes,
                                        const int* b_parity, const int* b_ticks,
                                        const long long* b_count, const double* b_g_min,
                                        const double* b_g_max, int L, int C, int k,
                                        unsigned long long* gbuf, void* stream) {
  return kll_compact_merge_stacked_launch(items, sizes, parity, ticks, count, g_min, g_max,
                                          b_items, b_sizes, b_parity, b_ticks, b_count, b_g_min,
                                          b_g_max, 1, L, C, k, gbuf, stream);
}

// the stacked sketches of kc_ingest; gbuf: uint64[S * kll_compact_scratch(C)]
// of device scratch, or null when that is 0
extern "C" int kll_compact_ingest_launch(float* items, int* sizes, int* parity, int* ticks,
                                         long long* count, double* g_min, double* g_max,
                                         int S, int L, int C, int k, int B,
                                         const double* p_items, const int* p_m, const int* p_h,
                                         const long long* p_nv, const double* p_min,
                                         const double* p_max, unsigned long long* gbuf,
                                         void* stream) {
  if (kc_bad_shape(L, C, k) || S < 1 || B < 1) return (int)cudaErrorInvalidValue;
  size_t smem = 0;
  cudaError_t err = kc_prepare((const void*)kc_ingest, C, gbuf, &smem);
  if (err != cudaSuccess) return (int)err;
  KcState st = {items, sizes, parity, ticks, count, g_min, g_max};
  kc_ingest<<<S, KC_THREADS, smem, (cudaStream_t)stream>>>(
      st, L, C, k, B, p_items, p_m, p_h, p_nv, p_min, p_max, smem > 0 ? nullptr : gbuf,
      kll_compact_scratch(C));
  return (int)cudaGetLastError();
}
