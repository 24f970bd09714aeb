// K5 kll_compact: append to a KLL sketch's levels and run its compaction
// cascade, one thread block working each sketch.
//
// Replaces the state algebra of the JAX reference's KLL
// (deequ_tpu/ops/kll.py): _append_level :111, the single-level compactor
// _make_compact_level :147, and the cascades _compact_cascade_from :204
// (after kll_update's append, :233, and kll_ingest_sampled's, :284) and
// _compact_cascade :182 (after kll_merge's appends, :327).
//
// The state is float32 items[L][C] (C = 4k, +inf past each level's size),
// int32 sizes[L] and parity[L], and the scalars ticks, count, g_min and
// g_max.
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
//    launch; the one-pair merge is its M = 1 case.
//  - ingest mode (the host ingest tier; kll_ingest_sampled of the
//    reference, applied once per host partial in batch order): S sketches
//    of one shape, stacked, take a chunk of B host samples each, one block
//    per sketch, in place. For each sample b in order: its float64 items
//    are clipped to +-FLT_MAX and rounded to float32 (__double2float_rn),
//    m of them are appended at level h, the cascade runs up from h, ticks
//    gains 1, count gains nv, and g_min / g_max take the sample's min and
//    max.
//
// The scalars count, g_min and g_max (and a host sample's nv, min and
// max) are int64 and float64, or int32 and float32 in the reference's
// 32-bit accumulator mode (DEEQU_TPU_NO_X64): every kernel is a template on
// the two types, and each entry has a _f32 twin. Items are float32 in both.
//
// Appends drop items past a level's capacity C and do not count them.
// Compacting a level sorts its n items stably (-0.0 and +0.0 compare
// equal and keep their order, as in the reference's sort), promotes every
// second one from the parity offset (n / 2 of them) to the next level,
// keeps the odd tail (0 or 1 item) at the front of the level, and flips
// the parity. Min and max follow the reference's rules on signed zeros
// (common.cuh).
//
// What bounds it on this card: not bytes (a compaction reads a level of
// at most 4k items and writes about as many; an ingest chunk reads its B
// samples once) but the length of the block's chain of dependent steps,
// since each cascade depends on the one before. The design shortens that
// chain:
//  - A level is never an arbitrary sequence. It is the odd tail followed
//    by appended runs, each sorted: K4's picks come from a sorted batch,
//    the host sampler's blocks are sorted, and promoted items are a sorted
//    subsequence. So a compaction finds the level's natural runs (a
//    boundary is a descent, key[i] < key[i-1]; ties are not boundaries)
//    and merges adjacent runs pairwise, ceil(log2 r) rounds for r runs,
//    each round one merge-path pass over the block's threads (every
//    thread binary-searches the start of its share of the output, then
//    merges it serially, taking the left run on equal keys). A stable
//    merge of position-ordered runs is the stable sort whatever the input,
//    so an unsorted level costs a merge sort's rounds, never a wrong
//    order. The common level (a tail and one or two runs) takes one or two
//    rounds where a bitonic network took 91 block-wide steps.
//  - Items move as their float32 bits (4 bytes each; the merge rule gives
//    stability without a position field), double-buffered in shared
//    memory with the run starts beside them (12 bytes an item: 96 KB at
//    k = 2048), or in device scratch when C is too large for that.
//  - The ingest entry stages sample b+1's float64 items into shared memory
//    with cp.async while sample b's cascade runs (where shared memory
//    holds both: k <= 2815), so a sample's load never waits behind the
//    cascade before it; each sample's m and h are read one sample ahead,
//    and the scalars are folded once, after the last sample.
//  - The update and merge entries write a new state instead of updating a
//    copy: the level sizes alone decide which rows the cascade touches
//    (sizes evolve the same whatever the items), so the working block
//    copies those rows, with the appends written into them on the way,
//    and works on them in place, while KC_COPY_BLOCKS more blocks of the
//    same launch copy the untouched rows. One launch, no clone of the
//    seven leaves.
//  - Sizes and parities live in shared memory; after a compaction every
//    thread writes the same new sizes, so a barrier less a level.
//
// The block's chain stays the limit: a compaction is a few microseconds of
// barriers and dependent loads, far above the time of the bytes it moves.
#include <float.h>
#include <math_constants.h>

#include "common.cuh"

#define KC_THREADS 1024
#define KC_WARPS (KC_THREADS / 32)
#define KC_MAX_LEVELS 64
// dynamic shared memory a block may take (of the 227 KB of a block, with
// room for the static shared memory)
#define KC_SMEM_LIMIT (220 * 1024)
// blocks beside each working block that copy the untouched rows
#define KC_COPY_BLOCKS 8

// F: the type of g_min and g_max; N: the type of count
template <class F, class N>
struct KcState {
  float* items;
  int* sizes;
  int* parity;
  int* ticks;
  N* count;
  F* g_min;
  F* g_max;
};

template <class F, class N>
struct KcInput {
  const float* items;
  const int* sizes;
  const int* parity;
  const int* ticks;
  const N* count;
  const F* g_min;
  const F* g_max;
};

// a level's sort buffers: a and b hold C float32 bit patterns each, starts
// C + 1 run starts
struct KcBufs {
  uint32_t* a;
  uint32_t* b;
  int* starts;
};

struct KcShared {
  int sizes[KC_MAX_LEVELS];
  int parity[KC_MAX_LEVELS];
  int b_sizes[KC_MAX_LEVELS];  // the merge's second sketch
  int warp_sums[KC_WARPS];
  unsigned long long touched;  // the rows the working block rewrites
};

// order-preserving uint32 image of float32 bits; -0.0 maps to +0.0
__device__ __forceinline__ uint32_t kc_key(uint32_t b) {
  if ((b & 0x7fffffffu) == 0u) return 0x80000000u;
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

// 32-bit words of one block's sort buffers, a multiple of 4 (16 bytes)
__host__ __device__ inline long long kc_buf_words(int C) {
  return (3LL * C + 1 + 3) / 4 * 4;
}

// 16-byte asynchronous copy from device to shared memory (sm_80+)
__device__ __forceinline__ void kc_cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem) : "memory");
}

__device__ __forceinline__ void kc_cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void kc_cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// exclusive prefix of v over the block in thread order; total gets the sum
__device__ int kc_block_scan(int v, int* warp_sums, int& total) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int x = v;
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) warp_sums[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int s = warp_sums[lane];
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, s, o);
      if (lane >= o) s += y;
    }
    warp_sums[lane] = s;
  }
  __syncthreads();
  // warp_sums is written again only after the caller's next barrier
  const int excl = x - v + (warp > 0 ? warp_sums[warp - 1] : 0);
  total = warp_sums[KC_WARPS - 1];
  return excl;
}

// items of a (la of them) among the first diag outputs of the stable
// merge of a and b (a first on equal keys)
__device__ __forceinline__ int kc_merge_path(const uint32_t* a, int la, const uint32_t* b, int lb,
                                             int diag) {
  int lo = max(0, diag - lb);
  int hi = min(diag, la);
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (kc_key(a[mid]) <= kc_key(b[diag - 1 - mid])) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

// sort row[0, n) stably by kc_key; returns the buffer holding the result
__device__ const uint32_t* kc_sort_level(const float* row, int n, const KcBufs& buf,
                                         KcShared& sh) {
  uint32_t* src = buf.a;
  uint32_t* dst = buf.b;
  int* starts = buf.starts;
  for (int i = threadIdx.x; i < n; i += KC_THREADS) src[i] = __float_as_uint(row[i]);
  __syncthreads();
  // each thread owns the output positions [lo, hi) in every round
  const int per = (n + KC_THREADS - 1) / KC_THREADS;
  const int lo = min(n, (int)threadIdx.x * per);
  const int hi = min(n, lo + per);
  int descents = 0;
  for (int i = max(lo, 1); i < hi; ++i) descents += kc_key(src[i]) < kc_key(src[i - 1]);
  int total = 0;
  int at = 1 + kc_block_scan(descents, sh.warp_sums, total);
  for (int i = max(lo, 1); i < hi; ++i) {
    if (kc_key(src[i]) < kc_key(src[i - 1])) starts[at++] = i;
  }
  const int runs = total + 1;
  if (threadIdx.x == 0) {
    starts[0] = 0;
    starts[runs] = n;
  }
  __syncthreads();
  // round w merges groups of w runs pairwise: group g spans the runs
  // [g * w, (g + 1) * w), its items [starts[g * w], starts[(g + 1) * w])
  for (int w = 1; w < runs; w <<= 1) {
    const int pairs = (runs + 2 * w - 1) / (2 * w);
    int d = lo;
    while (d < hi) {
      int plo = 0;
      int phi = pairs - 1;
      while (plo < phi) {
        const int mid = (plo + phi + 1) >> 1;
        if (starts[2 * mid * w] <= d) {
          plo = mid;
        } else {
          phi = mid - 1;
        }
      }
      const int a0 = starts[2 * plo * w];
      const int a1 = starts[min((2 * plo + 1) * w, runs)];
      const int b1 = starts[min((2 * plo + 2) * w, runs)];
      const int la = a1 - a0;
      const int lb = b1 - a1;
      const int end = min(hi, b1);
      int i = kc_merge_path(src + a0, la, src + a1, lb, d - a0);
      int j = d - a0 - i;
      for (; d < end; ++d) {
        const bool left = i < la && (j >= lb || kc_key(src[a0 + i]) <= kc_key(src[a1 + j]));
        dst[d] = left ? src[a0 + i++] : src[a1 + j++];
      }
    }
    __syncthreads();
    uint32_t* t = src;
    src = dst;
    dst = t;
  }
  return src;
}

// compact level lvl into lvl + 1 (sizes and parity live in shared memory)
__device__ void kc_compact(float* items, int C, int lvl, const KcBufs& buf, KcShared& sh) {
  const int n = sh.sizes[lvl];
  float* row = items + (long long)lvl * C;
  float* next = row + C;
  const uint32_t* sorted = kc_sort_level(row, n, buf, sh);
  const int n2 = n - (n & 1);
  const int off = sh.parity[lvl];
  const int size_next = sh.sizes[lvl + 1];
  const int written = min(n2 / 2, C - size_next);
  for (int j = threadIdx.x; j < written; j += KC_THREADS) {
    next[size_next + j] = __uint_as_float(sorted[off + 2 * j]);
  }
  for (int i = threadIdx.x; i < n; i += KC_THREADS) {
    row[i] = (i == 0 && (n & 1)) ? __uint_as_float(sorted[n2]) : CUDART_INF_F;
  }
  __syncthreads();
  // every thread writes the same values, so each reads its own next
  sh.sizes[lvl] = n & 1;
  sh.parity[lvl] = 1 - off;
  sh.sizes[lvl + 1] = size_next + written;
}

// items an append of m to a level of `size` writes
__device__ inline int kc_written(int m, int size, int C) {
  return max(0, min(m, C - size));
}

// sizes after compacting level lvl (the plan's copy of kc_compact's sizes)
__device__ inline void kc_plan_compact(int* s, int lvl, int C) {
  const int n = s[lvl];
  const int n2 = n - (n & 1);
  s[lvl + 1] += min(n2 / 2, C - s[lvl + 1]);
  s[lvl] = n & 1;
}

// the rows an update touches: the append's level h and every level its
// cascade compacts or promotes into (thread 0)
__device__ unsigned long long kc_plan_update(const int* sizes, int L, int C, int k, int h, int m) {
  int s[KC_MAX_LEVELS];
  for (int l = 0; l < L; ++l) s[l] = sizes[l];
  s[h] += kc_written(m, s[h], C);
  unsigned long long touched = 1ull << h;
  for (int lvl = h; lvl < L - 1 && s[lvl] > k; ++lvl) {
    kc_plan_compact(s, lvl, C);
    touched |= 1ull << (lvl + 1);
  }
  return touched;
}

// the rows a merge touches: those b appends to, and every level its sweep
// compacts or promotes into (thread 0)
__device__ unsigned long long kc_plan_merge(const int* sizes, const int* b_sizes, int L, int C,
                                            int k) {
  int s[KC_MAX_LEVELS];
  unsigned long long touched = 0ull;
  for (int l = 0; l < L; ++l) {
    const int w = kc_written(b_sizes[l], sizes[l], C);
    s[l] = sizes[l] + w;
    if (w > 0) touched |= 1ull << l;
  }
  for (int lvl = 0; lvl < L - 1; ++lvl) {
    if (s[lvl] > k) {
      kc_plan_compact(s, lvl, C);
      touched |= 3ull << lvl;
    }
  }
  return touched;
}

// copy row src into dst, with app[0, written) in place of [at, at + written)
// (an append); 16-byte pieces where the rows allow
__device__ void kc_copy_row(float* dst, const float* src, int C, const float* app = nullptr,
                            int at = 0, int written = 0) {
  if ((((uintptr_t)dst | (uintptr_t)src) & 15u) == 0 && (C & 3) == 0) {
    const float4* s4 = (const float4*)src;
    float4* d4 = (float4*)dst;
    for (int i = threadIdx.x; i < C / 4; i += KC_THREADS) {
      float4 v = s4[i];
      if (4 * i + 4 > at && 4 * i < at + written) {
        float* f = (float*)&v;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int j = 4 * i + c - at;
          if (j >= 0 && j < written) f[c] = app[j];
        }
      }
      d4[i] = v;
    }
  } else {
    for (int i = threadIdx.x; i < C; i += KC_THREADS) {
      dst[i] = i >= at && i < at + written ? app[i - at] : src[i];
    }
  }
}

// blocks 1 .. copiers of a working block's group copy the rows of `in` it
// does not touch into `out`, one row in `copiers` each
__device__ void kc_copy_untouched(float* out, const float* in, int L, int C,
                                  unsigned long long touched) {
  const int copiers = (int)gridDim.x - 1;
  for (int l = (int)blockIdx.x - 1; l < L; l += copiers) {
    if (((touched >> l) & 1ull) == 0) kc_copy_row(out + (long long)l * C, in + (long long)l * C, C);
  }
}

// a block's sort buffers: in dynamic shared memory, or block `at`'s
// `stride` words of device scratch when gbuf is not null
__device__ KcBufs kc_block_bufs(unsigned char* smem, unsigned long long* gbuf, long long stride,
                                long long at, int C) {
  uint32_t* base = gbuf != nullptr ? (uint32_t*)(gbuf + at * stride) : (uint32_t*)smem;
  KcBufs buf = {base, base + C, (int*)(base + 2LL * C)};
  return buf;
}

template <class F, class N>
__global__ void __launch_bounds__(KC_THREADS)
kc_update(KcInput<F, N> in, KcState<F, N> out, int L, int C, int k,
          const float* __restrict__ samples, const int* __restrict__ meta,
          const F* __restrict__ minmax, unsigned long long* gbuf) {
  extern __shared__ __align__(16) unsigned char kc_smem[];
  __shared__ KcShared sh;
  const int m = meta[0];
  const int h = max(0, min(meta[1], L - 1));  // h <= 31 < L for any int32 count
  for (int l = threadIdx.x; l < L; l += KC_THREADS) {
    sh.sizes[l] = in.sizes[l];
    sh.parity[l] = in.parity[l];
  }
  __syncthreads();
  if (threadIdx.x == 0) sh.touched = kc_plan_update(sh.sizes, L, C, k, h, m);
  __syncthreads();
  if (blockIdx.x != 0) {
    kc_copy_untouched(out.items, in.items, L, C, sh.touched);
    return;
  }
  // the scalars' inputs, read early
  int ticks = 0;
  N count = 0;
  F g_min = 0;
  F g_max = 0;
  if (threadIdx.x == 0) {
    ticks = *in.ticks;
    count = *in.count + (N)meta[2];
    g_min = dq_min_z(*in.g_min, minmax[0]);
    g_max = dq_max_z(*in.g_max, minmax[1]);
  }
  // the touched rows, with the samples appended at level h
  const int size = sh.sizes[h];
  const int written = kc_written(m, size, C);
  for (int l = 0; l < L; ++l) {
    if ((sh.touched >> l) & 1ull) {
      kc_copy_row(out.items + (long long)l * C, in.items + (long long)l * C, C, samples,
                  l == h ? size : 0, l == h ? written : 0);
    }
  }
  const KcBufs buf = kc_block_bufs(kc_smem, gbuf, 0, 0, C);
  __syncthreads();
  sh.sizes[h] = size + written;  // the same value from every thread
  for (int lvl = h; lvl < L - 1 && sh.sizes[lvl] > k; ++lvl) {
    kc_compact(out.items, C, lvl, buf, sh);
  }
  for (int l = threadIdx.x; l < L; l += KC_THREADS) {
    out.sizes[l] = sh.sizes[l];
    out.parity[l] = sh.parity[l];
  }
  if (threadIdx.x == 0) {
    *out.ticks = (int)((unsigned)ticks + 1u);
    *out.count = count;
    *out.g_min = g_min;
    *out.g_max = g_max;
  }
}

// pair i = blockIdx.y of the stacked sketches a (items [M, L, C], sizes and
// parity [M, L], the scalars [M]) and b (the same shapes): out[i] becomes
// the merge of a[i] and b[i]; blockIdx.x == 0 merges, the others copy
template <class F, class N>
__global__ void __launch_bounds__(KC_THREADS)
kc_merge(KcInput<F, N> a, KcInput<F, N> b, KcState<F, N> out, int L, int C, int k,
         unsigned long long* gbuf, long long gbuf_stride) {
  extern __shared__ __align__(16) unsigned char kc_smem[];
  __shared__ KcShared sh;
  const long long i = blockIdx.y;
  const long long rows = i * L * C;
  float* items = out.items + rows;
  const float* b_items = b.items + rows;
  for (int l = threadIdx.x; l < L; l += KC_THREADS) {
    sh.sizes[l] = a.sizes[i * L + l];
    sh.b_sizes[l] = b.sizes[i * L + l];
    sh.parity[l] = a.parity[i * L + l] ^ b.parity[i * L + l];
  }
  __syncthreads();
  if (threadIdx.x == 0) sh.touched = kc_plan_merge(sh.sizes, sh.b_sizes, L, C, k);
  __syncthreads();
  if (blockIdx.x != 0) {
    kc_copy_untouched(items, a.items + rows, L, C, sh.touched);
    return;
  }
  // the scalars, read early
  int ticks = 0;
  N count = 0;
  F g_min = 0;
  F g_max = 0;
  if (threadIdx.x == 0) {
    ticks = (int)((unsigned)a.ticks[i] + (unsigned)b.ticks[i]);
    count = a.count[i] + b.count[i];
    g_min = dq_min_z(a.g_min[i], b.g_min[i]);
    g_max = dq_max_z(a.g_max[i], b.g_max[i]);
  }
  // the touched rows, each with b's level appended
  for (int l = 0; l < L; ++l) {
    if ((sh.touched >> l) & 1ull) {
      const long long at = (long long)l * C;
      kc_copy_row(items + at, a.items + rows + at, C, b_items + at, sh.sizes[l],
                  kc_written(sh.b_sizes[l], sh.sizes[l], C));
    }
  }
  const KcBufs buf = kc_block_bufs(kc_smem, gbuf, gbuf_stride, i, C);
  __syncthreads();
  for (int l = threadIdx.x; l < L; l += KC_THREADS) {
    sh.sizes[l] += kc_written(sh.b_sizes[l], sh.sizes[l], C);
  }
  __syncthreads();
  for (int lvl = 0; lvl < L - 1; ++lvl) {
    if (sh.sizes[lvl] > k) kc_compact(items, C, lvl, buf, sh);
  }
  for (int l = threadIdx.x; l < L; l += KC_THREADS) {
    out.sizes[i * L + l] = sh.sizes[l];
    out.parity[i * L + l] = sh.parity[l];
  }
  if (threadIdx.x == 0) {
    out.ticks[i] = ticks;
    out.count[i] = count;
    out.g_min[i] = g_min;
    out.g_max[i] = g_max;
  }
}

// stage sample `at`'s first min(m, C) float64 items into shared memory
__device__ void kc_stage(double* staging, const double* p_items, int m, long long at, int C) {
  const int count = max(0, min(m, C));
  const double* src = p_items + at * C;
  for (int c = threadIdx.x; c < (count + 1) / 2; c += KC_THREADS) {
    kc_cp_async16(staging + 2 * c, src + 2 * c);
  }
  kc_cp_async_commit();
}

// block s: sketch s of the stacked state (items [S, L, C], sizes and parity
// [S, L], the scalars [S]) takes its B samples (items [S, B, C] float64, m,
// h [S, B] int32, nv [S, B] int64, mn, mx [S, B] float64) in order, in
// place; staged: sample b + 1 is copied into shared memory during sample
// b's cascade
template <class F, class N>
__global__ void __launch_bounds__(KC_THREADS)
kc_ingest(KcState<F, N> st, int L, int C, int k, int B, const double* __restrict__ p_items,
          const int* __restrict__ p_m, const int* __restrict__ p_h,
          const N* __restrict__ p_nv, const F* __restrict__ p_min,
          const F* __restrict__ p_max, unsigned long long* gbuf, long long gbuf_stride,
          int staged) {
  extern __shared__ __align__(16) unsigned char kc_smem[];
  __shared__ KcShared sh;
  const int s = blockIdx.x;
  float* items = st.items + (long long)s * L * C;
  int* sizes = st.sizes + (long long)s * L;
  int* parity = st.parity + (long long)s * L;
  const KcBufs buf = kc_block_bufs(kc_smem, gbuf, gbuf_stride, s, C);
  double* staging = (double*)(kc_smem + kc_buf_words(C) * 4);
  for (int l = threadIdx.x; l < L; l += KC_THREADS) {
    sh.sizes[l] = sizes[l];
    sh.parity[l] = parity[l];
  }
  const long long first = (long long)s * B;
  // each sample's m and h are read one sample ahead
  int m_next = p_m[first];
  int h_next = p_h[first];
  if (staged) kc_stage(staging, p_items, m_next, first, C);
  for (int b = 0; b < B; ++b) {
    const long long at = first + b;
    const int m = m_next;
    const int h = max(0, min(h_next, L - 1));
    if (b + 1 < B) {
      m_next = p_m[at + 1];
      h_next = p_h[at + 1];
    }
    if (staged) kc_cp_async_wait_all();
    __syncthreads();
    const double* src = staged ? staging : p_items + at * C;
    const int size = sh.sizes[h];
    const int written = kc_written(m, size, C);
    float* row = items + (long long)h * C;
    for (int j = threadIdx.x; j < written; j += KC_THREADS) {
      double x = src[j];
      x = x > (double)FLT_MAX ? (double)FLT_MAX : (x < -(double)FLT_MAX ? -(double)FLT_MAX : x);
      row[size + j] = __double2float_rn(x);
    }
    __syncthreads();
    if (staged && b + 1 < B) kc_stage(staging, p_items, m_next, at + 1, C);
    sh.sizes[h] = size + written;  // the same value from every thread
    for (int lvl = h; lvl < L - 1 && sh.sizes[lvl] > k; ++lvl) {
      kc_compact(items, C, lvl, buf, sh);
    }
  }
  for (int l = threadIdx.x; l < L; l += KC_THREADS) {
    sizes[l] = sh.sizes[l];
    parity[l] = sh.parity[l];
  }
  // the scalars, folded over the samples in order
  if (threadIdx.x == 0) {
    unsigned ticks = (unsigned)st.ticks[s];
    N count = st.count[s];
    F g_min = st.g_min[s];
    F g_max = st.g_max[s];
    for (int b = 0; b < B; ++b) {
      ticks += 1u;
      count += p_nv[first + b];
      g_min = dq_min_z(g_min, p_min[first + b]);
      g_max = dq_max_z(g_max, p_max[first + b]);
    }
    st.ticks[s] = (int)ticks;
    st.count[s] = count;
    st.g_min[s] = g_min;
    st.g_max[s] = g_max;
  }
}

static size_t kc_level_bytes(int C) { return (size_t)kc_buf_words(C) * 4; }

// uint64 entries of device scratch one block's level sort needs: 0 when it
// fits in shared memory
extern "C" long long kll_compact_scratch(int C) {
  const size_t bytes = kc_level_bytes(C);
  return bytes <= KC_SMEM_LIMIT ? 0 : (long long)((bytes + 7) / 8);
}

static cudaError_t kc_prepare(const void* kernel, int C, const unsigned long long* gbuf,
                              size_t extra, size_t* smem) {
  if (kll_compact_scratch(C) > 0) {
    *smem = 0;
    return gbuf == nullptr ? cudaErrorInvalidValue : cudaSuccess;
  }
  *smem = kc_level_bytes(C) + extra;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)*smem);
}

static bool kc_bad_shape(int L, int C, int k) {
  return L < 2 || L > KC_MAX_LEVELS || C < 1 || k < 1;
}

static dim3 kc_grid(int L, int M) {
  return dim3(1 + (L < KC_COPY_BLOCKS ? L : KC_COPY_BLOCKS), M);
}

// out: the seven leaves of a new state (written whole); in: the state
// updated, read only; gbuf: uint64[kll_compact_scratch(C)] of device
// scratch, or null when that is 0
template <class F, class N>
static int kc_update_launch(KcInput<F, N> in, KcState<F, N> out, int L, int C, int k,
                            const float* samples, const int* meta, const F* minmax,
                            unsigned long long* gbuf, void* stream) {
  if (kc_bad_shape(L, C, k)) return (int)cudaErrorInvalidValue;
  size_t smem = 0;
  cudaError_t err = kc_prepare((const void*)kc_update<F, N>, C, gbuf, 0, &smem);
  if (err != cudaSuccess) return (int)err;
  kc_update<F, N><<<kc_grid(L, 1), KC_THREADS, smem, (cudaStream_t)stream>>>(
      in, out, L, C, k, samples, meta, minmax, smem > 0 ? nullptr : gbuf);
  return (int)cudaGetLastError();
}

// the stacked merge of M pairs into a new stacked state `out`; gbuf:
// uint64[M * kll_compact_scratch(C)] of device scratch, or null when that
// is 0
template <class F, class N>
static int kc_merge_launch(KcInput<F, N> a, KcInput<F, N> b, KcState<F, N> out, int M, int L,
                           int C, int k, unsigned long long* gbuf, void* stream) {
  if (kc_bad_shape(L, C, k) || M < 1 || M > 65535) return (int)cudaErrorInvalidValue;
  size_t smem = 0;
  cudaError_t err = kc_prepare((const void*)kc_merge<F, N>, C, gbuf, 0, &smem);
  if (err != cudaSuccess) return (int)err;
  kc_merge<F, N><<<kc_grid(L, M), KC_THREADS, smem, (cudaStream_t)stream>>>(
      a, b, out, L, C, k, smem > 0 ? nullptr : gbuf, kll_compact_scratch(C));
  return (int)cudaGetLastError();
}

// the stacked sketches of kc_ingest, updated in place; gbuf: uint64[S *
// kll_compact_scratch(C)] of device scratch, or null when that is 0
template <class F, class N>
static int kc_ingest_launch(KcState<F, N> st, int S, int L, int C, int k, int B,
                            const double* p_items, const int* p_m, const int* p_h,
                            const N* p_nv, const F* p_min, const F* p_max,
                            unsigned long long* gbuf, void* stream) {
  if (kc_bad_shape(L, C, k) || S < 1 || B < 1) return (int)cudaErrorInvalidValue;
  // stage the samples where shared memory holds them beside the level
  // buffers and the copies are whole 16-byte pieces
  const size_t staging = (size_t)C * 8;
  const int staged = kll_compact_scratch(C) == 0 &&
                     kc_level_bytes(C) + staging <= KC_SMEM_LIMIT && (C & 1) == 0 &&
                     ((uintptr_t)p_items & 15u) == 0;
  size_t smem = 0;
  cudaError_t err =
      kc_prepare((const void*)kc_ingest<F, N>, C, gbuf, staged ? staging : 0, &smem);
  if (err != cudaSuccess) return (int)err;
  kc_ingest<F, N><<<S, KC_THREADS, smem, (cudaStream_t)stream>>>(
      st, L, C, k, B, p_items, p_m, p_h, p_nv, p_min, p_max, smem > 0 ? nullptr : gbuf,
      kll_compact_scratch(C), staged);
  return (int)cudaGetLastError();
}

// The C entries, float64 / int64 scalars and their _f32 twins (float32 /
// int32), one macro body each: the seven leaves of a sketch are
// items, sizes, parity, ticks, count, g_min, g_max.
#define KC_ENTRIES(SUFFIX, F, N)                                                               \
  extern "C" int kll_compact_update_launch##SUFFIX(                                            \
      const float* items, const int* sizes, const int* parity, const int* ticks,               \
      const N* count, const F* g_min, const F* g_max, float* o_items, int* o_sizes,            \
      int* o_parity, int* o_ticks, N* o_count, F* o_g_min, F* o_g_max, int L, int C, int k,    \
      const float* samples, const int* meta, const F* minmax, unsigned long long* gbuf,        \
      void* stream) {                                                                          \
    KcInput<F, N> in = {items, sizes, parity, ticks, count, g_min, g_max};                     \
    KcState<F, N> out = {o_items, o_sizes, o_parity, o_ticks, o_count, o_g_min, o_g_max};      \
    return kc_update_launch<F, N>(in, out, L, C, k, samples, meta, minmax, gbuf, stream);      \
  }                                                                                            \
  extern "C" int kll_compact_merge_stacked_launch##SUFFIX(                                     \
      const float* items, const int* sizes, const int* parity, const int* ticks,               \
      const N* count, const F* g_min, const F* g_max, const float* b_items, const int* b_sizes, \
      const int* b_parity, const int* b_ticks, const N* b_count, const F* b_g_min,             \
      const F* b_g_max, float* o_items, int* o_sizes, int* o_parity, int* o_ticks, N* o_count, \
      F* o_g_min, F* o_g_max, int M, int L, int C, int k, unsigned long long* gbuf,            \
      void* stream) {                                                                          \
    KcInput<F, N> a = {items, sizes, parity, ticks, count, g_min, g_max};                      \
    KcInput<F, N> b = {b_items, b_sizes, b_parity, b_ticks, b_count, b_g_min, b_g_max};        \
    KcState<F, N> out = {o_items, o_sizes, o_parity, o_ticks, o_count, o_g_min, o_g_max};      \
    return kc_merge_launch<F, N>(a, b, out, M, L, C, k, gbuf, stream);                         \
  }                                                                                            \
  extern "C" int kll_compact_merge_launch##SUFFIX(                                             \
      const float* items, const int* sizes, const int* parity, const int* ticks,               \
      const N* count, const F* g_min, const F* g_max, const float* b_items, const int* b_sizes, \
      const int* b_parity, const int* b_ticks, const N* b_count, const F* b_g_min,             \
      const F* b_g_max, float* o_items, int* o_sizes, int* o_parity, int* o_ticks, N* o_count, \
      F* o_g_min, F* o_g_max, int L, int C, int k, unsigned long long* gbuf, void* stream) {   \
    KcInput<F, N> a = {items, sizes, parity, ticks, count, g_min, g_max};                      \
    KcInput<F, N> b = {b_items, b_sizes, b_parity, b_ticks, b_count, b_g_min, b_g_max};        \
    KcState<F, N> out = {o_items, o_sizes, o_parity, o_ticks, o_count, o_g_min, o_g_max};      \
    return kc_merge_launch<F, N>(a, b, out, 1, L, C, k, gbuf, stream);                         \
  }                                                                                            \
  extern "C" int kll_compact_ingest_launch##SUFFIX(                                            \
      float* items, int* sizes, int* parity, int* ticks, N* count, F* g_min, F* g_max, int S,  \
      int L, int C, int k, int B, const double* p_items, const int* p_m, const int* p_h,       \
      const N* p_nv, const F* p_min, const F* p_max, unsigned long long* gbuf, void* stream) { \
    KcState<F, N> st = {items, sizes, parity, ticks, count, g_min, g_max};                     \
    return kc_ingest_launch<F, N>(st, S, L, C, k, B, p_items, p_m, p_h, p_nv, p_min, p_max,    \
                                  gbuf, stream);                                               \
  }

KC_ENTRIES(, double, long long)
KC_ENTRIES(_f32, float, int)
