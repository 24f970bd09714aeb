// K1 scan_reduce: every scalar reduction of one batch, for a table of slots,
// in one launch.
//
// Replaces the fused per-batch update of the JAX reference,
// PackedScanProgram.fused_update (deequ_tpu/runners/engine.py:366) over the
// analyzers' update functions in deequ_tpu/analyzers/simple.py: Size :127,
// Completeness :189, Compliance :232, PatternMatch :302, Mean :354, Sum :383,
// Minimum :415, Maximum :448, MinLength :519, MaxLength :545 and
// StandardDeviation :572, DataType.update :779 (a class-count slot) and
// Correlation.update :661 (a co-moment slot).
//
// A slot names up to three byte masks and a value array; the batch row mask
// is shared by all slots. Per slot the kernel writes
//   out_i[s] = (matches, count)    matches = sum(rows & where & sel),
//                                  count   = sum(rows & where)
//   out_f[s] = (sum, min, max, mean, m2) over the selected values:
//              min in the NaN-largest order (NaN skipped; NaN if none),
//              max with NaN propagation (-inf if none), and the batch's
//              (mean, M2) about its own mean for StandardDeviation.
// Counting slots (kind 0) carry no values and leave out_f at identities.
// A class-count slot (kind 2) reads int32 codes in its value array and also
// writes out_i[s][2 + c] = sum(rows & where & (code == c)) for the five
// type classes c of DataType; its matches count the rows with a code in
// [0, 5). Every other slot leaves those five columns at 0.
// A co-moment slot (kind 3) reads two float64 arrays (vals, vals2); its
// selected rows are rows & where & sel & sel2 (both columns present), and
// it writes out_f[s] = (x_avg, y_avg, ck, x_mk, y_mk): the two means and
// the centred co-moments of the selected rows, Correlation's batch state
// (its n is out_i[s][0]).
//
// Bound on the card: bytes. Each distinct input array is read from device
// memory once (the row mask, each mask and value array: 1 to 8 bytes per
// row); the arithmetic is a few adds and compares per selected value, far
// below the H100's rate. The design keeps many loads in flight and reads
// each array once:
//   - The wrapper hands the kernel the table's DISTINCT arrays (the row
//     mask first) and, per slot, indices into that list: a where-filter,
//     mask or column under several slots is one array.
//   - A block owns a chunk of CHUNK rows (128, 256 or 512, chosen by the
//     wrapper from n and the table's bytes a row, never from the number of
//     sessions) and first stages every distinct array's rows of the chunk
//     into shared memory with cp.async: all of the chunk's loads are issued
//     before any is waited on. Small chunks keep several blocks' stages in
//     flight on each SM.
//   - Each warp takes every fourth slot and reduces it over the whole
//     chunk from shared memory, with no block barrier: a lane holds 4
//     consecutive rows a step (one 32-bit word of each mask, a double2 pair
//     or an int4 of values), selects with predicates, and the warp reduces
//     with redux (counts, and min/max as 64-bit order keys in two 32-bit
//     halves) and xor shuffles (sums). A moments or co-moment slot's second
//     pass, about the chunk's own means, re-reads the staged chunk, never
//     device memory.
// Each warp writes its slot's chunk partial: the counts as int32, the sum,
// min, max, the chunk's mean and M2 about it (co-moments: the two sums,
// the two means and the three co-moments about them), column by column.
//
// Sessions (the stacked entry, replacing the coalesced fold of the JAX
// reference: PackedScanProgram.init_carry_stacked :490,
// call_with_slots_stacked :501 and unpack_stacked_final :514, a jax.vmap of
// fused_update over a leading session axis, driven by
// fold_sessions_coalesced :818): one launch reduces W sessions' batches of
// n rows each. Every array of the slot table and the row mask is a [W, n]
// row-major tensor; session w's rows start at w * n, and its chunks are
// blocks w * n_chunks .. (w + 1) * n_chunks - 1. The chunks of
// a session and the fold of its partials are those of a launch over that
// session alone (W = 1 is the single-batch launch), so
// each session's outputs equal a one-session launch over its batch bit for
// bit.
//
// The fold: a second launch, one 512-thread block per slot and session,
// in two passes over the session's chunk partials: first the counts, sums,
// min and max (each thread a stride of chunks in order, then a fixed tree
// across the threads), which give the batch's means; then M2 (and the
// co-moments) as the sum over chunks of the chunk's own M2 plus n_c times
// the squared distance of its mean from the batch's, in the same order.
// One division per slot, no chain of pairwise merges. No float atomics:
// the same order on every run, so the result is the same bits every run.
//
// Two instantiations of every kernel, one entry each: scan_reduce_launch
// (float64 values, sums and moments; int64 counts) and
// scan_reduce_launch_f32, the reference's 32-bit accumulator mode
// (DEEQU_TPU_NO_X64: float32 values read as float4, sums, means and M2
// in float32, min and max keyed on the float's 32 bits so one redux
// takes each, counts written as int32). Lengths and codes are int32 in
// both.
#include <stdint.h>

#include <math_constants.h>

#include "common.cuh"

#define SR_MAX_SLOTS 64
// the row mask and at most five arrays a slot
#define SR_MAX_ARRAYS (1 + 5 * SR_MAX_SLOTS)
#define SR_NONE 0xFFFF
#define SR_THREADS 128
#define SR_WARPS (SR_THREADS / 32)
// rows a warp covers in one step: 32 lanes x 4 consecutive rows
#define SR_STEP 128
// threads of the fold launch, one block per slot and session
#define SR_FOLD_THREADS 512
#define SR_FOLD_WARPS (SR_FOLD_THREADS / 32)

#define SR_KIND_COUNTS 0
#define SR_KIND_MOMENTS 1
#define SR_KIND_CLASSES 2
#define SR_KIND_COMOMENTS 3
#define SR_CLASSES 5
// int64 columns per slot of the output: matches, count, the class counts
#define SR_IWIDTH (2 + SR_CLASSES)
// columns of a chunk partial, int32 (matches, count, class counts) and
// float64 alike (moments: sum, min, max, mean, m2; co-moments: sum x,
// sum y, x mean, y mean, ck, x_mk, y_mk)
#define SR_PWIDTH 7

// a slot as six uint16 words of deequ_tpu_torch/kernels/scan_reduce.py _Table.slot
struct SrSlot {
  uint8_t kind;      // SR_KIND_*
  uint8_t vals_i32;  // 1: int32 values (string lengths, class codes); 0: float64
  uint16_t where, sel, vals, vals2, sel2;  // indices into SrTable.ptr; SR_NONE: absent
};

// mirrors deequ_tpu_torch/kernels/scan_reduce.py _Table; passed by value
// (under the 4 KB of a launch's parameters)
struct SrTable {
  const void* ptr[SR_MAX_ARRAYS];  // the distinct [W, n] arrays; ptr[0] is the row mask
  uint16_t at[SR_MAX_ARRAYS + 1];  // bytes a row of arrays [0, a): array a's
                                   // rows of a staged chunk start at chunk * at[a]
  SrSlot slot[SR_MAX_SLOTS];
  int32_t n_arrays;
  int32_t n_slots;
};

__device__ __forceinline__ void sr_cp_async16(void* dst, const void* src, int bytes) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src), "r"(bytes)
               : "memory");
}

// A value's place in the order min and max use on non-NaN values: -inf
// lowest, -0.0 below +0.0 (common.cuh's rules), as an unsigned key of the
// value's width, and the warp's least and greatest key (redux on 32-bit
// halves). T is the accumulator type: double, or float in the 32-bit
// accumulator mode (DEEQU_TPU_NO_X64), whose keys are one 32-bit word.
template <class T>
struct SrKey;

template <>
struct SrKey<double> {
  typedef unsigned long long K;
  __device__ static __forceinline__ K key(double v) {
    const unsigned long long b = (unsigned long long)__double_as_longlong(v);
    return (b >> 63) ? ~b : (b | 0x8000000000000000ull);
  }
  __device__ static __forceinline__ double unkey(K k) {
    return __longlong_as_double((long long)((k >> 63) ? (k & 0x7fffffffffffffffull) : ~k));
  }
  __device__ static __forceinline__ K warp_min(K k) {
    const unsigned hi = __reduce_min_sync(0xffffffffu, (unsigned)(k >> 32));
    const unsigned lo = __reduce_min_sync(
        0xffffffffu, (unsigned)(k >> 32) == hi ? (unsigned)k : 0xffffffffu);
    return ((unsigned long long)hi << 32) | lo;
  }
  __device__ static __forceinline__ K warp_max(K k) {
    const unsigned hi = __reduce_max_sync(0xffffffffu, (unsigned)(k >> 32));
    const unsigned lo =
        __reduce_max_sync(0xffffffffu, (unsigned)(k >> 32) == hi ? (unsigned)k : 0u);
    return ((unsigned long long)hi << 32) | lo;
  }
};

template <>
struct SrKey<float> {
  typedef unsigned K;
  __device__ static __forceinline__ K key(float v) {
    const unsigned b = __float_as_uint(v);
    return (b >> 31) ? ~b : (b | 0x80000000u);
  }
  __device__ static __forceinline__ float unkey(K k) {
    return __uint_as_float((k >> 31) ? (k & 0x7fffffffu) : ~k);
  }
  __device__ static __forceinline__ K warp_min(K k) { return __reduce_min_sync(0xffffffffu, k); }
  __device__ static __forceinline__ K warp_max(K k) { return __reduce_max_sync(0xffffffffu, k); }
};

// the same sum in every lane: xor shuffles add each pair in both orders,
// and a + b == b + a
template <class T>
__device__ __forceinline__ T sr_warp_sum(T v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// A warp's view of one staged chunk: the rows a lane holds at step k are
// 128 k + 4 lane + j (j < 4); their row-mask bytes, one per row, ANDed
// with the chunk's tail.
template <int K>
struct SrChunk {
  const unsigned char* stage;
  int m;  // rows of the chunk that exist
  int lane;
  long long w;    // the session
  int c;          // the chunk within the session
  int n_chunks;   // chunks a session

  // where slot s's partials go: column col of chunk c of session w
  __device__ __forceinline__ long long part(int s, int n_slots, int col) const {
    return (((w * n_slots + s) * SR_PWIDTH) + col) * (long long)n_chunks + c;
  }

  __device__ __forceinline__ const unsigned char* array(const SrTable& t, int a) const {
    return stage + (size_t)(SR_STEP * K) * t.at[a];
  }

  __device__ __forceinline__ uint32_t word(const unsigned char* a, int k) const {
    return reinterpret_cast<const uint32_t*>(a)[32 * k + lane];
  }

  // the row mask and the where mask of step k, 0 or 1 in each byte
  __device__ __forceinline__ uint32_t base(const SrTable& t, const SrSlot& s, int k) const {
    const int left = m - (SR_STEP * k + 4 * lane);
    uint32_t w = left >= 4 ? 0x01010101u : (left <= 0 ? 0u : 0x01010101u >> (8 * (4 - left)));
    w &= word(array(t, 0), k);
    if (s.where != SR_NONE) w &= word(array(t, s.where), k);
    return w;
  }

  __device__ __forceinline__ uint32_t selected(const SrTable& t, const SrSlot& s,
                                               uint32_t base_word, int k) const {
    uint32_t w = base_word;
    if (s.sel != SR_NONE) w &= word(array(t, s.sel), k);
    if (s.sel2 != SR_NONE) w &= word(array(t, s.sel2), k);
    return w;
  }

  // the four values of step k in the accumulator type T (the value
  // arrays of a launch are int32 or of type T)
  template <class T>
  __device__ __forceinline__ void values(const SrTable& t, uint16_t a, bool i32, int k,
                                         T v[4]) const {
    const unsigned char* p = array(t, a);
    if (i32) {
      const int4 q = reinterpret_cast<const int4*>(p)[32 * k + lane];
      v[0] = (T)q.x;
      v[1] = (T)q.y;
      v[2] = (T)q.z;
      v[3] = (T)q.w;
    } else if constexpr (sizeof(T) == 8) {
      const double2* d = reinterpret_cast<const double2*>(p) + 64 * k + 2 * lane;
      const double2 a0 = d[0];
      const double2 a1 = d[1];
      v[0] = a0.x;
      v[1] = a0.y;
      v[2] = a1.x;
      v[3] = a1.y;
    } else {
      const float4 q = reinterpret_cast<const float4*>(p)[32 * k + lane];
      v[0] = q.x;
      v[1] = q.y;
      v[2] = q.z;
      v[3] = q.w;
    }
  }
};

template <int K>
__device__ void sr_counts(const SrTable& t, const SrSlot& sl, const SrChunk<K>& ch, int s,
                          int* __restrict__ part_i) {
  // PHASE pass1
  unsigned base = 0, sel = 0;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const uint32_t b = ch.base(t, sl, k);
    base += __popc(b);
    sel += __popc(ch.selected(t, sl, b, k));
  }
  // PHASE reduce1
  const unsigned both = __reduce_add_sync(0xffffffffu, base | (sel << 16));
  // PHASE pass2
  // PHASE write
  if (ch.lane == 0) {
    part_i[ch.part(s, t.n_slots, 0)] = (int)(both >> 16);
    part_i[ch.part(s, t.n_slots, 1)] = (int)(both & 0xffffu);
  }
  // PHASE done
}

template <int K>
__device__ void sr_classes(const SrTable& t, const SrSlot& sl, const SrChunk<K>& ch, int s,
                           int* __restrict__ part_i) {
  // PHASE pass1
  // class counts two to a word (a warp counts at most a chunk's 512 rows)
  unsigned c01 = 0, c23 = 0, c4b = 0;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const uint32_t b = ch.base(t, sl, k);
    const int4 q = reinterpret_cast<const int4*>(ch.array(t, sl.vals))[32 * k + ch.lane];
    const int code[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const unsigned f = (b >> (8 * j)) & 1u;
      const int c = code[j];
      c01 += (f & (c == 0)) | ((f & (c == 1)) << 16);
      c23 += (f & (c == 2)) | ((f & (c == 3)) << 16);
      c4b += (f & (c == 4)) | (f << 16);
    }
  }
  // PHASE reduce1
  c01 = __reduce_add_sync(0xffffffffu, c01);
  c23 = __reduce_add_sync(0xffffffffu, c23);
  c4b = __reduce_add_sync(0xffffffffu, c4b);
  // PHASE pass2
  // PHASE write
  if (ch.lane == 0) {
    const int cls[SR_CLASSES] = {(int)(c01 & 0xffffu), (int)(c01 >> 16), (int)(c23 & 0xffffu),
                                 (int)(c23 >> 16), (int)(c4b & 0xffffu)};
    int matches = 0;
#pragma unroll
    for (int c = 0; c < SR_CLASSES; ++c) {
      part_i[ch.part(s, t.n_slots, 2 + c)] = cls[c];
      matches += cls[c];
    }
    part_i[ch.part(s, t.n_slots, 0)] = matches;
    part_i[ch.part(s, t.n_slots, 1)] = (int)(c4b >> 16);
  }
  // PHASE done
}

template <int K, class T>
__device__ void sr_moments(const SrTable& t, const SrSlot& sl, const SrChunk<K>& ch, int s,
                           int* __restrict__ part_i, T* __restrict__ part_f) {
  typedef SrKey<T> Key;
  // PHASE pass1
  unsigned base = 0, sel = 0, nonnan = 0, has_nan = 0;
  T sum = 0;
  typename Key::K kmin = Key::key((T)CUDART_INF), kmax = Key::key((T)-CUDART_INF);
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const uint32_t b = ch.base(t, sl, k);
    const uint32_t m = ch.selected(t, sl, b, k);
    T v[4];
    ch.values(t, sl.vals, sl.vals_i32, k, v);
    base += __popc(b);
    sel += __popc(m);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const bool f = (m >> (8 * j)) & 1u;
      const bool nan = isnan(v[j]);
      sum += f ? v[j] : (T)0;
      has_nan |= (unsigned)(f && nan);
      const bool ok = f && !nan;
      nonnan += ok;
      const typename Key::K key = Key::key(v[j]);
      kmin = ok && key < kmin ? key : kmin;
      kmax = ok && key > kmax ? key : kmax;
    }
  }
  // PHASE reduce1
  const unsigned counts = __reduce_add_sync(0xffffffffu, base | (sel << 16));
  const unsigned nans = __reduce_add_sync(0xffffffffu, nonnan | (has_nan << 16));
  kmin = Key::warp_min(kmin);
  kmax = Key::warp_max(kmax);
  sum = sr_warp_sum(sum);
  const unsigned n = counts >> 16;
  const T mean = n > 0 ? sum / (T)n : (T)0;
  // PHASE pass2
  T m2 = 0;
  if (n > 0) {  // uniform across the warp
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const uint32_t m = ch.selected(t, sl, ch.base(t, sl, k), k);
      T v[4];
      ch.values(t, sl.vals, sl.vals_i32, k, v);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const T d = v[j] - mean;
        m2 += ((m >> (8 * j)) & 1u) ? d * d : (T)0;
      }
    }
    m2 = sr_warp_sum(m2);
  }
  // PHASE write
  if (ch.lane == 0) {
    part_i[ch.part(s, t.n_slots, 0)] = (int)n;
    part_i[ch.part(s, t.n_slots, 1)] = (int)(counts & 0xffffu);
    part_f[ch.part(s, t.n_slots, 0)] = sum;
    part_f[ch.part(s, t.n_slots, 1)] = (nans & 0xffffu) ? Key::unkey(kmin) : (T)CUDART_NAN;
    part_f[ch.part(s, t.n_slots, 2)] = (nans >> 16) ? (T)CUDART_NAN : Key::unkey(kmax);
    part_f[ch.part(s, t.n_slots, 3)] = mean;
    part_f[ch.part(s, t.n_slots, 4)] = m2;
  }
  // PHASE done
}

template <int K, class T>
__device__ void sr_comoments(const SrTable& t, const SrSlot& sl, const SrChunk<K>& ch, int s,
                             int* __restrict__ part_i, T* __restrict__ part_f) {
  // PHASE pass1
  unsigned base = 0, sel = 0;
  T sx = 0, sy = 0;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const uint32_t b = ch.base(t, sl, k);
    const uint32_t m = ch.selected(t, sl, b, k);
    T x[4], y[4];
    ch.values(t, sl.vals, false, k, x);
    ch.values(t, sl.vals2, false, k, y);
    base += __popc(b);
    sel += __popc(m);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const bool f = (m >> (8 * j)) & 1u;
      sx += f ? x[j] : (T)0;
      sy += f ? y[j] : (T)0;
    }
  }
  // PHASE reduce1
  const unsigned counts = __reduce_add_sync(0xffffffffu, base | (sel << 16));
  sx = sr_warp_sum(sx);
  sy = sr_warp_sum(sy);
  const unsigned n = counts >> 16;
  const T mx = n > 0 ? sx / (T)n : (T)0;
  const T my = n > 0 ? sy / (T)n : (T)0;
  // PHASE pass2
  T ck = 0, xmk = 0, ymk = 0;
  if (n > 0) {  // uniform across the warp
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const uint32_t m = ch.selected(t, sl, ch.base(t, sl, k), k);
      T x[4], y[4];
      ch.values(t, sl.vals, false, k, x);
      ch.values(t, sl.vals2, false, k, y);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const bool f = (m >> (8 * j)) & 1u;
        const T dx = x[j] - mx;
        const T dy = y[j] - my;
        ck += f ? dx * dy : (T)0;
        xmk += f ? dx * dx : (T)0;
        ymk += f ? dy * dy : (T)0;
      }
    }
    ck = sr_warp_sum(ck);
    xmk = sr_warp_sum(xmk);
    ymk = sr_warp_sum(ymk);
  }
  // PHASE write
  if (ch.lane == 0) {
    part_i[ch.part(s, t.n_slots, 0)] = (int)n;
    part_i[ch.part(s, t.n_slots, 1)] = (int)(counts & 0xffffu);
    const T f[SR_PWIDTH] = {sx, sy, mx, my, ck, xmk, ymk};
#pragma unroll
    for (int c = 0; c < SR_PWIDTH; ++c) part_f[ch.part(s, t.n_slots, c)] = f[c];
  }
  // PHASE done
}

// Stage chunk t (of the W x n_chunks chunks, session-major) of every
// distinct array into `buf`: 16-byte cp.async copies, issued together and
// committed as one group; an array view that starts off 16 bytes (a
// session of odd length) is copied by element loads instead.
template <int K>
__device__ __forceinline__ void sr_stage_chunk(const SrTable& table, long long n, int n_chunks,
                                               long long t, unsigned char* buf) {
  constexpr int CHUNK = SR_STEP * K;
  const long long w = t / n_chunks;
  const long long r0 = (t - w * n_chunks) * CHUNK;
  const long long left = n - r0;
  const int m = left <= 0 ? 0 : (left < CHUNK ? (int)left : CHUNK);
  const long long first = w * n + r0;  // in every [W, n] array
  for (int a = 0; a < table.n_arrays; ++a) {
    const int es = table.at[a + 1] - table.at[a];
    unsigned char* dst = buf + (size_t)CHUNK * table.at[a];
    const unsigned char* src = (const unsigned char*)table.ptr[a] + first * es;
    const int bytes = m * es;
    if ((reinterpret_cast<uintptr_t>(src) & 15) == 0) {
      for (int o = 16 * threadIdx.x; o < bytes; o += 16 * SR_THREADS) {
        sr_cp_async16(dst + o, src + o, bytes - o < 16 ? bytes - o : 16);
      }
    } else {
      for (int o = es * threadIdx.x; o < bytes; o += es * SR_THREADS) {
        if (es == 8) {
          *reinterpret_cast<unsigned long long*>(dst + o) =
              __ldg(reinterpret_cast<const unsigned long long*>(src + o));
        } else if (es == 4) {
          *reinterpret_cast<unsigned*>(dst + o) = __ldg(reinterpret_cast<const unsigned*>(src + o));
        } else {
          dst[o] = __ldg(src + o);
        }
      }
    }
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// One block per chunk of CHUNK = 128 K rows, blockIdx.x the chunk t of
// the W x n_chunks chunks (session-major): stage the chunk's distinct
// arrays, then each warp reduces its slots over it. A chunk's partials
// depend on its rows alone.
template <int K, class T>
__global__ void __launch_bounds__(SR_THREADS)
scan_reduce_chunks(const __grid_constant__ SrTable table, long long n, int n_chunks,
                   int* __restrict__ part_i, T* __restrict__ part_f) {
  extern __shared__ __align__(16) unsigned char sr_stage[];
  constexpr int CHUNK = SR_STEP * K;
  const long long t = blockIdx.x;
  // PHASE stage0
  sr_stage_chunk<K>(table, n, n_chunks, t, sr_stage);
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();
  // PHASE stage1
  SrChunk<K> ch;
  ch.stage = sr_stage;
  ch.lane = threadIdx.x & 31;
  ch.n_chunks = n_chunks;
  ch.w = t / n_chunks;
  ch.c = (int)(t - ch.w * n_chunks);
  const long long left = n - (long long)ch.c * CHUNK;
  ch.m = left <= 0 ? 0 : (left < CHUNK ? (int)left : CHUNK);
  for (int s = threadIdx.x >> 5; s < table.n_slots; s += SR_WARPS) {
    const SrSlot sl = table.slot[s];
    switch (sl.kind) {
      case SR_KIND_MOMENTS:
        sr_moments<K, T>(table, sl, ch, s, part_i, part_f);
        break;
      case SR_KIND_CLASSES:
        sr_classes<K>(table, sl, ch, s, part_i);
        break;
      case SR_KIND_COMOMENTS:
        sr_comoments<K, T>(table, sl, ch, s, part_i, part_f);
        break;
      default:
        sr_counts<K>(table, sl, ch, s, part_i);
        break;
    }
  }
}

// The fold of one slot: pass 1 adds the counts and sums and takes min and
// max, pass 2 the second moments; in each, thread t takes chunks t, t +
// SR_FOLD_THREADS, ... in order, loading SR_FOLD_BATCH of them before it
// adds any, and then the block reduces in a fixed tree (each warp by down
// shuffles, then thread 0 adds the warps in order).
#define SR_FOLD_BATCH 8

template <class T>
struct SrFold {
  long long i[SR_IWIDTH];
  T a, b;    // moments: sum; co-moments: sum x, sum y
  T mn, mx;  // moments: min, max
};

template <int KIND, class T>
__device__ __forceinline__ void sr_fold_add(SrFold<T>& x, const SrFold<T>& y) {
  constexpr int icols = KIND == SR_KIND_CLASSES ? SR_IWIDTH : 2;
#pragma unroll
  for (int c = 0; c < icols; ++c) x.i[c] += y.i[c];
  if (KIND == SR_KIND_MOMENTS) {
    x.a += y.a;
    x.mn = dq_min_nan_largest(x.mn, y.mn);
    x.mx = dq_max_nan(x.mx, y.mx);
  } else if (KIND == SR_KIND_COMOMENTS) {
    x.a += y.a;
    x.b += y.b;
  }
}

template <int KIND, class T>
__device__ __forceinline__ SrFold<T> sr_fold_shfl(const SrFold<T>& x, int off) {
  SrFold<T> y = x;
  constexpr int icols = KIND == SR_KIND_CLASSES ? SR_IWIDTH : 2;
#pragma unroll
  for (int c = 0; c < icols; ++c) y.i[c] = __shfl_down_sync(0xffffffffu, x.i[c], off);
  y.a = __shfl_down_sync(0xffffffffu, x.a, off);
  y.b = __shfl_down_sync(0xffffffffu, x.b, off);
  y.mn = __shfl_down_sync(0xffffffffu, x.mn, off);
  y.mx = __shfl_down_sync(0xffffffffu, x.mx, off);
  return y;
}

// the sum of three values over the fold block, in a fixed order; thread
// 0 gets it
template <class T>
__device__ __forceinline__ void sr_block_sum3(T& x, T& y, T& z, T (*scratch)[3]) {
  for (int off = 16; off > 0; off >>= 1) {
    x += __shfl_down_sync(0xffffffffu, x, off);
    y += __shfl_down_sync(0xffffffffu, y, off);
    z += __shfl_down_sync(0xffffffffu, z, off);
  }
  if ((threadIdx.x & 31) == 0) {
    scratch[threadIdx.x >> 5][0] = x;
    scratch[threadIdx.x >> 5][1] = y;
    scratch[threadIdx.x >> 5][2] = z;
  }
  __syncthreads();
  x = scratch[0][0];
  y = scratch[0][1];
  z = scratch[0][2];
  for (int w = 1; w < SR_FOLD_WARPS; ++w) {
    x += scratch[w][0];
    y += scratch[w][1];
    z += scratch[w][2];
  }
}

// slot s of session w: pi / pf its partials' columns (column c at c * C),
// oi / of its outputs
template <int KIND, class F, class I>
__device__ void sr_fold_slot(const int* __restrict__ pi, const F* __restrict__ pf, int C,
                             I* __restrict__ oi, F* __restrict__ of) {
  constexpr int icols = KIND == SR_KIND_CLASSES ? SR_IWIDTH : 2;
  constexpr bool moments = KIND == SR_KIND_MOMENTS;
  constexpr bool comoments = KIND == SR_KIND_COMOMENTS;
  constexpr int T = SR_FOLD_THREADS;
  const F zero = 0;
  const F nan = (F)CUDART_NAN;
  const F ninf = (F)-CUDART_INF;
  __shared__ SrFold<F> warps[SR_FOLD_WARPS];
  __shared__ F sums[SR_FOLD_WARPS][3];
  SrFold<F> f;
#pragma unroll
  for (int c = 0; c < SR_IWIDTH; ++c) f.i[c] = 0;
  f.a = zero;
  f.b = zero;
  f.mn = nan;
  f.mx = ninf;
  // pass 1
  for (int c0 = threadIdx.x; c0 < C; c0 += SR_FOLD_BATCH * T) {
    int iv[SR_FOLD_BATCH][icols];
    F a[SR_FOLD_BATCH], b[SR_FOLD_BATCH], mn[SR_FOLD_BATCH], mx[SR_FOLD_BATCH];
#pragma unroll
    for (int u = 0; u < SR_FOLD_BATCH; ++u) {
      const int c = c0 + u * T;
      const bool in = c < C;
#pragma unroll
      for (int col = 0; col < icols; ++col) iv[u][col] = in ? pi[(long long)col * C + c] : 0;
      a[u] = in && (moments || comoments) ? pf[c] : zero;
      b[u] = in && comoments ? pf[(long long)C + c] : zero;
      mn[u] = in && moments ? pf[(long long)C + c] : nan;
      mx[u] = in && moments ? pf[2LL * C + c] : ninf;
    }
#pragma unroll
    for (int u = 0; u < SR_FOLD_BATCH; ++u) {
      if (c0 + u * T >= C) break;
#pragma unroll
      for (int col = 0; col < icols; ++col) f.i[col] += iv[u][col];
      if (moments) {
        f.a += a[u];
        f.mn = dq_min_nan_largest(f.mn, mn[u]);
        f.mx = dq_max_nan(f.mx, mx[u]);
      } else if (comoments) {
        f.a += a[u];
        f.b += b[u];
      }
    }
  }
  for (int off = 16; off > 0; off >>= 1) {
    sr_fold_add<KIND, F>(f, sr_fold_shfl<KIND, F>(f, off));
  }
  if ((threadIdx.x & 31) == 0) warps[threadIdx.x >> 5] = f;
  __syncthreads();
  f = warps[0];
  for (int k = 1; k < SR_FOLD_WARPS; ++k) sr_fold_add<KIND, F>(f, warps[k]);
  const long long n = f.i[0];
  const F nd = (F)n;
  const F xa = n > 0 ? f.a / nd : zero;  // the mean (co-moments: of x)
  const F ya = n > 0 ? f.b / nd : zero;
  // pass 2: each chunk's own M2 (co-moments) plus n_c times its mean's
  // squared distance from the batch's
  F p = zero, q = zero, r = zero;
  if ((moments || comoments) && n > 0) {  // uniform across the block
    for (int c0 = threadIdx.x; c0 < C; c0 += SR_FOLD_BATCH * T) {
      F nc[SR_FOLD_BATCH], mx_[SR_FOLD_BATCH], my_[SR_FOLD_BATCH];
      F m0[SR_FOLD_BATCH], m1[SR_FOLD_BATCH], m2[SR_FOLD_BATCH];
#pragma unroll
      for (int u = 0; u < SR_FOLD_BATCH; ++u) {
        const int c = c0 + u * T;
        const bool in = c < C;
        nc[u] = in ? (F)pi[c] : zero;
        mx_[u] = in ? pf[(moments ? 3LL : 2LL) * C + c] : zero;
        my_[u] = in && comoments ? pf[3LL * C + c] : zero;
        m0[u] = in ? pf[4LL * C + c] : zero;
        m1[u] = in && comoments ? pf[5LL * C + c] : zero;
        m2[u] = in && comoments ? pf[6LL * C + c] : zero;
      }
#pragma unroll
      for (int u = 0; u < SR_FOLD_BATCH; ++u) {
        if (nc[u] == zero) continue;  // an empty chunk (or none): nothing
        const F dx = mx_[u] - xa;
        if (moments) {
          p += m0[u] + nc[u] * (dx * dx);
        } else {
          const F dy = my_[u] - ya;
          p += m0[u] + nc[u] * (dx * dy);
          q += m1[u] + nc[u] * (dx * dx);
          r += m2[u] + nc[u] * (dy * dy);
        }
      }
    }
    sr_block_sum3(p, q, r, sums);
  }
  if (threadIdx.x != 0) return;
  for (int c = 0; c < SR_IWIDTH; ++c) oi[c] = c < icols ? (I)f.i[c] : (I)0;
  if (comoments) {
    of[0] = xa;
    of[1] = ya;
    of[2] = p;
    of[3] = q;
    of[4] = r;
  } else if (moments) {
    of[0] = f.a;
    of[1] = f.mn;
    of[2] = f.mx;
    of[3] = xa;
    of[4] = p;
  } else {
    of[0] = zero;
    of[1] = nan;
    of[2] = ninf;
    of[3] = zero;
    of[4] = zero;
  }
}

// One block per slot (blockIdx.x) and session (blockIdx.y) folds the
// session's n_chunks chunk partials (see the head of the file). The same
// order on every run. F and I are the outputs' float and count types:
// double and long long, or float and int in the 32-bit accumulator mode.
template <class F, class I>
__global__ void __launch_bounds__(SR_FOLD_THREADS)
scan_reduce_fold(const __grid_constant__ SrTable table, int n_chunks,
                 const int* __restrict__ part_i, const F* __restrict__ part_f,
                 I* __restrict__ out_i, F* __restrict__ out_f) {
  const int s = blockIdx.x;
  const long long o = (long long)blockIdx.y * table.n_slots + s;
  // PHASE fold0
  const int* pi = part_i + o * SR_PWIDTH * (long long)n_chunks;
  const F* pf = part_f + o * SR_PWIDTH * (long long)n_chunks;
  I* oi = out_i + o * SR_IWIDTH;
  F* of = out_f + o * 5;
  switch (table.slot[s].kind) {
    case SR_KIND_MOMENTS:
      sr_fold_slot<SR_KIND_MOMENTS, F, I>(pi, pf, n_chunks, oi, of);
      break;
    case SR_KIND_CLASSES:
      sr_fold_slot<SR_KIND_CLASSES, F, I>(pi, pf, n_chunks, oi, of);
      break;
    case SR_KIND_COMOMENTS:
      sr_fold_slot<SR_KIND_COMOMENTS, F, I>(pi, pf, n_chunks, oi, of);
      break;
    default:
      sr_fold_slot<SR_KIND_COUNTS, F, I>(pi, pf, n_chunks, oi, of);
      break;
  }
  // PHASE fold1
}

extern "C" int scan_reduce_max_slots() { return SR_MAX_SLOTS; }

extern "C" int scan_reduce_max_arrays() { return SR_MAX_ARRAYS; }

extern "C" int scan_reduce_int_width() { return SR_IWIDTH; }

extern "C" int scan_reduce_table_bytes() { return (int)sizeof(SrTable); }

extern "C" int scan_reduce_partial_width() { return SR_PWIDTH; }

template <int K, class T>
static int sr_launch_chunks(const SrTable& table, long long n, int n_chunks, int width,
                            int* part_i, T* part_f, cudaStream_t st) {
  // the dynamic shared memory this instance may use, by device
  static int opted[64];
  const int smem = SR_STEP * K * table.at[table.n_arrays];
  if (smem > 48 * 1024) {
    int device = 0;
    cudaError_t err = cudaGetDevice(&device);
    if (err != cudaSuccess) return (int)err;
    if (device < 0 || device >= 64) return (int)cudaErrorInvalidDevice;
    if (smem > opted[device]) {
      err = cudaFuncSetAttribute(scan_reduce_chunks<K, T>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (err != cudaSuccess) return (int)err;
      opted[device] = smem;
    }
  }
  const long long blocks = (long long)n_chunks * width;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  scan_reduce_chunks<K, T><<<(int)blocks, SR_THREADS, smem, st>>>(table, n, n_chunks, part_i,
                                                                  part_f);
  return (int)cudaGetLastError();
}

// W sessions of n rows each (W = 1: one batch), in chunks of `chunk` rows
// (128, 256 or 512). part_i: int32[W * n_slots * 7 * n_chunks] and
// part_f: F[W * n_slots * 7 * n_chunks] scratch, n_chunks =
// max(1, ceil(n / chunk)); out_i: I[W, n_slots, 7]; out_f: F[W, n_slots, 5].
template <class F, class I>
static int sr_launch(const SrTable* table, long long n, int width, int chunk, int* part_i,
                     F* part_f, I* out_i, F* out_f, void* stream) {
  if (table->n_slots < 1 || table->n_slots > SR_MAX_SLOTS || table->n_arrays < 1 ||
      table->n_arrays > SR_MAX_ARRAYS || n < 0 || width < 1 || width > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  const long long chunks = n == 0 ? 1 : (n + chunk - 1) / chunk;
  if (chunks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const int n_chunks = (int)chunks;
  cudaStream_t st = (cudaStream_t)stream;
  int status;
  switch (chunk) {
    case 128:
      status = sr_launch_chunks<1, F>(*table, n, n_chunks, width, part_i, part_f, st);
      break;
    case 256:
      status = sr_launch_chunks<2, F>(*table, n, n_chunks, width, part_i, part_f, st);
      break;
    case 512:
      status = sr_launch_chunks<4, F>(*table, n, n_chunks, width, part_i, part_f, st);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  if (status != 0) return status;
  scan_reduce_fold<F, I><<<dim3(table->n_slots, width), SR_FOLD_THREADS, 0, st>>>(
      *table, n_chunks, part_i, part_f, out_i, out_f);
  return (int)cudaGetLastError();
}

// float64 values and sums, int64 counts: out_i int64[W, n_slots, 7],
// out_f float64[W, n_slots, 5]
extern "C" int scan_reduce_launch(const SrTable* table, long long n, int width, int chunk,
                                  int* part_i, double* part_f, long long* out_i, double* out_f,
                                  void* stream) {
  return sr_launch<double, long long>(table, n, width, chunk, part_i, part_f, out_i, out_f,
                                      stream);
}

// the 32-bit accumulator mode (DEEQU_TPU_NO_X64): float32 values (or the
// int32 lengths and codes), sums, means and M2 in float32, counts written
// as int32: out_i int32[W, n_slots, 7], out_f float32[W, n_slots, 5]
extern "C" int scan_reduce_launch_f32(const SrTable* table, long long n, int width, int chunk,
                                      int* part_i, float* part_f, int* out_i, float* out_f,
                                      void* stream) {
  return sr_launch<float, int>(table, n, width, chunk, part_i, part_f, out_i, out_f, stream);
}
