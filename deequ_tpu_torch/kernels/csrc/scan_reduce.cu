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
// (its n is out_i[s][0]). Per block the first pass sums n, x and y, the
// second the co-moments about the block's own means, as the moments kind
// does M2.
//
// Bound on the card: bytes. Each distinct input array is read from device
// memory once (the row mask, each mask and value array: 1 to 8 bytes per
// row); the arithmetic is a few adds and compares per selected value, far
// below the H100's rate. Design: each block owns a chunk of 4096 rows and
// walks the slot table over it; slots that share an array re-read the
// chunk from L1/L2, not from device memory. The second pass of the two-pass
// moments re-reads the chunk the same way.
//
// Determinism: no float atomics. Blocks write per-slot partials; a second
// launch, one block per slot, folds them in a fixed order (each thread a
// stride of blocks in order, then a tree across its threads): counts and
// sums added, min and max by the rules in common.cuh, moments and
// co-moments merged by Chan's rule as dq_merge_moments /
// dq_merge_comoments state it. Within a block, threads reduce in a fixed
// shuffle tree. The result is the same on every run.
#include <string.h>

#include <math_constants.h>

#include "common.cuh"

#define SR_MAX_SLOTS 64
#define SR_THREADS 256
#define SR_ROWS_PER_THREAD 16
#define SR_CHUNK (SR_THREADS * SR_ROWS_PER_THREAD)
#define SR_WARPS (SR_THREADS / 32)
// threads of the fold launch, one block per slot
#define SR_FOLD_THREADS 128

#define SR_KIND_COUNTS 0
#define SR_KIND_MOMENTS 1
#define SR_KIND_CLASSES 2
#define SR_KIND_COMOMENTS 3
#define SR_CLASSES 5
// int64 columns per slot: matches, count, then the SR_CLASSES class counts
#define SR_IWIDTH (2 + SR_CLASSES)

// mirrors deequ_tpu_torch/kernels/scan_reduce.py _SlotStruct
struct SrSlot {
  int32_t kind;         // SR_KIND_COUNTS, SR_KIND_MOMENTS or SR_KIND_CLASSES
  int32_t vals_i32;     // 1: int32 values (string lengths, class codes); 0: float64
  const void* vals;     // null for counting slots
  const uint8_t* where;  // null: no where-filter
  const uint8_t* sel;    // null: every counted row is selected
  const double* vals2;   // a co-moment slot's second column; else null
  const uint8_t* sel2;   // a co-moment slot's second presence mask; else null
};

struct SrTable {
  SrSlot s[SR_MAX_SLOTS];
};

struct SrAcc {
  long long base;    // rows & where
  long long sel;     // rows & where & sel
  long long nonnan;  // selected values that are not NaN
  double sum;
  double mn;         // min over non-NaN selected values, +inf if none
  double mx;         // max over non-NaN selected values, -inf if none
  int has_nan;       // a selected value was NaN
};

__device__ __forceinline__ double sr_value(const SrSlot& s, long long i) {
  return s.vals_i32 ? (double)((const int32_t*)s.vals)[i]
                    : ((const double*)s.vals)[i];
}

__device__ __forceinline__ void sr_combine(SrAcc& a, const SrAcc& b) {
  a.base += b.base;
  a.sel += b.sel;
  a.nonnan += b.nonnan;
  a.sum += b.sum;
  a.mn = dq_min_z(a.mn, b.mn);
  a.mx = dq_max_z(a.mx, b.mx);
  a.has_nan |= b.has_nan;
}

__device__ __forceinline__ SrAcc sr_shfl_down(const SrAcc& a, int offset) {
  SrAcc o;
  o.base = __shfl_down_sync(0xffffffffu, a.base, offset);
  o.sel = __shfl_down_sync(0xffffffffu, a.sel, offset);
  o.nonnan = __shfl_down_sync(0xffffffffu, a.nonnan, offset);
  o.sum = __shfl_down_sync(0xffffffffu, a.sum, offset);
  o.mn = __shfl_down_sync(0xffffffffu, a.mn, offset);
  o.mx = __shfl_down_sync(0xffffffffu, a.mx, offset);
  o.has_nan = __shfl_down_sync(0xffffffffu, a.has_nan, offset);
  return o;
}

// A class-count slot over the block's chunk: per-thread counters of the
// five classes and of the counted rows, reduced by warp shuffles and then
// across the block's warps in a fixed order. Leaves the float partials at
// their identities.
__device__ void sr_class_counts(const SrSlot& slot, const uint8_t* __restrict__ rows,
                                long long n, long long start, int s, int n_slots,
                                long long (*warp_cls)[SR_CLASSES + 1],
                                long long* __restrict__ part_i,
                                double* __restrict__ part_f) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int32_t* codes = (const int32_t*)slot.vals;
  long long cnt[SR_CLASSES + 1];  // the classes, then the counted rows
  for (int c = 0; c <= SR_CLASSES; ++c) cnt[c] = 0;
  for (int k = 0; k < SR_ROWS_PER_THREAD; ++k) {
    const long long i = start + (long long)k * SR_THREADS + threadIdx.x;
    if (i >= n) break;
    if (!rows[i] || (slot.where != nullptr && !slot.where[i])) continue;
    cnt[SR_CLASSES] += 1;
    const int32_t code = codes[i];
    if (code >= 0 && code < SR_CLASSES) cnt[code] += 1;
  }
  for (int c = 0; c <= SR_CLASSES; ++c) {
    for (int off = 16; off > 0; off >>= 1) {
      cnt[c] += __shfl_down_sync(0xffffffffu, cnt[c], off);
    }
    if (lane == 0) warp_cls[warp][c] = cnt[c];
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    const long long o = (long long)blockIdx.x * n_slots + s;
    long long matches = 0;
    for (int c = 0; c < SR_CLASSES; ++c) {
      long long t = 0;
      for (int w = 0; w < SR_WARPS; ++w) t += warp_cls[w][c];
      part_i[o * SR_IWIDTH + 2 + c] = t;
      matches += t;
    }
    long long base = 0;
    for (int w = 0; w < SR_WARPS; ++w) base += warp_cls[w][SR_CLASSES];
    part_i[o * SR_IWIDTH + 0] = matches;
    part_i[o * SR_IWIDTH + 1] = base;
    part_f[o * 5 + 0] = 0.0;
    part_f[o * 5 + 1] = CUDART_NAN;
    part_f[o * 5 + 2] = -CUDART_INF;
    part_f[o * 5 + 3] = 0.0;
    part_f[o * 5 + 4] = 0.0;
  }
  __syncthreads();  // warp_cls is rewritten by the next class-count slot
}

// A co-moment slot over the block's chunk: n, sum x and sum y, then the
// co-moments about the block's means, each reduced by warp shuffles and
// then across the warps in a fixed order.
__device__ void sr_comoments(const SrSlot& slot, const uint8_t* __restrict__ rows,
                             long long n, long long start, int s, int n_slots,
                             double (*warp_f)[3], long long (*warp_c)[2],
                             double* block_means,
                             long long* __restrict__ part_i,
                             double* __restrict__ part_f) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const double* x = (const double*)slot.vals;
  const double* y = slot.vals2;
  long long base = 0, sel = 0;
  double sx = 0.0, sy = 0.0;
  for (int k = 0; k < SR_ROWS_PER_THREAD; ++k) {
    const long long i = start + (long long)k * SR_THREADS + threadIdx.x;
    if (i >= n) break;
    if (!rows[i] || (slot.where != nullptr && !slot.where[i])) continue;
    base += 1;
    if ((slot.sel != nullptr && !slot.sel[i]) || (slot.sel2 != nullptr && !slot.sel2[i])) continue;
    sel += 1;
    sx += x[i];
    sy += y[i];
  }
  for (int off = 16; off > 0; off >>= 1) {
    base += __shfl_down_sync(0xffffffffu, base, off);
    sel += __shfl_down_sync(0xffffffffu, sel, off);
    sx += __shfl_down_sync(0xffffffffu, sx, off);
    sy += __shfl_down_sync(0xffffffffu, sy, off);
  }
  if (lane == 0) {
    warp_c[warp][0] = base;
    warp_c[warp][1] = sel;
    warp_f[warp][0] = sx;
    warp_f[warp][1] = sy;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    long long b = 0, m = 0;
    double tx = 0.0, ty = 0.0;
    for (int w = 0; w < SR_WARPS; ++w) {
      b += warp_c[w][0];
      m += warp_c[w][1];
      tx += warp_f[w][0];
      ty += warp_f[w][1];
    }
    warp_c[0][0] = b;
    warp_c[0][1] = m;
    block_means[0] = m > 0 ? tx / (double)m : 0.0;
    block_means[1] = m > 0 ? ty / (double)m : 0.0;
  }
  __syncthreads();
  const long long blk_base = warp_c[0][0];
  const long long blk_sel = warp_c[0][1];
  const double mx = block_means[0];
  const double my = block_means[1];
  __syncthreads();  // warp_c[0] is rewritten below
  double ck = 0.0, xmk = 0.0, ymk = 0.0;
  if (blk_sel > 0) {  // uniform across the block
    for (int k = 0; k < SR_ROWS_PER_THREAD; ++k) {
      const long long i = start + (long long)k * SR_THREADS + threadIdx.x;
      if (i >= n) break;
      if (!rows[i] || (slot.where != nullptr && !slot.where[i])) continue;
      if ((slot.sel != nullptr && !slot.sel[i]) || (slot.sel2 != nullptr && !slot.sel2[i])) continue;
      const double dx = x[i] - mx;
      const double dy = y[i] - my;
      ck += dx * dy;
      xmk += dx * dx;
      ymk += dy * dy;
    }
    for (int off = 16; off > 0; off >>= 1) {
      ck += __shfl_down_sync(0xffffffffu, ck, off);
      xmk += __shfl_down_sync(0xffffffffu, xmk, off);
      ymk += __shfl_down_sync(0xffffffffu, ymk, off);
    }
    if (lane == 0) {
      warp_f[warp][0] = ck;
      warp_f[warp][1] = xmk;
      warp_f[warp][2] = ymk;
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      ck = xmk = ymk = 0.0;
      for (int w = 0; w < SR_WARPS; ++w) {
        ck += warp_f[w][0];
        xmk += warp_f[w][1];
        ymk += warp_f[w][2];
      }
    }
  }
  if (threadIdx.x == 0) {
    const long long o = (long long)blockIdx.x * n_slots + s;
    part_i[o * SR_IWIDTH + 0] = blk_sel;
    part_i[o * SR_IWIDTH + 1] = blk_base;
    for (int c = 0; c < SR_CLASSES; ++c) part_i[o * SR_IWIDTH + 2 + c] = 0;
    part_f[o * 5 + 0] = mx;
    part_f[o * 5 + 1] = my;
    part_f[o * 5 + 2] = ck;
    part_f[o * 5 + 3] = xmk;
    part_f[o * 5 + 4] = ymk;
  }
  __syncthreads();  // the shared arrays are rewritten by the next slot
}

__global__ void __launch_bounds__(SR_THREADS)
scan_reduce_blocks(const SrTable table, int n_slots,
                   const uint8_t* __restrict__ rows, long long n,
                   long long* __restrict__ part_i,
                   double* __restrict__ part_f) {
  __shared__ SrAcc warp_acc[SR_WARPS];
  __shared__ double warp_m2[SR_WARPS];
  __shared__ double block_mean;
  __shared__ long long warp_cls[SR_WARPS][SR_CLASSES + 1];
  __shared__ double warp_co[SR_WARPS][3];
  __shared__ long long warp_cc[SR_WARPS][2];
  __shared__ double co_means[2];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long start = (long long)blockIdx.x * SR_CHUNK;

  for (int s = 0; s < n_slots; ++s) {
    const SrSlot slot = table.s[s];
    if (slot.kind == SR_KIND_CLASSES) {
      sr_class_counts(slot, rows, n, start, s, n_slots, warp_cls, part_i, part_f);
      continue;
    }
    if (slot.kind == SR_KIND_COMOMENTS) {
      sr_comoments(slot, rows, n, start, s, n_slots, warp_co, warp_cc, co_means, part_i,
                   part_f);
      continue;
    }
    const bool moments = slot.kind == SR_KIND_MOMENTS;
    SrAcc acc;
    acc.base = 0;
    acc.sel = 0;
    acc.nonnan = 0;
    acc.sum = 0.0;
    acc.mn = CUDART_INF;
    acc.mx = -CUDART_INF;
    acc.has_nan = 0;
    for (int k = 0; k < SR_ROWS_PER_THREAD; ++k) {
      const long long i = start + (long long)k * SR_THREADS + threadIdx.x;
      if (i >= n) break;
      if (!rows[i] || (slot.where != nullptr && !slot.where[i])) continue;
      acc.base += 1;
      if (slot.sel != nullptr && !slot.sel[i]) continue;
      acc.sel += 1;
      if (moments) {
        const double v = sr_value(slot, i);
        acc.sum += v;
        if (isnan(v)) {
          acc.has_nan = 1;
        } else {
          acc.nonnan += 1;
          acc.mn = dq_min_z(acc.mn, v);
          acc.mx = dq_max_z(acc.mx, v);
        }
      }
    }
    for (int off = 16; off > 0; off >>= 1) {
      const SrAcc o = sr_shfl_down(acc, off);
      sr_combine(acc, o);
    }
    if (lane == 0) warp_acc[warp] = acc;
    __syncthreads();
    if (threadIdx.x == 0) {
      SrAcc b = warp_acc[0];
      for (int w = 1; w < SR_WARPS; ++w) sr_combine(b, warp_acc[w]);
      warp_acc[0] = b;
      block_mean = b.sel > 0 ? b.sum / (double)b.sel : 0.0;
    }
    __syncthreads();
    const SrAcc blk = warp_acc[0];
    const double mean = block_mean;

    // second pass: M2 about the block's own mean (the chunk is in cache)
    double m2 = 0.0;
    if (moments && blk.sel > 0) {  // uniform across the block
      for (int k = 0; k < SR_ROWS_PER_THREAD; ++k) {
        const long long i = start + (long long)k * SR_THREADS + threadIdx.x;
        if (i >= n) break;
        if (!rows[i] || (slot.where != nullptr && !slot.where[i])) continue;
        if (slot.sel != nullptr && !slot.sel[i]) continue;
        const double d = sr_value(slot, i) - mean;
        m2 += d * d;
      }
      for (int off = 16; off > 0; off >>= 1) {
        m2 += __shfl_down_sync(0xffffffffu, m2, off);
      }
      if (lane == 0) warp_m2[warp] = m2;
      __syncthreads();
      if (threadIdx.x == 0) {
        double t = warp_m2[0];
        for (int w = 1; w < SR_WARPS; ++w) t += warp_m2[w];
        m2 = t;
      }
    }

    if (threadIdx.x == 0) {
      const long long o = (long long)blockIdx.x * n_slots + s;
      part_i[o * SR_IWIDTH + 0] = blk.sel;
      part_i[o * SR_IWIDTH + 1] = blk.base;
      for (int c = 0; c < SR_CLASSES; ++c) part_i[o * SR_IWIDTH + 2 + c] = 0;
      part_f[o * 5 + 0] = blk.sum;
      part_f[o * 5 + 1] = blk.nonnan > 0 ? blk.mn : CUDART_NAN;
      part_f[o * 5 + 2] = blk.has_nan ? CUDART_NAN : blk.mx;
      part_f[o * 5 + 3] = mean;
      part_f[o * 5 + 4] = blk.sel > 0 ? m2 : 0.0;
    }
    __syncthreads();  // warp_acc and block_mean are rewritten by the next slot
  }
}

// A slot's partials being folded: the int64 columns, and the float ones
// of its kind (sum, min, max and the moments, or the co-moments).
struct SrFold {
  long long i[SR_IWIDTH];
  double sum, mn, mx;
  DqMoments mom;
  DqComoments co;
};

__device__ __forceinline__ SrFold sr_fold_identity() {
  SrFold a;
  for (int c = 0; c < SR_IWIDTH; ++c) a.i[c] = 0;
  a.sum = 0.0;
  a.mn = CUDART_NAN;
  a.mx = -CUDART_INF;
  a.mom = {0.0, 0.0, 0.0};
  a.co = {0.0, 0.0, 0.0, 0.0, 0.0, 0.0};
  return a;
}

// b merged into a; an empty side (n == 0) leaves the other as it is
__device__ __forceinline__ void sr_fold_merge(SrFold& a, const SrFold& b, bool comoments) {
  for (int c = 0; c < SR_IWIDTH; ++c) a.i[c] += b.i[c];
  if (comoments) {
    if (b.co.n != 0.0) a.co = a.co.n == 0.0 ? b.co : dq_merge_comoments(a.co, b.co);
    return;
  }
  a.sum += b.sum;
  a.mn = dq_min_nan_largest(a.mn, b.mn);
  a.mx = dq_max_nan(a.mx, b.mx);
  if (b.mom.n != 0.0) a.mom = a.mom.n == 0.0 ? b.mom : dq_merge_moments(a.mom, b.mom);
}

// One block per slot folds the block partials: each thread folds the
// blocks t, t + SR_FOLD_THREADS, ... in order, then the threads' folds
// merge in a fixed tree in shared memory. The same order on every run.
__global__ void __launch_bounds__(SR_FOLD_THREADS)
scan_reduce_fold(const SrTable table, int n_blocks, int n_slots,
                 const long long* __restrict__ part_i,
                 const double* __restrict__ part_f,
                 long long* __restrict__ out_i,
                 double* __restrict__ out_f) {
  __shared__ SrFold acc[SR_FOLD_THREADS];
  const int s = blockIdx.x;
  const bool comoments = table.s[s].kind == SR_KIND_COMOMENTS;
  SrFold a = sr_fold_identity();
  for (int b = threadIdx.x; b < n_blocks; b += SR_FOLD_THREADS) {
    const long long o = (long long)b * n_slots + s;
    const double* pf = part_f + o * 5;
    SrFold p = sr_fold_identity();
    for (int c = 0; c < SR_IWIDTH; ++c) p.i[c] = part_i[o * SR_IWIDTH + c];
    const double nb = (double)p.i[0];
    if (nb != 0.0) {  // an empty block's float partials are identities
      if (comoments) {
        p.co = {nb, pf[0], pf[1], pf[2], pf[3], pf[4]};
      } else {
        p.sum = pf[0];
        p.mn = pf[1];
        p.mx = pf[2];
        p.mom = {nb, pf[3], pf[4]};
      }
    }
    sr_fold_merge(a, p, comoments);
  }
  acc[threadIdx.x] = a;
  __syncthreads();
  for (int stride = SR_FOLD_THREADS / 2; stride > 0; stride >>= 1) {
    if (threadIdx.x < stride) sr_fold_merge(acc[threadIdx.x], acc[threadIdx.x + stride], comoments);
    __syncthreads();
  }
  if (threadIdx.x != 0) return;
  const SrFold& r = acc[0];
  for (int c = 0; c < SR_IWIDTH; ++c) out_i[s * SR_IWIDTH + c] = r.i[c];
  if (comoments) {
    out_f[s * 5 + 0] = r.co.x_avg;
    out_f[s * 5 + 1] = r.co.y_avg;
    out_f[s * 5 + 2] = r.co.ck;
    out_f[s * 5 + 3] = r.co.x_mk;
    out_f[s * 5 + 4] = r.co.y_mk;
    return;
  }
  out_f[s * 5 + 0] = r.sum;
  out_f[s * 5 + 1] = r.mn;
  out_f[s * 5 + 2] = r.mx;
  out_f[s * 5 + 3] = r.mom.avg;
  out_f[s * 5 + 4] = r.mom.m2;
}

extern "C" int scan_reduce_max_slots() { return SR_MAX_SLOTS; }

extern "C" int scan_reduce_int_width() { return SR_IWIDTH; }

extern "C" int scan_reduce_num_blocks(long long n) {
  const long long b = (n + SR_CHUNK - 1) / SR_CHUNK;
  return b < 1 ? 1 : (int)b;
}

// part_i: int64[num_blocks * n_slots * 7], part_f: float64[num_blocks *
// n_slots * 5] scratch; out_i: int64[n_slots * 7]; out_f: float64[n_slots * 5]
extern "C" int scan_reduce_launch(const SrSlot* slots, int n_slots,
                                  const uint8_t* rows, long long n,
                                  long long* part_i, double* part_f,
                                  long long* out_i, double* out_f,
                                  void* stream) {
  if (n_slots < 1 || n_slots > SR_MAX_SLOTS || n < 0) {
    return (int)cudaErrorInvalidValue;
  }
  SrTable table;
  memset(&table, 0, sizeof(table));
  memcpy(table.s, slots, sizeof(SrSlot) * (size_t)n_slots);
  const int nb = scan_reduce_num_blocks(n);
  cudaStream_t st = (cudaStream_t)stream;
  scan_reduce_blocks<<<nb, SR_THREADS, 0, st>>>(table, n_slots, rows, n,
                                                part_i, part_f);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  scan_reduce_fold<<<n_slots, SR_FOLD_THREADS, 0, st>>>(table, nb, n_slots, part_i, part_f,
                                                        out_i, out_f);
  return (int)cudaGetLastError();
}
