// K4 kll_sample: the batch pre-collapse of the KLL update.
//
// Replaces the row work of kll_update (deequ_tpu/ops/kll.py:233-266): keep
// the valid non-NaN values, count them (n) and take their float64 min and
// max, clip them to the float32 range in float64 and round them to float32,
// sort the batch with masked rows as +inf, and pick at most k items at
// offset + j * 2^h, where 2^h is the least power of two with n <= k * 2^h
// and the offset turns with the sketch's update counter. The picked items
// then enter the sketch at level h through K5 (kll_compact.cu), which reads
// m, h, n, min and max from this kernel's device outputs: nothing goes
// through the host between the two.
//
// Outputs: samples float32[k] (+inf past m), meta int32[3] = (m, h, n),
// minmax float64[2].
//
// The sort is this file's own: a stable least-significant-digit radix sort
// of (key, bits) pairs over four 8-bit digits. The key is an order-
// preserving uint32 image of the float32 value in which -0.0 and +0.0 are
// the same key (the reference's sort treats them as equal and keeps their
// input order), and the bits are the value itself, so a picked zero keeps
// its sign. Each pass is three launches: a per-tile digit histogram, one
// exclusive scan over the digit-major histogram table, and a stable
// scatter in which every block ranks its tile's items by digit with
// __match_any_sync inside a warp and per-warp digit counts across warps.
//
// Min and max are order-free: atomicMin/atomicMax on the total-order uint64
// image of the float64 values, where -0.0 sorts below +0.0, so the min
// takes -0.0 and the max +0.0 among zeros, as the reference does.
//
// Bound on the card: bytes. The function reads 10 to 11 bytes per row (the
// float64 value and the row masks) and writes 4k bytes; the sort's work is
// four passes of a few integer operations per row. This simple design
// moves 16 bytes per row through device memory in each of the four passes
// (two reads of the pairs, one write), plus the prep pass.
#include <math_constants.h>

#include "common.cuh"

#define KS_THREADS 1024
#define KS_WARPS (KS_THREADS / 32)
#define KS_TILE 4096  // items per block in a radix pass
#define KS_CHUNKS (KS_TILE / KS_THREADS)
#define KS_RADIX 256
#define KS_PREP_THREADS 256
#define KS_PREP_MAX_BLOCKS 2048
#define KS_F32_MAX 3.4028234663852886e38

// order-preserving uint32 image of a float32 sort key; -0.0 maps to +0.0
__device__ __forceinline__ uint32_t ks_key(float x) {
  uint32_t b = __float_as_uint(x);
  if ((b & 0x7fffffffu) == 0u) b = 0u;
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

// total-order uint64 image of a float64 (NaN excluded by the caller)
__device__ __forceinline__ unsigned long long ks_order64(double x) {
  const unsigned long long b = (unsigned long long)__double_as_longlong(x);
  return (b >> 63) ? ~b : (b | 0x8000000000000000ull);
}

__device__ __forceinline__ double ks_unorder64(unsigned long long o) {
  const unsigned long long b = (o >> 63) ? (o & 0x7fffffffffffffffull) : ~o;
  return __longlong_as_double((long long)b);
}

// mask, clip, round to float32; count and min/max of the kept values
__global__ void __launch_bounds__(KS_PREP_THREADS)
ks_prep(const double* __restrict__ values, const uint8_t* __restrict__ rows,
        const uint8_t* __restrict__ where, const uint8_t* __restrict__ present,
        long long n, uint32_t* __restrict__ keys, uint32_t* __restrict__ bits,
        int* __restrict__ count, unsigned long long* __restrict__ order_mm) {
  __shared__ int s_cnt[KS_PREP_THREADS / 32];
  __shared__ unsigned long long s_mn[KS_PREP_THREADS / 32];
  __shared__ unsigned long long s_mx[KS_PREP_THREADS / 32];
  int cnt = 0;
  unsigned long long mn = ~0ull;
  unsigned long long mx = 0ull;
  const long long step = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += step) {
    bool ok = rows[i] && (present == nullptr || present[i]) &&
              (where == nullptr || where[i]);
    const double v = values[i];
    ok = ok && !isnan(v);
    float f = CUDART_INF_F;
    if (ok) {
      cnt += 1;
      const unsigned long long o = ks_order64(v);
      mn = o < mn ? o : mn;
      mx = o > mx ? o : mx;
      // v is not NaN, so fmax/fmin clip it like the reference's jnp.clip
      f = __double2float_rn(fmin(fmax(v, -KS_F32_MAX), KS_F32_MAX));
    }
    keys[i] = ks_key(f);
    bits[i] = __float_as_uint(f);
  }
  for (int off = 16; off > 0; off >>= 1) {
    cnt += __shfl_down_sync(0xffffffffu, cnt, off);
    const unsigned long long omn = __shfl_down_sync(0xffffffffu, mn, off);
    const unsigned long long omx = __shfl_down_sync(0xffffffffu, mx, off);
    mn = omn < mn ? omn : mn;
    mx = omx > mx ? omx : mx;
  }
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) {
    s_cnt[warp] = cnt;
    s_mn[warp] = mn;
    s_mx[warp] = mx;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < KS_PREP_THREADS / 32; ++w) {
      cnt += s_cnt[w];
      mn = s_mn[w] < mn ? s_mn[w] : mn;
      mx = s_mx[w] > mx ? s_mx[w] : mx;
    }
    if (cnt > 0) {
      atomicAdd(count, cnt);
      atomicMin(&order_mm[0], mn);
      atomicMax(&order_mm[1], mx);
    }
  }
}

// hist[d * tiles + t] = items of tile t whose digit is d
__global__ void __launch_bounds__(KS_THREADS)
ks_hist(const uint32_t* __restrict__ keys, long long n, int shift, int tiles,
        uint32_t* __restrict__ hist) {
  __shared__ uint32_t h[KS_RADIX];
  for (int d = threadIdx.x; d < KS_RADIX; d += KS_THREADS) h[d] = 0u;
  __syncthreads();
  const long long base = (long long)blockIdx.x * KS_TILE;
  for (int c = 0; c < KS_CHUNKS; ++c) {
    const long long i = base + c * KS_THREADS + threadIdx.x;
    if (i < n) atomicAdd(&h[(keys[i] >> shift) & 0xffu], 1u);
  }
  __syncthreads();
  for (int d = threadIdx.x; d < KS_RADIX; d += KS_THREADS) {
    hist[(long long)d * tiles + blockIdx.x] = h[d];
  }
}

// exclusive scan of hist[0, len) in place, in one block: each thread sums a
// contiguous segment, the segment sums are scanned in shared memory, and
// each thread writes its segment's prefixes
__global__ void __launch_bounds__(KS_THREADS)
ks_scan(uint32_t* __restrict__ hist, int len) {
  __shared__ uint32_t sums[KS_THREADS];
  const int per = (len + KS_THREADS - 1) / KS_THREADS;
  const int lo = threadIdx.x * per;
  const int hi = min(lo + per, len);
  uint32_t s = 0u;
  for (int i = lo; i < hi; ++i) s += hist[i];
  sums[threadIdx.x] = s;
  __syncthreads();
  for (int off = 1; off < KS_THREADS; off <<= 1) {
    const uint32_t t = threadIdx.x >= off ? sums[threadIdx.x - off] : 0u;
    __syncthreads();
    sums[threadIdx.x] += t;
    __syncthreads();
  }
  uint32_t run = threadIdx.x ? sums[threadIdx.x - 1] : 0u;
  for (int i = lo; i < hi; ++i) {
    const uint32_t v = hist[i];
    hist[i] = run;
    run += v;
  }
}

// stable scatter of one tile by the digit at `shift`
__global__ void __launch_bounds__(KS_THREADS)
ks_scatter(const uint32_t* __restrict__ keys_in, const uint32_t* __restrict__ bits_in,
           long long n, int shift, int tiles, const uint32_t* __restrict__ offsets,
           uint32_t* __restrict__ keys_out, uint32_t* __restrict__ bits_out) {
  __shared__ uint32_t base[KS_RADIX];
  __shared__ uint32_t chunk_total[KS_RADIX];
  __shared__ uint32_t warp_cnt[KS_WARPS][KS_RADIX];  // 32 KB
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const unsigned lanes_below = (1u << lane) - 1u;
  for (int d = threadIdx.x; d < KS_RADIX; d += KS_THREADS) {
    base[d] = offsets[(long long)d * tiles + blockIdx.x];
  }
  const long long tile0 = (long long)blockIdx.x * KS_TILE;
  for (int c = 0; c < KS_CHUNKS; ++c) {
    for (int j = threadIdx.x; j < KS_WARPS * KS_RADIX; j += KS_THREADS) {
      (&warp_cnt[0][0])[j] = 0u;
    }
    __syncthreads();
    const long long i = tile0 + c * KS_THREADS + threadIdx.x;
    const bool valid = i < n;
    const uint32_t key = valid ? keys_in[i] : 0u;
    const uint32_t bits = valid ? bits_in[i] : 0u;
    // rows past n take a digit of their own, so they rank with no one
    const uint32_t d = valid ? (key >> shift) & 0xffu : 0x100u + lane;
    const unsigned peers = __match_any_sync(0xffffffffu, d);
    const unsigned rank = __popc(peers & lanes_below);
    if (valid && rank == 0) warp_cnt[warp][d] = __popc(peers);
    __syncthreads();
    if (threadIdx.x < KS_RADIX) {
      uint32_t s = 0u;
      for (int w = 0; w < KS_WARPS; ++w) {
        const uint32_t t = warp_cnt[w][threadIdx.x];
        warp_cnt[w][threadIdx.x] = s;
        s += t;
      }
      chunk_total[threadIdx.x] = s;
    }
    __syncthreads();
    if (valid) {
      const uint32_t pos = base[d] + warp_cnt[warp][d] + rank;
      keys_out[pos] = key;
      bits_out[pos] = bits;
    }
    __syncthreads();
    if (threadIdx.x < KS_RADIX) base[threadIdx.x] += chunk_total[threadIdx.x];
  }
}

// one block: h, the offset and the picks; decode min and max
__global__ void ks_pick(const uint32_t* __restrict__ sorted_bits,
                        const int* __restrict__ count,
                        const unsigned long long* __restrict__ order_mm,
                        const int* __restrict__ ticks, int k,
                        float* __restrict__ samples, int* __restrict__ meta,
                        double* __restrict__ minmax) {
  const long long n = *count;
  long long m_needed = (n + k - 1) / k;
  if (m_needed < 1) m_needed = 1;
  // ceil(log2(m_needed)) in integers: the bit length of m_needed - 1
  const int h = m_needed <= 1 ? 0 : 64 - __clzll(m_needed - 1);
  const unsigned stride = 1u << h;
  const unsigned r = ((unsigned)(*ticks) * 2654435761u) >> 7;
  const unsigned offset = r % stride;
  for (int j = threadIdx.x; j < k; j += blockDim.x) {
    const long long pos = (long long)offset + (long long)j * stride;
    samples[j] = pos < n ? __uint_as_float(sorted_bits[pos]) : CUDART_INF_F;
  }
  if (threadIdx.x == 0) {
    long long m = 0;
    if (n > (long long)offset) {
      m = (n - (long long)offset + stride - 1) / stride;
      if (m > k) m = k;
    }
    meta[0] = (int)m;
    meta[1] = h;
    meta[2] = (int)n;
    minmax[0] = n > 0 ? ks_unorder64(order_mm[0]) : CUDART_INF;
    minmax[1] = n > 0 ? ks_unorder64(order_mm[1]) : -CUDART_INF;
  }
}

extern "C" int kll_sample_tile() { return KS_TILE; }

// scratch: uint32[4 * n] (two key and two bits buffers); hist: uint32[256 *
// ceil(n / KS_TILE)]; count: int32[1] and order_mm: uint64[2] of scratch;
// ticks: the sketch's int32 update counter on the device
extern "C" int kll_sample_launch(const double* values, const uint8_t* rows,
                                 const uint8_t* where, const uint8_t* present,
                                 long long n, int k, const int* ticks,
                                 uint32_t* scratch, uint32_t* hist, int* count,
                                 unsigned long long* order_mm, float* samples,
                                 int* meta, double* minmax, void* stream) {
  if (n < 0 || n > 0x7fffffffLL || k < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err = cudaMemsetAsync(count, 0, sizeof(int), st);
  if (err == cudaSuccess) err = cudaMemsetAsync(order_mm, 0xff, sizeof(unsigned long long), st);
  if (err == cudaSuccess) err = cudaMemsetAsync(order_mm + 1, 0, sizeof(unsigned long long), st);
  if (err != cudaSuccess) return (int)err;
  uint32_t* keys0 = scratch;
  uint32_t* bits0 = scratch + n;
  uint32_t* keys1 = scratch + 2 * n;
  uint32_t* bits1 = scratch + 3 * n;
  if (n > 0) {
    const int prep_blocks = dq_grid_for(n, KS_PREP_THREADS * 4, KS_PREP_MAX_BLOCKS);
    ks_prep<<<prep_blocks, KS_PREP_THREADS, 0, st>>>(values, rows, where, present, n,
                                                     keys0, bits0, count, order_mm);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    const int tiles = (int)((n + KS_TILE - 1) / KS_TILE);
    for (int pass = 0; pass < 4; ++pass) {
      const int shift = 8 * pass;
      const uint32_t* kin = pass % 2 == 0 ? keys0 : keys1;
      const uint32_t* bin = pass % 2 == 0 ? bits0 : bits1;
      uint32_t* kout = pass % 2 == 0 ? keys1 : keys0;
      uint32_t* bout = pass % 2 == 0 ? bits1 : bits0;
      ks_hist<<<tiles, KS_THREADS, 0, st>>>(kin, n, shift, tiles, hist);
      if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
      ks_scan<<<1, KS_THREADS, 0, st>>>(hist, KS_RADIX * tiles);
      if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
      ks_scatter<<<tiles, KS_THREADS, 0, st>>>(kin, bin, n, shift, tiles, hist, kout, bout);
      if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    }
  }
  // after four passes the sorted pairs are back in keys0 / bits0
  ks_pick<<<1, 1024, 0, st>>>(bits0, count, order_mm, ticks, k, samples, meta, minmax);
  return (int)cudaGetLastError();
}
