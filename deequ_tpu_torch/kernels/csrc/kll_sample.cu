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
// minmax float64[2]. A second entry, kll_sample_launch_f32, serves the
// reference's 32-bit accumulator mode (DEEQU_TPU_NO_X64): float32 values
// in (4 bytes a row), float32 minmax out, the same items.
//
// What bounds it on this card: bytes. The function reads 10 to 11 bytes
// per row (the float64 value and the row masks) and writes 4k bytes; the
// sort's work is a few integer operations per row and digit. So the design
// moves each row through device memory as few times as a radix sort
// allows, in few launches, with no step that one block does alone:
//
//  - Only the float32 bits travel. The sort key is an order-preserving
//    uint32 image of the bits in which -0.0 and +0.0 are one key (the
//    reference's sort treats them as equal and keeps their input order),
//    recomputed from the bits wherever a digit is needed; the bits keep a
//    picked zero's sign. 4 bytes a row per pass, read once and written
//    once.
//  - One upsweep (ks_upsweep) reads the values and masks once (each thread
//    KS_UP_UNROLL rows in flight) and writes the bits, the count, the min
//    and max, and all four 8-bit digit histograms (shared counters, one
//    add a row, or one a warp where its rows share the digit; then 1,024
//    global atomics a block).
//  - Four scatter passes (ks_scatter), a launch each, of the one-sweep
//    shape. A pass whose digit is the same for every row (the histogram
//    says so: a constant column, the zero low bytes of small integers)
//    moves nothing and returns at once; the passes after it read from
//    where the last pass that moved rows wrote. Otherwise a block takes a
//    tile of KS_TILE rows (dynamic tile ids, so a block only ever waits on
//    tiles already running; one block an SM), loads it with 16-byte
//    loads into shared memory, ranks it by digit (each warp a contiguous
//    segment; a row's peers among 32 are eight ballots, one a bit of the
//    digit; per-warp digit counts), reorders the tile in shared memory so
//    each digit's rows are contiguous, gets each digit's global offset by
//    decoupled look-back over the tiles before it, and writes every
//    digit's run out contiguously. The look-back reads a 32-bit status
//    word per digit and tile (aggregate, then inclusive prefix; two arrays
//    that the passes take in turns, each clearing the other for the next),
//    32 tiles of a warp's 8 digits in one go, coalesced, and only for the
//    digits the tile holds. The exclusive scan of the pass's 256 global
//    counts is each block's prologue.
//  - The pick (ks_pick_block): h, the offset and the picks; min and max
//    decoded; done by the last block of the last pass to finish (or by
//    ks_pick alone for an empty batch).
//
// Six launches a call: one memset of the counters and status words, the
// upsweep, four passes. The passes stay latency-bound: a block's chain
// (ticket, tile load, ranking, look-back windows) takes far longer than
// its tile's bytes.
//
// Min and max are order-free: atomics on the total-order uint64 image of
// the float64 values, where -0.0 sorts below +0.0, so the min takes -0.0
// and the max +0.0 among zeros, as the reference does.
#include <math_constants.h>

#include "common.cuh"

#define KS_THREADS 1024
#define KS_WARPS (KS_THREADS / 32)
#define KS_TILE 8192  // rows a block sorts in a scatter pass
#define KS_PER_WARP (KS_TILE / KS_WARPS)
#define KS_CHUNKS (KS_PER_WARP / 32)
#define KS_RADIX 256
// digits whose look-back a warp resolves (KS_RADIX / KS_WARPS)
#define KS_LOOK_BACK_DIGITS (KS_RADIX / KS_WARPS)
#define KS_UP_THREADS 512
#define KS_UP_UNROLL 4  // rows a thread loads before it uses them
#define KS_UP_ROWS_PER_THREAD 8
#define KS_UP_MAX_BLOCKS 1024
#define KS_F32_MAX 3.4028234663852886e38
// dynamic shared memory of a scatter block: the tile, and each warp's
// digit counts
#define KS_SCATTER_SMEM ((KS_TILE + KS_WARPS * KS_RADIX) * 4)

// the control block (uint64 words, zeroed by one memset): the four digit
// histograms (uint32[4][256]), the count, min and max, the four passes'
// tile tickets (uint32[4]), the last pass's finished blocks, then one
// status word per digit and tile
#define KS_CTL_HIST 0
#define KS_CTL_COUNT 512
#define KS_CTL_MINMAX 513
#define KS_CTL_TICKETS 515
#define KS_CTL_DONE 517
#define KS_CTL_STATUS 518

// order-preserving uint32 image of float32 bits; -0.0 maps to +0.0
__device__ __forceinline__ uint32_t ks_key(uint32_t b) {
  if ((b & 0x7fffffffu) == 0u) return 0x80000000u;
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

// status word of a digit in a tile: 0 until published; then the tile's
// rows of the digit plus 1 (an aggregate), or, with the top bit set, the
// rows of the digit in this tile and all before it plus 1 (an inclusive
// prefix; at most n < 2^31)
#define KS_INC 0x80000000u

// add a warp's rows (valid lanes) to the four digit histograms: one add
// where the warp's rows share a digit (a constant column, a zero byte),
// else one add a row
__device__ __forceinline__ void ks_count_digits(unsigned* s_hist, uint32_t key, bool valid,
                                                int lane) {
  const unsigned lanes = __ballot_sync(0xffffffffu, valid);
  if (lanes == 0u) return;
#pragma unroll
  for (int p = 0; p < 4; ++p) {
    const unsigned d = (key >> (8 * p)) & 0xffu;
    const unsigned d0 = __shfl_sync(0xffffffffu, d, __ffs(lanes) - 1);
    if (__all_sync(0xffffffffu, !valid || d == d0)) {
      if (lane == 0) atomicAdd(&s_hist[p * KS_RADIX + d0], (unsigned)__popc(lanes));
    } else if (valid) {
      atomicAdd(&s_hist[p * KS_RADIX + d], 1u);
    }
  }
}

// mask, clip, round to float32; count, min and max of the kept values; the
// four digit histograms of the keys. V is the values' type: double, or
// float in the 32-bit accumulator mode, whose values widen to double
// exactly (the same order keys, clip and rounding, which then changes
// nothing)
template <class V>
__global__ void __launch_bounds__(KS_UP_THREADS)
ks_upsweep(const V* __restrict__ values, const uint8_t* __restrict__ rows,
           const uint8_t* __restrict__ where, const uint8_t* __restrict__ present, long long n,
           uint32_t* __restrict__ bits, unsigned long long* __restrict__ ctl) {
  __shared__ unsigned s_hist[4 * KS_RADIX];
  __shared__ int s_cnt[KS_UP_THREADS / 32];
  __shared__ unsigned long long s_nmn[KS_UP_THREADS / 32];
  __shared__ unsigned long long s_mx[KS_UP_THREADS / 32];
  for (int d = threadIdx.x; d < 4 * KS_RADIX; d += KS_UP_THREADS) s_hist[d] = 0u;
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int cnt = 0;
  unsigned long long nmn = 0ull;  // max of the complemented order: ~min
  unsigned long long mx = 0ull;
  const long long step = (long long)gridDim.x * KS_UP_THREADS;
  // i0 is the same for the whole warp, so every lane takes every trip
  for (long long i0 = (long long)blockIdx.x * KS_UP_THREADS + warp * 32; i0 < n;
       i0 += KS_UP_UNROLL * step) {
    double v[KS_UP_UNROLL];
    bool ok[KS_UP_UNROLL];
#pragma unroll
    for (int u = 0; u < KS_UP_UNROLL; ++u) {
      const long long i = i0 + u * step + lane;
      ok[u] = i < n && rows[i] && (present == nullptr || present[i]) &&
              (where == nullptr || where[i]);
      v[u] = i < n ? (double)values[i] : 0.0;
    }
#pragma unroll
    for (int u = 0; u < KS_UP_UNROLL; ++u) {
      const long long i = i0 + u * step + lane;
      float f = CUDART_INF_F;
      if (ok[u] && !isnan(v[u])) {
        cnt += 1;
        const unsigned long long o = ks_order64(v[u]);
        nmn = ~o > nmn ? ~o : nmn;
        mx = o > mx ? o : mx;
        // v is not NaN, so fmax/fmin clip it like the reference's jnp.clip
        f = __double2float_rn(fmin(fmax(v[u], -KS_F32_MAX), KS_F32_MAX));
      }
      if (i < n) bits[i] = __float_as_uint(f);
      ks_count_digits(s_hist, ks_key(__float_as_uint(f)), i < n, lane);
    }
  }
  for (int off = 16; off > 0; off >>= 1) {
    cnt += __shfl_down_sync(0xffffffffu, cnt, off);
    const unsigned long long a = __shfl_down_sync(0xffffffffu, nmn, off);
    const unsigned long long b = __shfl_down_sync(0xffffffffu, mx, off);
    nmn = a > nmn ? a : nmn;
    mx = b > mx ? b : mx;
  }
  if (lane == 0) {
    s_cnt[warp] = cnt;
    s_nmn[warp] = nmn;
    s_mx[warp] = mx;
  }
  __syncthreads();
  unsigned* hist = (unsigned*)(ctl + KS_CTL_HIST);
  for (int d = threadIdx.x; d < 4 * KS_RADIX; d += KS_UP_THREADS) {
    if (s_hist[d] != 0u) atomicAdd(&hist[d], s_hist[d]);
  }
  if (threadIdx.x == 0) {
    for (int w = 1; w < KS_UP_THREADS / 32; ++w) {
      cnt += s_cnt[w];
      nmn = s_nmn[w] > nmn ? s_nmn[w] : nmn;
      mx = s_mx[w] > mx ? s_mx[w] : mx;
    }
    if (cnt > 0) {
      atomicAdd((int*)(ctl + KS_CTL_COUNT), cnt);
      atomicMax(ctl + KS_CTL_MINMAX, nmn);
      atomicMax(ctl + KS_CTL_MINMAX + 1, mx);
    }
  }
}

// inclusive scan of v over the 32 lanes of a warp
__device__ __forceinline__ unsigned ks_warp_scan(unsigned v, int lane) {
  for (int o = 1; o < 32; o <<= 1) {
    const unsigned y = __shfl_up_sync(0xffffffffu, v, o);
    if (lane >= o) v += y;
  }
  return v;
}

// whether every row has one digit in pass p (a pass that moves nothing),
// from the upsweep's histogram; threads 0 .. 255 each read one count, and
// every thread of the block must call
__device__ bool ks_trivial(const unsigned long long* ctl, long long n, int p) {
  const unsigned* hist = (const unsigned*)(ctl + KS_CTL_HIST) + p * KS_RADIX;
  return __syncthreads_or(threadIdx.x < KS_RADIX && (long long)hist[threadIdx.x] == n) != 0;
}

// the passes before pass p that moved rows (a trivial pass is skipped);
// pass p reads bits0 or bits1 and its status words as this is even or
// odd; pass 4 is the pick's
__device__ int ks_moved(const unsigned long long* ctl, long long n, int p) {
  int moved = 0;
  for (int q = 0; q < p; ++q) moved += !ks_trivial(ctl, n, q);
  return moved;
}

// decoupled look-back of one warp for the KS_LOOK_BACK_DIGITS digits from
// d0 that this tile holds (`pending`): each digit's rows in the tiles
// before this one, summed from their status words (status[d][t]) back to
// an inclusive prefix, a window of 32 tiles at a time for all the digits
// (lane i reads tile t - i, so a digit's window is one coalesced load, and
// the digits' loads are in flight together); a window in which a tile has
// not published yet is read again. Then this tile's inclusive prefixes
// are published and the sums kept in before[digit]. A digit the tile does
// not hold publishes no prefix: a later tile sums its aggregate, 0.
__device__ void ks_look_back(unsigned* status, int tiles, int tile, int d0, unsigned pending,
                             int lane, const unsigned* total, unsigned* before) {
  const unsigned held = pending;
  unsigned mine = 0u;  // lane j: the sum of digit d0 + j
  for (int t = tile - 1; pending; t -= 32) {
    unsigned s[KS_LOOK_BACK_DIGITS];
    for (;;) {
#pragma unroll
      for (int j = 0; j < KS_LOOK_BACK_DIGITS; ++j) {
        s[j] = ((pending >> j) & 1u) && t - lane >= 0
            ? *(const volatile unsigned*)(status + (long long)(d0 + j) * tiles + t - lane)
            : KS_INC | 1u;
      }
      bool ready = true;
#pragma unroll
      for (int j = 0; j < KS_LOOK_BACK_DIGITS; ++j) {
        const unsigned incs = __ballot_sync(0xffffffffu, s[j] & KS_INC);
        const unsigned published = __ballot_sync(0xffffffffu, s[j] != 0u);
        // the lanes up to the nearest inclusive prefix must have published
        const unsigned need = incs ? ((incs & (0u - incs)) << 1) - 1u : 0xffffffffu;
        ready = ready && (published & need) == need;
      }
      if (ready) break;
      __nanosleep(64);
    }
#pragma unroll
    for (int j = 0; j < KS_LOOK_BACK_DIGITS; ++j) {
      if (((pending >> j) & 1u) == 0u) continue;
      const unsigned incs = __ballot_sync(0xffffffffu, s[j] & KS_INC);
      const int last = incs ? __ffs(incs) - 1 : 31;
      unsigned v = lane <= last ? (s[j] & ~KS_INC) - 1u : 0u;
      for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
      if (lane == j) mine += v;
      if (incs) pending &= ~(1u << j);
    }
  }
  if (lane < KS_LOOK_BACK_DIGITS && ((held >> lane) & 1u)) {
    const int d = d0 + lane;
    *(volatile unsigned*)&status[(long long)d * tiles + tile] = KS_INC | (mine + total[d] + 1u);
    before[d] = mine;
  }
}

// the lanes of the warp whose digit equals this lane's, among `lanes`: eight
// ballots, one a bit of the digit
__device__ __forceinline__ unsigned ks_peers(unsigned d, unsigned lanes) {
  unsigned peers = lanes;
#pragma unroll
  for (int b = 0; b < 8; ++b) {
    const unsigned vote = __ballot_sync(0xffffffffu, (d >> b) & 1u);
    peers &= ((d >> b) & 1u) ? vote : ~vote;
  }
  return peers;
}

// h, the offset and the picks from the sorted bits, by one block; decode
// min and max (the bits are read from L2: other blocks wrote them) into
// minmax of the values' type M (a float's min and max round-trip through
// double exactly)
template <class M>
__device__ void ks_pick_block(const uint32_t* sorted_bits, const unsigned long long* ctl,
                              const int* ticks, int k, float* samples, int* meta,
                              M* minmax) {
  const long long n = *(const int*)(ctl + KS_CTL_COUNT);
  long long m_needed = (n + k - 1) / k;
  if (m_needed < 1) m_needed = 1;
  // ceil(log2(m_needed)) in integers: the bit length of m_needed - 1
  const int h = m_needed <= 1 ? 0 : 64 - __clzll(m_needed - 1);
  const unsigned stride = 1u << h;
  const unsigned r = ((unsigned)(*ticks) * 2654435761u) >> 7;
  const unsigned offset = r % stride;
  for (int j = threadIdx.x; j < k; j += blockDim.x) {
    const long long pos = (long long)offset + (long long)j * stride;
    samples[j] = pos < n ? __uint_as_float(__ldcg(sorted_bits + pos)) : CUDART_INF_F;
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
    minmax[0] = (M)(n > 0 ? ks_unorder64(~ctl[KS_CTL_MINMAX]) : CUDART_INF);
    minmax[1] = (M)(n > 0 ? ks_unorder64(ctl[KS_CTL_MINMAX + 1]) : -CUDART_INF);
  }
}

// one stable scatter pass over the digit at 8 * pass, one tile a block (one
// block an SM: the tiles of 2^20 rows all run at once, and a block that
// waits in its look-back slows no other block); bits0 / bits1 are the two
// buffers, read and written as ks_moved says
template <class M>
__global__ void __launch_bounds__(KS_THREADS)
ks_scatter(uint32_t* bits0, uint32_t* bits1, long long n, int pass, unsigned long long* ctl,
           const int* __restrict__ ticks, int k, float* __restrict__ samples,
           int* __restrict__ meta, M* __restrict__ minmax) {
  extern __shared__ __align__(16) uint32_t ks_smem[];
  __shared__ int s_tile_id;
  __shared__ unsigned s_start[KS_RADIX];      // the tile's first sorted row of each digit
  __shared__ unsigned s_total[KS_RADIX];      // the tile's rows of each digit
  __shared__ unsigned s_before[KS_RADIX];     // the digit's rows in earlier tiles
  __shared__ long long s_offset[KS_RADIX];    // global row minus tile row, by digit
  __shared__ unsigned s_sums[2][KS_RADIX / 32];
  __shared__ bool s_last;
  if (ks_trivial(ctl, n, pass)) {
    // the last pass moves nothing: block 0 picks from where the rows are
    if (pass == 3 && blockIdx.x == 0) {
      const bool in_bits1 = ks_moved(ctl, n, 4) & 1;
      ks_pick_block(in_bits1 ? bits1 : bits0, ctl, ticks, k, samples, meta, minmax);
    }
    return;
  }
  const int odd = ks_moved(ctl, n, pass) & 1;
  const uint32_t* in = odd ? bits1 : bits0;
  uint32_t* out = odd ? bits0 : bits1;
  uint32_t* s_tile = ks_smem;
  unsigned* s_count = ks_smem + KS_TILE;  // [warp][digit]
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int shift = 8 * pass;
  if (threadIdx.x == 0) {
    s_tile_id = (int)atomicAdd((unsigned*)(ctl + KS_CTL_TICKETS) + pass, 1u);
  }
  for (int j = threadIdx.x; j < KS_WARPS * KS_RADIX; j += KS_THREADS) s_count[j] = 0u;
  __syncthreads();
  const int tile = s_tile_id;
  const int tiles = (int)((n + KS_TILE - 1) / KS_TILE);
  const long long base = (long long)tile * KS_TILE;
  const int rows = (int)(n - base < KS_TILE ? n - base : KS_TILE);
  if (rows == KS_TILE && ((uintptr_t)(in + base) & 15u) == 0) {
    const uint4* src = (const uint4*)(in + base);
    uint4* dst = (uint4*)s_tile;
    for (int j = threadIdx.x; j < KS_TILE / 4; j += KS_THREADS) dst[j] = src[j];
  } else {
    for (int j = threadIdx.x; j < rows; j += KS_THREADS) s_tile[j] = in[base + j];
  }
  __syncthreads();

  // rank: warp w takes rows [w * KS_PER_WARP, (w + 1) * KS_PER_WARP) in
  // chunks of 32, in order; rank = the digit's rows before this one in the
  // warp's segment
  uint32_t item[KS_CHUNKS];
  unsigned rank[KS_CHUNKS];
  unsigned* count = s_count + warp * KS_RADIX;
  const unsigned below = (1u << lane) - 1u;
#pragma unroll
  for (int c = 0; c < KS_CHUNKS; ++c) {
    const int j = warp * KS_PER_WARP + c * 32 + lane;
    const bool valid = j < rows;
    const uint32_t b = valid ? s_tile[j] : 0u;
    const unsigned d = (ks_key(b) >> shift) & 0xffu;
    const unsigned peers = ks_peers(d, __ballot_sync(0xffffffffu, valid));
    const unsigned before = count[d];
    __syncwarp();
    if (valid && (peers & below) == 0u) count[d] = before + __popc(peers);
    __syncwarp();
    item[c] = b;
    rank[c] = before + __popc(peers & below);
  }
  __syncthreads();

  // the status words: two arrays [digit][tile], the passes that move rows
  // take them in turns, and each clears the other (zeroed by the memset
  // at first) for the pass after it
  unsigned* status = (unsigned*)(ctl + KS_CTL_STATUS) + (long long)odd * KS_RADIX * tiles;
  unsigned* other = (unsigned*)(ctl + KS_CTL_STATUS) + (long long)(1 - odd) * KS_RADIX * tiles;
  const int d = threadIdx.x;
  unsigned t_incl = 0u;
  unsigned g_incl = 0u;
  if (d < KS_RADIX) {
    // each warp's first row of the digit, and the tile's total; publish it
    unsigned total = 0u;
    for (int w = 0; w < KS_WARPS; ++w) {
      const unsigned t = s_count[w * KS_RADIX + d];
      s_count[w * KS_RADIX + d] = total;
      total += t;
    }
    s_total[d] = total;
    *(volatile unsigned*)&status[(long long)d * tiles + tile] = (tile == 0 ? KS_INC : 0u) |
                                                                  (total + 1u);
    other[(long long)d * tiles + tile] = 0u;
    s_before[d] = 0u;
    // inclusive scans over the digits, in each warp: the tile's digit
    // starts, and the pass's global digit starts from its histogram
    t_incl = ks_warp_scan(total, lane);
    g_incl = ks_warp_scan(((const unsigned*)(ctl + KS_CTL_HIST))[pass * KS_RADIX + d], lane);
    if (lane == 31) {
      s_sums[0][warp] = t_incl;
      s_sums[1][warp] = g_incl;
    }
  }
  __syncthreads();
  if (d < KS_RADIX) {
    unsigned t_base = 0u;
    unsigned g_base = 0u;
    for (int w = 0; w < warp; ++w) {
      t_base += s_sums[0][w];
      g_base += s_sums[1][w];
    }
    const unsigned start = t_base + t_incl - s_total[d];
    s_start[d] = start;
    const unsigned g = ((const unsigned*)(ctl + KS_CTL_HIST))[pass * KS_RADIX + d];
    s_offset[d] = (long long)(g_base + g_incl - g) - (long long)start;
  }
  __syncthreads();
  // reorder the tile so that each digit's rows are contiguous
#pragma unroll
  for (int c = 0; c < KS_CHUNKS; ++c) {
    const int j = warp * KS_PER_WARP + c * 32 + lane;
    if (j < rows) {
      const unsigned dd = (ks_key(item[c]) >> shift) & 0xffu;
      s_tile[s_start[dd] + s_count[warp * KS_RADIX + dd] + rank[c]] = item[c];
    }
  }
  // decoupled look-back: warp w resolves the digits from KS_LOOK_BACK_DIGITS * w
  // that the tile holds
  if (tile > 0) {
    const int d0 = warp * KS_LOOK_BACK_DIGITS;
    const unsigned held = __ballot_sync(0xffffffffu, lane < KS_LOOK_BACK_DIGITS &&
                                                         s_total[d0 + lane] != 0u);
    ks_look_back(status, tiles, tile, d0, held, lane, s_total, s_before);
  }
  __syncthreads();
  // write each digit's run out contiguously
  for (int j = threadIdx.x; j < rows; j += KS_THREADS) {
    const uint32_t b = s_tile[j];
    const unsigned dd = (ks_key(b) >> shift) & 0xffu;
    out[s_offset[dd] + s_before[dd] + j] = b;
  }
  if (pass != 3) return;
  // the last pass: the block that finishes last picks
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    s_last = atomicAdd((unsigned*)(ctl + KS_CTL_DONE), 1u) == (unsigned)tiles - 1u;
  }
  __syncthreads();
  if (s_last) {
    __threadfence();
    ks_pick_block(out, ctl, ticks, k, samples, meta, minmax);
  }
}

// the pick of an empty batch (no pass runs)
template <class M>
__global__ void ks_pick(const unsigned long long* __restrict__ ctl, const int* __restrict__ ticks,
                        int k, float* __restrict__ samples, int* __restrict__ meta,
                        M* __restrict__ minmax) {
  ks_pick_block(nullptr, ctl, ticks, k, samples, meta, minmax);
}

static long long ks_tiles(long long n) { return (n + KS_TILE - 1) / KS_TILE; }

// bytes of the control block: a multiple of 16
static long long ks_control_bytes(long long n) {
  return (KS_CTL_STATUS + ks_tiles(n) * KS_RADIX + 1) / 2 * 2 * 8;
}

// rows of one bits buffer: n rounded up to a multiple of 4 (16 bytes)
static long long ks_padded(long long n) { return (n + 3) / 4 * 4; }

// bytes of device scratch a call over n rows needs
extern "C" long long kll_sample_scratch_bytes(long long n) {
  return ks_control_bytes(n) + 2 * ks_padded(n) * 4;
}

// scratch: kll_sample_scratch_bytes(n) bytes, 16-byte aligned; ticks: the
// sketch's int32 update counter on the device; values and minmax of type V
template <class V>
static int ks_launch(const V* values, const uint8_t* rows, const uint8_t* where,
                     const uint8_t* present, long long n, int k, const int* ticks, void* scratch,
                     float* samples, int* meta, V* minmax, void* stream) {
  if (n < 0 || n > 0x7fffffffLL || k < 1 || ((uintptr_t)scratch & 15u) != 0) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = (cudaStream_t)stream;
  unsigned long long* ctl = (unsigned long long*)scratch;
  uint32_t* bits0 = (uint32_t*)((char*)scratch + ks_control_bytes(n));
  uint32_t* bits1 = bits0 + ks_padded(n);
  cudaError_t err = cudaMemsetAsync(ctl, 0, (size_t)ks_control_bytes(n), st);
  if (err != cudaSuccess) return (int)err;
  if (n > 0) {
    const int up_blocks =
        dq_grid_for(n, KS_UP_THREADS * KS_UP_ROWS_PER_THREAD, KS_UP_MAX_BLOCKS);
    ks_upsweep<V><<<up_blocks, KS_UP_THREADS, 0, st>>>(values, rows, where, present, n, bits0,
                                                      ctl);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    err = cudaFuncSetAttribute((const void*)ks_scatter<V>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, KS_SCATTER_SMEM);
    if (err != cudaSuccess) return (int)err;
    // the last pass's last block picks
    for (int pass = 0; pass < 4; ++pass) {
      ks_scatter<V><<<(unsigned)ks_tiles(n), KS_THREADS, KS_SCATTER_SMEM, st>>>(
          bits0, bits1, n, pass, ctl, ticks, k, samples, meta, minmax);
      if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    }
    return (int)cudaSuccess;
  }
  ks_pick<V><<<1, 1024, 0, st>>>(ctl, ticks, k, samples, meta, minmax);
  return (int)cudaGetLastError();
}

// float64 values, float64 minmax
extern "C" int kll_sample_launch(const double* values, const uint8_t* rows,
                                 const uint8_t* where, const uint8_t* present, long long n,
                                 int k, const int* ticks, void* scratch, float* samples,
                                 int* meta, double* minmax, void* stream) {
  return ks_launch<double>(values, rows, where, present, n, k, ticks, scratch, samples, meta,
                           minmax, stream);
}

// the 32-bit accumulator mode (DEEQU_TPU_NO_X64): float32 values, float32
// minmax; the same samples and meta
extern "C" int kll_sample_launch_f32(const float* values, const uint8_t* rows,
                                     const uint8_t* where, const uint8_t* present, long long n,
                                     int k, const int* ticks, void* scratch, float* samples,
                                     int* meta, float* minmax, void* stream) {
  return ks_launch<float>(values, rows, where, present, n, k, ticks, scratch, samples, meta,
                          minmax, stream);
}
