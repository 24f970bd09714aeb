// K7 freq_compact: sort-merge compaction of (key, count) pairs into a table
// of at most out_size sorted unique keys with summed counts.
//
// Replaces freq_compact (deequ_tpu/ops/__init__.py:33) as the reference's
// FrequencyTableState.compacted (deequ_tpu/analyzers/states.py:112) and
// .merge (:190) call it. Keys are uint64 (the port holds them in int64
// tensors); the sentinel (all ones) marks an empty entry, sorts last and
// carries count 0.
//
// Inputs: A, a table (na keys sorted ascending, sentinel-padded, counts);
// B, either a second table of the same form (merge mode) or the raw key
// buffer of one state (nb keys in any order, each counting 1 unless it is
// the sentinel). Outputs: out_keys[out_size] ascending, sentinel past the
// unique count; out_counts[out_size], 0 past it; meta int64[4] = (n_unique,
// kept_rows, total_rows, scratch): n_unique is the raw distinct count,
// which may exceed out_size (the smallest out_size keys are kept),
// kept_rows the summed counts of the kept keys, total_rows of all keys.
//
// Steps, each spread over many blocks:
//   1. buffer mode only: a stable LSD radix sort of B's keys, eight 8-bit
//      digits, each pass three launches: a per-tile digit histogram (which
//      also adds up each digit's total), a scan of the digit-major table in
//      which block d scans digit d's row of tiles, and a stable scatter
//      that ranks a tile's keys by digit with __match_any_sync inside a
//      warp and per-warp counts across warps;
//   2. a merge of the two sorted runs: each entry finds its place by a
//      binary search in the other run (A before B among equal keys);
//   3. per chunk of the merged run, the number of run starts (an entry
//      that differs from its predecessor and is not the sentinel) and the
//      sum of counts; one block scans those chunk sums;
//   4. per chunk again, round by round, a block scan gives each entry its
//      run rank and count prefix: a run's first entry writes its key and
//      subtracts the prefix before it from the run's count, its last entry
//      adds the prefix after it (two atomics per unique key, on distinct
//      addresses). A round is one entry per thread, so loads coalesce;
//   5. one thread settles kept_rows.
// Integer adds are exact, so the result is the same bits in any order.
//
// Bound on the card: bytes. The function must read the (key, count) pairs
// and write the table: 16 bytes per input entry and per table entry. This
// design also moves the radix passes (16 bytes per buffer key and pass)
// and the merged run (16 bytes per entry, written once and read twice).
#include "common.cuh"

#define FC_THREADS 256
#define FC_WARPS (FC_THREADS / 32)
#define FC_RADIX 256
#define FC_PASSES 8
#define FC_TILE 2048  // keys per block in a radix pass
#define FC_ROUNDS (FC_TILE / FC_THREADS)
#define FC_ITEMS 16   // rounds of FC_THREADS merged entries in a run-scan chunk
#define FC_CHUNK (FC_THREADS * FC_ITEMS)
#define FC_MERGE_MAX_BLOCKS 4224
#define FC_SENTINEL 0xffffffffffffffffull

typedef unsigned long long u64;
typedef long long i64;

// inclusive scan over the block; *total gets the block's sum. Every thread
// of the block must call it (it synchronises twice).
template <typename T>
__device__ __forceinline__ T fc_block_scan(T v, T* warp_tot, T* total) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int off = 1; off < 32; off <<= 1) {
    const T t = __shfl_up_sync(0xffffffffu, v, off);
    if (lane >= off) v += t;
  }
  if (lane == 31) warp_tot[warp] = v;
  __syncthreads();
  T before = 0, all = 0;
  for (int w = 0; w < FC_WARPS; ++w) {
    const T x = warp_tot[w];
    if (w < warp) before += x;
    all += x;
  }
  __syncthreads();
  *total = all;
  return v + before;
}

// ---- step 1: the radix sort of the buffer ---------------------------------

// hist[d * tiles + t] = keys of tile t whose digit is d; totals[d] += that
__global__ void __launch_bounds__(FC_THREADS)
fc_hist(const u64* __restrict__ keys, i64 n, int shift, int tiles,
        unsigned* __restrict__ hist, unsigned* __restrict__ totals) {
  __shared__ unsigned h[FC_RADIX];
  h[threadIdx.x] = 0u;
  __syncthreads();
  const i64 tile0 = (i64)blockIdx.x * FC_TILE;
  for (int r = 0; r < FC_ROUNDS; ++r) {
    const i64 i = tile0 + r * FC_THREADS + threadIdx.x;
    if (i < n) atomicAdd(&h[(keys[i] >> shift) & 0xffu], 1u);
  }
  __syncthreads();
  const unsigned c = h[threadIdx.x];
  hist[(i64)threadIdx.x * tiles + blockIdx.x] = c;
  if (c) atomicAdd(&totals[threadIdx.x], c);
}

// block d: exclusive scan of digit d's row of tiles, offset by the keys of
// all smaller digits, in place
__global__ void __launch_bounds__(FC_THREADS)
fc_digit_scan(unsigned* __restrict__ hist, const unsigned* __restrict__ totals, int tiles) {
  __shared__ unsigned warp_tot[FC_WARPS];
  const int d = blockIdx.x;
  unsigned total;
  fc_block_scan<unsigned>(threadIdx.x < d ? totals[threadIdx.x] : 0u, warp_tot, &total);
  unsigned running = total;
  unsigned* row = hist + (i64)d * tiles;
  for (int start = 0; start < tiles; start += FC_THREADS) {
    const int j = start + threadIdx.x;
    const unsigned v = j < tiles ? row[j] : 0u;
    const unsigned incl = fc_block_scan<unsigned>(v, warp_tot, &total);
    if (j < tiles) row[j] = running + incl - v;
    running += total;
  }
}

// stable scatter of one tile by the digit at `shift`
__global__ void __launch_bounds__(FC_THREADS)
fc_scatter(const u64* __restrict__ keys_in, i64 n, int shift, int tiles,
           const unsigned* __restrict__ offsets, u64* __restrict__ keys_out) {
  __shared__ unsigned base[FC_RADIX];
  __shared__ unsigned round_total[FC_RADIX];
  __shared__ unsigned warp_cnt[FC_WARPS][FC_RADIX];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const unsigned lanes_below = (1u << lane) - 1u;
  base[threadIdx.x] = offsets[(i64)threadIdx.x * tiles + blockIdx.x];
  const i64 tile0 = (i64)blockIdx.x * FC_TILE;
  for (int r = 0; r < FC_ROUNDS; ++r) {
    for (int w = 0; w < FC_WARPS; ++w) warp_cnt[w][threadIdx.x] = 0u;
    __syncthreads();
    const i64 i = tile0 + r * FC_THREADS + threadIdx.x;
    const bool valid = i < n;
    const u64 key = valid ? keys_in[i] : 0ull;
    // entries past n take a digit of their own, so they rank with no one
    const unsigned d = valid ? (unsigned)((key >> shift) & 0xffu) : 0x100u + lane;
    const unsigned peers = __match_any_sync(0xffffffffu, d);
    const unsigned rank = __popc(peers & lanes_below);
    if (valid && rank == 0) warp_cnt[warp][d] = __popc(peers);
    __syncthreads();
    unsigned s = 0u;
    for (int w = 0; w < FC_WARPS; ++w) {
      const unsigned t = warp_cnt[w][threadIdx.x];
      warp_cnt[w][threadIdx.x] = s;
      s += t;
    }
    round_total[threadIdx.x] = s;
    __syncthreads();
    if (valid) keys_out[base[d] + warp_cnt[warp][d] + rank] = key;
    __syncthreads();
    base[threadIdx.x] += round_total[threadIdx.x];
  }
}

// ---- step 2: the merge ----------------------------------------------------

// entries of a[0, n) below key (strict) or at most key
__device__ __forceinline__ i64 fc_rank(const u64* __restrict__ a, i64 n, u64 key,
                                       bool inclusive) {
  i64 lo = 0, hi = n;
  while (lo < hi) {
    const i64 mid = (lo + hi) >> 1;
    const u64 v = a[mid];
    if (v < key || (inclusive && v == key)) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

// b_counts null: each key of B counts 1 unless it is the sentinel
__global__ void __launch_bounds__(FC_THREADS)
fc_merge(const u64* __restrict__ a_keys, const i64* __restrict__ a_counts, i64 na,
         const u64* __restrict__ b_keys, const i64* __restrict__ b_counts, i64 nb,
         u64* __restrict__ keys, i64* __restrict__ counts) {
  const i64 stride = (i64)gridDim.x * blockDim.x;
  for (i64 idx = (i64)blockIdx.x * blockDim.x + threadIdx.x; idx < na + nb; idx += stride) {
    u64 key;
    i64 count, pos;
    if (idx < na) {
      key = a_keys[idx];
      count = a_counts[idx];
      pos = idx + fc_rank(b_keys, nb, key, false);
    } else {
      const i64 j = idx - na;
      key = b_keys[j];
      count = b_counts ? b_counts[j] : (key != FC_SENTINEL ? 1 : 0);
      pos = j + fc_rank(a_keys, na, key, true);
    }
    keys[pos] = key;
    counts[pos] = count;
  }
}

// ---- steps 3-5: runs, ranks and counts ------------------------------------

__device__ __forceinline__ bool fc_starts_run(const u64* __restrict__ keys, i64 i, u64 k) {
  return k != FC_SENTINEL && (i == 0 || keys[i - 1] != k);
}

// sums[2 b] = run starts in chunk b, sums[2 b + 1] = its summed counts.
// A chunk is FC_ITEMS rounds of FC_THREADS consecutive entries, one entry
// per thread a round, so a warp's loads are contiguous.
__global__ void __launch_bounds__(FC_THREADS)
fc_chunk_sums(const u64* __restrict__ keys, const i64* __restrict__ counts, i64 n,
              i64* __restrict__ sums) {
  __shared__ i64 warp_tot[FC_WARPS];
  const i64 chunk0 = (i64)blockIdx.x * FC_CHUNK;
  i64 starts = 0, total = 0;
  for (int r = 0; r < FC_ITEMS; ++r) {
    const i64 i = chunk0 + (i64)r * FC_THREADS + threadIdx.x;
    if (i < n) {
      starts += fc_starts_run(keys, i, keys[i]) ? 1 : 0;
      total += counts[i];
    }
  }
  i64 all_starts, all_total;
  fc_block_scan<i64>(starts, warp_tot, &all_starts);
  fc_block_scan<i64>(total, warp_tot, &all_total);
  if (threadIdx.x == 0) {
    sums[2 * blockIdx.x] = all_starts;
    sums[2 * blockIdx.x + 1] = all_total;
  }
}

// one block: exclusive scan of the chunk sums, in place
__global__ void __launch_bounds__(FC_THREADS)
fc_scan_chunks(i64* __restrict__ sums, int chunks) {
  __shared__ i64 warp_tot[FC_WARPS];
  i64 run_starts = 0, run_total = 0;
  for (int start = 0; start < chunks; start += FC_THREADS) {
    const int b = start + threadIdx.x;
    const i64 s = b < chunks ? sums[2 * b] : 0;
    const i64 t = b < chunks ? sums[2 * b + 1] : 0;
    i64 all_s, all_t;
    const i64 incl_s = fc_block_scan<i64>(s, warp_tot, &all_s);
    const i64 incl_t = fc_block_scan<i64>(t, warp_tot, &all_t);
    if (b < chunks) {
      sums[2 * b] = run_starts + incl_s - s;
      sums[2 * b + 1] = run_total + incl_t - t;
    }
    run_starts += all_s;
    run_total += all_t;
  }
}

// out_counts zeroed and out_keys filled with the sentinel beforehand. The
// chunk's rounds go in order; a block scan per round ranks its entries.
__global__ void __launch_bounds__(FC_THREADS)
fc_emit(const u64* __restrict__ keys, const i64* __restrict__ counts, i64 n,
        const i64* __restrict__ sums, i64 out_size, u64* __restrict__ out_keys,
        i64* __restrict__ out_counts, i64* __restrict__ meta) {
  __shared__ i64 warp_tot[FC_WARPS];
  const i64 chunk0 = (i64)blockIdx.x * FC_CHUNK;
  i64 rank_base = sums[2 * blockIdx.x];
  i64 prefix_base = sums[2 * blockIdx.x + 1];
  for (int r = 0; r < FC_ITEMS; ++r) {
    const i64 i = chunk0 + (i64)r * FC_THREADS + threadIdx.x;
    const bool valid = i < n;
    const u64 k = valid ? keys[i] : FC_SENTINEL;
    const i64 c = valid ? counts[i] : 0;
    const bool start = valid && fc_starts_run(keys, i, k);
    i64 round_starts, round_total;
    // runs started up to and including entry i: the rank of i's run
    const i64 rank = rank_base + fc_block_scan<i64>(start ? 1 : 0, warp_tot, &round_starts);
    const i64 after = prefix_base + fc_block_scan<i64>(c, warp_tot, &round_total);
    if (start && rank <= out_size) {
      out_keys[rank - 1] = k;
      atomicAdd((u64*)&out_counts[rank - 1], (u64)(-(after - c)));
    }
    if (valid && k != FC_SENTINEL && (i == n - 1 || keys[i + 1] != k) && rank <= out_size) {
      atomicAdd((u64*)&out_counts[rank - 1], (u64)after);
      if (rank == out_size) meta[3] = after;  // rows up to the last kept key
    }
    if (i == n - 1) {
      meta[0] = rank;
      meta[2] = after;
    }
    rank_base += round_starts;
    prefix_base += round_total;
  }
}

__global__ void fc_finish(i64* __restrict__ meta, i64 out_size) {
  meta[1] = meta[0] > out_size ? meta[3] : meta[2];
}

// ---- entry points -----------------------------------------------------------

static i64 fc_tiles(i64 nb) { return (nb + FC_TILE - 1) / FC_TILE; }

static i64 fc_chunks(i64 n) { return (n + FC_CHUNK - 1) / FC_CHUNK; }

// 8-byte words of scratch a launch needs
extern "C" long long freq_compact_scratch_words(long long na, long long nb, int sort_b) {
  i64 words = 2 * (na + nb) + 2 * fc_chunks(na + nb);
  if (sort_b) {
    const i64 hist = (i64)FC_RADIX * fc_tiles(nb) + (i64)FC_PASSES * FC_RADIX;
    words += 2 * nb + (hist + 1) / 2;
  }
  return words;
}

// a_keys/a_counts: the first table (na entries); b_keys: the second table
// (b_counts given) or the raw buffer (b_counts null, sorted here). out_keys
// and out_counts: out_size entries; meta: int64[4]; scratch: the words of
// freq_compact_scratch_words.
extern "C" int freq_compact_launch(const u64* a_keys, const i64* a_counts, long long na,
                                   const u64* b_keys, const i64* b_counts, long long nb,
                                   long long out_size, u64* out_keys, i64* out_counts,
                                   i64* meta, i64* scratch, void* stream) {
  if (na < 0 || nb < 0 || out_size < 1 || na + nb > 0x7fffffffLL) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = (cudaStream_t)stream;
  const i64 n = na + nb;
  const i64 chunks = fc_chunks(n);
  u64* keys = (u64*)scratch;
  i64* counts = scratch + n;
  i64* sums = scratch + 2 * n;
  cudaError_t err = cudaMemsetAsync(meta, 0, 4 * sizeof(i64), st);
  if (err == cudaSuccess) err = cudaMemsetAsync(out_keys, 0xff, out_size * sizeof(u64), st);
  if (err == cudaSuccess) err = cudaMemsetAsync(out_counts, 0, out_size * sizeof(i64), st);
  if (err != cudaSuccess) return (int)err;

  const u64* sorted_b = b_keys;
  if (!b_counts && nb > 0) {
    u64* s0 = (u64*)(sums + 2 * chunks);
    u64* s1 = s0 + nb;
    const int tiles = (int)fc_tiles(nb);
    unsigned* hist = (unsigned*)(s1 + nb);
    unsigned* totals = hist + (i64)FC_RADIX * tiles;
    err = cudaMemsetAsync(totals, 0, FC_PASSES * FC_RADIX * sizeof(unsigned), st);
    if (err != cudaSuccess) return (int)err;
    const u64* in = b_keys;
    for (int pass = 0; pass < FC_PASSES; ++pass) {
      u64* out = pass % 2 == 0 ? s0 : s1;
      const int shift = 8 * pass;
      unsigned* pass_totals = totals + pass * FC_RADIX;
      fc_hist<<<tiles, FC_THREADS, 0, st>>>(in, nb, shift, tiles, hist, pass_totals);
      if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
      fc_digit_scan<<<FC_RADIX, FC_THREADS, 0, st>>>(hist, pass_totals, tiles);
      if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
      fc_scatter<<<tiles, FC_THREADS, 0, st>>>(in, nb, shift, tiles, hist, out);
      if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
      in = out;
    }
    sorted_b = in;
  }
  if (n > 0) {
    const int blocks = dq_grid_for(n, FC_THREADS * 4, FC_MERGE_MAX_BLOCKS);
    fc_merge<<<blocks, FC_THREADS, 0, st>>>(a_keys, a_counts, na, sorted_b, b_counts, nb,
                                            keys, counts);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    fc_chunk_sums<<<(unsigned)chunks, FC_THREADS, 0, st>>>(keys, counts, n, sums);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    fc_scan_chunks<<<1, FC_THREADS, 0, st>>>(sums, (int)chunks);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    fc_emit<<<(unsigned)chunks, FC_THREADS, 0, st>>>(keys, counts, n, sums, out_size,
                                                     out_keys, out_counts, meta);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  fc_finish<<<1, 1, 0, st>>>(meta, out_size);
  return (int)cudaGetLastError();
}
