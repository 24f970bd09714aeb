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
// kept_rows, total_rows, rows up to the last kept key when n_unique >=
// out_size, else 0): n_unique is the raw distinct count, which may exceed
// out_size (the smallest out_size keys are kept), kept_rows the summed
// counts of the kept keys, total_rows of all keys.
//
// What bounds it on this card: bytes. The function must read the (key,
// count) pairs and write the table: 16 bytes per table entry, 8 per buffer
// key (a 2^22-entry table and a 2^20-key buffer: 143 MB, 43 us at 3.35
// TB/s). Design:
//
//  - Buffer mode sorts only the buffer's real keys: the sentinels are
//    counted and set aside (they would sort last with count 0 and add
//    nothing). The sort is a one-sweep LSD radix sort of 8-bit digits, the
//    shape of K4's (kll_sample.cu): one upsweep reads the buffer once and
//    builds the count of real keys and all eight digit histograms, and its
//    last block marks the passes whose digit is not the same for every
//    real key; then eight scatter launches, launch i running the i-th
//    marked pass (a launch past the last returns at once). The keys are
//    hashes (SplitMix64 or xxhash64), so a buffer of many distinct keys
//    takes all eight passes; one of few keys skips most. A pass takes
//    8,192-key tiles (dynamic tile ids), loads a tile with every load in
//    flight, ranks it by digit with eight ballots a warp, reorders it in
//    shared memory, gets each digit's offset by decoupled look-back over
//    the tiles before it, and writes each digit's run contiguously. The
//    first pass drops the sentinels. An equal-key buffer with sentinels
//    runs one pass anyway, as its compaction.
//  - One pass merges and compacts (fc_merge_compact): merge path cuts the
//    merged sequence into tiles of FC_TILE entries (fc_partition: a search
//    of A and B by FC_SPLIT_LANES lanes on each tile boundary's diagonal, A
//    before B among equal keys); a block loads its tile of both runs with
//    every load in flight, merges it in shared memory, marks run starts,
//    and gets the run rank and the open run's count from the tiles before
//    it by decoupled look-back (a 16-byte descriptor a tile: its run
//    starts, and the counts of the run open at its end, which a tile
//    holding a run start or a sentinel closes). Each run is written by the
//    tile that holds its end, staged in rank order and stored coalesced
//    into out_keys / out_counts: the merged run is never stored.
//  - Only the slots past n_unique are filled with the sentinel and 0 (a
//    last launch, which also settles meta).
// Both stages stay latency-bound far from the byte bound: a scatter pass
// is one tile's chain of ticket, load, ranking, look-back and store; a
// merge tile's chain of load, merge, scans, look-back and store, with 4
// tiles an SM in flight (tools/freq_compact_phases.py times them).
// Integer adds are exact, so the result is the same bits in any order.
#include "common.cuh"

typedef unsigned long long u64;
typedef long long i64;

#define FC_SENTINEL 0xffffffffffffffffull
#define FC_RADIX 256
#define FC_PASSES 8

// the sort: upsweep and scatter shapes
#define FC_UP_THREADS 512
#define FC_UP_UNROLL 4
#define FC_UP_MAX_BLOCKS 1024
#define FC_S_THREADS 1024
#define FC_S_WARPS (FC_S_THREADS / 32)
#define FC_S_TILE 8192
#define FC_S_PER_WARP (FC_S_TILE / FC_S_WARPS)
#define FC_S_CHUNKS (FC_S_PER_WARP / 32)
#define FC_LOOK_BACK_DIGITS (FC_RADIX / FC_S_WARPS)
// dynamic shared memory of a scatter block: the tile, and each warp's
// digit counts
#define FC_S_SMEM (FC_S_TILE * 8 + FC_S_WARPS * FC_RADIX * 4)

// the merge: FC_ITEMS merged entries a thread, FC_TILE a block
#define FC_M_THREADS 256
#define FC_M_WARPS (FC_M_THREADS / 32)
#define FC_ITEMS 8
#define FC_TILE (FC_M_THREADS * FC_ITEMS)
// a tile entry's place in shared memory: one word of padding every 16, so
// that the threads of a warp, each merging from its own diagonal 8
// entries after the last, read from different banks
#define FC_PAD(j) ((j) + ((j) >> 4))
#define FC_TILE_PADDED FC_PAD(FC_TILE)
// dynamic shared memory of a merge block: the tile's keys and counts, each
// thread's first and last merged key
#define FC_M_SMEM (FC_TILE_PADDED * 16 + FC_M_THREADS * 16)
// the split kernel: FC_SPLIT_LANES lanes a tile boundary
#define FC_P_THREADS 256
#define FC_SPLIT_LANES 8
#define FC_FILL_THREADS 256
#define FC_FILL_MAX_BLOCKS 2048

// the control block (uint64 words, zeroed by one memset): the eight digit
// histograms (uint32[8][256]), the real keys of the buffer, the scatter
// launches' tile tickets (uint32[8]), the merge's, the kept and total
// counts, the unique count, the mask of the passes that move keys and the
// upsweep's finished blocks; then the merge's tile descriptors (two words
// a tile), its tiles' merge-path splits (one word a tile and one more),
// then the scatter's status words (two arrays of uint32[256][sort tiles])
#define FC_CTL_HIST 0
#define FC_CTL_REAL 1024
#define FC_CTL_TICKETS 1025
#define FC_CTL_MERGE_TICKET 1029
#define FC_CTL_KEPT 1030
#define FC_CTL_TOTAL 1031
#define FC_CTL_UNIQUE 1032
#define FC_CTL_RUNNING 1033
#define FC_CTL_UP_DONE 1034
#define FC_CTL_DESC 1036  // 16-byte aligned

// ---- the sort of the buffer's real keys ------------------------------------

// add a warp's keys (valid lanes) to the eight digit histograms: one add
// where the warp's keys share a digit (a buffer of few distinct keys),
// else one add a key
__device__ __forceinline__ void fc_count_digits(unsigned* s_hist, u64 key, bool valid, int lane) {
  const unsigned lanes = __ballot_sync(0xffffffffu, valid);
  if (lanes == 0u) return;
#pragma unroll
  for (int p = 0; p < FC_PASSES; ++p) {
    const unsigned d = (unsigned)(key >> (8 * p)) & 0xffu;
    const unsigned d0 = __shfl_sync(0xffffffffu, d, __ffs(lanes) - 1);
    if (__all_sync(0xffffffffu, !valid || d == d0)) {
      if (lane == 0) atomicAdd(&s_hist[p * FC_RADIX + d0], (unsigned)__popc(lanes));
    } else if (valid) {
      atomicAdd(&s_hist[p * FC_RADIX + d], 1u);
    }
  }
}

__device__ __forceinline__ i64 fc_real_keys(const u64* ctl) {
  return (i64) * (const volatile unsigned*)(ctl + FC_CTL_REAL);
}

// the passes that move keys, in order, as a bit mask: a pass whose digit is
// not the same for every real key; or, when no pass is such and the buffer
// holds sentinels beside real keys, the last pass (a compaction). Every
// thread of the block must call it; threads 0 .. 255 read eight counts each.
__device__ unsigned fc_running(const u64* ctl, i64 nb) {
  const i64 real = fc_real_keys(ctl);
  const volatile unsigned* hist = (const volatile unsigned*)(ctl + FC_CTL_HIST);
  unsigned full = 0u;  // the passes in which this thread's digit holds every key
  if (threadIdx.x < FC_RADIX) {
    for (int p = 0; p < FC_PASSES; ++p) {
      full |= (i64)hist[p * FC_RADIX + threadIdx.x] == real ? 1u << p : 0u;
    }
  }
  unsigned mask = 0u;
  for (int p = 0; p < FC_PASSES; ++p) {
    if (!__syncthreads_or((full >> p) & 1u)) mask |= 1u << p;
  }
  if (mask == 0u && real > 0 && real < nb) mask = 1u << (FC_PASSES - 1);
  return mask;
}

// the count of real keys and the eight digit histograms of the buffer
__global__ void __launch_bounds__(FC_UP_THREADS)
fc_upsweep(const u64* __restrict__ keys, i64 n, u64* __restrict__ ctl) {
  __shared__ unsigned s_hist[FC_PASSES * FC_RADIX];
  __shared__ unsigned s_real;
  __shared__ bool s_last;
  for (int d = threadIdx.x; d < FC_PASSES * FC_RADIX; d += FC_UP_THREADS) s_hist[d] = 0u;
  if (threadIdx.x == 0) s_real = 0u;
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  unsigned real = 0u;
  const i64 step = (i64)gridDim.x * FC_UP_THREADS;
  // i0 is the same for the whole warp, so every lane takes every trip
  for (i64 i0 = (i64)blockIdx.x * FC_UP_THREADS + warp * 32; i0 < n; i0 += FC_UP_UNROLL * step) {
    u64 k[FC_UP_UNROLL];
#pragma unroll
    for (int u = 0; u < FC_UP_UNROLL; ++u) {
      const i64 i = i0 + u * step + lane;
      k[u] = i < n ? keys[i] : FC_SENTINEL;
    }
#pragma unroll
    for (int u = 0; u < FC_UP_UNROLL; ++u) {
      const bool valid = k[u] != FC_SENTINEL;
      real += valid ? 1u : 0u;
      fc_count_digits(s_hist, k[u], valid, lane);
    }
  }
  for (int off = 16; off > 0; off >>= 1) real += __shfl_down_sync(0xffffffffu, real, off);
  if (lane == 0 && real) atomicAdd(&s_real, real);
  __syncthreads();
  unsigned* hist = (unsigned*)(ctl + FC_CTL_HIST);
  for (int d = threadIdx.x; d < FC_PASSES * FC_RADIX; d += FC_UP_THREADS) {
    if (s_hist[d] != 0u) atomicAdd(&hist[d], s_hist[d]);
  }
  if (threadIdx.x == 0 && s_real) atomicAdd((unsigned*)(ctl + FC_CTL_REAL), s_real);
  // the block that finishes last settles which passes move keys
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    s_last = atomicAdd((unsigned*)(ctl + FC_CTL_UP_DONE), 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (s_last) {
    __threadfence();
    const unsigned mask = fc_running(ctl, n);
    if (threadIdx.x == 0) *(unsigned*)(ctl + FC_CTL_RUNNING) = mask;
  }
}

// inclusive scan of v over the 32 lanes of a warp
template <typename T>
__device__ __forceinline__ T fc_warp_scan(T v, int lane) {
  for (int o = 1; o < 32; o <<= 1) {
    const T y = __shfl_up_sync(0xffffffffu, v, o);
    if (lane >= o) v += y;
  }
  return v;
}

// status word of a digit in a tile: 0 until published; then the tile's
// keys of the digit plus 1 (an aggregate), or, with the top bit set, the
// keys of the digit in this tile and all before it plus 1 (an inclusive
// prefix; at most n < 2^31)
#define FC_INC 0x80000000u

// decoupled look-back of one warp for the FC_LOOK_BACK_DIGITS digits from
// d0 that this tile holds (`pending`); kll_sample.cu ks_look_back, the same
// protocol
__device__ void fc_look_back(unsigned* status, int tiles, int tile, int d0, unsigned pending,
                             int lane, const unsigned* total, unsigned* before) {
  const unsigned held = pending;
  unsigned mine = 0u;  // lane j: the sum of digit d0 + j
  for (int t = tile - 1; pending; t -= 32) {
    unsigned s[FC_LOOK_BACK_DIGITS];
    for (;;) {
#pragma unroll
      for (int j = 0; j < FC_LOOK_BACK_DIGITS; ++j) {
        s[j] = ((pending >> j) & 1u) && t - lane >= 0
            ? *(const volatile unsigned*)(status + (i64)(d0 + j) * tiles + t - lane)
            : FC_INC | 1u;
      }
      bool ready = true;
#pragma unroll
      for (int j = 0; j < FC_LOOK_BACK_DIGITS; ++j) {
        const unsigned incs = __ballot_sync(0xffffffffu, s[j] & FC_INC);
        const unsigned published = __ballot_sync(0xffffffffu, s[j] != 0u);
        // the lanes up to the nearest inclusive prefix must have published
        const unsigned need = incs ? ((incs & (0u - incs)) << 1) - 1u : 0xffffffffu;
        ready = ready && (published & need) == need;
      }
      if (ready) break;
      __nanosleep(64);
    }
#pragma unroll
    for (int j = 0; j < FC_LOOK_BACK_DIGITS; ++j) {
      if (((pending >> j) & 1u) == 0u) continue;
      const unsigned incs = __ballot_sync(0xffffffffu, s[j] & FC_INC);
      const int last = incs ? __ffs(incs) - 1 : 31;
      unsigned v = lane <= last ? (s[j] & ~FC_INC) - 1u : 0u;
      for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
      if (lane == j) mine += v;
      if (incs) pending &= ~(1u << j);
    }
  }
  if (lane < FC_LOOK_BACK_DIGITS && ((held >> lane) & 1u)) {
    const int d = d0 + lane;
    *(volatile unsigned*)&status[(i64)d * tiles + tile] = FC_INC | (mine + total[d] + 1u);
    before[d] = mine;
  }
}

// the lanes of the warp whose digit equals this lane's, among `lanes`:
// eight ballots, one a bit of the digit
__device__ __forceinline__ unsigned fc_peers(unsigned d, unsigned lanes) {
  unsigned peers = lanes;
#pragma unroll
  for (int b = 0; b < 8; ++b) {
    const unsigned vote = __ballot_sync(0xffffffffu, (d >> b) & 1u);
    peers &= ((d >> b) & 1u) ? vote : ~vote;
  }
  return peers;
}

// launch `launch` of the sort: the launch-th pass that moves keys (none:
// return). Launch 0 reads the raw buffer and drops its sentinels; launch i
// reads keys[(i - 1) & 1] and writes keys[i & 1]. One stable scatter over
// the pass's digit, one tile a block (one block an SM).
__global__ void __launch_bounds__(FC_S_THREADS)
fc_scatter(const u64* __restrict__ raw, i64 nb, u64* keys0, u64* keys1, int launch,
           u64* ctl, unsigned* sort_status, int stride) {
  extern __shared__ __align__(16) u64 fc_smem[];
  __shared__ int s_tile_id;
  __shared__ unsigned s_start[FC_RADIX];    // the tile's first sorted key of each digit
  __shared__ unsigned s_total[FC_RADIX];    // the tile's keys of each digit
  __shared__ unsigned s_before[FC_RADIX];   // the digit's keys in earlier tiles
  __shared__ i64 s_offset[FC_RADIX];        // global position minus tile position, by digit
  __shared__ unsigned s_sums[2][FC_RADIX / 32];
  __shared__ unsigned s_kept[FC_S_WARPS];
  const unsigned running = *(const unsigned*)(ctl + FC_CTL_RUNNING);
  if (__popc(running) <= launch) return;
  unsigned m = running;
  for (int i = 0; i < launch; ++i) m &= m - 1u;
  const int pass = __ffs(m) - 1;
  const int shift = 8 * pass;
  const bool first = launch == 0;
  const u64* in = first ? raw : (launch & 1 ? keys0 : keys1);
  u64* out = launch & 1 ? keys1 : keys0;
  const i64 n = first ? nb : fc_real_keys(ctl);
  const int tiles = (int)((n + FC_S_TILE - 1) / FC_S_TILE);
  u64* s_tile = fc_smem;
  unsigned* s_count = (unsigned*)(fc_smem + FC_S_TILE);  // [warp][digit]
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (threadIdx.x == 0) {
    s_tile_id = (int)atomicAdd((unsigned*)(ctl + FC_CTL_TICKETS) + launch, 1u);
  }
  for (int j = threadIdx.x; j < FC_S_WARPS * FC_RADIX; j += FC_S_THREADS) s_count[j] = 0u;
  __syncthreads();
  const int tile = s_tile_id;
  if (tile >= tiles) return;
  const i64 base = (i64)tile * FC_S_TILE;
  const int rows = (int)(n - base < FC_S_TILE ? n - base : FC_S_TILE);
  {
    // every load of the tile in flight before the first store
    u64 k[FC_S_TILE / FC_S_THREADS];
#pragma unroll
    for (int u = 0; u < FC_S_TILE / FC_S_THREADS; ++u) {
      const int j = threadIdx.x + u * FC_S_THREADS;
      if (j < rows) k[u] = in[base + j];
    }
#pragma unroll
    for (int u = 0; u < FC_S_TILE / FC_S_THREADS; ++u) {
      const int j = threadIdx.x + u * FC_S_THREADS;
      if (j < rows) s_tile[j] = k[u];
    }
  }
  __syncthreads();

  // rank: warp w takes keys [w * FC_S_PER_WARP, (w + 1) * FC_S_PER_WARP) in
  // chunks of 32, in order; rank = the digit's keys before this one in the
  // warp's segment. The first pass's sentinels take no part.
  u64 item[FC_S_CHUNKS];
  unsigned rank[FC_S_CHUNKS];
  unsigned* count = s_count + warp * FC_RADIX;
  const unsigned below = (1u << lane) - 1u;
  unsigned kept = 0u;
#pragma unroll
  for (int c = 0; c < FC_S_CHUNKS; ++c) {
    const int j = warp * FC_S_PER_WARP + c * 32 + lane;
    const u64 k = j < rows ? s_tile[j] : FC_SENTINEL;
    const bool valid = j < rows && (!first || k != FC_SENTINEL);
    const unsigned d = (unsigned)(k >> shift) & 0xffu;
    const unsigned peers = fc_peers(d, __ballot_sync(0xffffffffu, valid));
    const unsigned before = count[d];
    __syncwarp();
    if (valid && (peers & below) == 0u) count[d] = before + __popc(peers);
    __syncwarp();
    item[c] = valid ? k : FC_SENTINEL;
    rank[c] = before + __popc(peers & below);
    kept += valid ? 1u : 0u;
  }
  for (int o = 16; o > 0; o >>= 1) kept += __shfl_xor_sync(0xffffffffu, kept, o);
  if (lane == 0) s_kept[warp] = kept;
  __syncthreads();

  // the status words: two arrays [digit][stride], the launches take them
  // in turns, and each clears the other (zeroed by the memset at first)
  // for the launch after it
  unsigned* status = sort_status + (i64)(launch & 1) * FC_RADIX * stride;
  unsigned* other = sort_status + (i64)(1 - (launch & 1)) * FC_RADIX * stride;
  const int d = threadIdx.x;
  unsigned t_incl = 0u;
  unsigned g_incl = 0u;
  const unsigned* hist = (const unsigned*)(ctl + FC_CTL_HIST) + pass * FC_RADIX;
  if (d < FC_RADIX) {
    // each warp's first key of the digit, and the tile's total; publish it
    unsigned total = 0u;
    for (int w = 0; w < FC_S_WARPS; ++w) {
      const unsigned t = s_count[w * FC_RADIX + d];
      s_count[w * FC_RADIX + d] = total;
      total += t;
    }
    s_total[d] = total;
    *(volatile unsigned*)&status[(i64)d * stride + tile] = (tile == 0 ? FC_INC : 0u) |
                                                            (total + 1u);
    other[(i64)d * stride + tile] = 0u;
    s_before[d] = 0u;
    // inclusive scans over the digits, in each warp: the tile's digit
    // starts, and the pass's global digit starts from its histogram
    t_incl = fc_warp_scan(total, lane);
    g_incl = fc_warp_scan(hist[d], lane);
    if (lane == 31) {
      s_sums[0][warp] = t_incl;
      s_sums[1][warp] = g_incl;
    }
  }
  __syncthreads();
  if (d < FC_RADIX) {
    unsigned t_base = 0u;
    unsigned g_base = 0u;
    for (int w = 0; w < warp; ++w) {
      t_base += s_sums[0][w];
      g_base += s_sums[1][w];
    }
    const unsigned start = t_base + t_incl - s_total[d];
    s_start[d] = start;
    s_offset[d] = (i64)(g_base + g_incl - hist[d]) - (i64)start;
  }
  __syncthreads();
  // reorder the tile so that each digit's keys are contiguous (the first
  // pass's sentinels drop out)
#pragma unroll
  for (int c = 0; c < FC_S_CHUNKS; ++c) {
    if (item[c] == FC_SENTINEL && first) continue;
    const int j = warp * FC_S_PER_WARP + c * 32 + lane;
    if (j < rows) {
      const unsigned dd = (unsigned)(item[c] >> shift) & 0xffu;
      s_tile[s_start[dd] + s_count[warp * FC_RADIX + dd] + rank[c]] = item[c];
    }
  }
  // decoupled look-back: warp w resolves the digits from
  // FC_LOOK_BACK_DIGITS * w that the tile holds
  if (tile > 0) {
    const int d0 = warp * FC_LOOK_BACK_DIGITS;
    const unsigned held = __ballot_sync(0xffffffffu, lane < FC_LOOK_BACK_DIGITS &&
                                                         s_total[d0 + lane] != 0u);
    fc_look_back(status, stride, tile, d0, held, lane, s_total, s_before);
  }
  __syncthreads();
  unsigned valid_rows = 0u;
  for (int w = 0; w < FC_S_WARPS; ++w) valid_rows += s_kept[w];
  // write each digit's run out contiguously
  for (int j = threadIdx.x; j < (int)valid_rows; j += FC_S_THREADS) {
    const u64 k = s_tile[j];
    const unsigned dd = (unsigned)(k >> shift) & 0xffu;
    out[s_offset[dd] + s_before[dd] + j] = k;
  }
}

// ---- merge and compaction ---------------------------------------------------

// where B's sorted keys lie and how many: the second table (merge mode),
// or the buffer's real keys where the sort left them
struct FcRun {
  const u64* keys;
  const i64* counts;  // null: every key counts 1
  i64 n;
};

__device__ FcRun fc_sorted_b(const u64* raw, const i64* counts, i64 nb, const u64* keys0,
                             const u64* keys1, const u64* ctl, bool sorted) {
  FcRun b = {raw, counts, nb};
  if (!sorted) return b;
  const int moved = __popc(*(const unsigned*)(ctl + FC_CTL_RUNNING));
  b.keys = moved == 0 ? raw : ((moved - 1) & 1 ? keys1 : keys0);
  b.n = fc_real_keys(ctl);
  return b;
}

// merge path on diagonal d, by FC_SPLIT_LANES lanes of a warp (`sub` the
// lane among them, `group` which of the warp's groups): the entries of A
// among the first d of the merge (A before B among equal keys). Every lane
// of the warp must call it.
__device__ i64 fc_split(const u64* a, i64 na, const u64* b, i64 nb, i64 d, int sub, int group) {
  constexpr int L = FC_SPLIT_LANES;
  i64 lo = d - nb > 0 ? d - nb : 0;
  i64 hi = d < na ? d : na;
  // the answer lies in [lo, hi]; pred(i) = a[i] <= b[d - 1 - i] holds
  // below it and fails from it on
  for (;;) {
    const bool wide = hi - lo > L;
    if (!__any_sync(0xffffffffu, wide)) break;
    const i64 i = lo + (hi - lo) * sub / L;
    const bool pred = wide && __ldg(a + i) <= __ldg(b + (d - 1 - i));
    const unsigned votes = (__ballot_sync(0xffffffffu, pred) >> (L * group)) & ((1u << L) - 1u);
    const int c = __popc(votes);
    const i64 i_last = __shfl_sync(0xffffffffu, i, c > 0 ? c - 1 : 0, L);
    const i64 i_next = __shfl_sync(0xffffffffu, i, c < L ? c : L - 1, L);
    if (wide) {
      hi = c < L ? i_next : hi;
      lo = c > 0 ? i_last + 1 : lo;
    }
  }
  const i64 i = lo + sub;
  const bool pred = i < hi && __ldg(a + i) <= __ldg(b + (d - 1 - i));
  const unsigned votes = (__ballot_sync(0xffffffffu, pred) >> (L * group)) & ((1u << L) - 1u);
  return lo + __popc(votes);
}

// the merge-path split of every tile boundary t (diagonal t * FC_TILE, the
// last one at n), FC_SPLIT_LANES lanes each, into splits[t]
__global__ void __launch_bounds__(FC_P_THREADS)
fc_partition(const u64* __restrict__ a_keys, i64 na, const u64* b_raw, const i64* b_counts,
             i64 nb, const u64* keys0, const u64* keys1, int sorted, const u64* ctl,
             i64* __restrict__ splits) {
  const FcRun b = fc_sorted_b(b_raw, b_counts, nb, keys0, keys1, ctl, sorted != 0);
  const i64 n = na + b.n;
  const i64 t = ((i64)blockIdx.x * FC_P_THREADS + threadIdx.x) / FC_SPLIT_LANES;
  const i64 last = (n + FC_TILE - 1) / FC_TILE;  // the boundary at n
  // a warp past the last boundary returns whole; a group past it in the
  // last warp searches the last diagonal again and writes nothing
  if (__all_sync(0xffffffffu, t > last)) return;
  const i64 d = t < last ? t * FC_TILE : n;
  const int sub = threadIdx.x % FC_SPLIT_LANES;
  const i64 i = fc_split(a_keys, na, b.keys, b.n, d, sub, (threadIdx.x & 31) / FC_SPLIT_LANES);
  if (sub == 0 && t <= last) splits[t] = i;
}

// block-wide exclusive scans of three counters over FC_M_THREADS threads
// at once; tot gets the block's sums. Every thread must call it (it
// synchronises twice).
struct FcSums {
  i64 starts, real, all;
};

__device__ __forceinline__ FcSums fc_block_exclusive(FcSums v, FcSums* warp_tot, FcSums* tot) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  FcSums incl = {fc_warp_scan(v.starts, lane), fc_warp_scan(v.real, lane),
                 fc_warp_scan(v.all, lane)};
  if (lane == 31) warp_tot[warp] = incl;
  __syncthreads();
  FcSums before = {0, 0, 0}, all = {0, 0, 0};
  for (int w = 0; w < FC_M_WARPS; ++w) {
    const FcSums x = warp_tot[w];
    if (w < warp) {
      before.starts += x.starts;
      before.real += x.real;
      before.all += x.all;
    }
    all.starts += x.starts;
    all.real += x.real;
    all.all += x.all;
  }
  __syncthreads();
  *tot = all;
  const FcSums out = {before.starts + incl.starts - v.starts, before.real + incl.real - v.real,
                      before.all + incl.all - v.all};
  return out;
}

// a tile's descriptor: w0 = status (1 aggregate, 2 inclusive) | 4 when the
// tile closes the open run (it holds a run start or a sentinel) | the run
// starts << 32 (the tile's, or the inclusive prefix); w1 = the counts of
// the run open at the tile's end (the tile's part of it, or all of it).
// Published and read as one 16-byte word.
#define FC_AGG 1ull
#define FC_INCL 2ull
#define FC_CLOSES 4ull

__device__ __forceinline__ void fc_publish(u64* desc, u64 w0, u64 w1) {
#ifdef __CUDA_ARCH__
  asm volatile("st.volatile.global.v2.u64 [%0], {%1, %2};" ::"l"(desc), "l"(w0), "l"(w1)
               : "memory");
#else
  desc[0] = w0;
  desc[1] = w1;
#endif
}

__device__ __forceinline__ void fc_read(const u64* desc, u64* w0, u64* w1) {
#ifdef __CUDA_ARCH__
  asm volatile("ld.volatile.global.v2.u64 {%0, %1}, [%2];" : "=l"(*w0), "=l"(*w1) : "l"(desc));
#else
  *w0 = desc[0];
  *w1 = desc[1];
#endif
}

// look-back of warp 0 over the tiles before `tile`, 32 at a time: the run
// starts before the tile and the counts of the run open at its start
__device__ void fc_merge_look_back(const u64* desc, int tile, int lane, i64* starts, i64* carry) {
  i64 s_sum = 0, c_sum = 0;
  bool carried = false;
  for (int t = tile - 1;; t -= 32) {
    u64 w0, w1;
    for (;;) {
      if (t - lane >= 0) {
        fc_read(desc + 2 * (i64)(t - lane), &w0, &w1);
      } else {
        w0 = FC_INCL;  // before tile 0: an inclusive prefix of nothing
        w1 = 0;
      }
      const unsigned incs = __ballot_sync(0xffffffffu, (w0 & 3ull) == FC_INCL);
      const unsigned published = __ballot_sync(0xffffffffu, (w0 & 3ull) != 0ull);
      const unsigned need = incs ? ((incs & (0u - incs)) << 1) - 1u : 0xffffffffu;
      if ((published & need) == need) break;
      __nanosleep(32);
    }
    const unsigned incs = __ballot_sync(0xffffffffu, (w0 & 3ull) == FC_INCL);
    const int last = incs ? __ffs(incs) - 1 : 31;
    i64 s = lane <= last ? (i64)(w0 >> 32) : 0;
    for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    s_sum += s;
    if (!carried) {
      // the open run reaches back to the nearest tile that closes it or is
      // an inclusive prefix
      const unsigned stops =
          __ballot_sync(0xffffffffu, lane <= last && ((w0 & FC_CLOSES) || (w0 & 3ull) == FC_INCL));
      const int stop = stops ? __ffs(stops) - 1 : 31;
      i64 c = lane <= stop ? (i64)w1 : 0;
      for (int o = 16; o > 0; o >>= 1) c += __shfl_xor_sync(0xffffffffu, c, o);
      c_sum += c;
      carried = stops != 0u;
    }
    if (incs) break;
  }
  *starts = s_sum;
  *carry = c_sum;
}

// One tile of the merged sequence of A [na] and B, compacted: see the top
// of this file. b_counts null: each key of B counts 1. Tiles by ticket;
// splits from fc_partition.
__global__ void __launch_bounds__(FC_M_THREADS, 4)
fc_merge_compact(const u64* __restrict__ a_keys, const i64* __restrict__ a_counts, i64 na,
                 const u64* b_raw, const i64* b_counts, i64 nb, const u64* keys0,
                 const u64* keys1, int sorted, const i64* __restrict__ splits, i64 out_size,
                 u64* __restrict__ out_keys, i64* __restrict__ out_counts, u64* ctl) {
  extern __shared__ __align__(16) u64 fc_msmem[];
  u64* s_keys = fc_msmem;
  // the counts, at FC_PAD places as the keys; then each local run's start
  // prefix, by rank
  i64* s_cnt = (i64*)(fc_msmem + FC_TILE_PADDED);
  u64* s_first = fc_msmem + 2 * FC_TILE_PADDED;
  u64* s_last = s_first + FC_M_THREADS;
  __shared__ FcSums s_warp[FC_M_WARPS];
  __shared__ int s_tile;
  __shared__ u64 s_edge[2];     // the keys just before and just after the tile
  __shared__ int s_last_break;  // the tile's last entry that closes the open run
  __shared__ i64 s_break_prefix;
  __shared__ i64 s_before_starts, s_carry;
  const FcRun b = fc_sorted_b(b_raw, b_counts, nb, keys0, keys1, ctl, sorted != 0);
  const i64 n = na + b.n;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (threadIdx.x == 0) {
    s_tile = (int)atomicAdd((unsigned*)(ctl + FC_CTL_MERGE_TICKET), 1u);
    s_last_break = -1;
  }
  __syncthreads();
  const int tile = s_tile;
  const i64 d0 = (i64)tile * FC_TILE;
  if (d0 >= n) return;
  const i64 d1 = d0 + FC_TILE < n ? d0 + FC_TILE : n;
  const int len = (int)(d1 - d0);
  const i64 a0 = splits[tile];
  const int la = (int)(splits[tile + 1] - a0);
  const i64 b0 = d0 - a0;
  const int lb = len - la;
  if (threadIdx.x == 0) {
    // the key merged just before d0 (the larger of the two runs' last taken
    // keys) and the key merged at d1 (the smaller of their next)
    u64 k = 0;
    if (a0 > 0) k = a_keys[a0 - 1];
    if (b0 > 0 && b.keys[b0 - 1] > k) k = b.keys[b0 - 1];
    s_edge[0] = k;
    k = FC_SENTINEL;
    if (a0 + la < na) k = a_keys[a0 + la];
    if (b0 + lb < b.n && b.keys[b0 + lb] < k) k = b.keys[b0 + lb];
    s_edge[1] = k;
  }
  {
    // every load of the tile in flight before the first store
    u64 k[FC_ITEMS];
    i64 c[FC_ITEMS];
#pragma unroll
    for (int u = 0; u < FC_ITEMS; ++u) {
      const int j = threadIdx.x + u * FC_M_THREADS;
      if (j < la) {
        k[u] = a_keys[a0 + j];
        c[u] = a_counts[a0 + j];
      } else if (j < len) {
        k[u] = b.keys[b0 + j - la];
        c[u] = b.counts ? b.counts[b0 + j - la] : 1;
      }
    }
#pragma unroll
    for (int u = 0; u < FC_ITEMS; ++u) {
      const int j = threadIdx.x + u * FC_M_THREADS;
      if (j < len) {
        s_keys[FC_PAD(j)] = k[u];
        s_cnt[FC_PAD(j)] = c[u];
      }
    }
  }
  __syncthreads();

  // each thread merges FC_ITEMS entries from its own diagonal of the tile
  u64 key[FC_ITEMS];
  i64 cnt[FC_ITEMS];
  {
    const int dt = threadIdx.x * FC_ITEMS < len ? threadIdx.x * FC_ITEMS : len;
    int lo = dt - lb > 0 ? dt - lb : 0;
    int hi = dt < la ? dt : la;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (s_keys[FC_PAD(mid)] <= s_keys[FC_PAD(la + dt - 1 - mid)]) {
        lo = mid + 1;
      } else {
        hi = mid;
      }
    }
    int ai = lo, bi = dt - lo;
#pragma unroll
    for (int u = 0; u < FC_ITEMS; ++u) {
      const bool take_a =
          ai < la && (bi >= lb || s_keys[FC_PAD(ai)] <= s_keys[FC_PAD(la + bi)]);
      const bool ok = dt + u < len;
      const int at = take_a ? ai : la + bi;
      key[u] = ok ? s_keys[FC_PAD(at)] : FC_SENTINEL;
      cnt[u] = ok ? s_cnt[FC_PAD(at)] : 0;
      ai += ok && take_a ? 1 : 0;
      bi += ok && !take_a ? 1 : 0;
    }
  }
  s_first[threadIdx.x] = key[0];
  s_last[threadIdx.x] = key[FC_ITEMS - 1];
  __syncthreads();  // the merge is done: s_cnt is free

  // run starts, run ends and the counts of real keys
  const int q0 = threadIdx.x * FC_ITEMS;
  FcSums mine = {0, 0, 0};
  unsigned start_mask = 0u, end_mask = 0u;
  int last_break = -1;
#pragma unroll
  for (int u = 0; u < FC_ITEMS; ++u) {
    const int q = q0 + u;
    if (q >= len) break;
    const bool real = key[u] != FC_SENTINEL;
    const u64 prev = u > 0 ? key[u - 1] : (threadIdx.x > 0 ? s_last[threadIdx.x - 1] : s_edge[0]);
    const bool start = real && (d0 + q == 0 || prev != key[u]);
    const bool has_next = q + 1 < len || d1 < n;
    const u64 next = q + 1 < len ? (u + 1 < FC_ITEMS ? key[u + 1] : s_first[threadIdx.x + 1])
                                 : s_edge[1];
    const bool end = real && (!has_next || next != key[u]);
    mine.starts += start ? 1 : 0;
    start_mask |= start ? 1u << u : 0u;
    end_mask |= end ? 1u << u : 0u;
    if (start || !real) last_break = q;
    mine.real += real ? cnt[u] : 0;
    mine.all += cnt[u];
  }
  if (last_break >= 0) atomicMax(&s_last_break, last_break);
  FcSums tile_sums;
  const FcSums before_me = fc_block_exclusive(mine, s_warp, &tile_sums);
  // each local run's start prefix, by its local rank; and the prefix
  // before the tile's last entry that closes the open run
  {
    int r = (int)before_me.starts;
    i64 p = before_me.real;
    const int lb_q = s_last_break;
#pragma unroll
    for (int u = 0; u < FC_ITEMS; ++u) {
      const int q = q0 + u;
      if (q >= len) break;
      if ((start_mask >> u) & 1u) s_cnt[r++] = p;
      if (q == lb_q) s_break_prefix = p;
      p += key[u] != FC_SENTINEL ? cnt[u] : 0;
    }
  }
  __syncthreads();
  const bool closes = s_last_break >= 0;
  // the counts of the run open at the tile's end: the tile's part of it
  const i64 tail = closes ? tile_sums.real - s_break_prefix : tile_sums.real;
  u64* desc = ctl + FC_CTL_DESC + 2 * (i64)tile;
  const u64 flags = closes ? FC_CLOSES : 0ull;
  if (tile == 0) {
    if (threadIdx.x == 0) {
      fc_publish(desc, FC_INCL | flags | ((u64)tile_sums.starts << 32), (u64)tail);
      s_before_starts = 0;
      s_carry = 0;
    }
  } else if (warp == 0) {
    if (lane == 0) {
      fc_publish(desc, FC_AGG | flags | ((u64)tile_sums.starts << 32), (u64)tail);
    }
    i64 before, carry;
    fc_merge_look_back(ctl + FC_CTL_DESC, tile, lane, &before, &carry);
    if (lane == 0) {
      fc_publish(desc, FC_INCL | flags | ((u64)(before + tile_sums.starts) << 32),
                 (u64)(closes ? tail : carry + tail));
      s_before_starts = before;
      s_carry = carry;
    }
  }
  __syncthreads();

  // the runs that end in this tile, by local rank r (0: the run open at
  // its start; r >= 1: the r-th run started in it) into s_keys / s_cnt,
  // the sentinel where no run ends; then written out in rank order
  const i64 before = s_before_starts;
  const int local_runs = (int)tile_sums.starts + 1;
  {
    int r = (int)before_me.starts;
    i64 p = before_me.real;
#pragma unroll
    for (int u = 0; u < FC_ITEMS; ++u) {
      const int q = q0 + u;
      if (q >= len) break;
      r += (start_mask >> u) & 1u;
      p += key[u] != FC_SENTINEL ? cnt[u] : 0;
      cnt[u] = r > 0 ? p - s_cnt[r - 1] : s_carry + p;  // the count if a run ends here
    }
  }
  for (int i = threadIdx.x; i < local_runs; i += FC_M_THREADS) s_keys[i] = FC_SENTINEL;
  __syncthreads();  // every start prefix is read
  {
    int r = (int)before_me.starts;
#pragma unroll
    for (int u = 0; u < FC_ITEMS; ++u) {
      if (q0 + u >= len) break;
      r += (start_mask >> u) & 1u;
      if ((end_mask >> u) & 1u) {
        s_keys[r] = key[u];
        s_cnt[r] = cnt[u];
      }
    }
  }
  __syncthreads();
  i64 kept = 0;
  for (int i = threadIdx.x; i < local_runs; i += FC_M_THREADS) {
    const i64 rank = before + i;
    if (s_keys[i] != FC_SENTINEL && rank <= out_size) {
      out_keys[rank - 1] = s_keys[i];
      out_counts[rank - 1] = s_cnt[i];
      kept += s_cnt[i];
    }
  }
  for (int o = 16; o > 0; o >>= 1) kept += __shfl_xor_sync(0xffffffffu, kept, o);
  if (lane == 0 && kept) atomicAdd((u64*)(ctl + FC_CTL_KEPT), (u64)kept);
  if (threadIdx.x == 0) {
    if (tile_sums.all) atomicAdd((u64*)(ctl + FC_CTL_TOTAL), (u64)tile_sums.all);
    if (d1 == n) ctl[FC_CTL_UNIQUE] = (u64)(before + tile_sums.starts);
  }
}

// the slots past n_unique: the sentinel and count 0; and meta
__global__ void __launch_bounds__(FC_FILL_THREADS)
fc_fill(const u64* __restrict__ ctl, i64 out_size, u64* __restrict__ out_keys,
        i64* __restrict__ out_counts, i64* __restrict__ meta) {
  const i64 n_unique = (i64)ctl[FC_CTL_UNIQUE];
  const i64 stride = (i64)gridDim.x * FC_FILL_THREADS;
  for (i64 i = n_unique + (i64)blockIdx.x * FC_FILL_THREADS + threadIdx.x; i < out_size;
       i += stride) {
    out_keys[i] = FC_SENTINEL;
    out_counts[i] = 0;
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    const i64 kept = (i64)ctl[FC_CTL_KEPT];
    const i64 total = (i64)ctl[FC_CTL_TOTAL];
    meta[0] = n_unique;
    meta[1] = n_unique > out_size ? kept : total;
    meta[2] = total;
    meta[3] = n_unique >= out_size ? kept : 0;
  }
}

// ---- entry points -----------------------------------------------------------

static i64 fc_sort_tiles(i64 nb) { return (nb + FC_S_TILE - 1) / FC_S_TILE; }

static i64 fc_merge_tiles(i64 n) { return (n + FC_TILE - 1) / FC_TILE; }

// words of the control block that one memset zeroes
static i64 fc_control_words(i64 na, i64 nb, int sort_b) {
  i64 words = FC_CTL_DESC + 3 * fc_merge_tiles(na + nb) + 1;
  if (sort_b) words += (2 * FC_RADIX * fc_sort_tiles(nb) + 1) / 2;
  return (words + 1) / 2 * 2;
}

// 8-byte words of scratch a launch needs
extern "C" long long freq_compact_scratch_words(long long na, long long nb, int sort_b) {
  return fc_control_words(na, nb, sort_b) + (sort_b ? 2 * nb : 0);
}

// a_keys/a_counts: the first table (na entries); b_keys: the second table
// (b_counts given) or the raw buffer (b_counts null, sorted here). out_keys
// and out_counts: out_size entries; meta: int64[4]; scratch: the words of
// freq_compact_scratch_words, 16-byte aligned.
extern "C" int freq_compact_launch(const u64* a_keys, const i64* a_counts, long long na,
                                   const u64* b_keys, const i64* b_counts, long long nb,
                                   long long out_size, u64* out_keys, i64* out_counts,
                                   i64* meta, i64* scratch, void* stream) {
  if (na < 0 || nb < 0 || out_size < 1 || na + nb > 0x7fffffffLL ||
      ((uintptr_t)scratch & 15u) != 0) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = (cudaStream_t)stream;
  const int sort_b = b_counts == nullptr && nb > 0;
  const i64 ctl_words = fc_control_words(na, nb, sort_b);
  u64* ctl = (u64*)scratch;
  u64* keys0 = (u64*)scratch + ctl_words;
  u64* keys1 = keys0 + nb;
  cudaError_t err = cudaMemsetAsync(ctl, 0, (size_t)ctl_words * 8, st);
  if (err != cudaSuccess) return (int)err;
  if (sort_b) {
    const int up_blocks = dq_grid_for(nb, FC_UP_THREADS * FC_UP_UNROLL * 2, FC_UP_MAX_BLOCKS);
    fc_upsweep<<<up_blocks, FC_UP_THREADS, 0, st>>>(b_keys, nb, ctl);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    err = cudaFuncSetAttribute((const void*)fc_scatter,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, FC_S_SMEM);
    if (err != cudaSuccess) return (int)err;
    // the scatter's status words lie past the merge's descriptors and splits
    unsigned* sort_status = (unsigned*)(ctl + FC_CTL_DESC + 3 * fc_merge_tiles(na + nb) + 1);
    const int stride = (int)fc_sort_tiles(nb);
    for (int launch = 0; launch < FC_PASSES; ++launch) {
      fc_scatter<<<(unsigned)stride, FC_S_THREADS, FC_S_SMEM, st>>>(
          b_keys, nb, keys0, keys1, launch, ctl, sort_status, stride);
      if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    }
  }
  if (na + nb > 0) {
    const i64 tiles = fc_merge_tiles(na + nb);
    i64* splits = (i64*)(ctl + FC_CTL_DESC + 2 * tiles);
    const i64 lanes = (tiles + 1) * FC_SPLIT_LANES;
    fc_partition<<<(unsigned)((lanes + FC_P_THREADS - 1) / FC_P_THREADS), FC_P_THREADS, 0,
                   st>>>(a_keys, na, b_keys, b_counts, nb, keys0, keys1, sort_b, ctl, splits);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    err = cudaFuncSetAttribute((const void*)fc_merge_compact,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, FC_M_SMEM);
    if (err != cudaSuccess) return (int)err;
    fc_merge_compact<<<(unsigned)tiles, FC_M_THREADS, FC_M_SMEM, st>>>(
        a_keys, a_counts, na, b_keys, b_counts, nb, keys0, keys1, sort_b, splits, out_size,
        out_keys, out_counts, ctl);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  const int fill_blocks = dq_grid_for(out_size, FC_FILL_THREADS * 8, FC_FILL_MAX_BLOCKS);
  fc_fill<<<fill_blocks, FC_FILL_THREADS, 0, st>>>(ctl, out_size, out_keys, out_counts, meta);
  return (int)cudaGetLastError();
}
