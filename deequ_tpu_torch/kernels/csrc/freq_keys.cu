// K6 freq_keys: the 64-bit group key of every row of one batch, written
// straight into the frequency table state's key buffer.
//
// Replaces DeviceFrequencyTableScan.update (deequ_tpu/analyzers/grouping.py:
// 911) with splitmix64_jnp / xxhash64_u64_jnp (deequ_tpu/ops/hashing.py:150,
// 182) and the append of FrequencyTableState.append_keys
// (deequ_tpu/analyzers/states.py:139).
//
// Per row: valid = rows & every column's mask. Each column gives a 64-bit
// key: an integral or boolean value converted to uint64 (signed integers
// sign-extend, booleans come as float64 0/1) and mixed with SplitMix64, or a
// host xxhash64 feature taken as it is. Several columns chain with
// xxhash64, the key so far seeding the next column's hash. A valid row
// writes its key at out[i]; an invalid row writes the sentinel (all ones),
// and so does a valid row whose key IS the sentinel: that row is counted in
// counts[0] (sent_rows) instead, and the drain restores its group.
// counts[1] is the number of rows of the batch's row mask (num_rows).
//
// The table of columns is a by-value kernel parameter (as in K1), so a key
// of up to FK_MAX_COLS columns takes one launch.
//
// Bound on the card: bytes. Per row: 1 byte of row mask, per column its
// mask byte and its value (1 to 8 bytes), and 8 bytes of key written. The
// mixing is a few dozen integer operations per column.
//
// Design:
//   - A thread takes tiles of FK_TILE rows. It loads a column's tile (its
//     mask, 8 bytes, and its values, 8 to 64 bytes, as 8- and 16-byte
//     vector loads) and issues the next column's loads before it converts,
//     hashes and chains this one in registers: two columns' tiles are in
//     flight, and hashing one hides the next one's loads. The dtype switch
//     runs once a column a tile, not once a row. The kernel is
//     instantiated for each column count and capped at 64 registers, so
//     eight blocks fit an SM and one wave holds a 2^20-row batch's tiles,
//     one a thread. (All of a group's loads first, then its hashing, took
//     0.0390-0.0393 ms at five columns in groups of two or four:
//     tools/hll_freq_times.py.)
//   - The tiles start at the host's `head`: the first row at which every
//     input is aligned for its vector loads (-1 when no row is; every row
//     then takes scalar loads, as the rows before the first tile and after
//     the last do, one a thread, each load issued before any test). Keys
//     go out as 16-byte stores where out is 16-byte aligned at the tiles,
//     8-byte ones otherwise: out + offset is 8-byte aligned only.
//   - Counters: each block sums its rows' two counts with warp shuffles,
//     then adds each to a 64-bit word of the workspace that carries a
//     ticket in its low FK_TICKET_BITS bits: (count << FK_TICKET_BITS) +
//     1, one atomicAdd a word. The block whose add finds the ticket at
//     blocks - 1 is the last of that word: it writes that counter (the
//     word's count plus its own) and resets the word. The count rides in
//     the ticket itself, so no fence is needed and no last block reads
//     partials back (per-block partials summed by the last block took
//     1.2 us more at 1M rows: tools/hll_freq_phases.py). Both adds are in
//     flight before either result is read. The workspace is zeroed once by
//     the host and left so by every launch, so no memset runs.
#include "common.cuh"

#define FK_MAX_COLS 8
#define FK_THREADS 128
#define FK_TILE 8
#define FK_TICKET_BITS 13
#define FK_MAX_BLOCKS 4096

#define FK_KIND_NUM 0   // SplitMix64 of the value converted to uint64
#define FK_KIND_HASH 1  // the value is already a uint64 key (xxhash64)

#define FK_I8 0
#define FK_U8 1
#define FK_I16 2
#define FK_I32 3
#define FK_I64 4
#define FK_F64 5

#define FK_SENTINEL 0xffffffffffffffffull

#define FK_P1 11400714785074694791ull
#define FK_P2 14029467366897019727ull
#define FK_P3 1609587929392839161ull
#define FK_P4 9650029242287828579ull
#define FK_P5 2870177450012600261ull

typedef unsigned long long u64;

// one column: 8-byte words, as the host packs them
struct FkColumn {
  long long kind;   // FK_KIND_NUM or FK_KIND_HASH
  long long dtype;  // FK_I8 .. FK_F64 (FK_I64 for hash keys)
  const void* values;
  const uint8_t* mask;
};

struct FkTable {
  const uint8_t* rows;
  u64* out;            // the batch's first key (the buffer at its offset)
  u64* counts;         // (sent_rows, num_rows)
  u64* ws;             // the two ticket words: sent_rows', num_rows'
  long long n;
  long long ncols;
  long long head;      // the first tile's row, or -1: scalar loads only
  long long store16;   // out is 16-byte aligned at the tiles
  long long blocks;
  FkColumn c[FK_MAX_COLS];
};

__device__ __forceinline__ u64 fk_splitmix64(u64 v) {
  v ^= v >> 30;
  v *= 0xBF58476D1CE4E5B9ull;
  v ^= v >> 27;
  v *= 0x94D049BB133111EBull;
  return v ^ (v >> 31);
}

__device__ __forceinline__ u64 fk_rotl(u64 x, int r) { return (x << r) | (x >> (64 - r)); }

// xxHash64 of one 8-byte input with a 64-bit seed (the numpy xxhash64_u64)
__device__ __forceinline__ u64 fk_xxhash64(u64 v, u64 seed) {
  u64 h = seed + FK_P5 + 8ull;
  h ^= fk_rotl(v * FK_P2, 31) * FK_P1;
  h = fk_rotl(h, 27) * FK_P1 + FK_P4;
  h ^= h >> 33;
  h *= FK_P2;
  h ^= h >> 29;
  h *= FK_P3;
  return h ^ (h >> 32);
}

// the value's uint64 image, as the reference's astype(uint64) gives it
__device__ __forceinline__ u64 fk_value(const FkColumn& col, long long i) {
  switch (col.dtype) {
    case FK_I8: return (u64)(long long)((const int8_t*)col.values)[i];
    case FK_U8: return (u64)((const uint8_t*)col.values)[i];
    case FK_I16: return (u64)(long long)((const int16_t*)col.values)[i];
    case FK_I32: return (u64)(long long)((const int32_t*)col.values)[i];
    case FK_I64: return (u64)((const long long*)col.values)[i];
    default: return (u64)(long long)((const double*)col.values)[i];
  }
}

__device__ __forceinline__ u64 fk_mix(const FkColumn& col, u64 v) {
  return col.kind == FK_KIND_NUM ? fk_splitmix64(v) : v;
}

// one row with scalar loads, every load issued before any test; adds to
// the thread's counters
template <int NC>
__device__ __forceinline__ void fk_row(const FkTable& t, long long i, u64& sent,
                                       u64& num_rows) {
  unsigned valid = t.rows[i];
  num_rows += valid;
  u64 v[NC];
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    valid &= t.c[c].mask[i];
    v[c] = fk_value(t.c[c], i);
  }
  u64 key = FK_SENTINEL;
  if (valid) {
    u64 k = 0ull;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const u64 ck = fk_mix(t.c[c], v[c]);
      k = c == 0 ? ck : fk_xxhash64(ck, k);
    }
    if (k == FK_SENTINEL) {
      sent += 1ull;
    } else {
      key = k;
    }
  }
  t.out[i] = key;
}

// a column's FK_TILE values as loaded: up to 64 bytes
struct FkRaw {
  uint4 w[4];
};

__device__ __forceinline__ void fk_load(const FkColumn& col, long long i, FkRaw& r, uint2& m) {
  m = __ldg((const uint2*)(col.mask + i));
  switch (col.dtype) {
    case FK_I8:
    case FK_U8: {
      const uint2 x = __ldg((const uint2*)((const uint8_t*)col.values + i));
      r.w[0].x = x.x;
      r.w[0].y = x.y;
      break;
    }
    case FK_I16:
      r.w[0] = __ldg((const uint4*)((const int16_t*)col.values + i));
      break;
    case FK_I32: {
      const uint4* p = (const uint4*)((const int32_t*)col.values + i);
      r.w[0] = __ldg(p);
      r.w[1] = __ldg(p + 1);
      break;
    }
    default: {
      const uint4* p = (const uint4*)((const u64*)col.values + i);
#pragma unroll
      for (int q = 0; q < 4; ++q) r.w[q] = __ldg(p + q);
    }
  }
}

// row j's uint64 image from a column's loaded tile
__device__ __forceinline__ u64 fk_decode(const FkColumn& col, const FkRaw& r, int j) {
  const unsigned* b32 = (const unsigned*)&r.w[0];
  switch (col.dtype) {
    case FK_I8: return (u64)(long long)(int8_t)(b32[j >> 2] >> (8 * (j & 3)));
    case FK_U8: return (u64)((b32[j >> 2] >> (8 * (j & 3))) & 0xffu);
    case FK_I16: return (u64)(long long)(int16_t)(b32[j >> 1] >> (16 * (j & 1)));
    case FK_I32: return (u64)(long long)(int)b32[j];
    case FK_I64: return ((const u64*)&r.w[0])[j];
    default: return (u64)(long long)__longlong_as_double(((const long long*)&r.w[0])[j]);
  }
}

// blocks an SM holds at once (the launch bounds cap the registers to fit
// them); the host sizes a grid to one wave of them
#define FK_BLOCKS_PER_SM 8

// after a block added (count << FK_TICKET_BITS) + 1 to a ticket word and
// got back `old`: the last block of the launch writes the total to
// *counter and resets the word
__device__ __forceinline__ void fk_last(u64 old, u64 count, long long blocks, u64* word,
                                        u64* counter) {
  if ((old & ((1ull << FK_TICKET_BITS) - 1ull)) == (u64)(blocks - 1)) {
    *counter = (old >> FK_TICKET_BITS) + count;
    *word = 0ull;
  }
}

template <int NC>
__global__ void __launch_bounds__(FK_THREADS, FK_BLOCKS_PER_SM)
freq_keys_kernel(const __grid_constant__ FkTable t) {
  __shared__ u64 warp_sums[2][FK_THREADS / 32];
  // PHASE 0 rows
  u64 sent = 0ull, num_rows = 0ull;
  const long long n = t.n;
  const long long threads = t.blocks * FK_THREADS;
  const long long tid = (long long)blockIdx.x * FK_THREADS + threadIdx.x;
  const long long head = t.head < 0 ? n : (t.head < n ? t.head : n);
  const long long tiles = (n - head) / FK_TILE;
  for (long long tile = tid; tile < tiles; tile += threads) {
    const long long i = head + tile * FK_TILE;
    const uint2 rm = __ldg((const uint2*)(t.rows + i));
    num_rows += __popc(rm.x) + __popc(rm.y);  // bool bytes are 0 or 1
    uint2 valid = rm;
    u64 key[FK_TILE];
    // column c + 1's loads are issued before column c is hashed: two
    // columns' tiles in flight, and the hashing of one hides the next one's
    // loads
    FkRaw raw[2];
    uint2 m[2];
    fk_load(t.c[0], i, raw[0], m[0]);
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      if (c + 1 < NC) fk_load(t.c[c + 1], i, raw[(c + 1) & 1], m[(c + 1) & 1]);
      const FkColumn& col = t.c[c];
      valid.x &= m[c & 1].x;
      valid.y &= m[c & 1].y;
#pragma unroll
      for (int j = 0; j < FK_TILE; ++j) {
        const u64 ck = fk_mix(col, fk_decode(col, raw[c & 1], j));
        key[j] = c == 0 ? ck : fk_xxhash64(ck, key[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < FK_TILE; ++j) {
      const unsigned v = ((j < 4 ? valid.x : valid.y) >> (8 * (j & 3))) & 0xffu;
      if (!v) {
        key[j] = FK_SENTINEL;
      } else if (key[j] == FK_SENTINEL) {
        sent += 1ull;
      }
    }
    if (t.store16) {
      ulonglong2* o = (ulonglong2*)(t.out + i);
#pragma unroll
      for (int q = 0; q < FK_TILE / 2; ++q) o[q] = make_ulonglong2(key[2 * q], key[2 * q + 1]);
    } else {
#pragma unroll
      for (int j = 0; j < FK_TILE; ++j) t.out[i + j] = key[j];
    }
  }
  // the rows before the first tile and after the last, one a thread
  for (long long i = tid; i < head; i += threads) fk_row<NC>(t, i, sent, num_rows);
  for (long long i = head + tiles * FK_TILE + tid; i < n; i += threads) {
    fk_row<NC>(t, i, sent, num_rows);
  }
  // PHASE 1 sums
  for (int off = 16; off > 0; off >>= 1) {
    sent += __shfl_down_sync(0xffffffffu, sent, off);
    num_rows += __shfl_down_sync(0xffffffffu, num_rows, off);
  }
  const int warp = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) {
    warp_sums[0][warp] = sent;
    warp_sums[1][warp] = num_rows;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    u64 s = 0ull, r = 0ull;
    for (int w = 0; w < FK_THREADS / 32; ++w) {
      s += warp_sums[0][w];
      r += warp_sums[1][w];
    }
    // both adds in flight before either result is read
    const u64 a = atomicAdd(t.ws, (s << FK_TICKET_BITS) + 1ull);
    const u64 b = atomicAdd(t.ws + 1, (r << FK_TICKET_BITS) + 1ull);
    fk_last(a, s, t.blocks, t.ws, t.counts);
    fk_last(b, r, t.blocks, t.ws + 1, t.counts + 1);
  }
  // PHASE 2 end
}

extern "C" int freq_keys_max_columns() { return FK_MAX_COLS; }
extern "C" int freq_keys_max_blocks() { return FK_MAX_BLOCKS; }
extern "C" int freq_keys_threads() { return FK_THREADS; }
extern "C" int freq_keys_tile() { return FK_TILE; }
extern "C" int freq_keys_table_bytes() { return (int)sizeof(FkTable); }
extern "C" int freq_keys_blocks_per_sm() { return FK_BLOCKS_PER_SM; }

// table: the host's FkTable (copied into the launch's parameters): out is
// the n keys of the batch (the state's buffer at its fill offset), counts
// int64[2] = (sent_rows, num_rows), written by the launch; the workspace
// holds two words, both zero
extern "C" int freq_keys_launch(const FkTable* table, void* stream) {
  const FkTable t = *table;
  if (t.ncols < 1 || t.ncols > FK_MAX_COLS || t.n < 0 || t.blocks < 1 ||
      t.blocks > FK_MAX_BLOCKS || t.head >= FK_TILE || t.ws == nullptr) {
    return (int)cudaErrorInvalidValue;
  }
  const dim3 grid((unsigned)t.blocks);
  cudaStream_t st = (cudaStream_t)stream;
  switch (t.ncols) {
    case 1: freq_keys_kernel<1><<<grid, FK_THREADS, 0, st>>>(t); break;
    case 2: freq_keys_kernel<2><<<grid, FK_THREADS, 0, st>>>(t); break;
    case 3: freq_keys_kernel<3><<<grid, FK_THREADS, 0, st>>>(t); break;
    case 4: freq_keys_kernel<4><<<grid, FK_THREADS, 0, st>>>(t); break;
    case 5: freq_keys_kernel<5><<<grid, FK_THREADS, 0, st>>>(t); break;
    case 6: freq_keys_kernel<6><<<grid, FK_THREADS, 0, st>>>(t); break;
    case 7: freq_keys_kernel<7><<<grid, FK_THREADS, 0, st>>>(t); break;
    default: freq_keys_kernel<8><<<grid, FK_THREADS, 0, st>>>(t); break;
  }
  return (int)cudaGetLastError();
}
