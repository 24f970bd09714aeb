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
// counts[1] is the number of valid rows of the batch (num_rows).
//
// The table of columns is a by-value kernel parameter (as in K1), so a key
// of up to FK_MAX_COLS columns takes one launch.
//
// Bound on the card: bytes. Per row: 1 byte of row mask, per column its
// mask byte and its value (1 to 8 bytes), and 8 bytes of key written. The
// mixing is a few dozen integer operations per column. One thread per row,
// grid-stride; each block sums its two counters with warp shuffles and adds
// them with one 64-bit atomic each.
#include "common.cuh"

#define FK_MAX_COLS 8
#define FK_THREADS 256
#define FK_ROWS_PER_BLOCK (FK_THREADS * 8)
#define FK_MAX_BLOCKS 2112

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

struct FkColumn {
  int32_t kind;           // FK_KIND_NUM or FK_KIND_HASH
  int32_t dtype;          // FK_I8 .. FK_F64 (FK_I64 for hash keys)
  const void* values;
  const uint8_t* mask;
};

struct FkTable {
  FkColumn c[FK_MAX_COLS];
  int32_t ncols;
};

__device__ __forceinline__ unsigned long long fk_splitmix64(unsigned long long v) {
  v ^= v >> 30;
  v *= 0xBF58476D1CE4E5B9ull;
  v ^= v >> 27;
  v *= 0x94D049BB133111EBull;
  return v ^ (v >> 31);
}

__device__ __forceinline__ unsigned long long fk_rotl(unsigned long long x, int r) {
  return (x << r) | (x >> (64 - r));
}

// xxHash64 of one 8-byte input with a 64-bit seed (the numpy xxhash64_u64)
__device__ __forceinline__ unsigned long long fk_xxhash64(unsigned long long v,
                                                          unsigned long long seed) {
  unsigned long long h = seed + FK_P5 + 8ull;
  h ^= fk_rotl(v * FK_P2, 31) * FK_P1;
  h = fk_rotl(h, 27) * FK_P1 + FK_P4;
  h ^= h >> 33;
  h *= FK_P2;
  h ^= h >> 29;
  h *= FK_P3;
  return h ^ (h >> 32);
}

// the value's uint64 image, as the reference's astype(uint64) gives it
__device__ __forceinline__ unsigned long long fk_value(const FkColumn& col, long long i) {
  switch (col.dtype) {
    case FK_I8: return (unsigned long long)(long long)((const int8_t*)col.values)[i];
    case FK_U8: return (unsigned long long)((const uint8_t*)col.values)[i];
    case FK_I16: return (unsigned long long)(long long)((const int16_t*)col.values)[i];
    case FK_I32: return (unsigned long long)(long long)((const int32_t*)col.values)[i];
    case FK_I64: return (unsigned long long)((const long long*)col.values)[i];
    default: return (unsigned long long)(long long)((const double*)col.values)[i];
  }
}

__global__ void __launch_bounds__(FK_THREADS)
freq_keys_kernel(const FkTable table, const uint8_t* __restrict__ rows, long long n,
                 unsigned long long* __restrict__ out,
                 unsigned long long* __restrict__ counts) {
  __shared__ unsigned long long warp_sums[2][FK_THREADS / 32];
  unsigned long long sent = 0ull;
  unsigned long long num_rows = 0ull;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    bool valid = rows[i] != 0;
    num_rows += valid ? 1ull : 0ull;
    for (int c = 0; c < table.ncols && valid; ++c) valid = table.c[c].mask[i] != 0;
    unsigned long long key = FK_SENTINEL;
    if (valid) {
      unsigned long long k = 0ull;
      for (int c = 0; c < table.ncols; ++c) {
        const FkColumn& col = table.c[c];
        const unsigned long long ck = col.kind == FK_KIND_NUM
            ? fk_splitmix64(fk_value(col, i))
            : ((const unsigned long long*)col.values)[i];
        k = c == 0 ? ck : fk_xxhash64(ck, k);
      }
      if (k == FK_SENTINEL) {
        sent += 1ull;
      } else {
        key = k;
      }
    }
    out[i] = key;
  }
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
    unsigned long long s = 0ull, r = 0ull;
    for (int w = 0; w < FK_THREADS / 32; ++w) {
      s += warp_sums[0][w];
      r += warp_sums[1][w];
    }
    if (s) atomicAdd(&counts[0], s);
    if (r) atomicAdd(&counts[1], r);
  }
}

extern "C" int freq_keys_max_columns() { return FK_MAX_COLS; }

// out: the n keys of the batch (the state's buffer at its fill offset);
// counts: int64[2] = (sent_rows, num_rows), zeroed here on the stream
extern "C" int freq_keys_launch(const FkColumn* cols, int ncols, const uint8_t* rows,
                                long long n, unsigned long long* out,
                                unsigned long long* counts, void* stream) {
  if (ncols < 1 || ncols > FK_MAX_COLS || n < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  FkTable table;
  for (int c = 0; c < FK_MAX_COLS; ++c) {
    table.c[c] = c < ncols ? cols[c] : FkColumn{FK_KIND_HASH, FK_I64, nullptr, nullptr};
  }
  table.ncols = ncols;
  cudaError_t err = cudaMemsetAsync(counts, 0, 2 * sizeof(unsigned long long), st);
  if (err != cudaSuccess) return (int)err;
  if (n > 0) {
    const int blocks = dq_grid_for(n, FK_ROWS_PER_BLOCK, FK_MAX_BLOCKS);
    freq_keys_kernel<<<blocks, FK_THREADS, 0, st>>>(table, rows, n, out, counts);
  }
  return (int)cudaGetLastError();
}
