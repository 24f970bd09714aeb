// K3 dict_code_counts: exact count per dictionary code of one batch.
//
// Replaces DeviceFrequencyScan.update (deequ_tpu/analyzers/grouping.py:660),
// which counts with a chunked one-hot sum for K <= 4096 codes and with a
// sort plus boundary differences above.
//
// Input: int32 codes (nulls and padding carry the sentinel K), the row mask
// and the column's presence mask. Rows that are masked out, and codes
// outside [0, K), are dropped. Output: int64 counts[K] and int64 num_rows,
// the count of ALL valid rows (grouping semantics: the reference's numRows
// counts null rows too). The launch zeroes both on its stream first.
//
// Bound on the card: bytes. Each row is 4 bytes of code and 2 bytes of mask,
// read once; K counts are written once. A dictionary column is skewed (a
// Zipf(1.3) column puts a quarter of its rows on one code), so the design
// keeps every per-row increment off device memory and off any one address:
//   - A thread loads 4 rows a step (an int4 of codes and one 32-bit word of
//     each mask, all issued before any is tested) and tests them with
//     predicates.
//   - Warp aggregation: __match_any_sync groups the lanes that hold the
//     same code, and the group's first lane adds the group's size. A hot
//     code costs one add per warp instruction, not one per lane. A step in
//     which no two neighbouring lanes agree (a widely spread dictionary)
//     skips the grouping, which would find nothing to merge.
//   - Path "shared" (K bins of uint32 fit one block's opt-in shared memory,
//     cudaDevAttrMaxSharedMemoryPerBlockOptin: 58,096 bins on an H100):
//     one 1,024-thread block an SM counts its rows into its own histogram,
//     then adds each nonzero bin to device memory once.
//   - Path "cluster" (above that, up to 65,536 codes): a cluster of two
//     blocks on neighbouring SMs splits the bins, each block holding half
//     in its shared memory; an increment goes to the block that owns its
//     bin through distributed shared memory (the cluster's map_shared_rank),
//     and each block flushes its half.
//   - Path "global" (larger dictionaries): the warp-aggregated adds go to
//     the device-memory counts directly.
// Integer adds are exact and commutative, so the counts are exact for any
// K and any order.
#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

#define DCC_THREADS 1024
#define DCC_WARPS (DCC_THREADS / 32)
#define DCC_CLUSTER 2
// the cluster path's largest dictionary
#define DCC_CLUSTER_MAX_K 65536
// rows a thread takes a step
#define DCC_VEC 4
// a block's share of rows before another block is worth its histogram
#define DCC_ROWS_PER_BLOCK 8192

#define DCC_PATH_SHARED 0
#define DCC_PATH_CLUSTER 1
#define DCC_PATH_GLOBAL 2

// the increments of each path
struct DccSharedAdd {
  unsigned* hist;
  __device__ __forceinline__ void operator()(int c, unsigned m) const { atomicAdd(hist + c, m); }
};

struct DccClusterAdd {
  unsigned* half_of[DCC_CLUSTER];  // each block's bins, through the cluster
  int half;
  __device__ __forceinline__ void operator()(int c, unsigned m) const {
    const int r = c / half;
    atomicAdd(half_of[r] + (c - r * half), m);
  }
};

struct DccGlobalAdd {
  unsigned long long* counts;
  __device__ __forceinline__ void operator()(int c, unsigned m) const {
    atomicAdd(counts + c, (unsigned long long)m);
  }
};

// One warp step's increments: key is the lane's code, or -1 for none.
// Where two neighbouring lanes hold one code (a hot code: most steps of a
// skewed column), __match_any_sync groups the lanes by code and each
// group's first lane adds the group's size; a step with no such pair (a
// widely spread dictionary) skips the grouping and each lane adds 1.
template <class Add>
__device__ __forceinline__ void dcc_add_grouped(int key, int lane, const Add& add) {
  const int left = __shfl_up_sync(0xffffffffu, key, 1);
  if (__any_sync(0xffffffffu, lane > 0 && key >= 0 && key == left)) {
    const unsigned group = __match_any_sync(0xffffffffu, key);
    if (key >= 0 && lane == __ffs(group) - 1) add(key, (unsigned)__popc(group));
  } else if (key >= 0) {
    add(key, 1u);
  }
}

// The row loop, shared by the three paths: every warp walks its steps in
// lockstep (match_any needs the whole warp), each lane V rows a step;
// add(code, count) takes one increment per group of lanes with one code.
// Returns the lane's count of valid rows.
template <int V, class Add>
__device__ __forceinline__ unsigned dcc_rows(const int* __restrict__ codes,
                                             const uint8_t* __restrict__ rows,
                                             const uint8_t* __restrict__ present, long long n,
                                             int k, long long warp, long long warps,
                                             const Add& add) {
  const int lane = threadIdx.x & 31;
  const long long steps = n / V;  // whole steps; the tail below
  unsigned local = 0;
  // two steps a lane in flight: both steps' loads are issued before the
  // first is tested
  for (long long base = warp * 32; base < steps; base += 2 * warps * 32) {
    int c[2][4];
    uint32_t r[2], p[2];
    bool in[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const long long q = base + h * warps * 32 + lane;
      in[h] = q < steps;
      c[h][0] = c[h][1] = c[h][2] = c[h][3] = -1;
      r[h] = p[h] = 0u;
      if (in[h]) {
        if constexpr (V == 4) {
          const int4 cq = reinterpret_cast<const int4*>(codes)[q];
          c[h][0] = cq.x;
          c[h][1] = cq.y;
          c[h][2] = cq.z;
          c[h][3] = cq.w;
          r[h] = reinterpret_cast<const uint32_t*>(rows)[q];
          p[h] = reinterpret_cast<const uint32_t*>(present)[q];
        } else {
          c[h][0] = codes[q];
          r[h] = rows[q];
          p[h] = present[q];
        }
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const bool row = in[h] && ((r[h] >> (8 * j)) & 0xffu);
        const int code = c[h][j];
        const bool valid = row && ((p[h] >> (8 * j)) & 0xffu) && code >= 0 && code < k;
        local += row;
        dcc_add_grouped(valid ? code : -1, lane, add);
      }
    }
  }
  // the rows after the last whole step: one lane each of the first warp
  const long long tail = steps * V;
  if (warp == 0 && tail < n) {
    const long long i = tail + lane;
    const bool row = i < n && rows[i];
    const int code = i < n ? codes[i] : -1;
    const bool valid = row && present[i] && code >= 0 && code < k;
    local += row;
    dcc_add_grouped(valid ? code : -1, lane, add);
  }
  return local;
}

// the block's valid rows into num_rows: one device-memory add a block
__device__ __forceinline__ void dcc_add_rows(unsigned local, unsigned* block_rows,
                                             unsigned long long* num_rows) {
  local = __reduce_add_sync(0xffffffffu, local);
  if ((threadIdx.x & 31) == 0 && local != 0u) atomicAdd(block_rows, local);
  __syncthreads();
  if (threadIdx.x == 0 && *block_rows != 0u) atomicAdd(num_rows, (unsigned long long)*block_rows);
}

// zero `bins` uint32 (a multiple of 4) of shared memory
__device__ __forceinline__ void dcc_zero(unsigned* hist, int bins) {
  uint4* h4 = reinterpret_cast<uint4*>(hist);
  for (int i = threadIdx.x; i < bins / 4; i += blockDim.x) h4[i] = make_uint4(0u, 0u, 0u, 0u);
}

// this block's slice of the `words` output words, zeroed
__device__ __forceinline__ void dcc_zero_slice(unsigned long long* out, long long words) {
  const long long per = (words + gridDim.x - 1) / gridDim.x;
  const long long first = (long long)blockIdx.x * per;
  const long long last = first + per < words ? first + per : words;
  for (long long i = first + threadIdx.x; i < last; i += blockDim.x) out[i] = 0ull;
}

// add each nonzero bin of hist[0, bins) to counts[first + bin], bins < k - first
__device__ __forceinline__ void dcc_flush(const unsigned* hist, int bins, int first, int k,
                                          unsigned long long* counts) {
  const uint4* h4 = reinterpret_cast<const uint4*>(hist);
  for (int i = threadIdx.x; i < bins / 4; i += blockDim.x) {
    const uint4 h = h4[i];
    const unsigned v[4] = {h.x, h.y, h.z, h.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = first + 4 * i + j;
      if (v[j] != 0u && c < k) atomicAdd(&counts[c], (unsigned long long)v[j]);
    }
  }
}

// A cooperative launch (every block resident): each block zeroes its slice
// of the output while it counts, and a grid barrier orders the zeroing
// before any block adds into the output.
template <int V>
__global__ void __launch_bounds__(DCC_THREADS)
dict_code_counts_shared(const int* __restrict__ codes, const uint8_t* __restrict__ rows,
                        const uint8_t* __restrict__ present, long long n, int k,
                        unsigned long long* __restrict__ counts,
                        unsigned long long* __restrict__ num_rows) {
  extern __shared__ __align__(16) unsigned dcc_hist[];
  __shared__ unsigned block_rows;
  const int bins = (k + 3) & ~3;
  // PHASE start
  dcc_zero(dcc_hist, bins);
  dcc_zero_slice(counts, (long long)k + 1);
  if (threadIdx.x == 0) block_rows = 0u;
  __syncthreads();
  // PHASE zeroed
  const unsigned local = dcc_rows<V>(
      codes, rows, present, n, k, (long long)blockIdx.x * DCC_WARPS + (threadIdx.x >> 5),
      (long long)gridDim.x * DCC_WARPS, DccSharedAdd{dcc_hist});
  cg::this_grid().sync();  // every slice of the output is zero
  dcc_add_rows(local, &block_rows, num_rows);
  // PHASE rows
  dcc_flush(dcc_hist, bins, 0, k, counts);
  // PHASE flushed
}

template <int V>
__global__ void __cluster_dims__(DCC_CLUSTER, 1, 1) __launch_bounds__(DCC_THREADS)
dict_code_counts_cluster(const int* __restrict__ codes, const uint8_t* __restrict__ rows,
                         const uint8_t* __restrict__ present, long long n, int k, int half,
                         unsigned long long* __restrict__ counts,
                         unsigned long long* __restrict__ num_rows) {
  extern __shared__ __align__(16) unsigned dcc_hist[];
  __shared__ unsigned block_rows;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  // PHASE start
  dcc_zero(dcc_hist, half);
  if (threadIdx.x == 0) block_rows = 0u;
  cluster.sync();  // both halves zeroed before either takes an increment
  // PHASE zeroed
  DccClusterAdd add;
  for (int r = 0; r < DCC_CLUSTER; ++r) add.half_of[r] = cluster.map_shared_rank(dcc_hist, r);
  add.half = half;
  const unsigned local = dcc_rows<V>(
      codes, rows, present, n, k, (long long)blockIdx.x * DCC_WARPS + (threadIdx.x >> 5),
      (long long)gridDim.x * DCC_WARPS, add);
  dcc_add_rows(local, &block_rows, num_rows);
  cluster.sync();  // every increment is in before the halves are read
  // PHASE rows
  dcc_flush(dcc_hist, half, rank * half, k, counts);
  // PHASE flushed
}

// cooperative, as the shared path: the output zeroed, then the rows
template <int V>
__global__ void __launch_bounds__(DCC_THREADS)
dict_code_counts_global(const int* __restrict__ codes, const uint8_t* __restrict__ rows,
                        const uint8_t* __restrict__ present, long long n, int k,
                        unsigned long long* __restrict__ counts,
                        unsigned long long* __restrict__ num_rows) {
  __shared__ unsigned block_rows;
  dcc_zero_slice(counts, (long long)k + 1);
  if (threadIdx.x == 0) block_rows = 0u;
  cg::this_grid().sync();
  const unsigned local = dcc_rows<V>(
      codes, rows, present, n, k, (long long)blockIdx.x * DCC_WARPS + (threadIdx.x >> 5),
      (long long)gridDim.x * DCC_WARPS, DccGlobalAdd{counts});
  dcc_add_rows(local, &block_rows, num_rows);
}

static int dcc_device_attr(cudaDeviceAttr attr, int* value) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(value, attr, device);
  return (int)err;
}

// the shared memory one block may opt in to on the current device, bytes
extern "C" int dict_code_counts_shared_limit(int* bytes) {
  return dcc_device_attr(cudaDevAttrMaxSharedMemoryPerBlockOptin, bytes);
}

extern "C" int dict_code_counts_cluster_max_k() { return DCC_CLUSTER_MAX_K; }

extern "C" int dict_code_counts_cluster_size() { return DCC_CLUSTER; }

template <class Kernel>
static int dcc_opt_in(Kernel kernel, int smem) {
  if (smem <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
}

// the blocks of a cooperative launch: at most `cap`, and no more than the
// card holds at once
template <class Kernel>
static int dcc_resident(Kernel kernel, int smem, int sms, long long want, long long cap,
                        int* blocks) {
  int per_sm = 0;
  const cudaError_t err =
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, DCC_THREADS, smem);
  if (err != cudaSuccess) return (int)err;
  long long b = want < cap ? want : cap;
  if (b > (long long)per_sm * sms) b = (long long)per_sm * sms;
  *blocks = (int)(b < 1 ? 1 : b);
  return 0;
}

template <int V>
static int dcc_launch(const int* codes, const uint8_t* rows, const uint8_t* present, long long n,
                      int k, int path, unsigned long long* counts, unsigned long long* num_rows,
                      cudaStream_t st) {
  int sms = 0;
  int err = dcc_device_attr(cudaDevAttrMultiProcessorCount, &sms);
  if (err != 0) return err;
  long long want = (n + DCC_ROWS_PER_BLOCK - 1) / DCC_ROWS_PER_BLOCK;
  if (want < 1) want = 1;
  void* args[] = {&codes, &rows, &present, &n, &k, &counts, &num_rows};
  int blocks = 0;
  if (path == DCC_PATH_SHARED) {
    const int smem = 4 * ((k + 3) & ~3);
    err = dcc_opt_in(dict_code_counts_shared<V>, smem);
    if (err == 0) err = dcc_resident(dict_code_counts_shared<V>, smem, sms, want, sms, &blocks);
    if (err != 0) return err;
    return (int)cudaLaunchCooperativeKernel((const void*)dict_code_counts_shared<V>,
                                            dim3(blocks), dim3(DCC_THREADS), args, smem, st);
  }
  if (path == DCC_PATH_GLOBAL) {
    err = dcc_resident(dict_code_counts_global<V>, 0, sms, want, 2LL * sms, &blocks);
    if (err != 0) return err;
    return (int)cudaLaunchCooperativeKernel((const void*)dict_code_counts_global<V>,
                                            dim3(blocks), dim3(DCC_THREADS), args, 0, st);
  }
  // the cluster path zeroes the output before it starts
  cudaError_t e = cudaMemsetAsync(counts, 0, sizeof(unsigned long long) * ((size_t)k + 1), st);
  if (e != cudaSuccess) return (int)e;
  const int half = ((k + DCC_CLUSTER - 1) / DCC_CLUSTER + 3) & ~3;
  const int smem = 4 * half;
  err = dcc_opt_in(dict_code_counts_cluster<V>, smem);
  if (err != 0) return err;
  long long clusters = (want + DCC_CLUSTER - 1) / DCC_CLUSTER;
  if (clusters > sms / DCC_CLUSTER) clusters = sms / DCC_CLUSTER;
  if (clusters < 1) clusters = 1;
  dict_code_counts_cluster<V><<<(int)clusters * DCC_CLUSTER, DCC_THREADS, smem, st>>>(
      codes, rows, present, n, k, half, counts, num_rows);
  return (int)cudaGetLastError();
}

// counts: int64[k + 1]: the k counts, then num_rows; the launch zeroes
// them. path: DCC_PATH_* as the wrapper planned it from the shared limit.
extern "C" int dict_code_counts_launch(const int* codes, const uint8_t* rows,
                                       const uint8_t* present, long long n, int k, int path,
                                       unsigned long long* counts, void* stream) {
  if (n < 0 || k < 0 || path < DCC_PATH_SHARED || path > DCC_PATH_GLOBAL) {
    return (int)cudaErrorInvalidValue;
  }
  if (path == DCC_PATH_CLUSTER && k > DCC_CLUSTER_MAX_K) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  unsigned long long* num_rows = counts + k;
  const bool aligned = (reinterpret_cast<uintptr_t>(codes) & 15) == 0 &&
                       (reinterpret_cast<uintptr_t>(rows) & 3) == 0 &&
                       (reinterpret_cast<uintptr_t>(present) & 3) == 0;
  return aligned ? dcc_launch<DCC_VEC>(codes, rows, present, n, k, path, counts, num_rows, st)
                 : dcc_launch<1>(codes, rows, present, n, k, path, counts, num_rows, st);
}
