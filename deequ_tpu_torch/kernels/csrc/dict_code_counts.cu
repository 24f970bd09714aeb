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
// counts null rows too). Both are zeroed by the wrapper.
//
// Bound on the card: bytes. Each row is 4 bytes of code and 2 bytes of mask,
// read once. Design, two paths:
//   - K <= 32768: each block counts into a uint32 histogram in shared memory
//     (up to 128 KB, opted in with cudaFuncSetAttribute above 48 KB) and
//     adds only its nonzero bins to device memory, one 64-bit atomicAdd each.
//   - larger K: one 64-bit atomicAdd per valid row on the device-memory
//     counts; with tens of thousands of codes the contention per address is
//     low, and a block's histogram would not fit shared memory.
// Integer adds are exact and commutative, so the counts are exact for any
// K <= 65536 and any order.
#include "common.cuh"

#define DCC_THREADS 256
#define DCC_SHARED_MAX_K 32768
#define DCC_ROWS_PER_BLOCK (DCC_THREADS * 16)
#define DCC_MAX_BLOCKS 1056

__device__ __forceinline__ void dcc_add_rows(unsigned long long local,
                                             unsigned long long* num_rows) {
  for (int off = 16; off > 0; off >>= 1) {
    local += __shfl_down_sync(0xffffffffu, local, off);
  }
  if ((threadIdx.x & 31) == 0 && local != 0ull) atomicAdd(num_rows, local);
}

__global__ void __launch_bounds__(DCC_THREADS)
dict_code_counts_shared(const int* __restrict__ codes,
                        const uint8_t* __restrict__ rows,
                        const uint8_t* __restrict__ present, long long n,
                        int k, unsigned long long* __restrict__ counts,
                        unsigned long long* __restrict__ num_rows) {
  extern __shared__ unsigned int hist[];
  for (int c = threadIdx.x; c < k; c += blockDim.x) hist[c] = 0u;
  __syncthreads();
  unsigned long long local_rows = 0ull;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    if (!rows[i]) continue;
    local_rows += 1ull;
    const int c = codes[i];
    if (present[i] && c >= 0 && c < k) atomicAdd(&hist[c], 1u);
  }
  dcc_add_rows(local_rows, num_rows);
  __syncthreads();
  for (int c = threadIdx.x; c < k; c += blockDim.x) {
    const unsigned int h = hist[c];
    if (h != 0u) atomicAdd(&counts[c], (unsigned long long)h);
  }
}

__global__ void __launch_bounds__(DCC_THREADS)
dict_code_counts_global(const int* __restrict__ codes,
                        const uint8_t* __restrict__ rows,
                        const uint8_t* __restrict__ present, long long n,
                        int k, unsigned long long* __restrict__ counts,
                        unsigned long long* __restrict__ num_rows) {
  unsigned long long local_rows = 0ull;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    if (!rows[i]) continue;
    local_rows += 1ull;
    const int c = codes[i];
    if (present[i] && c >= 0 && c < k) atomicAdd(&counts[c], 1ull);
  }
  dcc_add_rows(local_rows, num_rows);
}

extern "C" int dict_code_counts_shared_max_k() { return DCC_SHARED_MAX_K; }

// counts: int64[k] and num_rows: int64[1], both zeroed by the caller on the
// same stream
extern "C" int dict_code_counts_launch(const int* codes, const uint8_t* rows,
                                       const uint8_t* present, long long n,
                                       int k, unsigned long long* counts,
                                       unsigned long long* num_rows,
                                       void* stream) {
  if (n < 0 || k < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (k <= DCC_SHARED_MAX_K) {
    const size_t smem = sizeof(unsigned int) * (size_t)k;
    int max_blocks = DCC_MAX_BLOCKS;
    if (smem > 48 * 1024) {
      cudaError_t err = cudaFuncSetAttribute(
          dict_code_counts_shared, cudaFuncAttributeMaxDynamicSharedMemorySize,
          (int)smem);
      if (err != cudaSuccess) return (int)err;
      // a histogram this large leaves room for one block per SM: one wave
      int device = 0;
      int sms = 0;
      err = cudaGetDevice(&device);
      if (err != cudaSuccess) return (int)err;
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                   device);
      if (err != cudaSuccess) return (int)err;
      max_blocks = sms;
    }
    const int blocks = dq_grid_for(n, DCC_ROWS_PER_BLOCK, max_blocks);
    dict_code_counts_shared<<<blocks, DCC_THREADS, smem, st>>>(
        codes, rows, present, n, k, counts, num_rows);
  } else {
    const int blocks = dq_grid_for(n, DCC_ROWS_PER_BLOCK, DCC_MAX_BLOCKS);
    dict_code_counts_global<<<blocks, DCC_THREADS, 0, st>>>(
        codes, rows, present, n, k, counts, num_rows);
  }
  return (int)cudaGetLastError();
}
