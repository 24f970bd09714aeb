// K2 hll_registers: the HLL++ register maximum of one batch.
//
// Replaces ApproxCountDistinct.update (deequ_tpu/analyzers/sketches.py:277),
// which folds the batch through chunked_key_fold (deequ_tpu/ops/__init__.py:9):
// a chunked one-hot compare/max over the 512 registers.
//
// Input: one packed uint16 key per row, (register index << 6) | rank, as the
// host feature builder writes it (deequ_tpu_torch/ops/hll.py
// hll_pack_features), plus the row, where-filter and presence masks.
// Output: int32[512] registers, which the wrapper zeroes before the launch;
// a register no valid row reaches stays 0, the identity of the max.
//
// Bound on the card: bytes. Each row is 2 bytes of key and 2 to 3 bytes of
// mask, read once; the work per row is one shared-memory atomicMax. Design:
// each block keeps its own int[512] in shared memory, so the contended
// atomics stay on the SM; at the end a block sends only its nonzero
// registers to device memory with one atomicMax each. Max is commutative
// and exact, so the result is bit-identical whatever the order.
//
// Sessions (the stacked entry, replacing the HLL update inside the JAX
// reference's coalesced fold, PackedScanProgram.call_with_slots_stacked,
// deequ_tpu/runners/engine.py:501): keys and masks are [W, n] row-major,
// the output int32[W, 512], and blockIdx.y is the session, whose rows start
// at w * n and whose registers at w * 512. W = 1 is the one-batch launch.
#include "common.cuh"

#define HLL_REGISTERS 512
#define HLL_THREADS 256
#define HLL_ROWS_PER_BLOCK (HLL_THREADS * 8)
#define HLL_MAX_BLOCKS 1056

__global__ void __launch_bounds__(HLL_THREADS)
hll_registers_kernel(const uint16_t* __restrict__ keys,
                     const uint8_t* __restrict__ rows,
                     const uint8_t* __restrict__ where,
                     const uint8_t* __restrict__ present, long long n,
                     int* __restrict__ out) {
  __shared__ int regs[HLL_REGISTERS];
  const long long off = (long long)blockIdx.y * n;  // the session's rows
  keys += off;
  rows += off;
  present += off;
  if (where != nullptr) where += off;
  out += (long long)blockIdx.y * HLL_REGISTERS;
  for (int r = threadIdx.x; r < HLL_REGISTERS; r += blockDim.x) regs[r] = 0;
  __syncthreads();
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    if (!rows[i] || !present[i] || (where != nullptr && !where[i])) continue;
    const unsigned int k = keys[i];
    const int rank = (int)(k & 63u);
    if (rank != 0) atomicMax(&regs[k >> 6], rank);
  }
  __syncthreads();
  for (int r = threadIdx.x; r < HLL_REGISTERS; r += blockDim.x) {
    if (regs[r] != 0) atomicMax(&out[r], regs[r]);
  }
}

// W sessions of n rows each; out: int32[W, 512], zeroed by the caller on
// the same stream. A session gets at most HLL_MAX_BLOCKS / W blocks (at
// least one), so a launch stays near HLL_MAX_BLOCKS blocks in all.
extern "C" int hll_registers_stacked_launch(const uint16_t* keys, const uint8_t* rows,
                                            const uint8_t* where,
                                            const uint8_t* present, long long n,
                                            int width, int* out, void* stream) {
  if (n < 0 || width < 1 || width > 65535) return (int)cudaErrorInvalidValue;
  const int per_session = HLL_MAX_BLOCKS / width > 1 ? HLL_MAX_BLOCKS / width : 1;
  const int blocks = dq_grid_for(n, HLL_ROWS_PER_BLOCK, per_session);
  hll_registers_kernel<<<dim3(blocks, width), HLL_THREADS, 0, (cudaStream_t)stream>>>(
      keys, rows, where, present, n, out);
  return (int)cudaGetLastError();
}
