// K2 hll_registers: the HLL++ register maximum of one batch, for every HLL
// column of a battery in one launch, with the previous registers folded in.
//
// Replaces ApproxCountDistinct.update (deequ_tpu/analyzers/sketches.py:277),
// which folds the batch through chunked_key_fold (deequ_tpu/ops/__init__.py:9):
// a chunked one-hot compare/max over the 512 registers, inside the jitted
// fused update that holds every HLL update of a battery
// (deequ_tpu/runners/engine.py:366).
//
// Input: one packed uint16 key per row, (register index << 6) | rank, as the
// host feature builder writes it (deequ_tpu_torch/ops/hll.py
// hll_pack_features), plus the row, where-filter and presence masks. A
// launch takes a table of parts: each part is one column (its keys, masks
// and previous registers) and writes int32[512] registers, max(prev, the
// batch's), or the batch's alone where prev is null. A register no valid row
// reaches keeps prev (0 without one), the identity of the max.
//
// Sessions (the stacked entry, replacing the HLL update inside the JAX
// reference's coalesced fold, PackedScanProgram.call_with_slots_stacked,
// deequ_tpu/runners/engine.py:501): every array is [W, n] row-major and
// session w's rows start at w * n, its registers at out + w * 512.
//
// Bound on the card: bytes. Each row is 2 bytes of key and 2 to 3 bytes of
// mask, read once; the work per row is one shared-memory max.
//
// Design:
//   - blockIdx.y is the (part, session) group, blockIdx.x one of the
//     group's blocks; the host sizes the grid from the rows (about one tile
//     a thread, at most eight blocks an SM in all: one wave).
//   - A thread loads a tile of 16 rows: two 16-byte loads of keys and one of
//     each mask, all issued before any test; it ANDs the masks in registers
//     and takes the max of each valid row's rank into the block's shared
//     registers (an atomicMax only where the rank is above the register).
//     (Two tiles a thread, their loads all in flight at once, was slower:
//     half the blocks at 1M rows, and the registers of two tiles halve the
//     blocks an SM holds.)
//     The tiles start where every array of the part is 16-byte aligned:
//     the host gives the element phase of the arrays at row 0 (-1 when the
//     arrays disagree, and then every row takes scalar loads); the rows
//     before the first tile and after the last are read one by one.
//   - A group of one block writes max(prev, its registers) itself. A group
//     of several flushes each nonzero register with one device atomicMax
//     (no return, so no wait) into one of HLL_SPREAD accumulator rows,
//     block b into row b % HLL_SPREAD, which spreads the same-address
//     atomics over as many L2 lines; the last of its blocks (a ticket
//     counter) reads the rows and resets them to 0 with one atomicExch a
//     register a row, writes max(prev, their max) and resets the ticket:
//     the workspace (int32 accumulators then uint32 tickets, zeroed once by
//     the host) is all zeros again when the launch ends. (A flush that
//     stores each block's registers for the last block to sweep was slower
//     at 1M rows: tools/hll_freq_phases.py --flush-variant.)
// Max is commutative and exact, so every output is bit for bit the plain
// version's whatever the order.
#include "common.cuh"

#define HLL_REGISTERS 512
#define HLL_THREADS 256
#define HLL_TILE 16
#define HLL_SPREAD 8
#define HLL_MAX_PARTS 32

// one column of a launch: 8-byte words, as the host packs them
struct HllPart {
  const uint16_t* keys;
  const uint8_t* where;    // null: no filter
  const uint8_t* present;
  const int* prev;         // null: the batch's registers alone
  int* out;
  long long phase;         // element phase of the arrays at row 0, or -1
};

struct HllTable {
  const uint8_t* rows;
  long long n;          // rows of a session
  long long parts;
  long long sessions;
  long long blocks;     // blocks of a (part, session) group
  int* ws;              // accumulators [parts * sessions][HLL_SPREAD][512],
                        // then one ticket a group
  HllPart p[HLL_MAX_PARTS];
};

__device__ __forceinline__ void hll_take(int* regs, unsigned k) {
  const int rank = (int)(k & 63u);
  const unsigned r = k >> 6;
  // keys above 2^15 - 1 name no register; the host never packs one
  if (rank != 0 && r < HLL_REGISTERS && rank > regs[r]) atomicMax(&regs[r], rank);
}

// one row, scalar loads, all issued before the test
__device__ __forceinline__ void hll_row(int* regs, const uint16_t* keys, const uint8_t* rows,
                                        const uint8_t* where, const uint8_t* present,
                                        long long i) {
  const unsigned k = keys[i];
  const unsigned v = (unsigned)rows[i] & (unsigned)present[i] &
                     (where != nullptr ? (unsigned)where[i] : 1u);
  if (v) hll_take(regs, k);
}

__global__ void __launch_bounds__(HLL_THREADS)
hll_registers_kernel(const __grid_constant__ HllTable t) {
  __shared__ int regs[HLL_REGISTERS];
  __shared__ bool last;
  // PHASE 0 zero
  const int g = blockIdx.y;
  const HllPart& part = t.p[g / t.sessions];
  const long long w = g % t.sessions;
  const long long n = t.n;
  const long long off = w * n;
  const uint16_t* keys = part.keys + off;
  const uint8_t* rows = t.rows + off;
  const uint8_t* present = part.present + off;
  const uint8_t* where = part.where != nullptr ? part.where + off : nullptr;
  int* out = part.out + w * HLL_REGISTERS;
  const int* prev = part.prev != nullptr ? part.prev + w * HLL_REGISTERS : nullptr;
  for (int r = threadIdx.x; r < HLL_REGISTERS; r += HLL_THREADS) regs[r] = 0;
  __syncthreads();
  // PHASE 1 rows
  long long head = n, tiles = 0;
  if (part.phase >= 0) {
    head = (HLL_TILE - (int)((part.phase + off) & (HLL_TILE - 1))) & (HLL_TILE - 1);
    if (head > n) head = n;
    tiles = (n - head) / HLL_TILE;
  }
  const long long body_end = head + tiles * HLL_TILE;
  const long long threads = t.blocks * HLL_THREADS;
  const long long tid = (long long)blockIdx.x * HLL_THREADS + threadIdx.x;
  for (long long tile = tid; tile < tiles; tile += threads) {
    const long long i = head + tile * HLL_TILE;
    const uint4 k0 = __ldg((const uint4*)(keys + i));
    const uint4 k1 = __ldg((const uint4*)(keys + i) + 1);
    const uint4 m = __ldg((const uint4*)(rows + i));
    const uint4 p = __ldg((const uint4*)(present + i));
    const uint4 f = where != nullptr ? __ldg((const uint4*)(where + i)) : m;
    const unsigned kw[8] = {k0.x, k0.y, k0.z, k0.w, k1.x, k1.y, k1.z, k1.w};
    const unsigned mw[4] = {m.x & p.x & f.x, m.y & p.y & f.y, m.z & p.z & f.z, m.w & p.w & f.w};
#pragma unroll
    for (int j = 0; j < HLL_TILE; ++j) {
      if ((mw[j >> 2] >> (8 * (j & 3))) & 0xffu) {
        hll_take(regs, (kw[j >> 1] >> (16 * (j & 1))) & 0xffffu);
      }
    }
  }
  // the rows before the first tile and after the last (all rows of a part
  // whose arrays cannot share tiles), one a thread
  for (long long i = tid; i < head; i += threads) hll_row(regs, keys, rows, where, present, i);
  for (long long i = body_end + tid; i < n; i += threads) {
    hll_row(regs, keys, rows, where, present, i);
  }
  __syncthreads();
  // PHASE 2 flush
  if (t.blocks == 1) {
    for (int r = threadIdx.x; r < HLL_REGISTERS; r += HLL_THREADS) {
      const int b = regs[r];
      out[r] = prev != nullptr ? max(prev[r], b) : b;
    }
    // PHASE 3 last
    // PHASE 4 end
    return;
  }
  int* acc = t.ws + (long long)g * HLL_SPREAD * HLL_REGISTERS;
  unsigned* ticket = (unsigned*)t.ws + t.parts * t.sessions * HLL_SPREAD * HLL_REGISTERS + g;
  int* mine = acc + (blockIdx.x % HLL_SPREAD) * HLL_REGISTERS;
  for (int r = threadIdx.x; r < HLL_REGISTERS; r += HLL_THREADS) {
    const int b = regs[r];
    if (b != 0) atomicMax(mine + r, b);
  }
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(ticket, 1u) == (unsigned)(t.blocks - 1);
  __syncthreads();
  // PHASE 3 last
  if (!last) return;
  __threadfence();
  for (int r = threadIdx.x; r < HLL_REGISTERS; r += HLL_THREADS) {
    int b = 0;
#pragma unroll
    for (int s = 0; s < HLL_SPREAD; ++s) b = max(b, atomicExch(acc + s * HLL_REGISTERS + r, 0));
    out[r] = prev != nullptr ? max(prev[r], b) : b;
  }
  if (threadIdx.x == 0) *ticket = 0u;
  // PHASE 4 end
}

extern "C" int hll_registers_max_parts() { return HLL_MAX_PARTS; }
extern "C" int hll_registers_table_bytes() { return (int)sizeof(HllTable); }
extern "C" int hll_registers_threads() { return HLL_THREADS; }
extern "C" int hll_registers_tile() { return HLL_TILE; }
extern "C" int hll_registers_spread() { return HLL_SPREAD; }

// table: the host's HllTable (copied into the launch's parameters); with
// more than one block a group, the workspace must hold parts * sessions *
// (HLL_SPREAD * 512 + 1) words, all zero (it may be null otherwise)
extern "C" int hll_registers_launch(const HllTable* table, void* stream) {
  const HllTable t = *table;
  if (t.n < 0 || t.parts < 1 || t.parts > HLL_MAX_PARTS || t.sessions < 1 || t.blocks < 1 ||
      t.parts * t.sessions > 65535 || t.blocks > 0x7fffffffLL ||
      (t.blocks > 1 && t.ws == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  hll_registers_kernel<<<dim3((unsigned)t.blocks, (unsigned)(t.parts * t.sessions)),
                         HLL_THREADS, 0, (cudaStream_t)stream>>>(t);
  return (int)cudaGetLastError();
}
