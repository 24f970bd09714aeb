// K8 state_fold: the left-to-right fold of N same-shape analyzer states
// with each state's merge, for every analyzer of a call, in one launch.
//
// Replaces two functions of the JAX reference with one kernel and two
// entry points:
//  - state_fold_launch: merge_states_batched (deequ_tpu/analyzers/base.py:
//    273), a lax.scan of analyzer.merge over N stacked states, for the
//    refresh of persisted states;
//  - state_fold_carry_launch: the host ingest tier's fold of a chunk of
//    host partials into the device-resident states (_ingest_program and
//    make_flagged_ingest_body, deequ_tpu/runners/engine.py:1760,1787: a
//    lax.scan of ingest_partial, which is merge for every analyzer but the
//    KLL sketches). The carry (one packed row per dtype) is row 0 of the
//    fold and receives its result in place; the chunk's B <= 32 partials
//    are rows 1..B. The reference pads its last chunk with identity
//    partials masked by flags to keep one compiled shape; here the last
//    chunk simply holds fewer rows, which is the same fold.
//
// Inputs: the states packed per dtype into row-major matrices, one row a
// state: float64 [., Wf], int64 [., Wi] and int32 [., Wr]; and a by-value
// table of slots, each naming a merge kind and the columns it owns:
//   SF_ADD_I64   `length` int64 columns, added (the counts of NumMatches,
//                NumMatchesAndCount, Mean, Sum, Minimum and Maximum;
//                DataType's five class counts; a dictionary column's code
//                counts, up to 2^16 of them, and its row count)
//   SF_ADD_F64   `length` float64 columns, added (Mean's and Sum's totals)
//   SF_MIN       `length` float64 columns, min in the NaN-largest order
//   SF_MAX       `length` float64 columns, max with NaN propagation
//   SF_MAX_I32   `length` int32 columns, max (HLL registers)
//   SF_MOMENTS   three float64 columns (n, avg, m2), Chan's rule
//   SF_COMOMENTS six float64 columns (n, x_avg, y_avg, ck, x_mk, y_mk)
// Every column belongs to exactly one slot; the kernel writes the folded
// row of every column: out_f [Wf], out_i [Wi], out_r [Wr].
//
// Order: the fold starts from state 0 and merges states 1..N-1 into it in
// order, as the reference's scan does; the rules are common.cuh's, each
// operation rounded on its own, so the result equals the sequential fold
// of the port's PyTorch merges bit for bit.
//
// Bound on the card: a few KiB to a few hundred KiB of states (a chunk of
// 32 partials of a battery with a dictionary column's 2^16 code counts:
// 17 MB), at most a few microseconds at 3.35 TB/s: the launch's latency
// bounds it. Design: one
// block per slot (no cross-block reduction); each thread of an elementwise
// slot folds its own columns, walking the N states in order, and a
// moments or co-moments slot folds on its block's thread 0.
#include <string.h>

#include "common.cuh"

#define SF_MAX_SLOTS 256
#define SF_THREADS 128

#define SF_ADD_I64 0
#define SF_ADD_F64 1
#define SF_MIN 2
#define SF_MAX 3
#define SF_MOMENTS 4
#define SF_COMOMENTS 5
#define SF_MAX_I32 6

// mirrors deequ_tpu_torch/kernels/state_fold.py _SlotStruct
struct SfSlot {
  int32_t kind;
  int32_t offset;  // first column in its dtype's matrix
  int32_t length;  // columns of an elementwise slot (1 for the moment kinds)
};

struct SfTable {
  SfSlot s[SF_MAX_SLOTS];
};

// The fold of row 0 (f0, i0, r0) and n_rest further rows (f64, i64, i32,
// row-major) into out_f, out_i, out_r. The carry entry passes the carry as
// both row 0 and the output: each column is read and written by one thread
// only, its own reads first, so the update in place is safe.
__global__ void __launch_bounds__(SF_THREADS)
state_fold_kernel(const SfTable table, int n_slots, long long n_rest,
                  const double* f0, const long long* i0, const int32_t* r0,
                  const double* __restrict__ f64, int wf,
                  const long long* __restrict__ i64, int wi,
                  const int32_t* __restrict__ i32, int wr,
                  double* out_f, long long* out_i, int32_t* out_r) {
  const int s = blockIdx.x;
  if (s >= n_slots) return;
  const SfSlot slot = table.s[s];
  const int c = slot.offset;
  // elementwise kinds: each thread folds its own columns of the slot
  if (slot.kind == SF_MAX_I32) {
    for (int j = threadIdx.x; j < slot.length; j += blockDim.x) {
      int32_t acc = r0[c + j];
      for (long long i = 0; i < n_rest; ++i) {
        const int32_t v = i32[i * wr + c + j];
        acc = v > acc ? v : acc;
      }
      out_r[c + j] = acc;
    }
    return;
  }
  if (slot.kind == SF_ADD_I64) {
    for (int j = threadIdx.x; j < slot.length; j += blockDim.x) {
      long long acc = i0[c + j];
      for (long long i = 0; i < n_rest; ++i) acc += i64[i * wi + c + j];
      out_i[c + j] = acc;
    }
    return;
  }
  if (slot.kind == SF_ADD_F64 || slot.kind == SF_MIN || slot.kind == SF_MAX) {
    for (int j = threadIdx.x; j < slot.length; j += blockDim.x) {
      double acc = f0[c + j];
      for (long long i = 0; i < n_rest; ++i) {
        const double v = f64[i * wf + c + j];
        acc = slot.kind == SF_ADD_F64 ? __dadd_rn(acc, v)
              : slot.kind == SF_MIN   ? dq_min_nan_largest(acc, v)
                                      : dq_max_nan(acc, v);
      }
      out_f[c + j] = acc;
    }
    return;
  }
  if (threadIdx.x != 0) return;
  switch (slot.kind) {
    case SF_MOMENTS: {
      DqMoments acc = {f0[c], f0[c + 1], f0[c + 2]};
      for (long long i = 0; i < n_rest; ++i) {
        const double* r = f64 + i * wf + c;
        const DqMoments b = {r[0], r[1], r[2]};
        acc = dq_merge_moments(acc, b);
      }
      out_f[c] = acc.n;
      out_f[c + 1] = acc.avg;
      out_f[c + 2] = acc.m2;
      break;
    }
    case SF_COMOMENTS: {
      DqComoments acc = {f0[c], f0[c + 1], f0[c + 2], f0[c + 3], f0[c + 4], f0[c + 5]};
      for (long long i = 0; i < n_rest; ++i) {
        const double* r = f64 + i * wf + c;
        const DqComoments b = {r[0], r[1], r[2], r[3], r[4], r[5]};
        acc = dq_merge_comoments(acc, b);
      }
      out_f[c] = acc.n;
      out_f[c + 1] = acc.x_avg;
      out_f[c + 2] = acc.y_avg;
      out_f[c + 3] = acc.ck;
      out_f[c + 4] = acc.x_mk;
      out_f[c + 5] = acc.y_mk;
      break;
    }
    default:
      break;
  }
}

extern "C" int state_fold_max_slots() { return SF_MAX_SLOTS; }

static int sf_launch(const SfSlot* slots, int n_slots, long long n_rest, const double* f0,
                     const long long* i0, const int32_t* r0, const double* f64, int wf,
                     const long long* i64, int wi, const int32_t* i32, int wr,
                     double* out_f, long long* out_i, int32_t* out_r, void* stream) {
  if (n_slots < 1 || n_slots > SF_MAX_SLOTS || n_rest < 0) {
    return (int)cudaErrorInvalidValue;
  }
  SfTable table;
  memset(&table, 0, sizeof(table));
  memcpy(table.s, slots, sizeof(SfSlot) * (size_t)n_slots);
  state_fold_kernel<<<n_slots, SF_THREADS, 0, (cudaStream_t)stream>>>(
      table, n_slots, n_rest, f0, i0, r0, f64, wf, i64, wi, i32, wr, out_f, out_i, out_r);
  return (int)cudaGetLastError();
}

// f64: float64[n_states * wf], i64: int64[n_states * wi], i32:
// int32[n_states * wr] (a null pointer where the width is 0); out_f,
// out_i, out_r: one row of each
extern "C" int state_fold_launch(const SfSlot* slots, int n_slots, long long n_states,
                                 const double* f64, int wf, const long long* i64, int wi,
                                 const int32_t* i32, int wr, double* out_f,
                                 long long* out_i, int32_t* out_r, void* stream) {
  if (n_states < 1) return (int)cudaErrorInvalidValue;
  return sf_launch(slots, n_slots, n_states - 1, f64, i64, i32, f64 ? f64 + wf : nullptr, wf,
                   i64 ? i64 + wi : nullptr, wi, i32 ? i32 + wr : nullptr, wr, out_f, out_i,
                   out_r, stream);
}

// carry_f, carry_i, carry_r: one packed row of each dtype, folded with the
// n_parts partial rows part_f [n_parts * wf], part_i [n_parts * wi] and
// part_r [n_parts * wr] in order, the result written back into the carry
extern "C" int state_fold_carry_launch(const SfSlot* slots, int n_slots, long long n_parts,
                                       double* carry_f, int wf, long long* carry_i, int wi,
                                       int32_t* carry_r, int wr, const double* part_f,
                                       const long long* part_i, const int32_t* part_r,
                                       void* stream) {
  if (n_parts < 1) return (int)cudaErrorInvalidValue;
  return sf_launch(slots, n_slots, n_parts, carry_f, carry_i, carry_r, part_f, wf, part_i, wi,
                   part_r, wr, carry_f, carry_i, carry_r, stream);
}
