// K8 state_fold: the left-to-right fold of N same-shape analyzer states
// with each state's merge, for every analyzer of a call, in one launch.
//
// Replaces functions of the JAX reference with one set of merge rules and
// four entry points:
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
// Two more entries of the same merge rules serve the mesh (the reference's
// B11, deequ_tpu/parallel/__init__.py):
//  - state_fold_carry_stacked_launch: sharded_ingest_fold (:171), n_dev
//    carries [n_dev, W] each folding their own local_chunk partials of a
//    chunk's [n_dev * local_chunk, W], skipping the rows whose flag is 0
//    (the padding of a last chunk). blockIdx.y is the shard; the carry
//    entry above is its n_dev = 1 case without flags, the same body.
//  - state_fold_butterfly_launch: collective_merge_states (:266) on one
//    device. The stacked states [n_dev * k, W] (shard s owns rows
//    s*k .. s*k+k-1) fold in one launch, in the reference's order: each
//    shard's local fold of its k rows, then log2(n_dev) XOR rounds of
//    acc[s] = merge(acc[s], acc[s ^ shift]) when n_dev is a power of two,
//    else the ordered fold acc[0], acc[1], .., acc[n_dev-1] that every
//    shard computes from the gathered accumulators. The moments merges are
//    not symmetric in their bits, so shard s and s ^ 1 hold different
//    accumulators after a round, and shard 0's round-2 partner is
//    merge(acc[2], acc[3]): the kernel keeps every shard's accumulator of
//    a column, double-buffered in the output and a scratch matrix, and
//    writes every shard's final row [n_dev, W]; row 0 is the result.
//
// Bound on the card: a few KiB to a few hundred KiB of states (a chunk of
// 32 partials of a battery with a dictionary column's 2^16 code counts:
// 17 MB), at most a few microseconds at 3.35 TB/s: the launch's latency
// bounds it. Design: blockIdx.x is the slot and blockIdx.z a span of
// SF_COLS_PER_BLOCK columns of it (a wide slot, such as a 50,000-code
// dictionary, spreads over several blocks); each thread of an elementwise
// slot folds its own columns, walking the states in order, and a moments
// or co-moments slot folds on thread 0 of its first block. No column is
// touched by two threads, so no block waits for another.
#include <string.h>

#include "common.cuh"

#define SF_MAX_SLOTS 256
#define SF_THREADS 128
#define SF_COLS_PER_BLOCK 1024
// shards a butterfly launch takes at most (each column's thread walks
// n_dev * log2(n_dev) merges)
#define SF_MAX_SHARDS 1024

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

// One merge kind: the type of its matrix (T), of one state's value in
// the slot (V), how a value is read from and written to a row at column
// c, and the merge. The rules are common.cuh's, each operation rounded
// on its own.
struct SfAddI64 {
  typedef long long T;
  typedef long long V;
  __device__ static V load(const T* row, int c) { return row[c]; }
  __device__ static void store(T* row, int c, V v) { row[c] = v; }
  __device__ static V merge(V a, V b) { return a + b; }
};
struct SfAddF64 {
  typedef double T;
  typedef double V;
  __device__ static V load(const T* row, int c) { return row[c]; }
  __device__ static void store(T* row, int c, V v) { row[c] = v; }
  __device__ static V merge(V a, V b) { return __dadd_rn(a, b); }
};
struct SfMin : SfAddF64 {
  __device__ static V merge(V a, V b) { return dq_min_nan_largest(a, b); }
};
struct SfMax : SfAddF64 {
  __device__ static V merge(V a, V b) { return dq_max_nan(a, b); }
};
struct SfMaxI32 {
  typedef int32_t T;
  typedef int32_t V;
  __device__ static V load(const T* row, int c) { return row[c]; }
  __device__ static void store(T* row, int c, V v) { row[c] = v; }
  __device__ static V merge(V a, V b) { return b > a ? b : a; }
};
struct SfMoments {
  typedef double T;
  typedef DqMoments V;
  __device__ static V load(const T* r, int c) {
    const V v = {r[c], r[c + 1], r[c + 2]};
    return v;
  }
  __device__ static void store(T* r, int c, V v) {
    r[c] = v.n;
    r[c + 1] = v.avg;
    r[c + 2] = v.m2;
  }
  __device__ static V merge(V a, V b) { return dq_merge_moments(a, b); }
};
struct SfComoments {
  typedef double T;
  typedef DqComoments V;
  __device__ static V load(const T* r, int c) {
    const V v = {r[c], r[c + 1], r[c + 2], r[c + 3], r[c + 4], r[c + 5]};
    return v;
  }
  __device__ static void store(T* r, int c, V v) {
    r[c] = v.n;
    r[c + 1] = v.x_avg;
    r[c + 2] = v.y_avg;
    r[c + 3] = v.ck;
    r[c + 4] = v.x_mk;
    r[c + 5] = v.y_mk;
  }
  __device__ static V merge(V a, V b) { return dq_merge_comoments(a, b); }
};

// The matrices of one launch: row 0 (f0, i0, r0), the further rows
// (f64, i64, i32, row-major) and the output (out_f, out_i, out_r).
struct SfMats {
  const double* f0;
  const long long* i0;
  const int32_t* r0;
  const double* f64;
  const long long* i64;
  const int32_t* i32;
  double* out_f;
  long long* out_i;
  int32_t* out_r;
  int wf, wi, wr;
};

// Column c of one shard: row0 folded with the n_rest rows of rest (those
// whose flag is set) into out. The carry entries pass the carry as both
// row 0 and the output: each column is read and written by one thread
// only, its own reads first, so the update in place is safe.
template <class K>
__device__ void sf_fold_column(const typename K::T* row0, const typename K::T* rest, int w,
                               long long n_rest, const unsigned char* flags, int c,
                               typename K::T* out) {
  typename K::V acc = K::load(row0, c);
  for (long long i = 0; i < n_rest; ++i) {
    if (flags != nullptr && !flags[i]) continue;
    acc = K::merge(acc, K::load(rest + i * w, c));
  }
  K::store(out, c, acc);
}

// The columns of slot `slot` that this block owns (its span, blockIdx.z),
// walked by the block's threads; the moment kinds on thread 0 of span 0.
template <class F>
__device__ void sf_for_columns(const SfSlot& slot, F f) {
  if (slot.kind == SF_MOMENTS || slot.kind == SF_COMOMENTS) {
    if (blockIdx.z == 0 && threadIdx.x == 0) f(slot.offset);
    return;
  }
  const int lo = blockIdx.z * SF_COLS_PER_BLOCK;
  const int hi = min(slot.length, lo + SF_COLS_PER_BLOCK);
  for (int j = lo + threadIdx.x; j < hi; j += blockDim.x) f(slot.offset + j);
}

// blockIdx.x: the slot; blockIdx.y: the shard (its row 0 and output at
// shard * W, its n_rest rows at shard * n_rest * W, its flags at
// shard * n_rest); blockIdx.z: the span of columns
__global__ void __launch_bounds__(SF_THREADS)
state_fold_kernel(const SfTable table, int n_slots, long long n_rest, SfMats m,
                  const unsigned char* flags) {
  const int s = blockIdx.x;
  if (s >= n_slots) return;
  const SfSlot slot = table.s[s];
  const long long sh = blockIdx.y;
  const unsigned char* fl = flags != nullptr ? flags + sh * n_rest : nullptr;
  const double* f0 = m.f0 + sh * m.wf;
  const double* f64 = m.f64 + sh * n_rest * m.wf;
  double* out_f = m.out_f + sh * m.wf;
  switch (slot.kind) {
    case SF_ADD_I64:
      sf_for_columns(slot, [&](int c) {
        sf_fold_column<SfAddI64>(m.i0 + sh * m.wi, m.i64 + sh * n_rest * m.wi, m.wi, n_rest, fl,
                                 c, m.out_i + sh * m.wi);
      });
      break;
    case SF_MAX_I32:
      sf_for_columns(slot, [&](int c) {
        sf_fold_column<SfMaxI32>(m.r0 + sh * m.wr, m.i32 + sh * n_rest * m.wr, m.wr, n_rest, fl,
                                 c, m.out_r + sh * m.wr);
      });
      break;
    case SF_ADD_F64:
      sf_for_columns(slot, [&](int c) {
        sf_fold_column<SfAddF64>(f0, f64, m.wf, n_rest, fl, c, out_f);
      });
      break;
    case SF_MIN:
      sf_for_columns(slot, [&](int c) {
        sf_fold_column<SfMin>(f0, f64, m.wf, n_rest, fl, c, out_f);
      });
      break;
    case SF_MAX:
      sf_for_columns(slot, [&](int c) {
        sf_fold_column<SfMax>(f0, f64, m.wf, n_rest, fl, c, out_f);
      });
      break;
    case SF_MOMENTS:
      sf_for_columns(slot, [&](int c) {
        sf_fold_column<SfMoments>(f0, f64, m.wf, n_rest, fl, c, out_f);
      });
      break;
    case SF_COMOMENTS:
      sf_for_columns(slot, [&](int c) {
        sf_fold_column<SfComoments>(f0, f64, m.wf, n_rest, fl, c, out_f);
      });
      break;
    default:
      break;
  }
}

// Column c of the butterfly: in [n_dev * k rows], the double buffers a
// (the output) and b (scratch), each [n_dev rows]; every row of width w.
// Ends with every shard's final value in a.
template <class K>
__device__ void sf_butterfly_column(const typename K::T* in, typename K::T* a,
                                    typename K::T* b, int w, int n_dev, int k, int c) {
  typedef typename K::V V;
  for (int s = 0; s < n_dev; ++s) {
    V acc = K::load(in + (long long)s * k * w, c);
    for (int i = 1; i < k; ++i) acc = K::merge(acc, K::load(in + ((long long)s * k + i) * w, c));
    K::store(a + (long long)s * w, c, acc);
  }
  if (n_dev < 2) return;
  typename K::T* cur = a;
  typename K::T* nxt = b;
  if ((n_dev & (n_dev - 1)) == 0) {
    for (int shift = 1; shift < n_dev; shift <<= 1) {
      for (int s = 0; s < n_dev; ++s) {
        K::store(nxt + (long long)s * w, c,
                 K::merge(K::load(cur + (long long)s * w, c),
                          K::load(cur + (long long)(s ^ shift) * w, c)));
      }
      typename K::T* t = cur;
      cur = nxt;
      nxt = t;
    }
  } else {
    // the gather route: every shard folds the gathered accumulators in
    // shard order; all of them hold the same value
    V acc = K::load(cur, c);
    for (int s = 1; s < n_dev; ++s) acc = K::merge(acc, K::load(cur + (long long)s * w, c));
    for (int s = 0; s < n_dev; ++s) K::store(nxt + (long long)s * w, c, acc);
    cur = nxt;
  }
  if (cur != a) {
    for (int s = 0; s < n_dev; ++s) K::store(a + (long long)s * w, c, K::load(cur + (long long)s * w, c));
  }
}

// blockIdx.x: the slot; blockIdx.z: the span of columns. m.f64 / i64 /
// i32 are the stacked input states [n_dev * k rows]; m.out_* the output
// [n_dev rows]; tmp_* the scratch of the same shape.
__global__ void __launch_bounds__(SF_THREADS)
state_fold_butterfly_kernel(const SfTable table, int n_slots, int n_dev, int k, SfMats m,
                            double* tmp_f, long long* tmp_i, int32_t* tmp_r) {
  const int s = blockIdx.x;
  if (s >= n_slots) return;
  const SfSlot slot = table.s[s];
  switch (slot.kind) {
    case SF_ADD_I64:
      sf_for_columns(slot, [&](int c) {
        sf_butterfly_column<SfAddI64>(m.i64, m.out_i, tmp_i, m.wi, n_dev, k, c);
      });
      break;
    case SF_MAX_I32:
      sf_for_columns(slot, [&](int c) {
        sf_butterfly_column<SfMaxI32>(m.i32, m.out_r, tmp_r, m.wr, n_dev, k, c);
      });
      break;
    case SF_ADD_F64:
      sf_for_columns(slot, [&](int c) {
        sf_butterfly_column<SfAddF64>(m.f64, m.out_f, tmp_f, m.wf, n_dev, k, c);
      });
      break;
    case SF_MIN:
      sf_for_columns(slot, [&](int c) {
        sf_butterfly_column<SfMin>(m.f64, m.out_f, tmp_f, m.wf, n_dev, k, c);
      });
      break;
    case SF_MAX:
      sf_for_columns(slot, [&](int c) {
        sf_butterfly_column<SfMax>(m.f64, m.out_f, tmp_f, m.wf, n_dev, k, c);
      });
      break;
    case SF_MOMENTS:
      sf_for_columns(slot, [&](int c) {
        sf_butterfly_column<SfMoments>(m.f64, m.out_f, tmp_f, m.wf, n_dev, k, c);
      });
      break;
    case SF_COMOMENTS:
      sf_for_columns(slot, [&](int c) {
        sf_butterfly_column<SfComoments>(m.f64, m.out_f, tmp_f, m.wf, n_dev, k, c);
      });
      break;
    default:
      break;
  }
}

extern "C" int state_fold_max_slots() { return SF_MAX_SLOTS; }
extern "C" int state_fold_max_shards() { return SF_MAX_SHARDS; }

// the table of a launch, and the spans of SF_COLS_PER_BLOCK columns its
// widest elementwise slot needs
static int sf_table(const SfSlot* slots, int n_slots, SfTable* table, int* spans) {
  if (n_slots < 1 || n_slots > SF_MAX_SLOTS) return 0;
  memset(table, 0, sizeof(*table));
  memcpy(table->s, slots, sizeof(SfSlot) * (size_t)n_slots);
  int widest = 1;
  for (int i = 0; i < n_slots; ++i) {
    if (slots[i].length > widest) widest = slots[i].length;
  }
  *spans = (widest + SF_COLS_PER_BLOCK - 1) / SF_COLS_PER_BLOCK;
  return 1;
}

static int sf_launch(const SfSlot* slots, int n_slots, int n_shards, long long n_rest,
                     const SfMats& m, const unsigned char* flags, void* stream) {
  SfTable table;
  int spans = 1;
  if (!sf_table(slots, n_slots, &table, &spans) || n_rest < 0 || n_shards < 1 ||
      n_shards > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  state_fold_kernel<<<dim3(n_slots, n_shards, spans), SF_THREADS, 0, (cudaStream_t)stream>>>(
      table, n_slots, n_rest, m, flags);
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
  const SfMats m = {f64, i64, i32, f64 ? f64 + wf : nullptr, i64 ? i64 + wi : nullptr,
                    i32 ? i32 + wr : nullptr, out_f, out_i, out_r, wf, wi, wr};
  return sf_launch(slots, n_slots, 1, n_states - 1, m, nullptr, stream);
}

// carry_f, carry_i, carry_r: n_shards packed rows of each dtype
// [n_shards * w], shard s folded with its n_parts partial rows of part_f
// [n_shards * n_parts * wf], part_i and part_r in order (those whose flag
// in flags [n_shards * n_parts] is set; every row when flags is null), the
// result written back into its carry row
extern "C" int state_fold_carry_stacked_launch(const SfSlot* slots, int n_slots, int n_shards,
                                               long long n_parts, double* carry_f, int wf,
                                               long long* carry_i, int wi, int32_t* carry_r,
                                               int wr, const double* part_f,
                                               const long long* part_i,
                                               const int32_t* part_r,
                                               const unsigned char* flags, void* stream) {
  if (n_parts < 1) return (int)cudaErrorInvalidValue;
  const SfMats m = {carry_f, carry_i, carry_r, part_f, part_i, part_r,
                    carry_f, carry_i, carry_r, wf, wi, wr};
  return sf_launch(slots, n_slots, n_shards, n_parts, m, flags, stream);
}

// the carry entry: state_fold_carry_stacked_launch with one shard and no
// flags
extern "C" int state_fold_carry_launch(const SfSlot* slots, int n_slots, long long n_parts,
                                       double* carry_f, int wf, long long* carry_i, int wi,
                                       int32_t* carry_r, int wr, const double* part_f,
                                       const long long* part_i, const int32_t* part_r,
                                       void* stream) {
  return state_fold_carry_stacked_launch(slots, n_slots, 1, n_parts, carry_f, wf, carry_i, wi,
                                         carry_r, wr, part_f, part_i, part_r, nullptr, stream);
}

// f64, i64, i32: the stacked states [n_dev * k * w]; out_*: every shard's
// final row [n_dev * w]; tmp_*: scratch of the output's size
extern "C" int state_fold_butterfly_launch(const SfSlot* slots, int n_slots, int n_dev, int k,
                                           const double* f64, int wf, const long long* i64,
                                           int wi, const int32_t* i32, int wr, double* out_f,
                                           long long* out_i, int32_t* out_r, double* tmp_f,
                                           long long* tmp_i, int32_t* tmp_r, void* stream) {
  SfTable table;
  int spans = 1;
  if (!sf_table(slots, n_slots, &table, &spans) || n_dev < 1 || n_dev > SF_MAX_SHARDS ||
      k < 1) {
    return (int)cudaErrorInvalidValue;
  }
  const SfMats m = {nullptr, nullptr, nullptr, f64, i64, i32, out_f, out_i, out_r, wf, wi, wr};
  state_fold_butterfly_kernel<<<dim3(n_slots, 1, spans), SF_THREADS, 0, (cudaStream_t)stream>>>(
      table, n_slots, n_dev, k, m, tmp_f, tmp_i, tmp_r);
  return (int)cudaGetLastError();
}
