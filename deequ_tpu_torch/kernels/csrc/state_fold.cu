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
//  - state_fold_carry_stacked_launch: sharded_ingest_fold (deequ_tpu/
//    parallel/__init__.py:171), n_dev carries [n_dev, W] each folding their
//    own local_chunk partials of a chunk's [n_dev * local_chunk, W],
//    skipping the rows whose flag is 0 (the padding of a last chunk); the
//    carry entry is its n_dev = 1 case without flags, the same body.
//  - state_fold_butterfly_launch: collective_merge_states (:266) on one
//    device. The stacked states [n_dev * k, W] (shard s owns rows
//    s*k .. s*k+k-1) fold in one launch, in the reference's order: each
//    shard's local fold of its k rows, then log2(n_dev) XOR rounds of
//    acc[s] = merge(acc[s], acc[s ^ shift]) when n_dev is a power of two,
//    else the ordered fold acc[0], acc[1], .., acc[n_dev-1] that every
//    shard computes from the gathered accumulators. The moments merges are
//    not symmetric in their bits, so shard s and s ^ 1 hold different
//    accumulators after a round: every shard's final row [n_dev, W] is
//    written; row 0 is the result.
//
// Inputs: the states packed per dtype into row-major matrices, one row a
// state: float64 [., Wf], int64 [., Wi] and int32 [., Wr]; and a work list
// in device memory, built once per slot layout by the wrapper
// (state_fold.py FoldPlan): items of one merge kind over a span of columns
//   SF_ADD_I64   int64 columns, added (the counts of NumMatches,
//                NumMatchesAndCount, Mean, Sum, Minimum and Maximum;
//                DataType's five class counts; a dictionary column's code
//                counts, up to 2^16 of them, and its row count)
//   SF_ADD_F64   float64 columns, added (Mean's and Sum's totals)
//   SF_MIN       float64 columns, min in the NaN-largest order
//   SF_MAX       float64 columns, max with NaN propagation
//   SF_MAX_I32   int32 columns, max (HLL registers)
//   SF_MOMENTS   one group of three float64 columns (n, avg, m2), Chan's rule
//   SF_COMOMENTS one group of six float64 columns (n, x_avg, y_avg, ck,
//                x_mk, y_mk)
// Every column belongs to exactly one item.
//
// Types: the float matrix is float64 and the count matrix int64, or float32
// and int32 in the reference's 32-bit accumulator mode (DEEQU_TPU_NO_X64);
// the merge kinds keep their names (SF_ADD_I64 adds the count matrix,
// SF_ADD_F64 the float one). Every kernel is a template on the two types,
// and each entry has a _f32 twin taking float32 / int32 / int32 matrices.
//
// Order: the fold starts from state 0 and merges states 1..N-1 into it in
// order, as the reference's scan does; the rules are common.cuh's, each
// operation rounded on its own, so the result equals the sequential fold
// of the port's PyTorch merges bit for bit.
//
// Bound on the card: a few KiB to a few MB of states (a chunk of 32
// partials of a battery with a dictionary column's 50,000 code counts:
// 14 MB), a few microseconds at 3.35 TB/s; state rows are small, so every
// entry is bound by latency. Design:
//  - One block a work item (and, in the fold, a shard: blockIdx.y). An
//    elementwise item spans at most SF_SPAN columns, so a wide dictionary
//    slot alone fills every SM; small slots are one small item each, and no
//    block of the grid is idle.
//  - The fold: each thread owns one column of its item and loads its rows
//    in batches of SF_BATCH before merging them, so the loads of a batch
//    are in flight together. A moments or co-moments group is one chain of
//    N merges (fp64 divisions): the whole block stages the group's rows
//    into shared memory, coalesced, SF_STAGE rows at a time, and thread 0
//    folds them from there. The flags of a stacked carry are staged beside
//    them. The carry entries read and write each column on one thread, its
//    reads first, so the update in place is safe.
//  - The butterfly: a block owns a span of columns (or one group) for all
//    n_dev shards: thread p holds the accumulator of shard p / cols,
//    column p % cols. It folds the shard's k rows in registers, then runs
//    every XOR round through one buffer of n_dev accumulators in shared
//    memory (write, sync, merge with the partner, sync), in the
//    reference's argument order, and writes each shard's final row once.
//    The wrapper sizes the span so that n_dev * cols <= SF_THREADS *
//    SF_PAIRS. The gather route folds the buffer in shard order on the
//    thread of shard 0 and every shard writes the result.
// What stays: a moments or co-moments group folds on one thread, a chain
// of N - 1 merges of two or three correctly rounded fp64 divisions each
// (about 0.3 us a co-moments merge on the H100); the fold's order and the
// reference's rounding fix that chain (tools/state_fold_phases.py times
// every block).
#include "common.cuh"

#define SF_THREADS 256
// columns of an elementwise item in the fold; rows a thread loads before
// it merges them; rows of a group staged at a time
#define SF_SPAN 256
#define SF_BATCH 8
#define SF_STAGE 256
// shards a butterfly launch takes at most, and accumulators a thread holds
#define SF_MAX_SHARDS 1024
#define SF_PAIRS 4

#define SF_ADD_I64 0
#define SF_ADD_F64 1
#define SF_MIN 2
#define SF_MAX 3
#define SF_MOMENTS 4
#define SF_COMOMENTS 5
#define SF_MAX_I32 6

// mirrors deequ_tpu_torch/kernels/state_fold.py _ITEM_FIELDS
struct SfItem {
  int32_t kind;
  int32_t offset;  // first column in its dtype's matrix
  int32_t cols;    // columns of an elementwise item; 1 (a group) for the moment kinds
};

// One merge kind: the type of its matrix (T), of one state's value in
// the item (V), its float64 columns per group when staged (G; 0 for the
// elementwise kinds), how a value is read from and written to a row at
// column c, and the merge. The rules are common.cuh's, each operation
// rounded on its own.
template <class I>
struct SfAddI {
  typedef I T;
  typedef I V;
  enum { G = 0 };
  __device__ static V load(const T* row, int c) { return row[c]; }
  __device__ static void store(T* row, int c, V v) { row[c] = v; }
  __device__ static V merge(V a, V b) { return a + b; }
};
template <class F>
struct SfAddF {
  typedef F T;
  typedef F V;
  enum { G = 0 };
  __device__ static V load(const T* row, int c) { return row[c]; }
  __device__ static void store(T* row, int c, V v) { row[c] = v; }
  __device__ static V merge(V a, V b) { return dq_add(a, b); }
};
template <class F>
struct SfMin : SfAddF<F> {
  __device__ static F merge(F a, F b) { return dq_min_nan_largest(a, b); }
};
template <class F>
struct SfMax : SfAddF<F> {
  __device__ static F merge(F a, F b) { return dq_max_nan(a, b); }
};
struct SfMaxI32 {
  typedef int32_t T;
  typedef int32_t V;
  enum { G = 0 };
  __device__ static V load(const T* row, int c) { return row[c]; }
  __device__ static void store(T* row, int c, V v) { row[c] = v; }
  __device__ static V merge(V a, V b) { return b > a ? b : a; }
};
template <class F>
struct SfMoments {
  typedef F T;
  typedef DqMomentsT<F> V;
  enum { G = 3 };
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
template <class F>
struct SfComoments {
  typedef F T;
  typedef DqComomentsT<F> V;
  enum { G = 6 };
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
// (f64, i64, i32, row-major; F and I the float and count types) and the
// output (out_f, out_i, out_r).
template <class F, class I>
struct SfMats {
  const F* f0;
  const I* i0;
  const int32_t* r0;
  const F* f64;
  const I* i64;
  const int32_t* i32;
  F* out_f;
  I* out_i;
  int32_t* out_r;
  int wf, wi, wr;
};

// The staging area of the fold: a chunk of a group's rows and the chunk's
// flags
template <class F>
struct SfStage {
  F vals[SF_STAGE * 6];
  unsigned char flags[SF_STAGE];
};

// one shard's fold of item (c0, cols) of kind K: row0 folded with the
// n_rest rows of rest (those whose flag is set, every row when flags is
// null) into out. Every thread of the block must call it.
template <class K, class S>
__device__ void sf_fold_item(const typename K::T* row0, const typename K::T* rest, int w,
                             long long n_rest, const unsigned char* flags, int c0, int cols,
                             typename K::T* out, S& st) {
  typedef typename K::V V;
  constexpr bool group = K::G > 0;
  const bool mine = group ? threadIdx.x == 0 : threadIdx.x < cols;
  const int c = c0 + (group ? 0 : threadIdx.x);
  V acc;
  if (mine) acc = K::load(row0, c);
  for (long long r0 = 0; r0 < n_rest; r0 += SF_STAGE) {
    const int rows = (int)(n_rest - r0 < SF_STAGE ? n_rest - r0 : SF_STAGE);
    if (group || flags != nullptr) {
      __syncthreads();  // the chunk before is folded
      if (flags != nullptr) {
        for (int j = threadIdx.x; j < rows; j += SF_THREADS) st.flags[j] = flags[r0 + j];
      }
      if constexpr (group) {
        for (int e = threadIdx.x; e < rows * K::G; e += SF_THREADS) {
          const int r = e / K::G;
          st.vals[e] = rest[(r0 + r) * w + c + e - r * K::G];
        }
      }
      __syncthreads();
    }
    if (!mine) continue;
    if constexpr (group) {
      for (int r = 0; r < rows; ++r) {
        if (flags == nullptr || st.flags[r]) acc = K::merge(acc, K::load(st.vals + r * K::G, 0));
      }
    } else {
      for (int i0 = 0; i0 < rows; i0 += SF_BATCH) {
        V v[SF_BATCH];
#pragma unroll
        for (int u = 0; u < SF_BATCH; ++u) {
          v[u] = i0 + u < rows ? K::load(rest + (r0 + i0 + u) * w, c) : acc;
        }
#pragma unroll
        for (int u = 0; u < SF_BATCH; ++u) {
          if (i0 + u < rows && (flags == nullptr || st.flags[i0 + u])) acc = K::merge(acc, v[u]);
        }
      }
    }
  }
  if (mine) K::store(out, c, acc);
}

// blockIdx.x: the work item; blockIdx.y: the shard (its row 0 and output
// at shard * W, its n_rest rows at shard * n_rest * W, its flags at
// shard * n_rest)
template <class F, class I>
__global__ void __launch_bounds__(SF_THREADS)
state_fold_kernel(const SfItem* __restrict__ items, long long n_rest, SfMats<F, I> m,
                  const unsigned char* flags) {
  __shared__ SfStage<F> st;
  const SfItem it = items[blockIdx.x];
  const long long sh = blockIdx.y;
  const unsigned char* fl = flags != nullptr ? flags + sh * n_rest : nullptr;
  const F* f0 = m.f0 + sh * m.wf;
  const F* f64 = m.f64 + sh * n_rest * m.wf;
  F* out_f = m.out_f + sh * m.wf;
  switch (it.kind) {
    case SF_ADD_I64:
      sf_fold_item<SfAddI<I>>(m.i0 + sh * m.wi, m.i64 + sh * n_rest * m.wi, m.wi, n_rest, fl,
                              it.offset, it.cols, m.out_i + sh * m.wi, st);
      break;
    case SF_MAX_I32:
      sf_fold_item<SfMaxI32>(m.r0 + sh * m.wr, m.i32 + sh * n_rest * m.wr, m.wr, n_rest, fl,
                             it.offset, it.cols, m.out_r + sh * m.wr, st);
      break;
    case SF_ADD_F64:
      sf_fold_item<SfAddF<F>>(f0, f64, m.wf, n_rest, fl, it.offset, it.cols, out_f, st);
      break;
    case SF_MIN:
      sf_fold_item<SfMin<F>>(f0, f64, m.wf, n_rest, fl, it.offset, it.cols, out_f, st);
      break;
    case SF_MAX:
      sf_fold_item<SfMax<F>>(f0, f64, m.wf, n_rest, fl, it.offset, it.cols, out_f, st);
      break;
    case SF_MOMENTS:
      sf_fold_item<SfMoments<F>>(f0, f64, m.wf, n_rest, fl, it.offset, 1, out_f, st);
      break;
    case SF_COMOMENTS:
      sf_fold_item<SfComoments<F>>(f0, f64, m.wf, n_rest, fl, it.offset, 1, out_f, st);
      break;
    default:
      break;
  }
}

// The butterfly of item (c0, cols) of kind K: in [n_dev * k rows], out
// [n_dev rows], every row of width w; buf: n_dev * cols accumulators in
// shared memory. Every thread of the block must call it.
template <class K>
__device__ void sf_butterfly_item(const typename K::T* in, typename K::T* out, int w, int n_dev,
                                  int k, int c0, int cols, typename K::V* buf) {
  typedef typename K::V V;
  // a group's batch is short: its values are 3 or 6 floats each
  constexpr int NB = K::G > 0 ? 2 : SF_BATCH;
  const int pairs = n_dev * cols;
  V acc[SF_PAIRS];
#pragma unroll
  for (int j = 0; j < SF_PAIRS; ++j) {
    const int p = threadIdx.x + j * SF_THREADS;
    if (p >= pairs) continue;
    const int c = c0 + p % cols;
    const typename K::T* rows = in + (long long)(p / cols) * k * w;
    acc[j] = K::load(rows, c);
    for (int i0 = 1; i0 < k; i0 += NB) {
      V v[NB];
#pragma unroll
      for (int u = 0; u < NB; ++u) {
        v[u] = i0 + u < k ? K::load(rows + (long long)(i0 + u) * w, c) : acc[j];
      }
#pragma unroll
      for (int u = 0; u < NB; ++u) {
        if (i0 + u < k) acc[j] = K::merge(acc[j], v[u]);
      }
    }
  }
  if (n_dev > 1 && (n_dev & (n_dev - 1)) == 0) {
    for (int shift = 1; shift < n_dev; shift <<= 1) {
#pragma unroll
      for (int j = 0; j < SF_PAIRS; ++j) {
        const int p = threadIdx.x + j * SF_THREADS;
        if (p < pairs) buf[p] = acc[j];
      }
      __syncthreads();
#pragma unroll
      for (int j = 0; j < SF_PAIRS; ++j) {
        const int p = threadIdx.x + j * SF_THREADS;
        if (p < pairs) acc[j] = K::merge(acc[j], buf[((p / cols) ^ shift) * cols + p % cols]);
      }
      __syncthreads();
    }
  } else if (n_dev > 1) {
    // the gather route: shard 0's thread of each column folds the gathered
    // accumulators in shard order; every shard takes the result
#pragma unroll
    for (int j = 0; j < SF_PAIRS; ++j) {
      const int p = threadIdx.x + j * SF_THREADS;
      if (p < pairs) buf[p] = acc[j];
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < SF_PAIRS; ++j) {
      const int p = threadIdx.x + j * SF_THREADS;
      if (p < cols) {
        V a = buf[p];
        for (int s = 1; s < n_dev; ++s) a = K::merge(a, buf[s * cols + p]);
        buf[p] = a;
      }
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < SF_PAIRS; ++j) {
      const int p = threadIdx.x + j * SF_THREADS;
      if (p < pairs) acc[j] = buf[p % cols];
    }
  }
#pragma unroll
  for (int j = 0; j < SF_PAIRS; ++j) {
    const int p = threadIdx.x + j * SF_THREADS;
    if (p < pairs) K::store(out + (long long)(p / cols) * w, c0 + p % cols, acc[j]);
  }
}

// blockIdx.x: the work item. m.f64 / i64 / i32 are the stacked input
// states [n_dev * k rows]; m.out_* the output [n_dev rows].
template <class F, class I>
__global__ void __launch_bounds__(SF_THREADS, 4)
state_fold_butterfly_kernel(const SfItem* __restrict__ items, int n_dev, int k,
                            SfMats<F, I> m) {
  extern __shared__ double sf_buf[];
  const SfItem it = items[blockIdx.x];
  switch (it.kind) {
    case SF_ADD_I64:
      sf_butterfly_item<SfAddI<I>>(m.i64, m.out_i, m.wi, n_dev, k, it.offset, it.cols,
                                   (I*)sf_buf);
      break;
    case SF_MAX_I32:
      sf_butterfly_item<SfMaxI32>(m.i32, m.out_r, m.wr, n_dev, k, it.offset, it.cols,
                                  (int32_t*)sf_buf);
      break;
    case SF_ADD_F64:
      sf_butterfly_item<SfAddF<F>>(m.f64, m.out_f, m.wf, n_dev, k, it.offset, it.cols,
                                   (F*)sf_buf);
      break;
    case SF_MIN:
      sf_butterfly_item<SfMin<F>>(m.f64, m.out_f, m.wf, n_dev, k, it.offset, it.cols,
                                  (F*)sf_buf);
      break;
    case SF_MAX:
      sf_butterfly_item<SfMax<F>>(m.f64, m.out_f, m.wf, n_dev, k, it.offset, it.cols,
                                  (F*)sf_buf);
      break;
    case SF_MOMENTS:
      sf_butterfly_item<SfMoments<F>>(m.f64, m.out_f, m.wf, n_dev, k, it.offset, 1,
                                      (DqMomentsT<F>*)sf_buf);
      break;
    case SF_COMOMENTS:
      sf_butterfly_item<SfComoments<F>>(m.f64, m.out_f, m.wf, n_dev, k, it.offset, 1,
                                        (DqComomentsT<F>*)sf_buf);
      break;
    default:
      break;
  }
}

extern "C" int state_fold_span() { return SF_SPAN; }
extern "C" int state_fold_max_shards() { return SF_MAX_SHARDS; }

// columns of a butterfly item over n_dev shards: n_dev * cols accumulators
// fit the block's threads twice over (four times at 1,024 shards)
extern "C" int state_fold_butterfly_span(int n_dev) {
  const int span = 2 * SF_THREADS / (n_dev < 1 ? 1 : n_dev);
  return span < 1 ? 1 : (span > SF_SPAN ? SF_SPAN : span);
}

template <class F, class I>
static int sf_launch(const SfItem* items, int n_items, int n_shards, long long n_rest,
                     const SfMats<F, I>& m, const unsigned char* flags, void* stream) {
  if (n_items < 1 || n_rest < 0 || n_shards < 1 || n_shards > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  state_fold_kernel<F, I><<<dim3(n_items, n_shards), SF_THREADS, 0, (cudaStream_t)stream>>>(
      items, n_rest, m, flags);
  return (int)cudaGetLastError();
}

// items: the work list [n_items] on the device, spans of at most
// state_fold_span() columns; f64: F[n_states * wf], i64: I[n_states * wi],
// i32: int32[n_states * wr] (a null pointer where the width is 0); out_f,
// out_i, out_r: one row of each
template <class F, class I>
static int sf_fold(const SfItem* items, int n_items, long long n_states, const F* f64, int wf,
                   const I* i64, int wi, const int32_t* i32, int wr, F* out_f, I* out_i,
                   int32_t* out_r, void* stream) {
  if (n_states < 1) return (int)cudaErrorInvalidValue;
  const SfMats<F, I> m = {f64, i64, i32, f64 ? f64 + wf : nullptr, i64 ? i64 + wi : nullptr,
                          i32 ? i32 + wr : nullptr, out_f, out_i, out_r, wf, wi, wr};
  return sf_launch(items, n_items, 1, n_states - 1, m, nullptr, stream);
}

// carry_f, carry_i, carry_r: n_shards packed rows of each dtype
// [n_shards * w], shard s folded with its n_parts partial rows of part_f
// [n_shards * n_parts * wf], part_i and part_r in order (those whose flag
// in flags [n_shards * n_parts] is set; every row when flags is null), the
// result written back into its carry row
template <class F, class I>
static int sf_carry(const SfItem* items, int n_items, int n_shards, long long n_parts,
                    F* carry_f, int wf, I* carry_i, int wi, int32_t* carry_r, int wr,
                    const F* part_f, const I* part_i, const int32_t* part_r,
                    const unsigned char* flags, void* stream) {
  if (n_parts < 1) return (int)cudaErrorInvalidValue;
  const SfMats<F, I> m = {carry_f, carry_i, carry_r, part_f, part_i, part_r,
                          carry_f, carry_i, carry_r, wf, wi, wr};
  return sf_launch(items, n_items, n_shards, n_parts, m, flags, stream);
}

// items: the work list with spans of at most state_fold_butterfly_span(
// n_dev) columns; f64, i64, i32: the stacked states [n_dev * k * w];
// out_*: every shard's final row [n_dev * w]
template <class F, class I>
static int sf_butterfly(const SfItem* items, int n_items, int n_dev, int k, const F* f64,
                        int wf, const I* i64, int wi, const int32_t* i32, int wr, F* out_f,
                        I* out_i, int32_t* out_r, void* stream) {
  if (n_items < 1 || n_dev < 1 || n_dev > SF_MAX_SHARDS || k < 1) {
    return (int)cudaErrorInvalidValue;
  }
  const int span = state_fold_butterfly_span(n_dev);
  // the buffer: n_dev accumulators of a co-moments group or n_dev * span
  // elementwise values, whichever is larger (48 KiB at most)
  const size_t smem = (size_t)n_dev * (span * 8 > (int)sizeof(DqComoments)
                                           ? span * 8 : (int)sizeof(DqComoments));
  const SfMats<F, I> m = {nullptr, nullptr, nullptr, f64, i64, i32, out_f, out_i, out_r,
                          wf, wi, wr};
  state_fold_butterfly_kernel<F, I><<<n_items, SF_THREADS, smem, (cudaStream_t)stream>>>(
      items, n_dev, k, m);
  return (int)cudaGetLastError();
}

// The four C entries over float64 / int64 / int32 matrices, and their _f32
// twins over float32 / int32 / int32 (the 32-bit accumulator mode).
#define SF_ENTRIES(SUFFIX, F, I)                                                               \
  extern "C" int state_fold_launch##SUFFIX(const SfItem* items, int n_items, long long n_states, \
                                           const F* f64, int wf, const I* i64, int wi,         \
                                           const int32_t* i32, int wr, F* out_f, I* out_i,     \
                                           int32_t* out_r, void* stream) {                     \
    return sf_fold<F, I>(items, n_items, n_states, f64, wf, i64, wi, i32, wr, out_f, out_i,    \
                         out_r, stream);                                                       \
  }                                                                                            \
  extern "C" int state_fold_carry_stacked_launch##SUFFIX(                                      \
      const SfItem* items, int n_items, int n_shards, long long n_parts, F* carry_f, int wf,   \
      I* carry_i, int wi, int32_t* carry_r, int wr, const F* part_f, const I* part_i,          \
      const int32_t* part_r, const unsigned char* flags, void* stream) {                       \
    return sf_carry<F, I>(items, n_items, n_shards, n_parts, carry_f, wf, carry_i, wi,        \
                          carry_r, wr, part_f, part_i, part_r, flags, stream);                 \
  }                                                                                            \
  /* the carry entry: the stacked carry with one shard and no flags */                         \
  extern "C" int state_fold_carry_launch##SUFFIX(                                              \
      const SfItem* items, int n_items, long long n_parts, F* carry_f, int wf, I* carry_i,     \
      int wi, int32_t* carry_r, int wr, const F* part_f, const I* part_i,                      \
      const int32_t* part_r, void* stream) {                                                   \
    return sf_carry<F, I>(items, n_items, 1, n_parts, carry_f, wf, carry_i, wi, carry_r, wr,  \
                          part_f, part_i, part_r, nullptr, stream);                            \
  }                                                                                            \
  extern "C" int state_fold_butterfly_launch##SUFFIX(                                          \
      const SfItem* items, int n_items, int n_dev, int k, const F* f64, int wf, const I* i64,  \
      int wi, const int32_t* i32, int wr, F* out_f, I* out_i, int32_t* out_r, void* stream) {  \
    return sf_butterfly<F, I>(items, n_items, n_dev, k, f64, wf, i64, wi, i32, wr, out_f,     \
                              out_i, out_r, stream);                                           \
  }

SF_ENTRIES(, double, long long)
SF_ENTRIES(_f32, float, int32_t)
