// Multi-RHS merge-path CsrMM for Hopper (sm_90a): Y = alpha * A * X + beta *
// Y_in with X [num_cols, k] and Y [num_rows, k] row-major (row strides ldx,
// ldy, ldyin), in one launch that reads A once for all k columns (K1m).
//
// Replaces the SpMM route of merge_spmv_tpu/ops/csrmv_pallas.py::_spmv_kernel:
// csrmm_column_loop (csrmv_pallas.py:1376-1406) runs the merge kernel once
// per column of X, which on the TPU measured fastest because a gather's cost
// per visit did not amortise over k there (merge_spmv_tpu/ops/operator.py:
// 98-118).  On Hopper it does: with X row-major, one nonzero's X row is one
// coalesced request of k * sizeof(V) contiguous bytes, where the column loop
// moves a 32-byte L2 sector for every 4-byte x[col] on scattered columns and
// reads A k times.
//
// The decomposition is K1's (csrc/merge_csrmv.cu): the merge tiles of
// merge_tile_coordinates, cut into equal contiguous runs, one persistent
// block per run (ops/plan.py::mm_geometry), the blocks of one SM on
// neighbouring runs; each run leaves one carry pair (row, k partials) and
// the block that takes the last ticket adds every row's carries into Y in
// run order.  No floating-point atomics: two calls give the same bits.
//
// Inside a run.  The block walks its tiles in chunks of chunk_tiles tiles
// (about 2048 merge items).  A chunk's values, column indices and row ends
// are three contiguous ranges: thread 0 copies each into one of two
// shared-memory stages with a 1-D bulk copy (TMA), started at its first
// element rounded down to 16 bytes, completion counted in bytes on the
// stage's mbarrier; the next chunk's copies run while this one is walked.
// The chunk's merge items are split evenly between walkers: a walker is
// kLanes lanes of a warp (32 / kLanes walkers a warp), its lane l holding
// kPer of the k columns, columns l * kPer + e (kVector: one vector load of
// kPer values) or l + e * kLanes (strided scalar loads).  A walker finds
// its start on the chunk's merge path by one binary search over the staged
// row ends; its end is the next walker's start, passed by a shuffle within
// the warp and through shared memory across warps.  It then walks its
// nonzeros in order, their X rows in two register batches of kBatch rows
// (batch_rows): the next batch's loads are issued before this batch's adds,
// so the row-close loop (rows that end before the next nonzero, each end
// read from shared memory once per row, not once per nonzero) and the adds,
// value * X[col, :] into the k-wide partial, run with 2 * kBatch rows in
// flight.  The first row a walker closes may have begun before it; every
// later one began in it and is written at once, Y[r, :] = alpha * sum +
// beta * Y_in[r, :], one coalesced store per row.  A segmented scan across
// the walkers (shuffles within a warp, the warps' totals through shared
// memory) gives each walker's first row the partial carried from the
// walkers, chunks and tiles before it, and the chunk's carry into the next.
// Two block barriers a chunk: one passes the walkers' ends, one the scan's
// warp totals.  The tail reads all carry rows with one coalesced load into
// shared memory, finds each pair's lead flag and further carries there, and
// issues a round's carry and Y-row loads together (fix_up).
//
// What bounds it.  A is read once: a value and a column index per nonzero,
// a row end per row; X and Y once each: spmm_bytes (bench/measure.py).  But
// X rows are gathered once per nonzero, nnz * k * sizeof(V) bytes from L1 or
// L2 (512 MB at k = 32 on the cant class against 48 MB of HBM bytes), so
// only L1 hits bring the kernel to the bytes bound; the L2's rate for whole
// rows (tools/gather_rate.py, rows class) gives the gather bound.  Measured
// (tools/mm_ablation.py, PERF.md; H100 80GB HBM3, 700 W): the previous
// kernel (commit 51a0a74) spent 63-86% of thread 0's stamped time in its
// walk, and inside the walk a batch's shared-memory loads before its X-row
// loads issued (19-35%), the wait for the first row (19-27%) and the
// row-close loop (26-43%: a dependent shared-memory load of the next row
// end per nonzero) outweighed the adds (8-14%).  This design's walk is
// 65-87% of the time again, but split 20-23% issue, 19-27% first-row wait,
// 17-22% closes and 30-40% adds with the later rows' waits: the X rows'
// arrival sets the pace, at 1.5-1.8x the gather bound at k = 32.  Neither
// gathering the same bytes in nonzero order (COAL) nor masking X to 128 KB
// of L1 (WIN) moves it by more than 12%.  The tail costs 2.0-4.7 us (the
// previous one 2.2-9.5): at k = 32 its carry and Y rows (127 KB at G =
// 496) outgrow one block's registers, so it takes four rounds of loads.
//
// Measured against the design and lost, in the same run (cant k = 32 /
// k = 8, ms; tools/mm_ablation.py): a ring of D X-row slots a walker in
// shared memory filled by cp.async, rows in flight holding no registers
// (D = 4, 8, 16: 0.1056, 0.1082, 0.1144 / 0.0485, 0.0517, 0.0554 against
// 0.0772 / 0.0365): a cp.async a lane a row and each row written to shared
// memory and read back cost more than the registers saved, and D = 8 and
// 16 cost blocks per SM; four rows a batch at 16-byte lanes (0.0799 /
// 0.0381: they spill); the previous kernel's per-element cp.async staging
// (equal here, 23% slower at grid3d(100) k = 4); two searches a walker
// (0.0786 / 0.0367); the previous tail (0.0820 / 0.0367).
//
// Columns: k up to kMaxK = 64 per launch (a wider X is cut into column
// blocks of 64 by the wrapper, one launch each); the wrapper picks kPer,
// kVector and kLanes from k and the operands' alignment (ops/plan.py::
// mm_layout).  Row and column offsets are 64-bit: num_rows * k passes 2^31
// on the split class.
//
// Plain C interface (loaded with ctypes): pointers and the stream are void*,
// every entry returns a CUDA error code (a launch returns cudaGetLastError()
// right after it).  The kernel allocates nothing and launches on the
// caller's stream; its ticket counter is the caller's (an operator's, shared
// with op(x)'s K1) or, given none, this module's one per device.  Launches
// that share a counter must be stream-ordered.

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int kThreads = 256;         // ops/plan.py::MM_THREADS
constexpr int kWarps = kThreads / 32;
constexpr int kMaxK = 64;             // ops/plan.py::MM_MAX_K
constexpr int kTail = 4;              // carry pairs a walker fixes at once
constexpr int kBlocksPerSm = 4;       // __launch_bounds__: 64 registers
constexpr int kChunkItems = 2048;     // ops/plan.py::MM_CHUNK_ITEMS
constexpr int kStageSlack = 96;       // ops/plan.py::MM_STAGE_SLACK
constexpr int kMaxSharedBytes = 232448;
constexpr int kSmSharedBytes = 233472;
constexpr int kBlockReserved = 1024;

// X rows a walker loads in one batch, by the bytes a lane loads of each
// row and the walker's lanes; two batches are in flight (ops/plan.py::
// mm_batch_rows).  Four rows of 16-byte lanes spill at 64 registers.
__host__ __device__ constexpr int batch_rows(int lane_bytes, int lanes) {
  return lane_bytes < 16 ? 4 : lanes <= 2 ? 2 : 3;
}

// A stage: the chunk's values, then its row ends and column indices, each
// range copied from its start rounded down to 16 bytes and its size rounded
// up, so each may take up to 32 bytes more than its data.
template <typename V>
__host__ __device__ constexpr size_t stage_bytes(int chunk_items) {
  return static_cast<size_t>(chunk_items) * (sizeof(V) + 4) + kStageSlack;
}

// Dynamic shared memory (ops/plan.py::mm_shared_bytes repeats it): the
// stages' two mbarriers (16 bytes), two stages, the warps' scan totals
// (kWarps x width values, width = per * lanes), their flags and the warps'
// first merge-path starts (kWarps ints each).
template <typename V>
__host__ __device__ constexpr size_t mm_shared_bytes(int chunk_items, int per,
                                                     int lanes) {
  return 16 + 2 * stage_bytes<V>(chunk_items) +
         static_cast<size_t>(kWarps) * per * lanes * sizeof(V) +
         2 * kWarps * 4;
}

template <typename V, int N>
struct Vec;
template <>
struct Vec<float, 1> { using T = float; };
template <>
struct Vec<float, 2> { using T = float2; };
template <>
struct Vec<float, 4> { using T = float4; };
template <>
struct Vec<double, 1> { using T = double; };
template <>
struct Vec<double, 2> { using T = double2; };

__device__ __forceinline__ void unpack(float v, float (&o)[1]) { o[0] = v; }
__device__ __forceinline__ void unpack(double v, double (&o)[1]) { o[0] = v; }
__device__ __forceinline__ void unpack(float2 v, float (&o)[2]) {
  o[0] = v.x;
  o[1] = v.y;
}
__device__ __forceinline__ void unpack(double2 v, double (&o)[2]) {
  o[0] = v.x;
  o[1] = v.y;
}
__device__ __forceinline__ void unpack(float4 v, float (&o)[4]) {
  o[0] = v.x;
  o[1] = v.y;
  o[2] = v.z;
  o[3] = v.w;
}
__device__ __forceinline__ void pack(const float (&o)[1], float& v) {
  v = o[0];
}
__device__ __forceinline__ void pack(const double (&o)[1], double& v) {
  v = o[0];
}
__device__ __forceinline__ void pack(const float (&o)[2], float2& v) {
  v.x = o[0];
  v.y = o[1];
}
__device__ __forceinline__ void pack(const double (&o)[2], double2& v) {
  v.x = o[0];
  v.y = o[1];
}
__device__ __forceinline__ void pack(const float (&o)[4], float4& v) {
  v.x = o[0];
  v.y = o[1];
  v.z = o[2];
  v.w = o[3];
}

// Lane l's columns of a k-wide row: l * kPer + e (kVector) or l + e * kLanes.
template <int kPer, bool kVector, int kLanes>
__device__ __forceinline__ int column(int l, int e) {
  return kVector ? l * kPer + e : l + e * kLanes;
}

// Lane l's kPer values of a row (0 past column k): through the read-only
// path, or through L2 (kCoherent: data written earlier in the same launch).
template <typename V, int kPer, bool kVector, int kLanes, bool kCoherent>
__device__ __forceinline__ void load_row(const V* row, int l, int k,
                                         V (&out)[kPer]) {
  if constexpr (kVector) {
    using T = typename Vec<V, kPer>::T;
    if (l * kPer < k) {
      const T* p = reinterpret_cast<const T*>(row) + l;
      unpack(kCoherent ? __ldcg(p) : __ldg(p), out);
    } else {
#pragma unroll
      for (int e = 0; e < kPer; ++e) out[e] = V(0);
    }
  } else {
#pragma unroll
    for (int e = 0; e < kPer; ++e) {
      const int c = l + e * kLanes;
      out[e] = c < k ? (kCoherent ? __ldcg(row + c) : __ldg(row + c)) : V(0);
    }
  }
}

template <typename V, int kPer, bool kVector, int kLanes>
__device__ __forceinline__ void store_row(V* row, int l, int k,
                                          const V (&v)[kPer]) {
  if constexpr (kVector) {
    using T = typename Vec<V, kPer>::T;
    if (l * kPer < k) {
      T t;
      pack(v, t);
      reinterpret_cast<T*>(row)[l] = t;
    }
  } else {
#pragma unroll
    for (int e = 0; e < kPer; ++e) {
      const int c = l + e * kLanes;
      if (c < k) row[c] = v[e];
    }
  }
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// --- the stages: bulk copies counted on an mbarrier -----------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;"
               :: "r"(smem_u32(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

// Waits until the phase of parity `parity` of the barrier has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n"
        "  .reg .pred p;\n"
        "  mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "  selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done) : "r"(smem_u32(bar)), "r"(parity) : "memory");
  }
}

// bytes (a multiple of 16) from global src to shared dst, both 16-byte
// aligned, completing as bytes on the barrier's transaction count.
__device__ __forceinline__ void bulk_copy(const void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];"
      :: "r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ uint32_t head16(const void* p) {
  return static_cast<uint32_t>(reinterpret_cast<uintptr_t>(p) & 15u);
}

__device__ __forceinline__ uint32_t round16(uint32_t n) {
  return (n + 15u) & ~15u;
}

// p rounded down to 16 bytes.
__device__ __forceinline__ const unsigned char* floor16(const void* p) {
  return static_cast<const unsigned char*>(p) - head16(p);
}

// A chunk of `rows` row ends from r0 and `nnz` nonzeros from n0 in a stage:
// where each range's first element lands.  Each range is copied from its
// first element rounded down to 16 bytes, so it lands as far past a 16-byte
// boundary of the stage as it lies past one in memory: the values at 0,
// the row ends at chunk_items * sizeof(V) + 32, the column indices after
// them.
template <typename V>
struct StageView {
  const V* val;
  const int* re;
  const int* col;
};

template <typename V>
__device__ __forceinline__ StageView<V> stage_view(
    const unsigned char* stage, const V* values, const int* cols,
    const int* row_end, int r0, int rows, int n0, int chunk_items) {
  const size_t vbytes = static_cast<size_t>(chunk_items) * sizeof(V) + 32;
  const uint32_t hr = head16(row_end + r0);
  const size_t cbase = vbytes + round16(hr + 4u * rows);
  StageView<V> v;
  v.val = reinterpret_cast<const V*>(stage + head16(values + n0));
  v.re = reinterpret_cast<const int*>(stage + vbytes + hr);
  v.col = reinterpret_cast<const int*>(stage + cbase + head16(cols + n0));
  return v;
}

// The bytes of a bulk copy of `bytes` from src: from src rounded down to
// 16 bytes, rounded up to 16 (0 for none).
__device__ __forceinline__ uint32_t copy_bytes(const void* src,
                                               uint32_t bytes) {
  return bytes ? round16(head16(src) + bytes) : 0u;
}

// The chunk (rows [r0, r1), nonzeros [n0, n1)) into a stage: thread 0
// expects the three ranges' bytes on the stage's barrier and starts one
// bulk copy each.  The clamp keeps the stage in bounds whatever coordinates
// the caller passed; the walkers clamp alike.
template <typename V>
__device__ __forceinline__ void stage_chunk(const V* values, const int* cols,
                                            const int* row_end, int r0,
                                            int r1, int n0, int n1,
                                            int chunk_items,
                                            unsigned char* stage,
                                            uint64_t* bar) {
  if (threadIdx.x != 0) return;
  const int nnz = min(max(n1 - n0, 0), chunk_items);
  const int rows = min(max(r1 - r0, 0), chunk_items - nnz);
  const StageView<V> v = stage_view(stage, values, cols, row_end, r0, rows,
                                    n0, chunk_items);
  const uint32_t bv = copy_bytes(values + n0, sizeof(V) * nnz);
  const uint32_t br = copy_bytes(row_end + r0, 4u * rows);
  const uint32_t bc = copy_bytes(cols + n0, 4u * nnz);
  mbar_expect_tx(bar, bv + br + bc);
  if (bv) bulk_copy(floor16(v.val), floor16(values + n0), bv, bar);
  if (br) bulk_copy(floor16(v.re), floor16(row_end + r0), br, bar);
  if (bc) bulk_copy(floor16(v.col), floor16(cols + n0), bc, bar);
}

// The X row of nonzero j of the chunk.
template <typename V>
__device__ __forceinline__ const V* x_row(const V* X, long long ldx,
                                          const int* s_col, int j) {
  return X + static_cast<long long>(s_col[j]) * ldx;
}

// The rows consumed before merge item d of a chunk of `rows` row ends (raw
// offsets, n0 taken off) and `nnz` nonzeros: the first i with
// row_end[i] - n0 + i >= d, in [max(d - nnz, 0), min(d, rows)]
// (ops/merge_path.py::merge_path_search).
__device__ __forceinline__ int merge_search(const int* s_re, int n0,
                                            int rows, int nnz, int d) {
  int lo = max(d - nnz, 0);
  int hi = min(d, rows);
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (s_re[mid] - n0 + mid < d)
      lo = mid + 1;
    else
      hi = mid;
  }
  return lo;
}

// Y[r, :] = alpha * s + beta * Y_in[r, :] for lane l's columns.
template <typename V, int kPer, bool kVector, int kLanes>
__device__ __forceinline__ void write_row(V* Y, long long ldy, const V* y_in,
                                          long long ldyin, long long r,
                                          int l, int k, V alpha, V beta,
                                          const V (&s)[kPer]) {
  V out[kPer];
#pragma unroll
  for (int e = 0; e < kPer; ++e) out[e] = alpha * s[e];
  if (y_in != nullptr) {
    V yi[kPer];
    load_row<V, kPer, kVector, kLanes, false>(y_in + r * ldyin, l, k, yi);
#pragma unroll
    for (int e = 0; e < kPer; ++e) out[e] += beta * yi[e];
  }
  store_row<V, kPer, kVector, kLanes>(Y + r * ldy, l, k, out);
}

// A walker's state over a chunk: `acc` is the sum since the last row end;
// the first row closed keeps its partial in `first` for the scan.
template <typename V, int kPer>
struct Walk {
  V acc[kPer];
  V first[kPer];
  int closed;
  int first_row;
};

// Where closed rows go: Y[r_lo + i, :] for lane l's columns.
template <typename V>
struct RowSink {
  V* Y;
  long long ldy;
  const V* y_in;
  long long ldyin;
  long long r_lo;
  V alpha;
  V beta;
  int l;
  int k;
};

// Closes row i: the walker's first closed row keeps its partial for the
// scan, every later one is written.
template <typename V, int kPer, bool kVector, int kLanes>
__device__ __forceinline__ void close_row(Walk<V, kPer>& w,
                                          const RowSink<V>& out, int i) {
  if (w.closed) {
    write_row<V, kPer, kVector, kLanes>(out.Y, out.ldy, out.y_in, out.ldyin,
                                        out.r_lo + i, out.l, out.k, out.alpha,
                                        out.beta, w.acc);
  } else {
    w.closed = 1;
    w.first_row = i;
#pragma unroll
    for (int e = 0; e < kPer; ++e) w.first[e] = w.acc[e];
  }
#pragma unroll
  for (int e = 0; e < kPer; ++e) w.acc[e] = V(0);
}

// Lane l's columns of the X rows of nonzeros [j, j + kBatch) (zeros past
// j_end): kBatch independent loads in flight.
template <typename V, int kPer, bool kVector, int kLanes, int kBatch>
__device__ __forceinline__ void load_batch(const StageView<V>& st, int n_lo,
                                           int j, int j_end, const V* X,
                                           long long ldx, int l, int k,
                                           V (&xv)[kBatch][kPer]) {
#pragma unroll
  for (int u = 0; u < kBatch; ++u) {
    if (j + u < j_end) {
      load_row<V, kPer, kVector, kLanes, false>(
          x_row(X, ldx, st.col, j + u), l, k, xv[u]);
    } else {
#pragma unroll
      for (int e = 0; e < kPer; ++e) xv[u][e] = V(0);
    }
  }
}

// Nonzeros [j, j + kBatch) (up to j_end) into the walker's partial, each
// after closing the rows that end before it.  The next row end is kept in
// a register, so a nonzero that closes no row reads no row end.
template <typename V, int kPer, bool kVector, int kLanes, int kBatch>
__device__ __forceinline__ void add_batch(const StageView<V>& st, int n_lo,
                                          int& i, int i_end, int& next_end,
                                          int j, int j_end,
                                          const V (&xv)[kBatch][kPer],
                                          const RowSink<V>& out,
                                          Walk<V, kPer>& w) {
#pragma unroll
  for (int u = 0; u < kBatch; ++u) {
    if (j + u >= j_end) break;
    while (next_end <= j + u) {   // rows that end before nonzero j + u
      close_row<V, kPer, kVector, kLanes>(w, out, i);
      ++i;
      next_end = i < i_end ? st.re[i] - n_lo : 0x7fffffff;
    }
    const V a = st.val[j + u];
#pragma unroll
    for (int e = 0; e < kPer; ++e) w.acc[e] += a * xv[u][e];
  }
}

// The walk of nonzeros [j, j_end) and rows [i, i_end) of a chunk: X rows
// in two register batches, the next batch's loads issued before this
// batch's adds and row closes, so 2 * kBatch rows are in flight.
template <typename V, int kPer, bool kVector, int kLanes>
__device__ __forceinline__ void walk(const StageView<V>& st, int n_lo, int i,
                                     int i_end, int j, int j_end, const V* X,
                                     long long ldx, const RowSink<V>& out,
                                     Walk<V, kPer>& w) {
  constexpr int kBatch =
      batch_rows(kPer * static_cast<int>(sizeof(V)), kLanes);
  int next_end = i < i_end ? st.re[i] - n_lo : 0x7fffffff;
  V xa[kBatch][kPer], xb[kBatch][kPer];
  load_batch<V, kPer, kVector, kLanes, kBatch>(st, n_lo, j, j_end, X, ldx,
                                               out.l, out.k, xa);
  for (; j < j_end; j += 2 * kBatch) {
    load_batch<V, kPer, kVector, kLanes, kBatch>(st, n_lo, j + kBatch, j_end,
                                                 X, ldx, out.l, out.k, xb);
    add_batch<V, kPer, kVector, kLanes, kBatch>(st, n_lo, i, i_end,
                                                next_end, j, j_end, xa, out,
                                                w);
    load_batch<V, kPer, kVector, kLanes, kBatch>(
        st, n_lo, j + 2 * kBatch, j_end, X, ldx, out.l, out.k, xa);
    add_batch<V, kPer, kVector, kLanes, kBatch>(st, n_lo, i, i_end,
                                                next_end, j + kBatch, j_end,
                                                xb, out, w);
  }
  for (; i < i_end; ++i)   // rows that end after the walker's last nonzero
    close_row<V, kPer, kVector, kLanes>(w, out, i);
}

// The fix-up as the tail: for every row r < num_rows whose first carry is
// pair t, Y[r, :] += alpha * (r's carries, in run order).  The block reads
// the carry rows with one coalesced load into shared memory (`s_crow`,
// room for cap + 1 of them; more pairs go in segments), where each walker
// finds its pairs' lead flags and further carries; then it issues all of
// its kTail pairs' carry and Y-row loads before adding any of them.  What
// other blocks wrote is read through L2.
template <typename V, int kPer, bool kVector, int kLanes>
__device__ __forceinline__ void fix_up(const int* carry_row,
                                       const V* carry_val, V* Y,
                                       long long ldy, V alpha, int num_rows,
                                       int num_pairs, int k, int walker,
                                       int num_walkers, int l, int* s_crow,
                                       int cap) {
  for (int base = 0; base < num_pairs; base += cap) {
    const int n = min(cap, num_pairs - base);
    // s_crow[q] = carry_row[base - 1 + q], q in [0, n]
    for (int q = threadIdx.x; q <= n; q += kThreads)
      s_crow[q] = q + base > 0 ? __ldcg(carry_row + base - 1 + q) : -1;
    __syncthreads();
    for (int q0 = walker; q0 < n; q0 += num_walkers * kTail) {
      int r[kTail], more[kTail];
#pragma unroll
      for (int u = 0; u < kTail; ++u) {
        const int q = q0 + u * num_walkers;
        r[u] = -1;
        more[u] = 0;
        if (q < n) {
          const int row = s_crow[q + 1];
          if (row < num_rows && s_crow[q] != row) {   // pair leads its row
            r[u] = row;
            int w = q + 2;
            while (w <= n && s_crow[w] == row) ++w;
            more[u] = w - q - 2;
            if (w > n)   // the row's carries reach past the segment
              for (int t = base + n; t < num_pairs &&
                                     __ldcg(carry_row + t) == row; ++t)
                ++more[u];
          }
        }
      }
      V s[kTail][kPer], yv[kTail][kPer];
#pragma unroll
      for (int u = 0; u < kTail; ++u) {
        if (r[u] < 0) continue;
        const long long t = base + q0 + u * num_walkers;
        load_row<V, kPer, kVector, kLanes, true>(carry_val + t * k, l, k,
                                                 s[u]);
        load_row<V, kPer, kVector, kLanes, true>(
            Y + static_cast<long long>(r[u]) * ldy, l, k, yv[u]);
      }
#pragma unroll
      for (int u = 0; u < kTail; ++u) {
        if (r[u] < 0) continue;
        const long long t = base + q0 + u * num_walkers;
        for (int m = 1; m <= more[u]; ++m) {   // rare: several carries
          V x[kPer];
          load_row<V, kPer, kVector, kLanes, true>(carry_val + (t + m) * k,
                                                   l, k, x);
#pragma unroll
          for (int e = 0; e < kPer; ++e) s[u][e] += x[e];
        }
#pragma unroll
        for (int e = 0; e < kPer; ++e) yv[u][e] += alpha * s[u][e];
        store_row<V, kPer, kVector, kLanes>(
            Y + static_cast<long long>(r[u]) * ldy, l, k, yv[u]);
      }
    }
    __syncthreads();   // s_crow is free for the next segment
  }
}

// The kernel's ticket counter for launches given none.
__device__ unsigned int g_mm_tickets = 0;

template <typename V, int kPer, bool kVector, int kLanes>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
    merge_tile_mm_kernel(const V* __restrict__ values,
                         const int* __restrict__ cols,
                         const int* __restrict__ row_end,
                         const V* __restrict__ X, long long ldx,
                         const V* __restrict__ y_in, long long ldyin,
                         const int* __restrict__ tile_rows,
                         const int* __restrict__ tile_nnz, V alpha, V beta,
                         V* __restrict__ Y, long long ldy,
                         int* __restrict__ carry_row,
                         V* __restrict__ carry_val, int num_rows,
                         int num_tiles, int run_tiles, int chunk_tiles,
                         int chunk_items, int sm_blocks, int k,
                         unsigned int* tickets) {
  constexpr int kWidth = kLanes * kPer;   // columns a walker holds
  constexpr int kWalkersPerWarp = 32 / kLanes;
  extern __shared__ __align__(16) unsigned char smem[];
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);
  unsigned char* stages = smem + 16;
  const size_t stage_len = stage_bytes<V>(chunk_items);
  V* s_wtot = reinterpret_cast<V*>(stages + 2 * stage_len);
  int* s_wflag = reinterpret_cast<int*>(s_wtot + kWarps * kWidth);
  int* s_start = s_wflag + kWarps;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int wl = lane % kLanes;           // lane within the walker
  const int p = lane / kLanes;            // walker within the warp
  const int walker = warp * kWalkersPerWarp + p;
  const int num_walkers = kThreads / kLanes;
  const unsigned full = 0xffffffffu;

  // Block b walks run b, or, with sm_blocks = s > 1 (G a multiple of s),
  // run (b mod G/s) * s + b / (G/s), as K1's blocks do: the card hands out
  // one block per SM in turn, so the s blocks sharing an SM walk s
  // neighbouring runs and gather from one window of X.
  const int groups = static_cast<int>(gridDim.x) / sm_blocks;
  const int my_run = sm_blocks > 1
                         ? static_cast<int>(blockIdx.x) % groups * sm_blocks +
                               static_cast<int>(blockIdx.x) / groups
                         : static_cast<int>(blockIdx.x);
  const int first = my_run * run_tiles;
  const int end = min(num_tiles - first, run_tiles) + first;
  const int num_chunks = (end - first + chunk_tiles - 1) / chunk_tiles;

  if (tid == 0) {
    mbar_init(bars, 1);
    mbar_init(bars + 1, 1);
    mbar_fence_init();
  }
  __syncthreads();

  // Chunk c is tiles [first + c * chunk_tiles, ...) up to end; (r_lo, n_lo)
  // and (r_hi, n_hi) are its merge coordinates, (r_nx, n_nx) the next
  // chunk's end; chunks c and c + 1 are in flight while c is walked.
  int r_lo = __ldg(tile_rows + first), n_lo = __ldg(tile_nnz + first);
  int t_hi = min(first + chunk_tiles, end);
  int r_hi = __ldg(tile_rows + t_hi), n_hi = __ldg(tile_nnz + t_hi);
  int t_nx = min(t_hi + chunk_tiles, end);
  int r_nx = 0, n_nx = 0;
  if (num_chunks > 1) {
    r_nx = __ldg(tile_rows + t_nx);
    n_nx = __ldg(tile_nnz + t_nx);
  }
  stage_chunk(values, cols, row_end, r_lo, r_hi, n_lo, n_hi, chunk_items,
              stages, bars);
  if (num_chunks > 1)
    stage_chunk(values, cols, row_end, r_hi, r_nx, n_hi, n_nx, chunk_items,
                stages + stage_len, bars + 1);

  V cin[kPer];   // the partial of the row open at the chunk's start
#pragma unroll
  for (int e = 0; e < kPer; ++e) cin[e] = V(0);

  for (int c = 0; c < num_chunks; ++c) {
    unsigned char* stage = stages + (c & 1) * stage_len;
    int r_nn = 0, n_nn = 0;   // chunk c + 2's end
    const int t_nn = min(t_nx + chunk_tiles, end);
    if (c + 2 < num_chunks) {
      r_nn = __ldg(tile_rows + t_nn);
      n_nn = __ldg(tile_nnz + t_nn);
    }
    mbar_wait(bars + (c & 1), (c >> 1) & 1);   // chunk c has landed

    const int nnz = min(max(n_hi - n_lo, 0), chunk_items);
    const int rows = min(max(r_hi - r_lo, 0), chunk_items - nnz);
    const StageView<V> st = stage_view(stage, values, cols, row_end, r_lo,
                                       rows, n_lo, chunk_items);
    const int items = rows + nnz;
    const int share = (items + num_walkers - 1) / num_walkers;
    const int d0 = min(walker * share, items);
    const int i = merge_search(st.re, n_lo, rows, nnz, d0);
    // The walker's end is the next walker's start: from the next walker of
    // the warp, or the next warp's first, or the chunk's end.
    int i_end = __shfl_down_sync(full, i, kLanes);
    if (lane == 0) s_start[warp] = i;
    __syncthreads();   // every warp's first start is in s_start
    if (p == kWalkersPerWarp - 1)
      i_end = warp + 1 < kWarps ? s_start[warp + 1] : rows;
    const int d1 = min(d0 + share, items);
    const int j_end = d1 - i_end;

    Walk<V, kPer> w;
#pragma unroll
    for (int e = 0; e < kPer; ++e) w.acc[e] = w.first[e] = V(0);
    w.closed = 0;
    w.first_row = 0;
    const RowSink<V> out{Y, ldy, y_in, ldyin, r_lo, alpha, beta, wl, k};
    walk<V, kPer, kVector, kLanes>(st, n_lo, i, i_end, d0 - i, j_end, X, ldx,
                                   out, w);
    __syncwarp();

    // Segmented scan of the walkers' (closed a row, open partial) pairs, a
    // before b: b's partial restarts after a row end.  Within the warp by
    // shuffles over walkers, kLanes lanes apart; then across the warps'
    // totals in shared memory, entered by the chunk's carry.
    int f = w.closed;
    V v[kPer];
#pragma unroll
    for (int e = 0; e < kPer; ++e) v[e] = w.acc[e];
#pragma unroll
    for (int d = 1; d < kWalkersPerWarp; d <<= 1) {
      const int f2 = __shfl_up_sync(full, f, d * kLanes);
      V v2[kPer];
#pragma unroll
      for (int e = 0; e < kPer; ++e)
        v2[e] = __shfl_up_sync(full, v[e], d * kLanes);
      if (p >= d) {
#pragma unroll
        for (int e = 0; e < kPer; ++e) v[e] = f ? v[e] : v2[e] + v[e];
        f |= f2;
      }
    }
    int ef = 0;   // the walkers before this one in the warp
    V ev[kPer];
#pragma unroll
    for (int e = 0; e < kPer; ++e) ev[e] = V(0);
    if constexpr (kWalkersPerWarp > 1) {
      ef = __shfl_up_sync(full, f, kLanes);
#pragma unroll
      for (int e = 0; e < kPer; ++e) ev[e] = __shfl_up_sync(full, v[e], kLanes);
      if (p == 0) {
        ef = 0;
#pragma unroll
        for (int e = 0; e < kPer; ++e) ev[e] = V(0);
      }
    }
    if (p == kWalkersPerWarp - 1) {
#pragma unroll
      for (int e = 0; e < kPer; ++e)
        s_wtot[warp * kWidth + column<kPer, kVector, kLanes>(wl, e)] = v[e];
      if (wl == 0) s_wflag[warp] = f;
    }
    __syncthreads();   // the warps' totals are in; the stage is read
    if (c + 2 < num_chunks)
      stage_chunk(values, cols, row_end, r_nx, r_nn, n_nx, n_nn, chunk_items,
                  stage, bars + (c & 1));
    V pv[kPer], mv[kPer];   // prefix of all warps so far; of those before
#pragma unroll
    for (int e = 0; e < kPer; ++e) pv[e] = mv[e] = cin[e];
    for (int q = 0; q < kWarps; ++q) {
      if (q == warp) {
#pragma unroll
        for (int e = 0; e < kPer; ++e) mv[e] = pv[e];
      }
      const int qf = s_wflag[q];
#pragma unroll
      for (int e = 0; e < kPer; ++e) {
        const V qv = s_wtot[q * kWidth + column<kPer, kVector, kLanes>(wl, e)];
        pv[e] = qf ? qv : pv[e] + qv;
      }
    }
    if (w.closed) {
      V s[kPer];
#pragma unroll
      for (int e = 0; e < kPer; ++e)
        s[e] = (ef ? ev[e] : mv[e] + ev[e]) + w.first[e];
      write_row<V, kPer, kVector, kLanes>(
          Y, ldy, y_in, ldyin, static_cast<long long>(r_lo) + w.first_row, wl,
          k, alpha, beta, s);
    }
#pragma unroll
    for (int e = 0; e < kPer; ++e) cin[e] = pv[e];

    r_lo = r_hi;
    n_lo = n_hi;
    r_hi = r_nx;
    n_hi = n_nx;
    r_nx = r_nn;
    n_nx = n_nn;
    t_nx = t_nn;
  }

  // The run's carry pair: the row open at its end, tile_rows[end].
  if (walker == 0) {
    store_row<V, kPer, kVector, kLanes>(
        carry_val + static_cast<long long>(my_run) * k, wl, k, cin);
    if (wl == 0) carry_row[my_run] = r_lo;
  }

  // The tail, as K1's: once the block's rows and pair are written, thread 0
  // takes a ticket with an acquire-release increment at device scope that
  // wraps the counter to 0 at the last ticket; the block that takes it runs
  // fix_up over every pair, in the stages' memory.
  __syncthreads();
  if (tid == 0) {
    unsigned int* counter = tickets != nullptr ? tickets : &g_mm_tickets;
    unsigned int ticket;
    asm volatile("atom.acq_rel.gpu.inc.u32 %0, [%1], %2;"
                 : "=r"(ticket) : "l"(counter), "r"(gridDim.x - 1)
                 : "memory");
    s_wflag[0] = ticket == gridDim.x - 1;
  }
  __syncthreads();
  if (!s_wflag[0]) return;
  fix_up<V, kPer, kVector, kLanes>(
      carry_row, carry_val, Y, ldy, alpha, num_rows,
      static_cast<int>(gridDim.x), k, walker, num_walkers, wl,
      reinterpret_cast<int*>(stages), static_cast<int>(2 * stage_len / 4) - 1);
}

// The instantiation for (per, vector, lanes); null for a layout it lacks.
// kVector with kPer values a lane (one 4, 8 or 16-byte copy), or strided
// with two (k of 33-64 columns that allow no vector copy).
template <typename V, int kPer, bool kVector>
const void* by_lanes(int lanes) {
  switch (lanes) {
    case 1:
      return reinterpret_cast<const void*>(
          merge_tile_mm_kernel<V, kPer, kVector, 1>);
    case 2:
      return reinterpret_cast<const void*>(
          merge_tile_mm_kernel<V, kPer, kVector, 2>);
    case 4:
      return reinterpret_cast<const void*>(
          merge_tile_mm_kernel<V, kPer, kVector, 4>);
    case 8:
      return reinterpret_cast<const void*>(
          merge_tile_mm_kernel<V, kPer, kVector, 8>);
    case 16:
      return reinterpret_cast<const void*>(
          merge_tile_mm_kernel<V, kPer, kVector, 16>);
    case 32:
      if constexpr (kPer * 32 <= kMaxK)
        return reinterpret_cast<const void*>(
            merge_tile_mm_kernel<V, kPer, kVector, 32>);
      return nullptr;
    default:
      return nullptr;
  }
}

template <typename V>
const void* mm_kernel(int per, int vector, int lanes) {
  if (vector) {
    if (per == 1) return by_lanes<V, 1, true>(lanes);
    if (per == 2) return by_lanes<V, 2, true>(lanes);
    if constexpr (sizeof(V) == 4)
      if (per == 4) return by_lanes<V, 4, true>(lanes);
    return nullptr;
  }
  if (per == 2 && lanes == 32)
    return reinterpret_cast<const void*>(
        merge_tile_mm_kernel<V, 2, false, 32>);
  return nullptr;
}

// The carveout (percent of the SM's shared memory) for a layout: what holds
// as many blocks as fit, at most kBlocksPerSm, at the default chunk; the
// rest of the SM's 256 KB is L1 for the X window (ops/plan.py::
// mm_carveout).
template <typename V>
__host__ __device__ constexpr int mm_carveout(int per, int lanes) {
  const size_t block = mm_shared_bytes<V>(kChunkItems, per, lanes) +
                       kBlockReserved;
  const size_t fit = kSmSharedBytes / block < kBlocksPerSm
                         ? kSmSharedBytes / block
                         : kBlocksPerSm;
  return static_cast<int>(((fit > 0 ? fit : 1) * block * 100 +
                           kSmSharedBytes - 1) / kSmSharedBytes);
}

// The attributes of every layout the wrapper may pick, set at init.
template <typename V>
cudaError_t set_attributes(int per, int vector, int lanes) {
  const void* kernel = mm_kernel<V>(per, vector, lanes);
  if (kernel == nullptr) return cudaSuccess;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSharedBytes);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             mm_carveout<V>(per, lanes));
  return e;
}

template <typename V>
cudaError_t set_all_attributes() {
  cudaError_t e = cudaSuccess;
  const int pers[] = {1, 2, 4};
  for (int per : pers)
    for (int lanes = 1; lanes <= 32 && e == cudaSuccess; lanes <<= 1)
      e = set_attributes<V>(per, 1, lanes);
  if (e == cudaSuccess) e = set_attributes<V>(2, 0, 32);
  return e;
}

template <typename V>
int launch_merge_tile_mm(const void* values, const void* cols,
                         const void* row_end, const void* x, long long ldx,
                         const void* y_in, long long ldyin,
                         const void* tile_rows, const void* tile_nnz,
                         double alpha, double beta, void* y, long long ldy,
                         void* carry_row, void* carry_val, int num_rows,
                         int num_tiles, int run_tiles, int chunk_tiles,
                         int chunk_items, int sm_blocks, int k, int per,
                         int vector, int lanes, int threads,
                         int shared_bytes, void* tickets, void* stream) {
  const void* kernel = mm_kernel<V>(per, vector, lanes);
  if (kernel == nullptr || k < 1 || k > kMaxK || k > per * lanes ||
      num_tiles < 1 || run_tiles < 1 || chunk_tiles < 1 ||
      chunk_items < 1 || chunk_items % 16 != 0 || threads != kThreads ||
      static_cast<size_t>(shared_bytes) !=
          mm_shared_bytes<V>(chunk_items, per, lanes))
    return static_cast<int>(cudaErrorInvalidValue);
  const int grid = num_tiles / run_tiles + (num_tiles % run_tiles != 0);
  if (sm_blocks < 1 || grid % sm_blocks != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  // the kernel's parameters, in its order and types
  const V* a_values = static_cast<const V*>(values);
  const int* a_cols = static_cast<const int*>(cols);
  const int* a_row_end = static_cast<const int*>(row_end);
  const V* a_x = static_cast<const V*>(x);
  const V* a_y_in = static_cast<const V*>(y_in);
  const int* a_tile_rows = static_cast<const int*>(tile_rows);
  const int* a_tile_nnz = static_cast<const int*>(tile_nnz);
  V a_alpha = static_cast<V>(alpha);
  V a_beta = static_cast<V>(beta);
  V* a_y = static_cast<V*>(y);
  int* a_carry_row = static_cast<int*>(carry_row);
  V* a_carry_val = static_cast<V*>(carry_val);
  unsigned int* a_tickets = static_cast<unsigned int*>(tickets);
  void* args[] = {&a_values, &a_cols, &a_row_end, &a_x, &ldx, &a_y_in,
                  &ldyin, &a_tile_rows, &a_tile_nnz, &a_alpha, &a_beta,
                  &a_y, &ldy, &a_carry_row, &a_carry_val, &num_rows,
                  &num_tiles, &run_tiles, &chunk_tiles, &chunk_items,
                  &sm_blocks, &k, &a_tickets};
  const cudaError_t e = cudaLaunchKernel(kernel, dim3(grid), dim3(threads),
                                         args, shared_bytes,
                                         static_cast<cudaStream_t>(stream));
  return static_cast<int>(e != cudaSuccess ? e : cudaGetLastError());
}

template <typename V>
int merge_tile_mm_occupancy(int per, int vector, int lanes, int threads,
                            int shared_bytes, int* blocks_per_sm,
                            int* registers) {
  const void* kernel = mm_kernel<V>(per, vector, lanes);
  if (kernel == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  cudaFuncAttributes attr;
  cudaError_t e = cudaFuncGetAttributes(&attr, kernel);
  if (e != cudaSuccess) return static_cast<int>(e);
  *registers = attr.numRegs;
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, kernel, threads, shared_bytes));
}

}  // namespace

extern "C" {

// Lets every instantiation take more than 48 KB of dynamic shared memory on
// the current device and sets its carveout.  Called once, before any
// launch, so that no launch (nor a CUDA graph that captures one) sets an
// attribute.
int merge_csrmm_init() {
  cudaError_t e = set_all_attributes<float>();
  if (e == cudaSuccess) e = set_all_attributes<double>();
  return static_cast<int>(e);
}

// Y (ldy) = alpha * A * X (ldx) + beta * Y_in (ldyin; null: none) over k <=
// 64 columns, with the carry fix-up as the tail: carry_row [G] and
// carry_val [G, k] are its scratch, tickets its counter (null: the
// module's).  per / vector / lanes pick the instantiation
// (ops/plan.py::mm_layout); chunk_tiles tiles of chunk_items merge items at
// most are staged at a time; sm_blocks as for merge_tile_f32.
#define MERGE_TILE_MM_ENTRY(SFX, V)                                           \
  int merge_tile_mm_##SFX(                                                    \
      const void* values, const void* cols, const void* row_end,             \
      const void* x, long long ldx, const void* y_in, long long ldyin,       \
      const void* tile_rows, const void* tile_nnz, double alpha,             \
      double beta, void* y, long long ldy, void* carry_row, void* carry_val, \
      int num_rows, int num_tiles, int run_tiles, int chunk_tiles,           \
      int chunk_items, int sm_blocks, int k, int per, int vector, int lanes, \
      int threads, int shared_bytes, void* tickets, void* stream) {          \
    return launch_merge_tile_mm<V>(                                           \
        values, cols, row_end, x, ldx, y_in, ldyin, tile_rows, tile_nnz,     \
        alpha, beta, y, ldy, carry_row, carry_val, num_rows, num_tiles,      \
        run_tiles, chunk_tiles, chunk_items, sm_blocks, k, per, vector,      \
        lanes, threads, shared_bytes, tickets, stream);                      \
  }                                                                           \
  int merge_tile_mm_occupancy_##SFX(int per, int vector, int lanes,           \
                                    int threads, int shared_bytes,           \
                                    int* blocks_per_sm, int* registers) {    \
    return merge_tile_mm_occupancy<V>(per, vector, lanes, threads,           \
                                      shared_bytes, blocks_per_sm,           \
                                      registers);                            \
  }

MERGE_TILE_MM_ENTRY(f32, float)
MERGE_TILE_MM_ENTRY(f64, double)
#undef MERGE_TILE_MM_ENTRY

const char* merge_csrmm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
