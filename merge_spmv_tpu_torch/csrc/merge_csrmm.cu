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
// run order, kTail pairs a walker at a time.  No floating-point atomics:
// two calls give the same bits.
//
// Inside a run.  The block walks its tiles in chunks of chunk_tiles tiles
// (about 2048 merge items).  A chunk's row ends, column indices and values
// are copied into one of two shared-memory stages by cp.async, the next
// chunk's while this one is reduced.  Its merge items are then split evenly
// between walkers: a walker is kLanes lanes of a warp (32 / kLanes walkers a
// warp), its lane l holding kPer of the k columns, columns l * kPer + e
// (kVector: one vector load of kPer values) or l + e * kLanes (strided
// scalar loads).  A walker finds its start and end on the chunk's merge path
// by a binary search over the staged row ends, then walks its nonzeros in
// order, kBatch X rows in flight: closes every row that ends before the
// next nonzero, adds value * X[col, :] into its k-wide partial.  The first
// row a walker closes may have begun before it; every later one began in it
// and is written at once, Y[r, :] = alpha * sum + beta * Y_in[r, :], one
// coalesced store per row.  A segmented scan across the walkers (shuffles
// within a warp, the warps' totals through shared memory) gives each
// walker's first row the partial carried from the walkers, chunks and tiles
// before it, and the chunk's carry into the next.
//
// What bounds it.  A is read once: a value and a column index per nonzero,
// a row end per row; X and Y once each: spmm_bytes (bench/measure.py).  But
// X rows are gathered once per nonzero, nnz * k * sizeof(V) bytes from L1 or
// L2 (512 MB at k = 32 on the cant class against 48 MB of HBM bytes), so
// only L1 hits bring the kernel to the bytes bound; the L2's rate for whole
// 32 B and 128 B requests (tools/gather_rate.py, rows class) gives the
// gather bound.  Hence: four blocks of 256 threads per SM on neighbouring
// runs, the carveout set (merge_csrmm_init) to what their stages need, so
// that the rest of the SM's 256 KB is L1 for the X window that a banded
// matrix's neighbouring rows share; kBatch gathers in flight per walker; A's
// streams copied asynchronously a chunk ahead.  Measured
// (tools/mm_ablation.py, PERF.md): neither the gather's scatter nor L1's
// capacity bounds it on the cant and pdb1HYS classes; the walk does (its
// serial chain of gathers and adds at 32 warps an SM), then the search and
// the scan each chunk costs; blocks of 256 threads beat 512 (their barriers
// stall fewer warps), most at k = 8.
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
constexpr int kBatch = 4;             // X rows a walker keeps in flight
constexpr int kTail = 4;              // carry pairs a walker fixes at once
constexpr int kBlocksPerSm = 4;       // __launch_bounds__: 64 registers
constexpr int kChunkItems = 2048;     // ops/plan.py::MM_CHUNK_ITEMS
constexpr int kMaxSharedBytes = 232448;
constexpr int kSmSharedBytes = 233472;
constexpr int kBlockReserved = 1024;

// Dynamic shared memory (ops/plan.py::mm_shared_bytes repeats it): the
// warps' scan totals (kWarps x width values, width = kLanes * kPer), their
// flags (kWarps ints), and two stages of chunk_items * (sizeof(V) + 4)
// bytes: the values, then one int array holding the chunk's row ends
// followed by its column indices (rows + nonzeros <= chunk_items).
template <typename V>
__host__ __device__ constexpr size_t mm_shared_bytes(int chunk_items,
                                                     int width) {
  return static_cast<size_t>(kWarps) * width * sizeof(V) + kWarps * 4 +
         2 * static_cast<size_t>(chunk_items) * (sizeof(V) + 4);
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

template <int kSize>
__device__ __forceinline__ void copy_async(void* dst, const void* src) {
  if constexpr (kSize == 8)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;"
                 :: "r"(smem_u32(dst)), "l"(src) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;"
                 :: "r"(smem_u32(dst)), "l"(src) : "memory");
}

// The block copies chunk (rows [r0, r1), nonzeros [n0, n1)) into a stage:
// values at s_val, row ends then column indices at s_int, one cp.async per
// element, as one commit group.  The clamp keeps the stage in bounds
// whatever coordinates the caller passed.
template <typename V>
__device__ __forceinline__ void stage_chunk(const V* values, const int* cols,
                                            const int* row_end, int r0,
                                            int r1, int n0, int n1,
                                            int chunk_items, V* s_val,
                                            int* s_int) {
  const int nnz = min(max(n1 - n0, 0), chunk_items);
  const int rows = min(max(r1 - r0, 0), chunk_items - nnz);
  for (int i = threadIdx.x; i < rows; i += blockDim.x)
    copy_async<4>(s_int + i, row_end + r0 + i);
  for (int j = threadIdx.x; j < nnz; j += blockDim.x) {
    copy_async<4>(s_int + rows + j, cols + n0 + j);
    copy_async<sizeof(V)>(s_val + j, values + n0 + j);
  }
  asm volatile("cp.async.commit_group;" ::: "memory");
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
  V* s_wtot = reinterpret_cast<V*>(smem);
  int* s_wflag = reinterpret_cast<int*>(s_wtot + kWarps * kWidth);
  unsigned char* stages = reinterpret_cast<unsigned char*>(s_wflag + kWarps);
  const size_t stage_len =
      static_cast<size_t>(chunk_items) * (sizeof(V) + 4);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;
  const int wl = lane % kLanes;           // lane within the walker
  const int p = lane / kLanes;            // walker within the warp
  const int walker = warp * kWalkersPerWarp + p;
  const int num_walkers = blockDim.x / kLanes;
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

  // Chunk c is tiles [first + c * chunk_tiles, ...) up to end; (r_lo, n_lo)
  // and (r_hi, n_hi) are its merge coordinates, (r_nx, n_nx) the next
  // chunk's end, loaded a chunk ahead of its copy.
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
              reinterpret_cast<V*>(stages),
              reinterpret_cast<int*>(stages + chunk_items * sizeof(V)));

  V cin[kPer];   // the partial of the row open at the chunk's start
#pragma unroll
  for (int e = 0; e < kPer; ++e) cin[e] = V(0);

  for (int c = 0; c < num_chunks; ++c) {
    unsigned char* stage = stages + (c & 1) * stage_len;
    if (c + 1 < num_chunks) {
      unsigned char* next = stages + ((c + 1) & 1) * stage_len;
      stage_chunk(values, cols, row_end, r_hi, r_nx, n_hi, n_nx,
                  chunk_items, reinterpret_cast<V*>(next),
                  reinterpret_cast<int*>(next + chunk_items * sizeof(V)));
      asm volatile("cp.async.wait_group 1;" ::: "memory");
    } else {
      asm volatile("cp.async.wait_group 0;" ::: "memory");
    }
    int r_nn = 0, n_nn = 0;   // chunk c + 2's end
    const int t_nn = min(t_nx + chunk_tiles, end);
    if (c + 2 < num_chunks) {
      r_nn = __ldg(tile_rows + t_nn);
      n_nn = __ldg(tile_nnz + t_nn);
    }
    __syncthreads();   // every thread's copies of chunk c have landed

    const int nnz = min(max(n_hi - n_lo, 0), chunk_items);
    const int rows = min(max(r_hi - r_lo, 0), chunk_items - nnz);
    const V* s_val = reinterpret_cast<const V*>(stage);
    const int* s_re = reinterpret_cast<const int*>(stage +
                                                   chunk_items * sizeof(V));
    const int* s_col = s_re + rows;
    const int items = rows + nnz;
    const int share = (items + num_walkers - 1) / num_walkers;
    const int d0 = min(walker * share, items);
    const int d1 = min(d0 + share, items);
    int i = merge_search(s_re, n_lo, rows, nnz, d0);
    const int i_end = merge_search(s_re, n_lo, rows, nnz, d1);
    const int j_end = d1 - i_end;

    // The walk.  `acc` is the sum since the last row end; the first row
    // closed keeps its partial in `first` for the scan.
    V acc[kPer], first[kPer];
#pragma unroll
    for (int e = 0; e < kPer; ++e) acc[e] = first[e] = V(0);
    int closed = 0, first_row = 0;
    for (int jb = d0 - i; jb < j_end; jb += kBatch) {
      V xv[kBatch][kPer];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        if (jb + u < j_end) {
          load_row<V, kPer, kVector, kLanes, false>(
              X + static_cast<long long>(s_col[jb + u]) * ldx, wl, k, xv[u]);
        } else {
#pragma unroll
          for (int e = 0; e < kPer; ++e) xv[u][e] = V(0);
        }
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int j = jb + u;
        if (j >= j_end) break;
        for (; i < i_end && s_re[i] - n_lo <= j; ++i) {
          if (closed) {
            write_row<V, kPer, kVector, kLanes>(
                Y, ldy, y_in, ldyin, static_cast<long long>(r_lo) + i, wl, k,
                alpha, beta, acc);
          } else {
            closed = 1;
            first_row = i;
#pragma unroll
            for (int e = 0; e < kPer; ++e) first[e] = acc[e];
          }
#pragma unroll
          for (int e = 0; e < kPer; ++e) acc[e] = V(0);
        }
        const V a = s_val[j];
#pragma unroll
        for (int e = 0; e < kPer; ++e) acc[e] += a * xv[u][e];
      }
    }
    for (; i < i_end; ++i) {   // rows that end after the walker's last nonzero
      if (closed) {
        write_row<V, kPer, kVector, kLanes>(
            Y, ldy, y_in, ldyin, static_cast<long long>(r_lo) + i, wl, k,
            alpha, beta, acc);
      } else {
        closed = 1;
        first_row = i;
#pragma unroll
        for (int e = 0; e < kPer; ++e) first[e] = acc[e];
      }
#pragma unroll
      for (int e = 0; e < kPer; ++e) acc[e] = V(0);
    }
    __syncwarp();

    // Segmented scan of the walkers' (closed a row, open partial) pairs, a
    // before b: b's partial restarts after a row end.  Within the warp by
    // shuffles over walkers, kLanes lanes apart; then across the warps'
    // totals in shared memory, entered by the chunk's carry.
    int f = closed;
    V v[kPer];
#pragma unroll
    for (int e = 0; e < kPer; ++e) v[e] = acc[e];
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
    __syncthreads();
    V pv[kPer], mv[kPer];   // prefix of all warps so far; of those before
#pragma unroll
    for (int e = 0; e < kPer; ++e) pv[e] = mv[e] = cin[e];
    for (int q = 0; q < nwarps; ++q) {
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
    if (closed) {
      V s[kPer];
#pragma unroll
      for (int e = 0; e < kPer; ++e) s[e] = (ef ? ev[e] : mv[e] + ev[e]) + first[e];
      write_row<V, kPer, kVector, kLanes>(
          Y, ldy, y_in, ldyin, static_cast<long long>(r_lo) + first_row, wl,
          k, alpha, beta, s);
    }
#pragma unroll
    for (int e = 0; e < kPer; ++e) cin[e] = pv[e];
    __syncthreads();   // the stage and the warp totals are free again

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

  // The fix-up as the tail, as K1's: once the block's rows and pair are
  // written, thread 0 takes a ticket with an acquire-release increment at
  // device scope that wraps the counter to 0 at the last ticket; the block
  // that takes it adds, for every row r < num_rows whose first carry is
  // pair t, alpha * (r's carries, in run order) into Y[r, :], reading what
  // other blocks wrote through L2.
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
  // kTail pairs a walker at a time, their loads issued together: a
  // pair's row, its neighbours' rows and its carry, then the Y rows of the
  // pairs that lead their row; a row with several carries (rare) sums the
  // rest in run order.
  const int num_pairs = static_cast<int>(gridDim.x);
  for (int base = walker; base < num_pairs; base += num_walkers * kTail) {
    int r[kTail], r_next[kTail];
    bool lead[kTail];
    V s[kTail][kPer];
#pragma unroll
    for (int u = 0; u < kTail; ++u) {
      const int t = base + u * num_walkers;
      lead[u] = false;
      r[u] = r_next[u] = -1;
      if (t < num_pairs) {
        r[u] = __ldcg(carry_row + t);
        const int r_before = __ldcg(carry_row + max(t - 1, 0));
        r_next[u] = t + 1 < num_pairs ? __ldcg(carry_row + t + 1) : -1;
        lead[u] = r[u] < num_rows && (t == 0 || r_before != r[u]);
        load_row<V, kPer, kVector, kLanes, true>(
            carry_val + static_cast<long long>(t) * k, wl, k, s[u]);
      }
    }
    V yv[kTail][kPer];
#pragma unroll
    for (int u = 0; u < kTail; ++u) {
      if (!lead[u]) continue;
      if (r_next[u] == r[u]) {
        const int t = base + u * num_walkers;
        for (int w = t + 1; w < num_pairs && __ldcg(carry_row + w) == r[u];
             ++w) {
          V more[kPer];
          load_row<V, kPer, kVector, kLanes, true>(
              carry_val + static_cast<long long>(w) * k, wl, k, more);
#pragma unroll
          for (int e = 0; e < kPer; ++e) s[u][e] += more[e];
        }
      }
      load_row<V, kPer, kVector, kLanes, true>(
          Y + static_cast<long long>(r[u]) * ldy, wl, k, yv[u]);
    }
#pragma unroll
    for (int u = 0; u < kTail; ++u) {
      if (!lead[u]) continue;
#pragma unroll
      for (int e = 0; e < kPer; ++e) yv[u][e] += alpha * s[u][e];
      store_row<V, kPer, kVector, kLanes>(
          Y + static_cast<long long>(r[u]) * ldy, wl, k, yv[u]);
    }
  }
}

// The instantiation for (per, vector, lanes); null for a layout it lacks.
// kVector with kPer values a lane (one 4, 8 or 16-byte load), or strided
// with two (k of 33-64 columns that allow no vector load).
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

// Every layout the wrapper may pick, for the attributes set at init.
template <typename V>
cudaError_t for_each_kernel(cudaError_t (*fn)(const void*)) {
  cudaError_t e = cudaSuccess;
  const int pers[] = {1, 2, 4};
  for (int per : pers)
    for (int lanes = 1; lanes <= 32 && e == cudaSuccess; lanes <<= 1) {
      const void* kernel = mm_kernel<V>(per, 1, lanes);
      if (kernel != nullptr) e = fn(kernel);
    }
  if (e == cudaSuccess) e = fn(mm_kernel<V>(2, 0, 32));
  return e;
}

// The carveout that holds kBlocksPerSm blocks at the default chunk and the
// widest k: the rest of the SM's 256 KB is L1 for the X window.
template <typename V>
int mm_carveout() {
  const size_t need =
      kBlocksPerSm * (mm_shared_bytes<V>(kChunkItems, kMaxK) +
                      kBlockReserved);
  return static_cast<int>((need * 100 + kSmSharedBytes - 1) /
                          kSmSharedBytes);
}

template <typename V>
cudaError_t set_attributes(const void* kernel) {
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSharedBytes);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             mm_carveout<V>());
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
      chunk_items < 1 || threads != kThreads ||
      static_cast<size_t>(shared_bytes) !=
          mm_shared_bytes<V>(chunk_items, per * lanes))
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
  cudaError_t e = for_each_kernel<float>(set_attributes<float>);
  if (e == cudaSuccess) e = for_each_kernel<double>(set_attributes<double>);
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
