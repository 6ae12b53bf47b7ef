// Merge-path CsrMV for Hopper (sm_90a): a tile kernel and a carry fix-up.
//
// Replaces merge_spmv_tpu/ops/csrmv_pallas.py::_spmv_kernel.  That kernel
// walks the merge tiles in order on one TensorCore and carries the partial
// sum of a row that spans tiles in SMEM.  Here the tiles run in parallel on
// all SMs in no order, so the work goes back to the reference's own
// pipeline (CUB's DeviceSpmvKernel + DeviceSegmentFixupKernel):
//
//   merge_tile_kernel   one thread block per merge tile of
//                       blockDim.x * ITEMS merge items.  Each thread finds its
//                       own diagonal by a merge-path search over the tile's
//                       row ends (staged in shared memory), consumes ITEMS
//                       merge items in sequence, and a block-wide segmented
//                       scan joins the threads' partial sums.  Every row that
//                       ends in the tile is written once,
//                       y[r] = alpha * sum + beta * y_in[r]; the row still
//                       open at the tile's end leaves one carry pair
//                       (row, partial), whose partial is exactly 0 when the
//                       tile ends on a row end.
//   carry_fixup_kernel  adds alpha * (sum of the carries of one row) into y,
//                       summing each row's carries in tile order: no
//                       floating-point atomics, so two calls on the same input
//                       give the same bits.
//
// What bounds it: HBM bytes.  Per nonzero a value and a column index stream
// once, x is gathered through the read-only cache, and per row one row end
// is read and one y written (plan.bytes_accessed()).  The design reads
// values and columns once each through the read-only cache (__ldg), stages
// only the tile's row ends in shared memory, and writes y once per row from
// shared memory with coalesced stores.  The value and column loads are not
// coalesced: each thread consumes kItems consecutive merge items, so the 32
// lanes of a warp read addresses about kItems elements apart and one warp
// load touches up to 32 sectors.  Staging those streams through shared
// memory (cp.async or TMA) is left for later work.  The arithmetic is 2
// flops per nonzero, far below the card's rate.
//
// Plain C interface (loaded with ctypes): every pointer and the stream are
// void*, every entry returns cudaGetLastError() right after its launch.
// Kernels allocate nothing and launch on the caller's stream.

#include <cuda_runtime.h>

namespace {

constexpr int kItems = 8;   // merge items per thread (ops/plan.py)

template <typename V>
__global__ void merge_tile_kernel(
    const V* __restrict__ values, const int* __restrict__ cols,
    const int* __restrict__ row_end, const V* __restrict__ x,
    const V* __restrict__ y_in, const int* __restrict__ tile_rows,
    const int* __restrict__ tile_nnz, V alpha, V beta,
    V* __restrict__ y, int* __restrict__ carry_row,
    V* __restrict__ carry_val) {
  // Shared memory: the tile's row ends, then one partial sum per tile row.
  // Once every thread has consumed its items the row-end area is dead and
  // holds the scan's per-warp scratch instead.
  extern __shared__ __align__(16) unsigned char smem[];
  const int tile_len = blockDim.x * kItems;
  int* s_row_end = reinterpret_cast<int*>(smem);
  V* s_partial = reinterpret_cast<V*>(smem + tile_len * sizeof(int));
  V* s_warp_val = reinterpret_cast<V*>(smem);
  V* s_pref_val = s_warp_val + 32;
  int* s_warp_key = reinterpret_cast<int*>(s_pref_val + 32);
  int* s_pref_key = s_warp_key + 32;

  const int tile = blockIdx.x;
  const int row0 = tile_rows[tile];
  const int nnz0 = tile_nnz[tile];
  const int num_rows = tile_rows[tile + 1] - row0;
  const int num_nnz = tile_nnz[tile + 1] - nnz0;
  const int num_items = num_rows + num_nnz;

  // Coordinates searched at this tile size give num_items <= tile_len; the
  // clamp keeps shared memory in bounds whatever the caller passed.
  const int staged = min(num_rows, tile_len);
  for (int i = threadIdx.x; i < staged; i += blockDim.x)
    s_row_end[i] = __ldg(row_end + row0 + i);
  __syncthreads();

  // Merge-path search for this thread's diagonal inside the tile
  // (cub/thread/thread_search.cuh:53-84): list A = the tile's row ends,
  // list B = the nonzero indices nnz0, nnz0 + 1, ...
  const int d0 = min(static_cast<int>(threadIdx.x) * kItems, num_items);
  const int d1 = min(d0 + kItems, num_items);
  int lo = max(d0 - num_nnz, 0);
  int hi = min(d0, num_rows);
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (s_row_end[mid] <= nnz0 + d0 - mid - 1)
      lo = mid + 1;
    else
      hi = mid;
  }
  int xr = lo;        // tile-local row
  int yn = d0 - lo;   // tile-local nonzero

  // Consume the thread's items: a nonzero while its index is below the
  // current row's end, else that row's end.  The first row this thread
  // completes may have started in earlier threads; its sum is finished
  // after the scan.  Every later row lies wholly inside this thread.
  V running = V(0);
  int first_row = -1;
  V first_partial = V(0);
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    if (d0 + i < d1) {
      if (xr < num_rows && nnz0 + yn >= s_row_end[xr]) {
        if (first_row < 0) {
          first_row = xr;
          first_partial = running;
        } else {
          s_partial[xr] = running;
        }
        running = V(0);
        ++xr;
      } else {
        const int j = nnz0 + yn;
        running += __ldg(values + j) * __ldg(x + __ldg(cols + j));
        ++yn;
      }
    }
  }

  // Block-wide exclusive scan of the (open row, trailing partial) pairs
  // with reduce-by-key: (ka, va) + (kb, vb) = (kb, ka == kb ? va + vb : vb).
  // The keys rise with the thread index, which makes the operator
  // associative.  Every sum below is taken in a fixed order.
  const unsigned full = 0xffffffffu;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int key = xr;
  V val = running;
#pragma unroll
  for (int s = 1; s < 32; s <<= 1) {
    const int k = __shfl_up_sync(full, key, s);
    const V v = __shfl_up_sync(full, val, s);
    if (lane >= s && k == key) val = v + val;
  }
  int ex_key = __shfl_up_sync(full, key, 1);
  V ex_val = __shfl_up_sync(full, val, 1);

  __syncthreads();   // the row ends are no longer read
  if (lane == 31) {
    s_warp_key[warp] = key;
    s_warp_val[warp] = val;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    int pk = -1;
    V pv = V(0);
    for (int w = 0; w < static_cast<int>(blockDim.x >> 5); ++w) {
      s_pref_key[w] = pk;
      s_pref_val[w] = pv;
      const int k = s_warp_key[w];
      V v = s_warp_val[w];
      if (k == pk) v = pv + v;
      pk = k;
      pv = v;
    }
    // The block's total is the carry of the row open at the tile's end.
    carry_row[tile] = row0 + pk;
    carry_val[tile] = pv;
  }
  __syncthreads();
  int pk = s_pref_key[warp];
  V pv = s_pref_val[warp];
  if (lane > 0) {
    if (ex_key == pk) ex_val = pv + ex_val;
    pk = ex_key;
    pv = ex_val;
  }
  if (first_row >= 0)
    s_partial[first_row] = (pk == first_row) ? pv + first_partial
                                             : first_partial;
  __syncthreads();

  for (int i = threadIdx.x; i < staged; i += blockDim.x) {
    const int r = row0 + i;
    V out = alpha * s_partial[i];
    if (y_in != nullptr) out += beta * y_in[r];
    y[r] = out;
  }
}

template <typename V>
__global__ void carry_fixup_kernel(const int* __restrict__ carry_row,
                                   const V* __restrict__ carry_val,
                                   int num_tiles, int num_rows, V alpha,
                                   V* __restrict__ y) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= num_tiles) return;
  const int r = carry_row[t];
  if (r >= num_rows) return;
  if (t > 0 && carry_row[t - 1] == r) return;   // not the first carry of r
  V sum = carry_val[t];
  for (int u = t + 1; u < num_tiles && carry_row[u] == r; ++u)
    sum += carry_val[u];
  y[r] += alpha * sum;
}

template <typename V>
int launch_merge_tile(const void* values, const void* cols,
                      const void* row_end, const void* x, const void* y_in,
                      const void* tile_rows, const void* tile_nnz,
                      double alpha, double beta, void* y, void* carry_row,
                      void* carry_val, int num_tiles, int threads,
                      void* stream) {
  const size_t smem =
      static_cast<size_t>(threads) * kItems * (sizeof(int) + sizeof(V));
  merge_tile_kernel<V><<<num_tiles, threads, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const V*>(values), static_cast<const int*>(cols),
      static_cast<const int*>(row_end), static_cast<const V*>(x),
      static_cast<const V*>(y_in), static_cast<const int*>(tile_rows),
      static_cast<const int*>(tile_nnz), static_cast<V>(alpha),
      static_cast<V>(beta), static_cast<V*>(y),
      static_cast<int*>(carry_row), static_cast<V*>(carry_val));
  return static_cast<int>(cudaGetLastError());
}

template <typename V>
int launch_carry_fixup(const void* carry_row, const void* carry_val,
                       int num_tiles, int num_rows, double alpha, void* y,
                       void* stream) {
  const int threads = 256;
  const int blocks = (num_tiles + threads - 1) / threads;
  carry_fixup_kernel<V><<<blocks, threads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(carry_row), static_cast<const V*>(carry_val),
      num_tiles, num_rows, static_cast<V>(alpha), static_cast<V*>(y));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int merge_tile_f32(const void* values, const void* cols, const void* row_end,
                   const void* x, const void* y_in, const void* tile_rows,
                   const void* tile_nnz, double alpha, double beta, void* y,
                   void* carry_row, void* carry_val, int num_tiles,
                   int threads, void* stream) {
  return launch_merge_tile<float>(values, cols, row_end, x, y_in, tile_rows,
                                  tile_nnz, alpha, beta, y, carry_row,
                                  carry_val, num_tiles, threads, stream);
}

int merge_tile_f64(const void* values, const void* cols, const void* row_end,
                   const void* x, const void* y_in, const void* tile_rows,
                   const void* tile_nnz, double alpha, double beta, void* y,
                   void* carry_row, void* carry_val, int num_tiles,
                   int threads, void* stream) {
  return launch_merge_tile<double>(values, cols, row_end, x, y_in, tile_rows,
                                   tile_nnz, alpha, beta, y, carry_row,
                                   carry_val, num_tiles, threads, stream);
}

int carry_fixup_f32(const void* carry_row, const void* carry_val,
                    int num_tiles, int num_rows, double alpha, void* y,
                    void* stream) {
  return launch_carry_fixup<float>(carry_row, carry_val, num_tiles, num_rows,
                                   alpha, y, stream);
}

int carry_fixup_f64(const void* carry_row, const void* carry_val,
                    int num_tiles, int num_rows, double alpha, void* y,
                    void* stream) {
  return launch_carry_fixup<double>(carry_row, carry_val, num_tiles,
                                    num_rows, alpha, y, stream);
}

const char* merge_csrmv_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
