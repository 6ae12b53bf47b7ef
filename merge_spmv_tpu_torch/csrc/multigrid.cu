// HPCG's multigrid V-cycle on Hopper (sm_90a): the colour step of the
// symmetric Gauss-Seidel sweep and the grid transfers of
// models/multigrid.py, beside the residual products (K1).
//
// Replaces no TPU kernel: the JAX package has no preconditioner.  HPCG's
// reference code (src/ComputeSYMGS_ref.cpp, ComputeRestriction_ref.cpp,
// ComputeProlongation_ref.cpp) runs these as loops over rows; here each is
// one launch over the rows it touches:
//
//   symgs_update_kernel   one colour's step over its gathered rows (a CSR
//                         copy of them, all columns): y_i = (A_c x)_i, then
//                         x[rows[i]] += (r[rows[i]] - y_i) / diag[i].  Rows
//                         of one colour share no nonzero but their own
//                         diagonal, so each row's group reads x[rows[i]]
//                         before it alone writes it, and every other x the
//                         launch reads belongs to another colour and stays
//                         as it is: one launch computes what a product and
//                         then an update would, each row summed in its own
//                         order;
//   mg_restrict_kernel    r_c[i] = r[f2c[i]] - Axf[f2c[i]], injection of the
//                         fine residual, and x_c[i] = 0, the coarse level's
//                         start (HPCG zeroes it at the top of ComputeMG);
//   mg_prolong_kernel     x[f2c[i]] += x_c[i].
//
// What bounds them: HBM bytes.  The colour step streams the colour's rows
// of A (a value and a column a nonzero, 8-27 nonzeros a row on HPCG's
// stencil) past x and r, which stay in the 50 MB L2 (9 MB each on 104^3 in
// float64): kLanes lanes a row, so that a warp's loads of consecutive
// rows' values and columns coalesce; each lane loads its 32 / kLanes
// nonzeros of a pass before it gathers x for them, so the loads are in
// flight together; values and columns are read with the evict-first
// hint (__ldcs), x with plain cached loads.  The lanes' sums are reduced by
// shuffles in a fixed order, so a launch gives the same bits every time,
// and the group's first lane writes x.  On the coarse levels (343-17,576
// rows a colour) the launch is latency-bound: one launch a colour step
// instead of two.  The transfers are one pass of coalesced reads over their
// own arrays and scattered reads and writes at f2c[i] (a stride of 2 along
// x: half of each 32-byte sector they touch is used), a thread a row, in
// the order the plain version (models/multigrid_cuda.py) takes, so kernel
// and plain version give the same bits on the same inputs.
//
// A V-cycle's run of launches at one level is a CUDA graph
// (models/multigrid.py::Segment), captured once on a side stream
// (mg_capture_begin / mg_capture_end) from the bound launches of these
// kernels, the level's residual product (K1) and mg_zero (a memset).
// mg_graph_launch runs it on the caller's stream; on a stream that is being
// captured (the solver recording its block) it adds the graph to that
// capture as one child-graph node instead.
//
// Plain C interface (loaded with ctypes): every pointer and the stream are
// void*, every entry returns cudaGetLastError() right after its launch (the
// graph entries: the runtime call's own status).  The kernels allocate
// nothing and launch on the caller's stream.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;   // models/multigrid_cuda.py::THREADS
// lanes a row of a colour step: 8 took less time than 4 or 16 at every
// level of HPCG's 104^3 hierarchy, in float64 and float32, on an H100
constexpr int kLanes = 8;

int blocks_for(int n) { return (n + kThreads - 1) / kThreads; }

// One colour step, kLanes lanes a row of the colour's gathered copy: row
// i's nonzeros lie at [row_ends[i - 1], row_ends[i]) of values and cols.
// A pass takes 32 nonzeros of the row, lane l those at l, l + kLanes, ...:
// first every value and column, then every x, so that they are in flight
// together.  A group never straddles a warp (kLanes divides 32), and a
// group past the last row leaves whole, before any shuffle.
template <typename V>
__global__ void __launch_bounds__(kThreads) symgs_update_kernel(
    V* __restrict__ x, const V* __restrict__ r, const V* __restrict__ values,
    const int* __restrict__ cols, const int* __restrict__ row_ends,
    const int* __restrict__ rows, const V* __restrict__ diag, int n) {
  static_assert(kLanes >= 2 && kLanes <= 16 && 32 % kLanes == 0,
                "a row's lanes divide a warp");
  constexpr int kPer = 32 / kLanes;   // a lane's nonzeros a pass
  const int t = blockIdx.x * kThreads + threadIdx.x;
  const int i = t / kLanes;
  const int lane = t % kLanes;
  if (i >= n) return;
  const unsigned group = ((1u << kLanes) - 1u)
                         << (threadIdx.x % 32 / kLanes * kLanes);
  const int begin = i ? row_ends[i - 1] : 0;
  const int end = row_ends[i];
  int row = 0;
  V ri = V(0), di = V(1);
  if (lane == 0) {
    row = rows[i];
    ri = r[row];
    di = diag[i];
  }
  V sum = V(0);
  for (int base = begin + lane; base < end; base += 32) {
    int c[kPer];
    V a[kPer];
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      const int j = base + u * kLanes;
      c[u] = j < end ? __ldcs(cols + j) : -1;
      a[u] = j < end ? __ldcs(values + j) : V(0);
    }
    V xv[kPer];
#pragma unroll
    for (int u = 0; u < kPer; ++u) xv[u] = c[u] >= 0 ? x[c[u]] : V(0);
#pragma unroll
    for (int u = 0; u < kPer; ++u)
      if (c[u] >= 0) sum += a[u] * xv[u];
  }
#pragma unroll
  for (int offset = kLanes / 2; offset > 0; offset /= 2)
    sum += __shfl_down_sync(group, sum, offset, kLanes);
  if (lane == 0) x[row] += (ri - sum) / di;
}

template <typename V>
__global__ void __launch_bounds__(kThreads) mg_restrict_kernel(
    V* __restrict__ rc, V* __restrict__ xc, const V* __restrict__ r,
    const V* __restrict__ axf, const int* __restrict__ f2c, int n) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const int f = f2c[i];
  rc[i] = r[f] - axf[f];
  xc[i] = V(0);
}

template <typename V>
__global__ void __launch_bounds__(kThreads) mg_prolong_kernel(
    V* __restrict__ x, const V* __restrict__ xc, const int* __restrict__ f2c,
    int n) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  x[f2c[i]] += xc[i];
}

template <typename V>
int launch_symgs_colour(void* x, const void* r, const void* values,
                        const void* cols, const void* row_ends,
                        const void* rows, const void* diag, int n,
                        void* stream) {
  if (n < 1) return cudaErrorInvalidValue;
  const long long threads = static_cast<long long>(n) * kLanes;
  symgs_update_kernel<V><<<static_cast<int>((threads + kThreads - 1) /
                                            kThreads),
                           kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<V*>(x), static_cast<const V*>(r),
      static_cast<const V*>(values), static_cast<const int*>(cols),
      static_cast<const int*>(row_ends), static_cast<const int*>(rows),
      static_cast<const V*>(diag), n);
  return cudaGetLastError();
}

template <typename V>
int launch_restrict(void* rc, void* xc, const void* r, const void* axf,
                    const void* f2c, int n, void* stream) {
  if (n < 1) return cudaErrorInvalidValue;
  mg_restrict_kernel<V><<<blocks_for(n), kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<V*>(rc), static_cast<V*>(xc), static_cast<const V*>(r),
      static_cast<const V*>(axf), static_cast<const int*>(f2c), n);
  return cudaGetLastError();
}

template <typename V>
int launch_prolong(void* x, const void* xc, const void* f2c, int n,
                   void* stream) {
  if (n < 1) return cudaErrorInvalidValue;
  mg_prolong_kernel<V><<<blocks_for(n), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<V*>(x), static_cast<const V*>(xc),
      static_cast<const int*>(f2c), n);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

#define MULTIGRID_ENTRIES(SFX, V)                                            \
  int symgs_colour_##SFX(void* x, const void* r, const void* values,        \
                         const void* cols, const void* row_ends,             \
                         const void* rows, const void* diag, int n,          \
                         void* stream) {                                     \
    return launch_symgs_colour<V>(x, r, values, cols, row_ends, rows, diag,  \
                                  n, stream);                                \
  }                                                                          \
  int mg_restrict_##SFX(void* rc, void* xc, const void* r, const void* axf,  \
                        const void* f2c, int n, void* stream) {              \
    return launch_restrict<V>(rc, xc, r, axf, f2c, n, stream);               \
  }                                                                          \
  int mg_prolong_##SFX(void* x, const void* xc, const void* f2c, int n,      \
                       void* stream) {                                       \
    return launch_prolong<V>(x, xc, f2c, n, stream);                         \
  }

MULTIGRID_ENTRIES(f32, float)
MULTIGRID_ENTRIES(f64, double)

#undef MULTIGRID_ENTRIES

int mg_zero(void* x, long long bytes, void* stream) {
  return cudaMemsetAsync(x, 0, static_cast<size_t>(bytes),
                         static_cast<cudaStream_t>(stream));
}

int mg_capture_begin(void* stream) {
  return cudaStreamBeginCapture(static_cast<cudaStream_t>(stream),
                                cudaStreamCaptureModeThreadLocal);
}

// Ends the capture and instantiates it: *graph and *exec on success, both
// null (and nothing left to free) otherwise.
int mg_capture_end(void* stream, void** graph, void** exec) {
  *graph = nullptr;
  *exec = nullptr;
  cudaGraph_t g = nullptr;
  cudaError_t e = cudaStreamEndCapture(static_cast<cudaStream_t>(stream), &g);
  if (e == cudaSuccess) {
    cudaGraphExec_t x = nullptr;
    e = cudaGraphInstantiateWithFlags(&x, g, 0);
    if (e == cudaSuccess) {
      *graph = g;
      *exec = x;
      return cudaSuccess;
    }
  }
  if (g != nullptr) cudaGraphDestroy(g);
  return e;
}

int mg_graph_launch(void* graph, void* exec, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaStreamCaptureStatus status;
  cudaError_t e = cudaStreamIsCapturing(s, &status);
  if (e != cudaSuccess) return e;
  if (status == cudaStreamCaptureStatusNone)
    return cudaGraphLaunch(static_cast<cudaGraphExec_t>(exec), s);
  if (status != cudaStreamCaptureStatusActive)
    return cudaErrorStreamCaptureInvalidated;
  // recording: the graph becomes one node after the capture's current
  // frontier, and the frontier moves onto it
  cudaGraph_t into = nullptr;
  const cudaGraphNode_t* deps = nullptr;
  size_t num_deps = 0;
#if CUDART_VERSION >= 13000
  e = cudaStreamGetCaptureInfo(s, &status, nullptr, &into, &deps, nullptr,
                               &num_deps);
#else
  e = cudaStreamGetCaptureInfo(s, &status, nullptr, &into, &deps, &num_deps);
#endif
  if (e != cudaSuccess) return e;
  cudaGraphNode_t node = nullptr;
  e = cudaGraphAddChildGraphNode(&node, into, deps, num_deps,
                                 static_cast<cudaGraph_t>(graph));
  if (e != cudaSuccess) return e;
#if CUDART_VERSION >= 13000
  return cudaStreamUpdateCaptureDependencies(
      s, &node, nullptr, 1, cudaStreamSetCaptureDependencies);
#else
  return cudaStreamUpdateCaptureDependencies(s, &node, 1,
                                             cudaStreamSetCaptureDependencies);
#endif
}

// An exec still running on the card is freed when it completes.
int mg_graph_destroy(void* graph, void* exec) {
  cudaError_t e = cudaSuccess;
  if (exec != nullptr)
    e = cudaGraphExecDestroy(static_cast<cudaGraphExec_t>(exec));
  if (graph != nullptr) {
    cudaError_t f = cudaGraphDestroy(static_cast<cudaGraph_t>(graph));
    if (e == cudaSuccess) e = f;
  }
  return e;
}

const char* multigrid_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
