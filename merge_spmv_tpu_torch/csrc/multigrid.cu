// HPCG's multigrid V-cycle on Hopper (sm_90a): the three vector kernels
// around the merge-path products of models/multigrid.py.
//
// Replaces no TPU kernel: the JAX package has no preconditioner.  HPCG's
// reference code (src/ComputeSYMGS_ref.cpp, ComputeRestriction_ref.cpp,
// ComputeProlongation_ref.cpp) runs these as loops over rows; here each is
// one launch over the rows it touches:
//
//   symgs_update_kernel   after the colour's product y = A_c x (K1 on the
//                         colour's rows, a gathered copy of them):
//                         x[rows[i]] += (r[rows[i]] - y[i]) / diag[i], the
//                         Gauss-Seidel update of one colour's rows.  Rows of
//                         one colour share no nonzero, so the product read
//                         every x it needs before any of them changes;
//   mg_restrict_kernel    r_c[i] = r[f2c[i]] - Axf[f2c[i]], injection of the
//                         fine residual, and x_c[i] = 0, the coarse level's
//                         start (HPCG zeroes it at the top of ComputeMG);
//   mg_prolong_kernel     x[f2c[i]] += x_c[i].
//
// What bounds them: HBM bytes, a few values a row, against the product's
// ~27 nonzeros a row; each is one pass of coalesced reads over its own
// arrays and scattered reads and writes at rows[i] or f2c[i] (a stride of 2
// along x: half of each 32-byte sector they touch is used).  A thread a row,
// no reduction: each result is one row's arithmetic, in the order the plain
// version (models/multigrid_cuda.py) takes, so kernel and plain version give
// the same bits on the same inputs.
//
// A V-cycle's run of launches at one level is a CUDA graph
// (models/multigrid.py::Segment), captured once on a side stream
// (mg_capture_begin / mg_capture_end) from the bound launches of these
// kernels, the colours' K1 products and the level's residual product, and
// of mg_zero (a memset).  mg_graph_launch runs it on the caller's stream;
// on a stream that is being captured (the solver recording its block) it
// adds the graph to that capture as one child-graph node instead.
//
// Plain C interface (loaded with ctypes): every pointer and the stream are
// void*, every entry returns cudaGetLastError() right after its launch (the
// graph entries: the runtime call's own status).  The kernels allocate
// nothing and launch on the caller's stream.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;   // models/multigrid_cuda.py::THREADS

int blocks_for(int n) { return (n + kThreads - 1) / kThreads; }

template <typename V>
__global__ void __launch_bounds__(kThreads) symgs_update_kernel(
    V* __restrict__ x, const V* __restrict__ r, const V* __restrict__ y,
    const int* __restrict__ rows, const V* __restrict__ diag, int n) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const int row = rows[i];
  x[row] += (r[row] - y[i]) / diag[i];
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
int launch_symgs_update(void* x, const void* r, const void* y,
                        const void* rows, const void* diag, int n,
                        void* stream) {
  if (n < 1) return cudaErrorInvalidValue;
  symgs_update_kernel<V><<<blocks_for(n), kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<V*>(x), static_cast<const V*>(r),
      static_cast<const V*>(y), static_cast<const int*>(rows),
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
  int symgs_update_##SFX(void* x, const void* r, const void* y,              \
                         const void* rows, const void* diag, int n,          \
                         void* stream) {                                     \
    return launch_symgs_update<V>(x, r, y, rows, diag, n, stream);           \
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
