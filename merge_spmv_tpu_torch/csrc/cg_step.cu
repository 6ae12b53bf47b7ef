// Conjugate gradient's masked step on Hopper (sm_90a): the vector work
// around the operator's product ap = A p, in three fused kernels.
//
// Replaces no TPU kernel: the JAX package runs CG's vector updates and dot
// products as XLA ops around its Pallas product (merge_spmv_tpu/models/
// solvers.py::conjugate_gradient).  In PyTorch those are ~24 small kernels a
// step, each reading and writing whole vectors; captured in a CUDA graph the
// recording, the instantiation and the eager block pay for each of them
// (models/solvers.py).  Here one step is the product plus
//
//   cg_pap_kernel        act = (rs > tol2) & (k < maxiter), stored for the
//                        step's two later kernels; per-block partials of
//                        p . ap; the last block to arrive sums the partials
//                        and writes alpha = rs / (p . ap);
//   cg_update_kernel     where act: x += alpha p, r -= alpha ap, with
//                        per-block partials of r . r (the new r); the last
//                        block writes rs_n, beta = rs_n / rs, rs = rs_n and
//                        k += 1;
//   cg_direction_kernel  where act: p = r + beta p.
//
// The Hestenes-Stiefel recurrence of the torch step, term for term.  Once act
// is false no kernel writes x, r, p, rs or k, so the state keeps its bits, as
// the torch step's masked commit keeps them.
//
// Preconditioned CG (HPCG's timed solve, z = M r by models/multigrid.py's
// V-cycle) takes the same product and direction and three kernels of its own:
//
//   pcg_pap_kernel       act as above (on rs = r . r); alpha = rz / (p . ap);
//   pcg_update_kernel    where act: x += alpha p, r -= alpha ap, rs = r . r,
//                        k += 1 (no beta: it waits for z);
//   (the V-cycle         z = M r, models/multigrid.py)
//   pcg_rz_kernel        where act: rz_n = r . z, beta = rz_n / rz, rz = rz_n;
//   cg_direction_kernel  where act: p = z + beta p (z in r's place).
//
// Each shares its body with its CG counterpart (pap_body, update_body), so
// the CG kernels compute what they did, term for term.
//
// What bounds it: HBM bytes.  A step's vector passes are p and ap read
// (cg_pap), x, r read and written, p and ap read (cg_update), r and p read, p
// written (cg_direction): 11 passes of n values, against the ~20 of the torch
// ops.  In CG's sequence the product streams the matrix between steps, but
// within a step cg_update finds p and ap, and cg_direction r and p, where
// the kernel before left them in L2, so 7 of the 11 cross HBM.  The
// arithmetic is 2 flops a value a pass, far below the card's rate.
// Each kernel is one resident wave (at most kMaxBlocks blocks of kThreads,
// eight blocks an SM) in a grid-stride loop of coalesced loads.  Three
// launches are kept apart, not merged behind a grid-wide barrier: the
// barrier saves one launch a step (a few microseconds inside a graph), and
// would need every block resident at once.
//
// Sums in a fixed order, with no floating-point atomics: each thread sums its
// grid-stride values in index order, a block sums its threads by a fixed
// shuffle tree and its warps in order, the last block sums the partials in
// block order the same way.  The grid depends on n alone, so every call,
// eager or replayed, gives the same bits.  Values and sums are in the
// operand type, float or double.
//
// The last block is found by a ticket: thread 0 of each block, once its
// partial is written, takes one with an acquire-release increment at device
// scope that wraps the counter to 0 at the last ticket (K1's tail,
// csrc/merge_csrmv.cu), so the counter is 0 again for the next kernel
// without a store of its own.  A masked step takes no ticket.
//
// Plain C interface (loaded with ctypes): every pointer and the stream are
// void*, every entry returns cudaGetLastError() right after its launch.  The
// kernels allocate nothing and launch on the caller's stream.  Their state
// (models/cg_cuda.py): rs, tol2 (0-dim, the value type), k (0-dim int32),
// flags [act, ticket] (int32, the ticket 0 at the first launch) and work
// [alpha, beta, partials of the grid's blocks] (the value type).  Launches
// that share the state must be stream-ordered.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxBlocks = 1024;    // models/cg_cuda.py::MAX_BLOCKS
constexpr int kAlpha = 0;           // work[]
constexpr int kBeta = 1;
constexpr int kPartials = 2;
constexpr int kAct = 0;             // flags[]
constexpr int kTicket = 1;

// The block's sum of v, in a fixed order: a shuffle tree in each warp, then
// the warp totals in warp order.  The result is thread 0's.  s_warp holds
// kWarps values; the barrier inside orders its writes.
template <typename V>
__device__ V block_sum(V v, V* s_warp) {
  for (int offset = 16; offset > 0; offset >>= 1)
    v += __shfl_down_sync(0xffffffffu, v, offset);
  if ((threadIdx.x & 31) == 0) s_warp[threadIdx.x >> 5] = v;
  __syncthreads();
  V total = V(0);
  if (threadIdx.x == 0)
    for (int w = 0; w < kWarps; ++w) total += s_warp[w];
  return total;
}

// Writes the block's partial, then says whether this block took the last
// ticket; that block sees every other block's partial.
template <typename V>
__device__ bool last_block(V partial, V* partials, unsigned int* ticket) {
  __shared__ int s_last;
  if (threadIdx.x == 0) {
    partials[blockIdx.x] = partial;
    unsigned int taken;
    asm volatile("atom.acq_rel.gpu.inc.u32 %0, [%1], %2;"
                 : "=r"(taken) : "l"(ticket), "r"(gridDim.x - 1)
                 : "memory");
    s_last = taken == gridDim.x - 1;
  }
  __syncthreads();
  return s_last != 0;
}

// The sum of the grid's partials, in block order (thread 0's), read past L1.
template <typename V>
__device__ V sum_partials(const V* partials, V* s_warp) {
  V v = V(0);
  for (unsigned int b = threadIdx.x; b < gridDim.x; b += kThreads)
    v += __ldcg(partials + b);
  return block_sum(v, s_warp);
}

// act = (rs > tol2) & (k < maxiter), stored for the step's later kernels;
// where act, alpha = rho / (p . ap), rho being rs (CG) or rz (PCG).
template <typename V>
__device__ void pap_body(const V* __restrict__ p, const V* __restrict__ ap,
                         long long n, const V* __restrict__ rs,
                         const V* __restrict__ rho,
                         const V* __restrict__ tol2,
                         const int* __restrict__ k, int maxiter, int* flags,
                         V* work) {
  __shared__ V s_warp[kWarps];
  const bool act = (*rs > *tol2) && (*k < maxiter);
  if (blockIdx.x == 0 && threadIdx.x == 0) flags[kAct] = act;
  if (!act) return;
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  V acc = V(0);
  for (long long i = static_cast<long long>(blockIdx.x) * kThreads +
                     threadIdx.x;
       i < n; i += stride)
    acc += p[i] * ap[i];
  const V partial = block_sum(acc, s_warp);
  unsigned int* ticket = reinterpret_cast<unsigned int*>(flags + kTicket);
  if (!last_block(partial, work + kPartials, ticket)) return;
  const V pap = sum_partials(work + kPartials, s_warp);
  if (threadIdx.x == 0) work[kAlpha] = *rho / pap;
}

template <typename V>
__global__ void __launch_bounds__(kThreads) cg_pap_kernel(
    const V* __restrict__ p, const V* __restrict__ ap, long long n,
    const V* __restrict__ rs, const V* __restrict__ tol2,
    const int* __restrict__ k, int maxiter, int* flags, V* work) {
  pap_body(p, ap, n, rs, rs, tol2, k, maxiter, flags, work);
}

template <typename V>
__global__ void __launch_bounds__(kThreads) pcg_pap_kernel(
    const V* __restrict__ p, const V* __restrict__ ap, long long n,
    const V* __restrict__ rs, const V* __restrict__ rz,
    const V* __restrict__ tol2, const int* __restrict__ k, int maxiter,
    int* flags, V* work) {
  pap_body(p, ap, n, rs, rz, tol2, k, maxiter, flags, work);
}

// Where act: x += alpha p, r -= alpha ap, rs = r . r (the new r), k += 1,
// and with kWithBeta (CG) beta = rs_n / rs before rs is replaced.
template <typename V, bool kWithBeta>
__device__ void update_body(V* __restrict__ x, V* __restrict__ r,
                            const V* __restrict__ p,
                            const V* __restrict__ ap, long long n, V* rs,
                            int* k, int* flags, V* work) {
  __shared__ V s_warp[kWarps];
  if (!flags[kAct]) return;
  const V alpha = work[kAlpha];
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  V acc = V(0);
  for (long long i = static_cast<long long>(blockIdx.x) * kThreads +
                     threadIdx.x;
       i < n; i += stride) {
    x[i] += alpha * p[i];
    const V r_n = r[i] - alpha * ap[i];
    r[i] = r_n;
    acc += r_n * r_n;
  }
  const V partial = block_sum(acc, s_warp);
  unsigned int* ticket = reinterpret_cast<unsigned int*>(flags + kTicket);
  if (!last_block(partial, work + kPartials, ticket)) return;
  const V rs_n = sum_partials(work + kPartials, s_warp);
  if (threadIdx.x == 0) {
    if (kWithBeta) work[kBeta] = rs_n / *rs;
    *rs = rs_n;
    *k += 1;
  }
}

template <typename V>
__global__ void __launch_bounds__(kThreads) cg_update_kernel(
    V* __restrict__ x, V* __restrict__ r, const V* __restrict__ p,
    const V* __restrict__ ap, long long n, V* rs, int* k, int* flags,
    V* work) {
  update_body<V, true>(x, r, p, ap, n, rs, k, flags, work);
}

template <typename V>
__global__ void __launch_bounds__(kThreads) pcg_update_kernel(
    V* __restrict__ x, V* __restrict__ r, const V* __restrict__ p,
    const V* __restrict__ ap, long long n, V* rs, int* k, int* flags,
    V* work) {
  update_body<V, false>(x, r, p, ap, n, rs, k, flags, work);
}

// Where act, after z = M r: rz_n = r . z, beta = rz_n / rz, rz = rz_n.
template <typename V>
__global__ void __launch_bounds__(kThreads) pcg_rz_kernel(
    const V* __restrict__ r, const V* __restrict__ z, long long n, V* rz,
    int* flags, V* work) {
  __shared__ V s_warp[kWarps];
  if (!flags[kAct]) return;
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  V acc = V(0);
  for (long long i = static_cast<long long>(blockIdx.x) * kThreads +
                     threadIdx.x;
       i < n; i += stride)
    acc += r[i] * z[i];
  const V partial = block_sum(acc, s_warp);
  unsigned int* ticket = reinterpret_cast<unsigned int*>(flags + kTicket);
  if (!last_block(partial, work + kPartials, ticket)) return;
  const V rz_n = sum_partials(work + kPartials, s_warp);
  if (threadIdx.x == 0) {
    work[kBeta] = rz_n / *rz;
    *rz = rz_n;
  }
}

template <typename V>
__global__ void __launch_bounds__(kThreads) cg_direction_kernel(
    V* __restrict__ p, const V* __restrict__ r, long long n,
    const int* __restrict__ flags, const V* __restrict__ work) {
  if (!flags[kAct]) return;
  const V beta = work[kBeta];
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long i = static_cast<long long>(blockIdx.x) * kThreads +
                     threadIdx.x;
       i < n; i += stride)
    p[i] = r[i] + beta * p[i];
}

// The wrapper's grid: 1 to kMaxBlocks blocks.
bool valid_grid(int blocks) { return blocks >= 1 && blocks <= kMaxBlocks; }

template <typename V>
int launch_pap(const void* p, const void* ap, long long n, const void* rs,
               const void* tol2, const void* k, int maxiter, void* flags,
               void* work, int blocks, void* stream) {
  if (!valid_grid(blocks)) return cudaErrorInvalidValue;
  cg_pap_kernel<V><<<blocks, kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const V*>(p), static_cast<const V*>(ap), n,
      static_cast<const V*>(rs), static_cast<const V*>(tol2),
      static_cast<const int*>(k), maxiter, static_cast<int*>(flags),
      static_cast<V*>(work));
  return cudaGetLastError();
}

template <typename V>
int launch_update(void* x, void* r, const void* p, const void* ap,
                  long long n, void* rs, void* k, void* flags, void* work,
                  int blocks, void* stream) {
  if (!valid_grid(blocks)) return cudaErrorInvalidValue;
  cg_update_kernel<V><<<blocks, kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<V*>(x), static_cast<V*>(r), static_cast<const V*>(p),
      static_cast<const V*>(ap), n, static_cast<V*>(rs),
      static_cast<int*>(k), static_cast<int*>(flags),
      static_cast<V*>(work));
  return cudaGetLastError();
}

template <typename V>
int launch_direction(void* p, const void* r, long long n, const void* flags,
                     const void* work, int blocks, void* stream) {
  if (!valid_grid(blocks)) return cudaErrorInvalidValue;
  cg_direction_kernel<V><<<blocks, kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<V*>(p), static_cast<const V*>(r), n,
      static_cast<const int*>(flags), static_cast<const V*>(work));
  return cudaGetLastError();
}

template <typename V>
int launch_pcg_pap(const void* p, const void* ap, long long n,
                   const void* rs, const void* rz, const void* tol2,
                   const void* k, int maxiter, void* flags, void* work,
                   int blocks, void* stream) {
  if (!valid_grid(blocks)) return cudaErrorInvalidValue;
  pcg_pap_kernel<V><<<blocks, kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const V*>(p), static_cast<const V*>(ap), n,
      static_cast<const V*>(rs), static_cast<const V*>(rz),
      static_cast<const V*>(tol2), static_cast<const int*>(k), maxiter,
      static_cast<int*>(flags), static_cast<V*>(work));
  return cudaGetLastError();
}

template <typename V>
int launch_pcg_update(void* x, void* r, const void* p, const void* ap,
                      long long n, void* rs, void* k, void* flags,
                      void* work, int blocks, void* stream) {
  if (!valid_grid(blocks)) return cudaErrorInvalidValue;
  pcg_update_kernel<V><<<blocks, kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<V*>(x), static_cast<V*>(r), static_cast<const V*>(p),
      static_cast<const V*>(ap), n, static_cast<V*>(rs),
      static_cast<int*>(k), static_cast<int*>(flags),
      static_cast<V*>(work));
  return cudaGetLastError();
}

template <typename V>
int launch_pcg_rz(const void* r, const void* z, long long n, void* rz,
                  void* flags, void* work, int blocks, void* stream) {
  if (!valid_grid(blocks)) return cudaErrorInvalidValue;
  pcg_rz_kernel<V><<<blocks, kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const V*>(r), static_cast<const V*>(z), n,
      static_cast<V*>(rz), static_cast<int*>(flags), static_cast<V*>(work));
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// blocks: the grid, 1 to 1,024 (models/cg_cuda.py::grid_blocks(n)); work
// holds 2 + blocks values.
#define CG_STEP_ENTRIES(SFX, V)                                              \
  int cg_pap_##SFX(const void* p, const void* ap, long long n,               \
                   const void* rs, const void* tol2, const void* k,          \
                   int maxiter, void* flags, void* work, int blocks,         \
                   void* stream) {                                           \
    return launch_pap<V>(p, ap, n, rs, tol2, k, maxiter, flags, work,        \
                         blocks, stream);                                    \
  }                                                                          \
  int cg_update_##SFX(void* x, void* r, const void* p, const void* ap,       \
                      long long n, void* rs, void* k, void* flags,           \
                      void* work, int blocks, void* stream) {                \
    return launch_update<V>(x, r, p, ap, n, rs, k, flags, work, blocks,      \
                            stream);                                         \
  }                                                                          \
  int cg_direction_##SFX(void* p, const void* r, long long n,                \
                         const void* flags, const void* work, int blocks,    \
                         void* stream) {                                     \
    return launch_direction<V>(p, r, n, flags, work, blocks, stream);        \
  }                                                                          \
  int pcg_pap_##SFX(const void* p, const void* ap, long long n,              \
                    const void* rs, const void* rz, const void* tol2,        \
                    const void* k, int maxiter, void* flags, void* work,     \
                    int blocks, void* stream) {                              \
    return launch_pcg_pap<V>(p, ap, n, rs, rz, tol2, k, maxiter, flags,      \
                             work, blocks, stream);                          \
  }                                                                          \
  int pcg_update_##SFX(void* x, void* r, const void* p, const void* ap,      \
                       long long n, void* rs, void* k, void* flags,          \
                       void* work, int blocks, void* stream) {               \
    return launch_pcg_update<V>(x, r, p, ap, n, rs, k, flags, work, blocks,  \
                                stream);                                     \
  }                                                                          \
  int pcg_rz_##SFX(const void* r, const void* z, long long n, void* rz,      \
                   void* flags, void* work, int blocks, void* stream) {      \
    return launch_pcg_rz<V>(r, z, n, rz, flags, work, blocks, stream);       \
  }

CG_STEP_ENTRIES(f32, float)
CG_STEP_ENTRIES(f64, double)

#undef CG_STEP_ENTRIES

const char* cg_step_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
