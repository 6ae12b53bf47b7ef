// Per-op-class throughput probe for Hopper (sm_90a).
//
// Replaces tools/vpu_ceiling.py::wrap.<locals>.kernel, the TPU probe whose
// five bodies measure the vector unit's rate for one class of operation at
// a time.  The function is the same: from x (8, 128) float32 a table of
// table_rows rows, table[i][j] = x[i % 8][j] * 1e-9, and `chains`
// accumulators of (8, 128), zero at the start, are updated for `grid` steps
// of `unroll` operations each; the result is the chains' sum, in chain
// order.  The classes and the Hopper primitive each one times:
//
//   fma       acc = acc * 0.999999 + (table[0:8] + 1): FFMA chains;
//   select    acc = (col == (t + u + c) & 127) ? table[0:8] : acc: integer
//             compare plus select;
//   gather    g = (g + 1)[:, (7 * col + t) & 127]: a cross-lane gather of a
//             128-wide row.  A row is one warp, each lane holding columns
//             lane + 32 s (s = 0..3).  Output slot s of lane d needs column
//             q = (7 (d + 32 s) + t) & 127, held by lane (7 d + t) & 31 in
//             slot q >> 5.  That lane is the same in every round s, and as
//             7 is odd each lane is read by exactly one other, lane
//             23 (l - t) & 31 (7 * 23 = 1 mod 32), which in round s wants
//             slot (m - s) & 3 for an m fixed per step.  So the sender
//             rotates its four values by m (two stages of selects on two
//             predicates fixed per step) and each round is one __shfl_sync:
//             per lane per step 4 shuffles, 8 selects and 4 adds;
//   dynfetch  acc += table[(37 t + 11 u + c) % (table_rows - 8)] broadcast
//             over the 8 rows: shared-memory loads at data-dependent rows;
//   statfetch acc += table[(11 u + 7 c) % (table_rows - 8)]: shared-memory
//             loads at indices that do not depend on the step.
//
// The TPU's sequential grid becomes a loop inside the block.  A block of
// 256 threads (8 warps, one per row) computes the whole (8, 128) result;
// the wrapper launches enough blocks to fill every SM and checks that the
// blocks agree.  The table lives in shared memory (table_rows * 512 bytes,
// at most 448 rows, below the 227 KB a block can have).  Fetch loads go
// through a volatile pointer so that none is hoisted out of the step loop;
// the row index advances by 11 per operation with a conditional subtract,
// so no integer division sits in the timed loop.
//
// What bounds it: operations.  fma at the data sheet's 67 TFLOP/s (128
// FFMA lanes per SM per clock); gather at the warp shuffle's 32 lanes per
// clock per SM; the fetch classes at 32 banks x 4 bytes per clock per SM
// of shared memory.  Its device-memory traffic is 4 KB in and 4 KB per
// block out.
//
// Plain C interface (loaded with ctypes): pointers and the stream are void*,
// every entry returns cudaGetLastError() right after its launch.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;   // 8 warps: one per row of the (8, 128) tile
constexpr int kSlots = 4;       // columns lane + 32 s held by each lane
constexpr unsigned kFull = 0xffffffffu;

enum Class { kFma = 0, kSelect = 1, kGather = 2, kDynfetch = 3, kStatfetch = 4 };

template <int CLS, int CHAINS>
__global__ void __launch_bounds__(kThreads) sm_ceiling_kernel(
    const float* __restrict__ x, int grid, int unroll, int table_rows,
    float* __restrict__ out) {
  extern __shared__ float table[];   // table_rows x 128
  const int row = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  for (int k = threadIdx.x; k < table_rows * 128; k += blockDim.x)
    table[k] = x[((k >> 7) & 7) * 128 + (k & 127)] * 1e-9f;
  __syncthreads();
  const volatile float* vtable = table;
  const int rows_mod = table_rows - 8;

  float acc[CHAINS][kSlots];
#pragma unroll
  for (int c = 0; c < CHAINS; ++c)
#pragma unroll
    for (int s = 0; s < kSlots; ++s) acc[c][s] = 0.0f;

  for (int t = 0; t < grid; ++t) {
    if (CLS == kFma) {
      float b[kSlots];
#pragma unroll
      for (int s = 0; s < kSlots; ++s)
        b[s] = table[row * 128 + lane + 32 * s] + 1.0f;
#pragma unroll 4
      for (int u = 0; u < unroll; ++u)
#pragma unroll
        for (int c = 0; c < CHAINS; ++c)
#pragma unroll
          for (int s = 0; s < kSlots; ++s)
            acc[c][s] = acc[c][s] * 0.999999f + b[s];
    } else if (CLS == kSelect) {
      float b[kSlots];
#pragma unroll
      for (int s = 0; s < kSlots; ++s) b[s] = table[row * 128 + lane + 32 * s];
#pragma unroll 4
      for (int u = 0; u < unroll; ++u)
#pragma unroll
        for (int c = 0; c < CHAINS; ++c) {
          const int want = (t + u + c) & 127;
#pragma unroll
          for (int s = 0; s < kSlots; ++s)
            acc[c][s] = (lane + 32 * s == want) ? b[s] : acc[c][s];
        }
    } else if (CLS == kGather) {
      const int src = (7 * lane + t) & 31;           // read in every round
      const int reader = (23 * (lane - t)) & 31;     // the lane reading us
      const int m = ((7 * reader + t) & 127) >> 5;   // its slot in round 0
      const bool rot1 = m & 1, rot2 = m & 2;
#pragma unroll 2
      for (int u = 0; u < unroll; ++u)
#pragma unroll
        for (int c = 0; c < CHAINS; ++c) {
          float g[kSlots], h[kSlots], r[kSlots];
#pragma unroll
          for (int s = 0; s < kSlots; ++s) g[s] = acc[c][s] + 1.0f;
          // r[j] = g[(j + m) & 3]
#pragma unroll
          for (int s = 0; s < kSlots; ++s) h[s] = rot1 ? g[(s + 1) & 3] : g[s];
#pragma unroll
          for (int s = 0; s < kSlots; ++s) r[s] = rot2 ? h[(s + 2) & 3] : h[s];
          // round s sends g[(m - s) & 3] = r[(4 - s) & 3]
#pragma unroll
          for (int s = 0; s < kSlots; ++s)
            acc[c][s] = __shfl_sync(kFull, r[(4 - s) & 3], src);
        }
    } else {   // kDynfetch, kStatfetch
      int idx[CHAINS];
#pragma unroll
      for (int c = 0; c < CHAINS; ++c)
        idx[c] = (CLS == kDynfetch ? t * 37 + c : c * 7) % rows_mod;
#pragma unroll 4
      for (int u = 0; u < unroll; ++u)
#pragma unroll
        for (int c = 0; c < CHAINS; ++c) {
          const volatile float* src = vtable + idx[c] * 128 + lane;
#pragma unroll
          for (int s = 0; s < kSlots; ++s) acc[c][s] += src[32 * s];
          idx[c] += 11;
          if (idx[c] >= rows_mod) idx[c] -= rows_mod;
        }
    }
  }

#pragma unroll
  for (int s = 0; s < kSlots; ++s) {
    float o = acc[0][s];
#pragma unroll
    for (int c = 1; c < CHAINS; ++c) o += acc[c][s];
    out[blockIdx.x * 1024 + row * 128 + lane + 32 * s] = o;
  }
}

template <int CLS, int CHAINS>
int launch(const float* x, int grid, int unroll, int table_rows, int blocks,
           float* out, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(table_rows) * 128 * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      sm_ceiling_kernel<CLS, CHAINS>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  sm_ceiling_kernel<CLS, CHAINS><<<blocks, kThreads, smem, stream>>>(
      x, grid, unroll, table_rows, out);
  return static_cast<int>(cudaGetLastError());
}

template <int CLS, int CHAINS>
int occupancy(int table_rows) {
  const size_t smem = static_cast<size_t>(table_rows) * 128 * sizeof(float);
  if (cudaFuncSetAttribute(sm_ceiling_kernel<CLS, CHAINS>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem)) != cudaSuccess)
    return -1;
  int per_sm = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, sm_ceiling_kernel<CLS, CHAINS>, kThreads, smem) !=
      cudaSuccess)
    return -1;
  return per_sm;
}

// Dispatch a runtime (class, chains) pair to its instantiation; CALL is a
// macro taking (CLS, CHAINS).  Every path returns.
#define SM_CEILING_CHAINS(CLS, CHAINS_VAL, CALL) \
  switch (CHAINS_VAL) {                           \
    case 1: return CALL(CLS, 1);                  \
    case 2: return CALL(CLS, 2);                  \
    case 4: return CALL(CLS, 4);                  \
    case 8: return CALL(CLS, 8);                  \
    default: return -2;                           \
  }

#define SM_CEILING_DISPATCH(CLS_VAL, CHAINS_VAL, CALL)                \
  switch (CLS_VAL) {                                                  \
    case kFma: SM_CEILING_CHAINS(kFma, CHAINS_VAL, CALL)              \
    case kSelect: SM_CEILING_CHAINS(kSelect, CHAINS_VAL, CALL)        \
    case kGather: SM_CEILING_CHAINS(kGather, CHAINS_VAL, CALL)        \
    case kDynfetch: SM_CEILING_CHAINS(kDynfetch, CHAINS_VAL, CALL)    \
    case kStatfetch: SM_CEILING_CHAINS(kStatfetch, CHAINS_VAL, CALL)  \
    default: return -2;                                               \
  }

}  // namespace

extern "C" {

// Blocks of the (cls, chains) kernel that fit on one SM with a table of
// table_rows rows; -1 on a CUDA error, -2 for an unsupported (cls, chains).
int sm_ceiling_blocks_per_sm(int cls, int chains, int table_rows) {
#define OCC(C, N) occupancy<C, N>(table_rows)
  SM_CEILING_DISPATCH(cls, chains, OCC)
#undef OCC
  return -2;
}

// Launch `blocks` blocks; out is (blocks, 8, 128) float32.  Returns
// cudaGetLastError() after the launch, or -2 for an unsupported
// (cls, chains).
int sm_ceiling_launch(int cls, int chains, const void* x, int grid,
                      int unroll, int table_rows, int blocks, void* out,
                      void* stream) {
#define LAUNCH(C, N)                                                        \
  launch<C, N>(static_cast<const float*>(x), grid, unroll, table_rows,     \
               blocks, static_cast<float*>(out),                            \
               static_cast<cudaStream_t>(stream))
  SM_CEILING_DISPATCH(cls, chains, LAUNCH)
#undef LAUNCH
  return -2;
}

const char* sm_ceiling_error_string(int code) {
  if (code == -2) return "unsupported probe class or chain count";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
