// DIA matvec for Hopper (sm_90a): y[r] = alpha * sum_d vtab[d, r] * x[r + off_d],
// with x taken as zero outside [0, num_cols).
//
// Replaces merge_spmv_tpu/ops/dia_pallas.py::_dia_kernel.  That kernel stages
// the whole zero-padded x in VMEM once, streams (D, R) tiles of the value
// table, and reads each diagonal's shifted window of x as two sublane loads
// glued by a static lane concat.  None of that staging carries over: here
// one thread computes one output row.
//
// What bounds it: HBM bytes.  The table streams once (D * m values), x is
// read once and y written once: (D * m + n + m) * sizeof(V), 32.0 MB for
// grid3d(100) in float32.  The design:
//   * a warp reads vtab[d, r .. r + 31] for consecutive rows: coalesced;
//   * it reads x[r + off_d .. r + off_d + 31] through the read-only path
//     (__ldg).  Neighbouring diagonals (offsets -1, 0, +1) hit the same L1
//     lines, and the far ones (+-w, +-w^2 of a stencil) find x in the 50 MB
//     L2 that the other diagonals filled;
//   * a predicate gives zero outside [0, n), so x is not padded per call;
//   * the offsets are a small device array read through __ldg (a broadcast
//     within the warp), so D has no cap;
//   * offsets are signed 64-bit and d * m + r is computed in 64 bits: at
//     D = 32 and m = 67M the flat index passes 2^31;
//   * each row's sum is taken by one thread in diagonal order: no atomics,
//     so two calls give the same bits.
// Values accumulate in the table's type: float (a bfloat16 operator holds
// its table in float after rounding it to bfloat16) or double.
//
// dia_matmat_kernel (K3m) is the same product over k columns at once,
// Y[r, :] = alpha * sum_d vtab[d, r] * X[r + off_d, :] (+ beta * Y_in[r, :]),
// with X [n, k] and Y [m, k] row-major (row strides ldx, ldy, ldyin): the
// function of the JAX package's DIA mm, one shifted multiply-add per diagonal
// over the whole table (merge_spmv_tpu/ops/dia.py:200-220), where the column
// loop would read the table k times.  Bound: HBM bytes, the table once, X and
// Y once each.  A thread computes kVec neighbouring columns of one row (one
// 4, 8 or 16-byte load of X per diagonal); the threads of a warp cover
// consecutive (row, column group) pairs, so for one diagonal a warp reads one
// contiguous span of rows x k of X, and the table's value is shared by the
// threads of a row.  The far diagonals of a stencil (+-w, +-w^2) read X rows
// that the near ones of other blocks brought into L2 a moment before.  The
// offsets sit in shared memory; (r + off) * ldx and d * m + r are 64-bit.  A
// row's sum is taken in diagonal order by one thread: two calls give the
// same bits.
//
// Plain C interface (loaded with ctypes): pointers and the stream are void*,
// every entry returns cudaGetLastError() right after its launch.  The
// kernels allocate nothing and launch on the caller's stream.

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kThreads = 256;
constexpr size_t kMaxOffsetBytes = 49152;   // 6,144 offsets

template <typename V>
__global__ void __launch_bounds__(kThreads) dia_matvec_kernel(
    const V* __restrict__ vtab, const V* __restrict__ x,
    const long long* __restrict__ offsets, int num_diags,
    long long num_rows, long long num_cols, V alpha, V* __restrict__ y) {
  const long long r =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (r >= num_rows) return;
  V acc = V(0);
  for (int d = 0; d < num_diags; ++d) {
    const long long c = r + __ldg(offsets + d);
    const V xv = (c >= 0 && c < num_cols) ? __ldg(x + c) : V(0);
    acc += __ldg(vtab + static_cast<long long>(d) * num_rows + r) * xv;
  }
  y[r] = alpha * acc;
}

template <typename V>
int launch_dia_matvec(const void* vtab, const void* x, const void* offsets,
                      int num_diags, long long num_rows, long long num_cols,
                      double alpha, void* y, void* stream) {
  const long long blocks = (num_rows + kThreads - 1) / kThreads;
  dia_matvec_kernel<V><<<static_cast<unsigned>(blocks), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const V*>(vtab), static_cast<const V*>(x),
      static_cast<const long long*>(offsets), num_diags, num_rows, num_cols,
      static_cast<V>(alpha), static_cast<V*>(y));
  return static_cast<int>(cudaGetLastError());
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

template <typename V, int kVec>
__global__ void __launch_bounds__(kThreads) dia_matmat_kernel(
    const V* __restrict__ vtab, const V* __restrict__ x, long long ldx,
    const long long* __restrict__ offsets, int num_diags,
    long long num_rows, long long num_cols, int k, V alpha, V beta,
    const V* __restrict__ y_in, long long ldyin, V* __restrict__ y,
    long long ldy) {
  using T = typename Vec<V, kVec>::T;
  extern __shared__ long long s_off[];
  for (int d = threadIdx.x; d < num_diags; d += blockDim.x)
    s_off[d] = offsets[d];
  __syncthreads();
  const int groups = k / kVec;   // column groups of a row
  const long long t =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= num_rows * groups) return;
  const long long r = t / groups;
  const int c = static_cast<int>(t - r * groups) * kVec;
  V acc[kVec];
#pragma unroll
  for (int e = 0; e < kVec; ++e) acc[e] = V(0);
#pragma unroll 4
  for (int d = 0; d < num_diags; ++d) {
    const long long col = r + s_off[d];
    const V a = __ldg(vtab + static_cast<long long>(d) * num_rows + r);
    V xv[kVec];
    if (col >= 0 && col < num_cols) {
      unpack(__ldg(reinterpret_cast<const T*>(x + col * ldx + c)), xv);
    } else {
#pragma unroll
      for (int e = 0; e < kVec; ++e) xv[e] = V(0);
    }
#pragma unroll
    for (int e = 0; e < kVec; ++e) acc[e] += a * xv[e];
  }
  V out[kVec];
#pragma unroll
  for (int e = 0; e < kVec; ++e) out[e] = alpha * acc[e];
  if (y_in != nullptr) {
    V yi[kVec];
    unpack(__ldg(reinterpret_cast<const T*>(y_in + r * ldyin + c)), yi);
#pragma unroll
    for (int e = 0; e < kVec; ++e) out[e] += beta * yi[e];
  }
  T o;
  pack(out, o);
  *reinterpret_cast<T*>(y + r * ldy + c) = o;
}

// The instantiation for kVec values a thread (one 4, 8 or 16-byte load);
// null for a width the value type lacks.
template <typename V>
const void* matmat_kernel(int vec) {
  if (vec == 1) return reinterpret_cast<const void*>(dia_matmat_kernel<V, 1>);
  if (vec == 2) return reinterpret_cast<const void*>(dia_matmat_kernel<V, 2>);
  if constexpr (sizeof(V) == 4)
    if (vec == 4)
      return reinterpret_cast<const void*>(dia_matmat_kernel<V, 4>);
  return nullptr;
}

template <typename V>
int launch_dia_matmat(const void* vtab, const void* x, long long ldx,
                      const void* offsets, int num_diags, long long num_rows,
                      long long num_cols, int k, int vec, double alpha,
                      double beta, const void* y_in, long long ldyin,
                      void* y, long long ldy, void* stream) {
  const void* kernel = matmat_kernel<V>(vec);
  const size_t shared = static_cast<size_t>(num_diags) * sizeof(long long);
  if (kernel == nullptr || k < 1 || k % vec != 0 || num_diags < 0 ||
      shared > kMaxOffsetBytes)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long threads = num_rows * (k / vec);
  const long long blocks = (threads + kThreads - 1) / kThreads;
  if (blocks == 0) return static_cast<int>(cudaSuccess);
  // the kernel's parameters, in its order and types
  const V* a_vtab = static_cast<const V*>(vtab);
  const V* a_x = static_cast<const V*>(x);
  const long long* a_offsets = static_cast<const long long*>(offsets);
  V a_alpha = static_cast<V>(alpha);
  V a_beta = static_cast<V>(beta);
  const V* a_y_in = static_cast<const V*>(y_in);
  V* a_y = static_cast<V*>(y);
  void* args[] = {&a_vtab, &a_x, &ldx, &a_offsets, &num_diags, &num_rows,
                  &num_cols, &k, &a_alpha, &a_beta, &a_y_in, &ldyin, &a_y,
                  &ldy};
  const cudaError_t e = cudaLaunchKernel(
      kernel, dim3(static_cast<unsigned>(blocks)), dim3(kThreads), args,
      shared, static_cast<cudaStream_t>(stream));
  return static_cast<int>(e != cudaSuccess ? e : cudaGetLastError());
}

}  // namespace

extern "C" {

int dia_matvec_f32(const void* vtab, const void* x, const void* offsets,
                   int num_diags, long long num_rows, long long num_cols,
                   double alpha, void* y, void* stream) {
  return launch_dia_matvec<float>(vtab, x, offsets, num_diags, num_rows,
                                  num_cols, alpha, y, stream);
}

int dia_matvec_f64(const void* vtab, const void* x, const void* offsets,
                   int num_diags, long long num_rows, long long num_cols,
                   double alpha, void* y, void* stream) {
  return launch_dia_matvec<double>(vtab, x, offsets, num_diags, num_rows,
                                   num_cols, alpha, y, stream);
}

// Y (ldy) = alpha * (the DIA product over k columns of X (ldx)) + beta *
// Y_in (ldyin; null: none), vec columns a thread (k a multiple of it, the
// rows of X, Y and Y_in aligned to vec values); at most 6,144 diagonals
// (their offsets fill the 48 KB of shared memory a launch gets unasked).
#define DIA_MATMAT_ENTRY(SFX, V)                                             \
  int dia_matmat_##SFX(const void* vtab, const void* x, long long ldx,      \
                       const void* offsets, int num_diags,                  \
                       long long num_rows, long long num_cols, int k,       \
                       int vec, double alpha, double beta, const void* y_in,\
                       long long ldyin, void* y, long long ldy,             \
                       void* stream) {                                      \
    return launch_dia_matmat<V>(vtab, x, ldx, offsets, num_diags, num_rows,  \
                                num_cols, k, vec, alpha, beta, y_in, ldyin, \
                                y, ldy, stream);                            \
  }

DIA_MATMAT_ENTRY(f32, float)
DIA_MATMAT_ENTRY(f64, double)
#undef DIA_MATMAT_ENTRY

const char* dia_matvec_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
