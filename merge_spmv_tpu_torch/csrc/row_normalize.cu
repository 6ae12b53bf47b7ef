// FastRP's normalise-and-accumulate on Hopper (sm_90a): after each product
// N = P X, the rows of N divided by their L2 norms, n(N), and the weighted
// sum of the embeddings E = sum_i w_i n(N_i), in one pass over N.
//
// Replaces no TPU kernel: the JAX package has no FastRP.  In PyTorch the
// step was four passes over N [num_rows, d] a product (models/solvers.py):
// the row norms (a reduce), the broadcast division, and E's multiply or
// add.  Here each row is read once and
//
//   sum of squares -> norm -> each value over the norm -> stored in place
//   when store_n; E = w n(N) (kSet) or E += w n(N) (kAdd) when e_mode
//
// in one launch.  The sum of squares and the division are in the operand
// type's compute type C (float32 for float32 and bfloat16, float64 for
// float64), as torch.linalg.vector_norm and div_ compute them: a row of norm
// 0 is divided by 1 and stays 0 (no NaN).  E's term is w * n, then E + w * n,
// from n(N) as stored (rounded to the operand type), each result rounded to
// it once.  In float32 and float64 n(N) differs from the torch ops only
// through the order of the sum; in bfloat16 the torch ops also round the
// norm to bfloat16 before the division, which the kernel does not.
//
// What bounds it: HBM bytes.  N is read once, written once when store_n; E
// is written (kSet) or read and written (kAdd).  A warp takes a row; on the
// vector path (a row of whole 16-byte vectors, at most 2 KB, every address
// and the row stride 16-byte aligned) each lane holds kVectors of them a
// row, for kRowsInFlight rows at once, so a warp has all of its loads of
// N (and E) in flight before the first shuffle.  At d = 256 in float32 a
// lane makes two 16-byte loads a row.  Any other row (d not a whole number
// of vectors, a longer row, an unaligned operand) takes the scalar path: a
// warp a row, its lanes striding over the row twice (the sum, then the
// division), the second read mostly from L1.  The choice depends on d, the
// type and the alignment alone (models/fastrp_cuda.py::vectors_per_lane).
// The grid is a block per kWarps x kRowsInFlight rows (kWarps rows on the
// scalar path), each warp striding over the rows should a grid be smaller.
// At 2^21 x 256 in float32 that grid streamed at 88.7-92.5% of the bytes
// bound in the three modes FastRP runs; a grid of the blocks resident at
// once, striding, at 84.8-88.8%; four rows in flight and streaming cache
// hints on the loads or the stores moved neither by more than 0.3 points.
//
// The sums in a fixed order: each lane sums its values in index order, the
// warp by a shuffle tree, so a row's bits depend on d and the path alone.
//
// Plain C interface (loaded with ctypes): every pointer and the stream are
// void*, every launch returns cudaGetLastError() right after it.  The kernel
// allocates nothing and launches on the caller's stream; N and E must not
// overlap.

#include <cuda_runtime.h>
#include <math.h>
#include <string.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRowsInFlight = 2;    // models/fastrp_cuda.py::ROWS_IN_FLIGHT
constexpr int kNone = 0;            // e_mode: E untouched,
constexpr int kSet = 1;             // E = w n(N),
constexpr int kAdd = 2;             // E += w n(N)

// A bfloat16 value: its bits (torch.bfloat16's layout, the high half of a
// float32).
struct Bf16 {
  unsigned short bits;
};

// The operand type V's compute type C, and the conversions between them:
// widening is exact; narrowing a float32 to bfloat16 rounds to nearest even
// and keeps NaN a NaN, as torch's conversion does.
template <typename V>
struct Of {
  using C = V;
  __device__ __forceinline__ static C wide(V x) { return x; }
  __device__ __forceinline__ static V narrow(C x) { return x; }
};
template <>
struct Of<Bf16> {
  using C = float;
  __device__ __forceinline__ static float wide(Bf16 x) {
    const unsigned int u = static_cast<unsigned int>(x.bits) << 16;
    float f;
    memcpy(&f, &u, sizeof f);
    return f;
  }
  __device__ __forceinline__ static Bf16 narrow(float x) {
    unsigned int u;
    memcpy(&u, &x, sizeof u);
    if (x != x) return Bf16{0x7fc0};
    u += 0x7fffu + ((u >> 16) & 1u);
    return Bf16{static_cast<unsigned short>(u >> 16)};
  }
};

// 16 bytes of V, loaded and stored as one vector.
template <typename V>
struct alignas(16) Pack {
  V v[16 / static_cast<int>(sizeof(V))];
};

__device__ __forceinline__ float root(float x) { return sqrtf(x); }
__device__ __forceinline__ double root(double x) { return sqrt(x); }

// The warp's sum of v, in a fixed order, in every lane.
template <typename V>
__device__ __forceinline__ V warp_sum(V v) {
  for (int offset = 16; offset > 0; offset >>= 1)
    v += __shfl_down_sync(0xffffffffu, v, offset);
  return __shfl_sync(0xffffffffu, v, 0);
}

// What a row is divided by: its norm, or 1 where the norm is 0 (or NaN),
// as the torch path's where(norm > 0, norm, 1).
template <typename V>
__device__ __forceinline__ V divisor(V sum_of_squares) {
  const V norm = root(sum_of_squares);
  return norm > V(0) ? norm : V(1);
}

// n(N)'s value m, rounded to V where it is stored, and E's (kSet or kAdd,
// from E's value y) from it.
template <typename V>
__device__ __forceinline__ void normalized(typename Of<V>::C x,
                                           typename Of<V>::C div,
                                           typename Of<V>::C w, V y,
                                           int e_mode, V& m, V& out) {
  using T = Of<V>;
  m = T::narrow(x / div);
  const typename Of<V>::C wm = w * T::wide(m);
  out = T::narrow(e_mode == kSet ? wm : T::wide(y) + wm);
}

// kVectors > 0: the vector path, kVectors 16-byte vectors a lane a row;
// kVectors == 0: the scalar path.  n: [rows, d] at row stride `stride`
// values; e: [rows, d] contiguous (unused when e_mode is kNone).  A call
// with neither store_n nor e_mode writes nothing (models/solvers.py::fastrp
// makes none).
template <typename V, int kVectors>
__global__ void __launch_bounds__(kThreads) row_normalize_kernel(
    V* __restrict__ n, long long rows, int d, long long stride,
    V* __restrict__ e, typename Of<V>::C w, int store_n, int e_mode) {
  using T = Of<V>;
  using C = typename T::C;
  const int lane = threadIdx.x & 31;
  const long long warps = static_cast<long long>(gridDim.x) * kWarps;
  const long long warp = static_cast<long long>(blockIdx.x) * kWarps +
                         (threadIdx.x >> 5);
  if constexpr (kVectors == 0) {
    for (long long row = warp; row < rows; row += warps) {
      V* src = n + row * stride;
      C sum = C(0);
      for (int c = lane; c < d; c += 32) {
        const C x = T::wide(src[c]);
        sum += x * x;
      }
      const C div = divisor(warp_sum(sum));
      V* dst = e_mode == kNone ? nullptr : e + row * d;
      for (int c = lane; c < d; c += 32) {
        V m, out;
        normalized<V>(T::wide(src[c]), div, w,
                      e_mode == kAdd ? dst[c] : V{}, e_mode, m, out);
        if (store_n) src[c] = m;
        if (e_mode != kNone) dst[c] = out;
      }
    }
  } else {
    using P = Pack<V>;
    constexpr int kPer = 16 / static_cast<int>(sizeof(V));
    const int nv = d / kPer;    // vectors a row
    for (long long r0 = warp * kRowsInFlight; r0 < rows;
         r0 += warps * kRowsInFlight) {
      P x[kRowsInFlight][kVectors];
      P y[kRowsInFlight][kVectors];     // E's values, kAdd
#pragma unroll
      for (int i = 0; i < kRowsInFlight; ++i) {
        const long long row = r0 + i;
#pragma unroll
        for (int j = 0; j < kVectors; ++j) {
          const int v = lane + 32 * j;
          if (row < rows && v < nv) {
            x[i][j] = *reinterpret_cast<const P*>(n + row * stride +
                                                  v * kPer);
            if (e_mode == kAdd)
              y[i][j] = *reinterpret_cast<const P*>(e + row * d + v * kPer);
          } else {
#pragma unroll
            for (int c = 0; c < kPer; ++c) x[i][j].v[c] = T::narrow(C(0));
          }
        }
      }
      C div[kRowsInFlight];
#pragma unroll
      for (int i = 0; i < kRowsInFlight; ++i) {
        C sum = C(0);
#pragma unroll
        for (int j = 0; j < kVectors; ++j)
#pragma unroll
          for (int c = 0; c < kPer; ++c) {
            const C v = T::wide(x[i][j].v[c]);
            sum += v * v;
          }
        div[i] = divisor(warp_sum(sum));
      }
#pragma unroll
      for (int i = 0; i < kRowsInFlight; ++i) {
        const long long row = r0 + i;
#pragma unroll
        for (int j = 0; j < kVectors; ++j) {
          const int v = lane + 32 * j;
          if (row >= rows || v >= nv) continue;
          P m, out;
#pragma unroll
          for (int c = 0; c < kPer; ++c)
            normalized<V>(T::wide(x[i][j].v[c]), div[i], w, y[i][j].v[c],
                          e_mode, m.v[c], out.v[c]);
          if (store_n)
            *reinterpret_cast<P*>(n + row * stride + v * kPer) = m;
          if (e_mode != kNone)
            *reinterpret_cast<P*>(e + row * d + v * kPer) = out;
        }
      }
    }
  }
}

template <typename V>
const void* kernel_of(int vectors) {
  switch (vectors) {
    case 0: return reinterpret_cast<const void*>(row_normalize_kernel<V, 0>);
    case 1: return reinterpret_cast<const void*>(row_normalize_kernel<V, 1>);
    case 2: return reinterpret_cast<const void*>(row_normalize_kernel<V, 2>);
    case 3: return reinterpret_cast<const void*>(row_normalize_kernel<V, 3>);
    case 4: return reinterpret_cast<const void*>(row_normalize_kernel<V, 4>);
    default: return nullptr;
  }
}

template <typename V>
int launch(void* n, long long rows, int d, long long stride, void* e,
           double w, int store_n, int e_mode, int vectors, int blocks,
           void* stream) {
  const void* kernel = kernel_of<V>(vectors);
  if (kernel == nullptr || blocks < 1 || rows < 0 || d < 0 ||
      e_mode < kNone || e_mode > kAdd || (e_mode != kNone && e == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  V* a_n = static_cast<V*>(n);
  V* a_e = static_cast<V*>(e);
  typename Of<V>::C a_w = static_cast<typename Of<V>::C>(w);
  void* args[] = {&a_n, &rows, &d, &stride, &a_e, &a_w, &store_n, &e_mode};
  const cudaError_t err = cudaLaunchKernel(
      kernel, dim3(blocks), dim3(kThreads), args, 0,
      static_cast<cudaStream_t>(stream));
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}

}  // namespace

extern "C" {

// vectors: 0 (the scalar path) or 1 to 4 16-byte vectors a lane a row
// (models/fastrp_cuda.py::vectors_per_lane); blocks: the grid, at least 1;
// w: the weight, rounded to the compute type here.
#define ROW_NORMALIZE_ENTRIES(SFX, V)                                        \
  int row_normalize_##SFX(void* n, long long rows, int d, long long stride,  \
                          void* e, double w, int store_n, int e_mode,        \
                          int vectors, int blocks, void* stream) {           \
    return launch<V>(n, rows, d, stride, e, w, store_n, e_mode, vectors,     \
                     blocks, stream);                                        \
  }

ROW_NORMALIZE_ENTRIES(f32, float)
ROW_NORMALIZE_ENTRIES(f64, double)
ROW_NORMALIZE_ENTRIES(bf16, Bf16)

#undef ROW_NORMALIZE_ENTRIES

const char* row_normalize_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
