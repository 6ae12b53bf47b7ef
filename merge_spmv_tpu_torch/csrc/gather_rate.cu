// Gather-rate probe for Hopper (sm_90a): how fast the card serves scattered
// 4-byte reads, the access that bounds the merge tile kernel's x gather on
// scattered columns (csrc/merge_csrmv.cu).
//
//   out[t] = sum over k of x[idx[t + k * T]],  T = gridDim.x * blockDim.x,
//
// summed in k order, so the plain version (tools/gather_rate.py) gives the
// same bits.  The index stream is read coalesced, as the tile kernel reads
// its staged column indices; each x read that misses L1 moves one 32-byte
// L2 sector.  Random indices over an array that fits L2 (22 MB: the circuit5M
// class's x; 4 MB: the kron class's) measure the L2 sector rate that a
// scattered gather meets; indices t + k * T (mod n) measure the same loop
// with coalesced reads.  Each thread keeps kUnroll reads in flight and the
// grid fills every SM (8 blocks of 256 threads, at most 32 registers), so the
// rate, not the latency, is measured.
//
// gather_rows_kernel is the rows class, the access of the multi-RHS tile
// kernel's X gather (csrc/merge_csrmm.cu): each read is a whole row of
// 4 * kLanes floats (32 B at k = 8, 128 B at k = 32), read by kLanes
// neighbouring lanes with one 16-byte load each, so one request moves whole
// sectors and no byte of them is wasted:
//
//   out[g, :] = sum over j of X[idx[g + j * G], :],  G = T / kLanes groups,
//
// summed in j order per column.  At a matrix's own column indices spread
// over the grid this way, consecutive nonzeros go to different SMs, so the
// rate is L2's for such requests, not what L1 hits add.
//
// Plain C interface (loaded with ctypes): pointers and the stream are void*,
// the entries return cudaGetLastError() right after their launch.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 8;

__global__ void __launch_bounds__(kThreads, 8) gather_rate_kernel(
    const float* __restrict__ x, const int* __restrict__ idx,
    long long count, float* __restrict__ out) {
  const long long T = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long t = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  float acc = 0.0f;
  long long j = t;
  for (; j + (kUnroll - 1) * T < count; j += kUnroll * T) {
    float v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) v[u] = __ldg(x + __ldg(idx + j + u * T));
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) acc += v[u];
  }
  for (; j < count; j += T) acc += __ldg(x + __ldg(idx + j));
  out[t] = acc;
}

template <int kLanes>
__global__ void __launch_bounds__(kThreads, 8) gather_rows_kernel(
    const float4* __restrict__ x, const int* __restrict__ idx,
    long long count, float4* __restrict__ out) {
  const long long T = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long t = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  const long long G = T / kLanes;
  const long long g = t / kLanes;
  const int l = static_cast<int>(t % kLanes);
  float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  long long j = g;
  for (; j + (kUnroll - 1) * G < count; j += kUnroll * G) {
    float4 v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      v[u] = __ldg(x + static_cast<long long>(__ldg(idx + j + u * G)) *
                           kLanes + l);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      acc.x += v[u].x;
      acc.y += v[u].y;
      acc.z += v[u].z;
      acc.w += v[u].w;
    }
  }
  for (; j < count; j += G) {
    const float4 v =
        __ldg(x + static_cast<long long>(__ldg(idx + j)) * kLanes + l);
    acc.x += v.x;
    acc.y += v.y;
    acc.z += v.z;
    acc.w += v.w;
  }
  out[t] = acc;
}

template <int kLanes>
int launch_gather_rows(const void* x, const void* idx, long long count,
                       int blocks, void* out, void* stream) {
  gather_rows_kernel<kLanes><<<blocks, kThreads, 0,
                               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(x), static_cast<const int*>(idx), count,
      static_cast<float4*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int gather_rate_f32(const void* x, const void* idx, long long count,
                    int blocks, void* out, void* stream) {
  if (blocks < 1 || count < 0) return static_cast<int>(cudaErrorInvalidValue);
  gather_rate_kernel<<<blocks, kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const int*>(idx), count,
      static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

int gather_rate_threads() { return kThreads; }

// Rows of row_floats = 4 * lanes floats (lanes 1, 2, 4, 8 or 16); out holds
// blocks * 256 * 4 floats.
int gather_rows_f32(const void* x, const void* idx, long long count,
                    int row_floats, int blocks, void* out, void* stream) {
  if (blocks < 1 || count < 0) return static_cast<int>(cudaErrorInvalidValue);
  switch (row_floats) {
    case 4: return launch_gather_rows<1>(x, idx, count, blocks, out, stream);
    case 8: return launch_gather_rows<2>(x, idx, count, blocks, out, stream);
    case 16: return launch_gather_rows<4>(x, idx, count, blocks, out, stream);
    case 32: return launch_gather_rows<8>(x, idx, count, blocks, out, stream);
    case 64: return launch_gather_rows<16>(x, idx, count, blocks, out, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

const char* gather_rate_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
