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
// Plain C interface (loaded with ctypes): pointers and the stream are void*,
// the entry returns cudaGetLastError() right after its launch.

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

const char* gather_rate_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
