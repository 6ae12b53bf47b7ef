"""The CUDA sources in merge_spmv_tpu_torch/csrc/ pass a C++ front end on
the CPU: each is compiled by ``g++ -std=c++17 -fsyntax-only`` against a
stand-in ``cuda_runtime.h`` that declares the runtime calls and device
intrinsics the sources use, with the inline PTX and the launch brackets
taken out.  This instantiates every template and checks names, types and
overloads: the errors nvcc would report before it reaches PTX (a name
shadowed in a kernel, a wrong argument type).  It checks nothing about
the PTX, the device code's behaviour or sm_90a; those need the card
(tests/test_torch_cuda.py).  Skips where g++ is absent.
"""

import re
import shutil
import subprocess

import pytest

from merge_spmv_tpu_torch.utils.cuda_build import CSRC_DIR

SOURCES = sorted(p.name for p in CSRC_DIR.glob("*.cu"))

CUDA_RUNTIME = r"""
#pragma once
#include <cstddef>
#include <cstdint>
#define __global__
#define __device__
#define __host__
#define __shared__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __restrict__ __restrict
#define __align__(n) __attribute__((aligned(n)))
#define INLINE_PTX(...) ((void)0)
struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
extern dim3 threadIdx, blockIdx, blockDim, gridDim;
typedef int cudaError_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
typedef struct CUstream_st* cudaStream_t;
enum cudaFuncAttribute {
  cudaFuncAttributeMaxDynamicSharedMemorySize,
  cudaFuncAttributePreferredSharedMemoryCarveout
};
struct cudaFuncAttributes { int numRegs; };
cudaError_t cudaFuncSetAttribute(const void*, cudaFuncAttribute, int);
cudaError_t cudaFuncGetAttributes(cudaFuncAttributes*, const void*);
cudaError_t cudaOccupancyMaxActiveBlocksPerMultiprocessor(int*, const void*,
                                                          int, size_t);
cudaError_t cudaLaunchKernel(const void*, dim3, dim3, void**, size_t,
                             cudaStream_t);
template <class T>
cudaError_t cudaFuncSetAttribute(T*, cudaFuncAttribute, int);
template <class T>
cudaError_t cudaOccupancyMaxActiveBlocksPerMultiprocessor(int*, T*, int,
                                                          size_t);
cudaError_t cudaGetLastError();
const char* cudaGetErrorString(cudaError_t);
template <class T> T __ldg(const T*);
template <class T> T __ldcg(const T*);
template <class T> T __shfl_up_sync(unsigned, T, int);
template <class T> T __shfl_sync(unsigned, T, int);
void __syncthreads();
size_t __cvta_generic_to_shared(const void*);
long long clock64();
void __syncwarp(unsigned = 0xffffffffu);
struct int4 { int x, y, z, w; };
struct float2 { float x, y; };
struct float4 { float x, y, z, w; };
struct double2 { double x, y; };
float4 make_float4(float, float, float, float);
int4 make_int4(int, int, int, int);
inline int min(int a, int b) { return a < b ? a : b; }
inline int max(int a, int b) { return a > b ? a : b; }
"""


def _front_end(tmp_path, source: str):
    """g++'s front end on ``source`` with its inline PTX and launch
    brackets taken out, against the stand-in runtime header."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++")
    (tmp_path / "cuda_runtime.h").write_text(CUDA_RUNTIME)
    text = source.replace("asm volatile(", "INLINE_PTX(")
    text = text.replace("asm(", "INLINE_PTX(")
    src = tmp_path / "source.cpp"
    src.write_text(re.sub(r"<<<.*?>>>", "", text, flags=re.S))
    return subprocess.run([gxx, "-std=c++17", "-fsyntax-only",
                           "-Wno-unknown-pragmas", f"-I{tmp_path}", str(src)],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                          text=True, timeout=120)


@pytest.mark.parametrize("name", SOURCES)
def test_cuda_source_passes_a_cpp_front_end(name, tmp_path):
    proc = _front_end(tmp_path, (CSRC_DIR / name).read_text())
    assert proc.returncode == 0, proc.stdout


def test_the_front_end_catches_a_shadowed_name(tmp_path):
    """The check fails on the fault it is for: the tile kernel's run index
    named like the reduce's running sum."""
    text = (CSRC_DIR / "merge_csrmv.cu").read_text()
    assert text.count("carry_row[my_run]") == 1
    proc = _front_end(tmp_path, text.replace("my_run", "run"))
    assert proc.returncode != 0 and "error" in proc.stdout
