"""The CUDA sources in merge_spmv_tpu_torch/csrc/ pass a C++ front end on
the CPU: each is compiled by ``g++ -std=c++17 -fsyntax-only`` against a
stand-in ``cuda_runtime.h`` that declares the runtime calls and device
intrinsics the sources use, with the inline PTX and the launch brackets
taken out.  This instantiates every template and checks names, types and
overloads: the errors nvcc would report before it reaches PTX (a name
shadowed in a kernel, a wrong argument type).  It checks nothing about
the PTX, the device code's behaviour or sm_90a; those need the card
(tests/test_torch_cuda.py).  Skips where g++ is absent.
Also the parser of nvcc's ``-Xptxas=-v`` report behind chip_smoke.py's
spill gates (utils/cuda_build.ptxas_report), on excerpts of that report.
"""

import re
import shutil
import subprocess

import pytest

from merge_spmv_tpu_torch.utils.cuda_build import CSRC_DIR, ptxas_report

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
cudaError_t cudaMemsetAsync(void*, int, size_t, cudaStream_t);
typedef struct CUgraph_st* cudaGraph_t;
typedef struct CUgraphExec_st* cudaGraphExec_t;
typedef struct CUgraphNode_st* cudaGraphNode_t;
enum cudaStreamCaptureMode { cudaStreamCaptureModeThreadLocal };
enum cudaStreamCaptureStatus {
  cudaStreamCaptureStatusNone, cudaStreamCaptureStatusActive,
  cudaStreamCaptureStatusInvalidated
};
enum { cudaErrorStreamCaptureInvalidated = 901 };
enum { cudaStreamSetCaptureDependencies = 1 };
cudaError_t cudaStreamBeginCapture(cudaStream_t, cudaStreamCaptureMode);
cudaError_t cudaStreamEndCapture(cudaStream_t, cudaGraph_t*);
cudaError_t cudaGraphInstantiateWithFlags(cudaGraphExec_t*, cudaGraph_t,
                                          unsigned long long);
cudaError_t cudaStreamIsCapturing(cudaStream_t, cudaStreamCaptureStatus*);
cudaError_t cudaGraphLaunch(cudaGraphExec_t, cudaStream_t);
cudaError_t cudaStreamGetCaptureInfo(cudaStream_t, cudaStreamCaptureStatus*,
                                     unsigned long long*, cudaGraph_t*,
                                     const cudaGraphNode_t**, size_t*);
cudaError_t cudaGraphAddChildGraphNode(cudaGraphNode_t*, cudaGraph_t,
                                       const cudaGraphNode_t*, size_t,
                                       cudaGraph_t);
cudaError_t cudaStreamUpdateCaptureDependencies(cudaStream_t,
                                                cudaGraphNode_t*, size_t,
                                                unsigned int);
cudaError_t cudaGraphExecDestroy(cudaGraphExec_t);
cudaError_t cudaGraphDestroy(cudaGraph_t);
template <class T> T __ldg(const T*);
template <class T> T __ldcg(const T*);
template <class T> T __ldcs(const T*);
template <class T> T __shfl_up_sync(unsigned, T, int);
template <class T> T __shfl_sync(unsigned, T, int);
template <class T> T __shfl_down_sync(unsigned, T, int, int = 32);
template <class T>
cudaError_t cudaMemcpyFromSymbol(void*, const T&, size_t, size_t = 0);
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


def test_multigrid_names_the_colour_step_as_the_benchmark_reads_it():
    """The benchmark finds HPCG's colour step on the device trace by
    spmv_bench/roofline_mg.py::UPDATE: csrc/multigrid.cu defines a
    __global__ kernel whose name holds it, the colour step's, so that a
    rename fails here before any run on the card."""
    from spmv_bench import roofline_mg
    text = (CSRC_DIR / "multigrid.cu").read_text()
    kernels = re.findall(r"__global__\s+void\s+(?:__launch_bounds__\("
                         r"[^)]*\)\s+)?(\w+)\(", text)
    assert "mg_restrict_kernel" in kernels
    assert [k for k in kernels if roofline_mg.UPDATE in k] == [
        "symgs_update_kernel"]


def test_the_front_end_catches_a_shadowed_name(tmp_path):
    """The check fails on the fault it is for: the tile kernel's run index
    named like the reduce's running sum."""
    text = (CSRC_DIR / "merge_csrmv.cu").read_text()
    assert text.count("carry_row[my_run]") == 1
    proc = _front_end(tmp_path, text.replace("my_run", "run"))
    assert proc.returncode != 0 and "error" in proc.stdout


def _mm_layouts():
    """Every (dtype, per, lanes) that ops/plan.py::mm_layout picks for a
    launch of 1-64 columns at any alignment."""
    from merge_spmv_tpu_torch.ops import plan as P
    out = set()
    for dtype, size in (("float32", 4), ("float64", 8)):
        for k in range(1, P.MM_MAX_K + 1):
            for align in (a for a in (16, 8, 4) if a >= size):
                lay = P.mm_layout(k, dtype, align)
                out.add((dtype, lay))
    return sorted(out, key=str)


def test_k1m_shared_layout_is_the_plans(tmp_path):
    """csrc/merge_csrmm.cu's own constexpr figures, checked by static_assert
    against ops/plan.py for every layout a launch can take and every chunk
    a tile size gives: the block's dynamic shared memory (mm_shared_bytes),
    the rows of a walker's load batch and the carveout the instantiation
    asks for."""
    from merge_spmv_tpu_torch.ops import plan as P
    chunks = sorted({max(1, P.MM_CHUNK_ITEMS // t) * t for t in range(
        P.MIN_TILE_ITEMS, P.MAX_TILE_ITEMS + 1, P.MIN_TILE_ITEMS)})
    lines = []
    for dtype, lay in _mm_layouts():
        ctype = "double" if dtype == "float64" else "float"
        size = 8 if dtype == "float64" else 4
        lines.append(f"static_assert(batch_rows({lay.per * size}, "
                     f"{lay.lanes}) == {P.mm_batch_rows(dtype, lay)});")
        lines.append(f"static_assert(mm_carveout<{ctype}>({lay.per}, "
                     f"{lay.lanes}) == {P.mm_carveout(dtype, lay)});")
        for c in chunks:
            lines.append(f"static_assert(mm_shared_bytes<{ctype}>({c}, "
                         f"{lay.per}, {lay.lanes}) == "
                         f"{P.mm_shared_bytes(c, dtype, lay)}u);")
    text = (CSRC_DIR / "merge_csrmm.cu").read_text()
    checks = "namespace {\n" + "\n".join(lines) + "\n}  // namespace\n"
    proc = _front_end(tmp_path, text + checks)
    assert proc.returncode == 0, proc.stdout
    assert len(lines) > 100
    wrong = lines[-1].replace("u);", "1u);")
    proc = _front_end(tmp_path, text + "namespace {\n" + wrong + "\n}\n")
    assert proc.returncode != 0 and "static assert" in proc.stdout


# PTX instructions the kernel may use: (operand count, positions of its
# shared-memory addresses, positions of its global addresses).
PTX_OPERANDS = {
    "mbarrier.init.shared::cta.b64": (2, {0}, set()),
    "fence.mbarrier_init.release.cluster": (0, set(), set()),
    "mbarrier.arrive.expect_tx.shared::cta.b64": (3, {1}, set()),
    "mbarrier.try_wait.parity.shared::cta.b64": (3, {1}, set()),
    "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes":
        (4, {0, 3}, {1}),
    "atom.acq_rel.gpu.inc.u32": (3, set(), {1}),
    "selp.u32": (4, set(), set()),
}
_LITERALS = re.compile(r'\s*((?:"(?:[^"\\]|\\.)*"\s*)+)', re.S)


def _asm_statements(text: str):
    """(PTX text, operand constraints) of each inline-PTX statement of a
    source: the leading string literals, then the constraints of the
    output and input lists."""
    out = []
    for m in re.finditer(r"asm volatile\((.*?)\);", text, flags=re.S):
        body = m.group(1)
        lit = _LITERALS.match(body)
        code = "".join(re.findall(r'"((?:[^"\\]|\\.)*)"', lit.group(1)))
        rest = body[lit.end():]
        constraints = re.findall(r'"([=+]?[a-z])"\s*\(', rest)
        out.append((code, constraints))
    return out


def test_k1m_inline_ptx_is_well_formed():
    """Every inline-PTX statement of csrc/merge_csrmm.cu (the bulk copies,
    the mbarriers and the ticket): each instruction is
    one the kernel is meant to use, with its number of operands; every %n
    names an operand and every operand is named; shared-memory addresses
    are 32-bit registers ("r") and global ones 64-bit ("l"); the barriers'
    initialisation is fenced."""
    text = (CSRC_DIR / "merge_csrmm.cu").read_text()
    stmts = _asm_statements(text)
    assert len(stmts) >= 6
    seen = set()
    for code, constraints in stmts:
        refs = {int(n) for n in re.findall(r"%(\d+)", code)}
        assert refs == set(range(len(constraints))), (code, constraints)
        for line in code.replace("\\n", "\n").split("\n"):
            line = line.strip().rstrip(";")
            if not line or line in ("{", "}") or line.startswith(".reg"):
                continue
            op, _, args = line.partition(" ")
            assert op in PTX_OPERANDS, op
            seen.add(op)
            count, shared, glob = PTX_OPERANDS[op]
            operands = [a for a in re.split(r",\s*", args.strip()) if a]
            assert len(operands) == count, line
            for pos, operand in enumerate(operands):
                ref = re.fullmatch(r"\[%(\d+)\]", operand)
                if pos in shared | glob:
                    assert ref, line
                    want = "r" if pos in shared else "l"
                    assert constraints[int(ref.group(1))].lstrip("=+") \
                        == want, line
    assert {"cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::"
            "bytes", "mbarrier.init.shared::cta.b64",
            "mbarrier.arrive.expect_tx.shared::cta.b64",
            "mbarrier.try_wait.parity.shared::cta.b64",
            "fence.mbarrier_init.release.cluster",
            "atom.acq_rel.gpu.inc.u32"} <= seen


# nvcc's -Xptxas=-v report for sm_90a, cut to one instantiation
K1_PTXAS = """\
ptxas info    : 4 bytes gmem
ptxas info    : Compiling entry function '_ZN47_GLOBAL__N__13b70a82_14_merge_csrmv_cu_f9dd90f217merge_tile_kernelIdLb1ELi1EEEvPKT_PKiS5_S3_S3_S5_S5_S1_S1_PS1_PiS6_iiiiPj' for 'sm_90a'
ptxas info    : Function properties for _ZN47_GLOBAL__N__13b70a82_14_merge_csrmv_cu_f9dd90f217merge_tile_kernelIdLb1ELi1EEEvPKT_PKiS5_S3_S3_S5_S5_S1_S1_PS1_PiS6_iiiiPj
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 82 registers, used 1 barriers
ptxas info    : Compile time = 183.400 ms
"""

# two instantiations; the second's spill line edited to nonzero bytes, as
# no committed instantiation spills
K1M_PTXAS = """\
ptxas info    : Compiling entry function '_ZN47_GLOBAL__N__94afda1c_14_merge_csrmm_cu_90cc62aa20merge_tile_mm_kernelIfLi4ELb1ELi16EEEvPKT_PKiS5_S3_xS3_xS5_S5_S1_S1_PS1_xPiS6_iiiiiiiPj' for 'sm_90a'
ptxas info    : Function properties for _ZN47_GLOBAL__N__94afda1c_14_merge_csrmm_cu_90cc62aa20merge_tile_mm_kernelIfLi4ELb1ELi16EEEvPKT_PKiS5_S3_xS3_xS5_S5_S1_S1_PS1_xPiS6_iiiiiiiPj
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 62 registers, used 1 barriers
ptxas info    : Compile time = 191.315 ms
ptxas info    : Compiling entry function '_ZN47_GLOBAL__N__94afda1c_14_merge_csrmm_cu_90cc62aa20merge_tile_mm_kernelIdLi2ELb1ELi1EEEvPKT_PKiS5_S3_xS3_xS5_S5_S1_S1_PS1_xPiS6_iiiiiiiPj' for 'sm_90a'
ptxas info    : Function properties for _ZN47_GLOBAL__N__94afda1c_14_merge_csrmm_cu_90cc62aa20merge_tile_mm_kernelIdLi2ELb1ELi1EEEvPKT_PKiS5_S3_xS3_xS5_S5_S1_S1_PS1_xPiS6_iiiiiiiPj
    48 bytes stack frame, 44 bytes spill stores, 36 bytes spill loads
ptxas info    : Used 64 registers, used 1 barriers
ptxas info    : Compile time = 189.965 ms
"""


@pytest.mark.parametrize("log,want", [
    (K1_PTXAS, {"merge_tile_kernel<double,1,1>": (82, 0, 0)}),
    (K1M_PTXAS, {"merge_tile_mm_kernel<float,4,1,16>": (62, 0, 0),
                 "merge_tile_mm_kernel<double,2,1,1>": (64, 44, 36)}),
], ids=["merge_tile", "merge_tile_mm"])
def test_ptxas_report_reads_each_instantiation(log, want):
    """Each entry function of nvcc's report by its template arguments:
    registers, spill-store and spill-load bytes, what chip_smoke.py's
    spill gates test."""
    assert {n: (r.registers, r.spill_stores, r.spill_loads)
            for n, r in ptxas_report(log).items()} == want
