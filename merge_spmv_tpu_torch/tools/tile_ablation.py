"""Ablations of the merge tile kernel (K1) on the card, and its gather
policies, on grid3d100 and the circuit5M and kron classes at full size.

    python -m merge_spmv_tpu_torch.tools.tile_ablation [BASE_SOURCE]

prints one JSON line per measurement.  Every time is the kernel alone, warm,
from CUDA-graph replays (``utils/timers.py::event_ms``), beside cuSPARSE on
the same matrix and timer; the matrices are made on the card with torch
from the distributions of bench/matrices.py (the same classes, not the same
bits: seconds where the host generators take ~100 s).

* The committed kernel through the package: each gather policy at each tile
  size, its blocks of one SM on neighbouring runs (``sm_blocks`` = the
  blocks per SM) or not (1), checked bit for bit against the two-kernel
  path at the same runs, with its largest relative difference from
  cuSPARSE's result.
* With ``BASE_SOURCE``, the text of the tile kernel before its gather
  policies (``git show
  bf5e34b:merge_spmv_tpu_torch/csrc/merge_csrmv.cu``), variants of it made
  by text substitution, written and built under the gitignored
  ``merge_spmv_tpu_torch/build/ablation/`` with the package's nvcc flags
  and loaded by ctypes; none is kept in the tree:
  A0 the kernel; A1 the x gather replaced by a coalesced
  ``x[(nnz0 + j) & 0x7FFFF]`` (what scatter costs); A2_W the columns
  masked to a window of W floats (what L1 capacity is worth); LEAD0 the
  gathers issued right before their use instead of a tile ahead; EVL the
  gathers with an L1 evict_last hint; STAMP ``clock64()`` stamps around
  the tile's four steps (read as shares: they slow the kernel).  Each is
  launched at 1 to 8 blocks per SM, set through the carveout preference
  (an ``extern "C" set_carveout`` appended to the variant), with the
  occupancy the card reports for it.
* With ``--tail``, the tail study, on the matrices where K1 lost to
  cuSPARSE (the long rows: wheel_1m, wheel_2m, gen_powerlaw_1m; the
  row-local 1M-row bands and power laws of tools/make_corpus_stats.py;
  the skew trio at 2^20 x 8, bench/matrices.py::skew_trio) and the ones
  it must not lose on (grid3d100, cant_class in float64, the circuit5M
  and kron classes), made at full size: the gather statistics of
  ops/plan.py (per warp request and per tile); every policy at each of
  its tiles through the package, warm and with a cold L2 (a 256 MB write
  before each launch, its time taken off), beside cuSPARSE on the same
  timer; at each (policy, tile) the plan picks from (``CHOICES``) the
  two-kernel path at the same runs, the unfused tile kernel alone, and
  two variants of the committed
  source: NOTAIL (the fused kernel with its fix-up skipped: a wrong
  result, for timing only) and TAILSTAMP (``clock64()`` and the global
  timer read by the last block before and after its fix-up, into a side
  buffer).  ``--ref FILE`` builds an earlier committed kernel (``git
  show <commit>:merge_spmv_tpu_torch/csrc/merge_csrmv.cu``) as REF and
  times it beside the committed one at each (policy, tile), in turns.
  ``--out PATH`` also writes every line to PATH.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import math
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

from merge_spmv_tpu_torch.bench.matrices import skew_trio
from merge_spmv_tpu_torch.bench.measure import _Flush
from merge_spmv_tpu_torch.formats.coo import CooMatrix
from merge_spmv_tpu_torch.formats.csr import CsrMatrix
from merge_spmv_tpu_torch.ops import csrmv_cuda as K
from merge_spmv_tpu_torch.ops.merge_path import merge_tile_coordinates
from merge_spmv_tpu_torch.ops.plan import (DEFAULT_TILE_ITEMS, L1_TILE_ITEMS,
                                           L1_WIDE_TILE_ITEMS, POLICIES,
                                           gather_choice,
                                           gather_sectors_per_nonzero,
                                           gather_policy, tile_geometry,
                                           tile_sectors, tile_shared_bytes)
from merge_spmv_tpu_torch.tools import gather_rate as GR
from merge_spmv_tpu_torch.utils.cuda_build import BUILD_DIR, NVCC_FLAGS, _nvcc
from merge_spmv_tpu_torch.utils.device import (nvidia_smi_name_power,
                                               peak_hbm_bandwidth)
from merge_spmv_tpu_torch.utils.timers import event_ms

SM_SHARED = 233_472
GATHER = "    xv[u] = j < h.nnz ? __ldg(x + s_col[j]) : V(0);"
CARVEOUT = r'''
extern "C" int set_carveout(int pct) {
  cudaError_t e = cudaFuncSetAttribute(
      merge_tile_kernel<float, true>,
      cudaFuncAttributePreferredSharedMemoryCarveout, pct);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(merge_tile_kernel<float, false>,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             pct);
  return static_cast<int>(e);
}
'''
EVICT_LAST = r'''
__device__ __forceinline__ float ldg_evl(const float* p) {
  float v;
  asm("ld.global.nc.L1::evict_last.f32 %0, [%1];" : "=f"(v) : "l"(p));
  return v;
}
__device__ __forceinline__ double ldg_evl(const double* p) {
  double v;
  asm("ld.global.nc.L1::evict_last.f64 %0, [%1];" : "=d"(v) : "l"(p));
  return v;
}
'''
# (tile items, blocks per SM); a negative tile: the CUDA driver's carveout
A0_CONFIGS = [(2048, 4), (2048, 3), (2048, 2), (2048, 1), (4096, 2),
              (4096, 1), (1024, 8), (1024, 4), (1024, 2), (-2048, 4)]
FEW_CONFIGS = [(2048, 4), (2048, 1), (4096, 1), (1024, 2)]
POLICY_TILES = {"stream": (2048, 4096), "l1": (1024, 2048, 4096)}
# the (policy, tile) pairs the plan picks from (ops/plan.py::gather_choice)
CHOICES = (("stream", DEFAULT_TILE_ITEMS), ("l1", L1_TILE_ITEMS),
           ("l1", L1_WIDE_TILE_ITEMS))
# the fused kernel's tail: the last block's call of the fix-up
TAIL = "    if (s_warp_flag[0])\n"
TAIL_CLOCKS = r'''
__device__ long long g_tail[2];
__device__ __forceinline__ long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return static_cast<long long>(t);
}
'''
READ_TAIL = r'''
extern "C" int read_tail(long long* host) {
  return static_cast<int>(cudaMemcpyFromSymbol(host, g_tail,
                                               2 * sizeof(long long)));
}
'''
# the matrices of the tail study from tools/make_corpus_stats.py
TAIL_CORPUS = ("wheel_1m", "wheel_2m", "gen_powerlaw_1m",
               "banded_n1024k_bw128_d5", "banded_n1024k_bw1024_d5",
               "banded_n1024k_bw128_d9", "banded_n1024k_bw1024_d9",
               "plaw_n1024k_a1p2", "plaw_n1024k_a1p5", "plaw_n1024k_a1p8")


def _sub(text, old, new):
    if text.count(old) != 1:
        raise ValueError(f"the source does not hold exactly one {old!r}")
    return text.replace(old, new)


def variants(src: str) -> dict:
    """The base kernel's variants, by name (see the module docstring)."""
    v = {"A0": src,
         "A1": _sub(src, GATHER, "    xv[u] = j < h.nnz ? __ldg(x + ((h.nnz0"
                    " + j) & 0x7FFFF)) : V(0);")}
    for w in (8192, 32768, 131072):
        v[f"A2_{w}"] = _sub(src, GATHER, "    xv[u] = j < h.nnz ? __ldg(x + "
                            f"(s_col[j] & {w - 1})) : V(0);")
    issue = ("      gather(stages + ((k + 1) & 1) * stage_len, "
             "hdr[(k + 1) & 1], x, xv);\n")
    prep = "    h = prepare(stage, hdr + ((k + 1) & 1), xv, carry, s_prod,"
    v["LEAD0"] = _sub(_sub(src, issue, ""), prep,
                      "    gather(stage, hdr[(k + 1) & 1], x, xv);\n" + prep)
    t = _sub(src, "// Thread i's gathers of the staged tile",
             EVICT_LAST + "// Thread i's gathers of the staged tile")
    v["EVL"] = _sub(t, GATHER, "    xv[u] = j < h.nnz ? ldg_evl(x + s_col[j])"
                    " : V(0);")
    # stamps, thread 0, summed over its run: stage wait and gather issue |
    # reduce, scan and writes | prepare (the gathers are waited for) |
    # the next stage's copy issued
    t = _sub(src, "__device__ unsigned int g_tickets = 0;\n",
             "__device__ unsigned int g_tickets = 0;\n"
             "__device__ long long g_stamps[16384 * 4];\n")
    t = _sub(t, "  for (int t = first, k = 0; t < end; ++t, ++k) {\n",
             "  long long acc_st[4] = {0, 0, 0, 0};\n"
             "  for (int t = first, k = 0; t < end; ++t, ++k) {\n")
    t = _sub(t, "    const bool more = t + 1 < end;\n",
             "    const bool more = t + 1 < end;\n"
             "    long long c0 = clock64();\n")
    t = _sub(t, issue + "    }\n", issue + "    }\n"
             "    long long c1 = clock64(); acc_st[0] += c1 - c0;\n")
    t = _sub(t, "    unsigned char* stage = stages + ((k + 1) & 1) * "
             "stage_len;\n", "    long long c2 = clock64(); acc_st[1] += "
             "c2 - c1;\n    unsigned char* stage = stages + ((k + 1) & 1) * "
             "stage_len;\n")
    fence = ('    asm volatile("fence.proxy.async.shared::cta;" ::: '
             '"memory");\n    __syncthreads();\n')
    t = _sub(t, fence, fence + "    long long c3 = clock64(); "
             "acc_st[2] += c3 - c2;\n")
    t = _sub(t, "      nC = __ldg(tile_nnz + t + 5);\n    }\n  }\n",
             "      nC = __ldg(tile_nnz + t + 5);\n    }\n"
             "    acc_st[3] += clock64() - c3;\n  }\n")
    t = _sub(t, "  if (kFused) {\n    // Once the block's",
             "  if (tid == 0)\n    for (int q = 0; q < 4; ++q)\n"
             "      g_stamps[blockIdx.x * 4 + q] = acc_st[q];\n"
             "  if (kFused) {\n    // Once the block's")
    v["STAMP"] = t + r'''
extern "C" int read_stamps(long long* host, int n) {
  return static_cast<int>(cudaMemcpyFromSymbol(host, g_stamps,
                                               n * sizeof(long long)));
}
'''
    return {k: s + CARVEOUT for k, s in v.items()}


def tail_variants(src: str) -> dict:
    """The committed kernel's tail variants, by name: NOTAIL (the last
    block skips the fix-up) and TAILSTAMP (its clock64() and global-timer
    time, start to end of the fix-up, in a side buffer read by
    ``read_tail``)."""
    if src.count(TAIL) != 1:
        raise ValueError(f"the source does not hold exactly one {TAIL!r}")
    at = src.index(TAIL) + len(TAIL)
    call = src[at:src.index(";\n", at) + 2]
    stamp = ("    if (s_warp_flag[0]) {\n"
             "      const long long c0 = clock64(), n0 = global_ns();\n"
             + call +
             "      __syncthreads();\n"
             "      if (tid == 0) {\n"
             "        g_tail[0] = clock64() - c0;\n"
             "        g_tail[1] = global_ns() - n0;\n"
             "      }\n"
             "    }\n")
    t = _sub(src, "__device__ unsigned int g_tickets = 0;\n",
             "__device__ unsigned int g_tickets = 0;\n" + TAIL_CLOCKS)
    return {"NOTAIL": _sub(src, TAIL + call, "    if (false)\n" + call),
            "TAILSTAMP": _sub(t, TAIL + call, stamp) + READ_TAIL}


def _build(item, committed=False):
    """Build one variant; ``committed``: the committed kernel's entry
    (with SM grouping and policy), else the base's."""
    name, src = item
    out = BUILD_DIR / "ablation"
    out.mkdir(parents=True, exist_ok=True)
    cu, so = out / f"{name}.cu", out / f"lib{name}.so"
    cu.write_text(src)
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(so), str(cu)],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                          text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed for {name}:\n{proc.stdout}")
    lib = ctypes.CDLL(str(so))
    P, I, D = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
    if committed:
        for sfx in ("f32", "f64"):
            getattr(lib, f"merge_tile_{sfx}").argtypes = \
                [P] * 7 + [D, D] + [P] * 3 + [I] * 8 + [P, P]
    else:
        lib.merge_tile_f32.argtypes = [P] * 7 + [D, D] + [P] * 3 + \
            [I] * 6 + [P, P]
        lib.merge_tile_occupancy_f32.argtypes = [I, I, I, ctypes.POINTER(I),
                                                 ctypes.POINTER(I)]
        lib.set_carveout.argtypes = [I]
    if lib.merge_csrmv_init():
        raise RuntimeError(f"merge_csrmv_init failed for {name}")
    return name, lib


def _circuit(dev, n=5_558_326, nnz=59_524_291, seed=0):
    """bench/matrices.py::make_circuit_like's distribution, on the card."""
    g = torch.Generator(device=dev).manual_seed(seed)
    raw = torch.rand(n, generator=g, device=dev, dtype=torch.float64
                     ).clamp_min(1e-300).pow(-1 / 1.8)
    deg = torch.clamp((raw * (nnz / raw.sum())).long(), min=1)
    rows = torch.repeat_interleave(torch.arange(n, device=dev), deg)
    u = torch.rand(rows.numel(), generator=g, device=dev,
                   dtype=torch.float64) - 0.5
    off = (-25000.0 * torch.sign(u) * torch.log1p(-2 * u.abs())).clamp(
        -65536, 65535).long()
    cols = torch.clamp(rows + off, 0, n - 1)
    return n, rows, cols


def _kron(dev, scale=20, nnz=50_000_000, seed=16):
    """bench/matrices.py::rmat's distribution, on the card."""
    g = torch.Generator(device=dev).manual_seed(seed)
    a, b, c = 0.57, 0.19, 0.19
    rows = torch.zeros(nnz, dtype=torch.int64, device=dev)
    cols = torch.zeros_like(rows)
    for level in range(scale):
        r = torch.rand(nnz, generator=g, device=dev, dtype=torch.float64)
        rows |= (r >= a + b).long() << level
        cols |= (((r >= a) & (r < a + b)) | (r >= a + b + c)).long() << level
    return int(max(rows.max(), cols.max())) + 1, rows, cols


class _Matrix:
    def __init__(self, name, n, rows, cols, dev, dtype=torch.float32):
        key, _ = torch.sort(rows * n + cols)
        ends = torch.cumsum(torch.bincount(key // n, minlength=n),
                            0).to(torch.int32)
        self._setup(name, n, n, ends, (key % n).to(torch.int32), dev, dtype)

    @classmethod
    def from_csr(cls, name, csr, dev, dtype=torch.float32):
        """A host CSR's structure on the card (its values redrawn)."""
        m = cls.__new__(cls)
        m._setup(name, csr.num_rows, csr.num_cols,
                 torch.from_numpy(csr.row_offsets[1:].astype(np.int32)
                                  ).to(dev),
                 torch.from_numpy(csr.col_indices.astype(np.int32)).to(dev),
                 dev, dtype)
        return m

    def _setup(self, name, n, num_cols, ends, cols, dev, dtype):
        g = torch.Generator(device=dev).manual_seed(1)
        self.name, self.n, self.nnz, self.dev = name, n, cols.numel(), dev
        self.dtype, self.cols, self.ends = dtype, cols, ends
        self.values = (torch.rand(self.nnz, generator=g, device=dev)
                       + 0.5).to(dtype)
        self.x = (torch.rand(num_cols, generator=g, device=dev)
                  + 0.5).to(dtype)
        starts = torch.cat([self.ends.new_zeros(1), self.ends])
        self.sp = torch.sparse_csr_tensor(starts, self.cols, self.values,
                                          size=(n, num_cols))
        self.want = torch.mv(self.sp, self.x)
        self.cusparse_ms = event_ms(lambda: torch.mv(self.sp, self.x))
        self._tiles = {}

    def tiles(self, T):
        if T not in self._tiles:
            self._tiles[T] = merge_tile_coordinates(self.ends, self.nnz, T)
        return self._tiles[T]

    def rel_err(self, y):
        return float(((y - self.want).abs()
                      / (self.want.abs() + 1e-6)).max())


def _matrices(dev):
    g3 = CsrMatrix.from_coo(CooMatrix.grid3d(100))
    starts = torch.from_numpy(g3.row_offsets.astype(np.int64)).to(dev)
    rows = torch.repeat_interleave(torch.arange(g3.num_rows, device=dev),
                                   starts[1:] - starts[:-1])
    cols = torch.from_numpy(g3.col_indices.astype(np.int64)).to(dev)
    return [_Matrix("grid3d100", g3.num_rows, rows, cols, dev),
            _Matrix("circuit5M", *_circuit(dev), dev),
            _Matrix("kron", *_kron(dev), dev)]


def _launcher(lib, M, T, run, sm_blocks, policy=None):
    """One fused launch of ``lib``'s tile kernel on M (a policy for the
    committed kernel, whose entry takes one; none for the base's)."""
    tr, tn = M.tiles(T)
    num_tiles = tr.shape[0] - 1
    G = -(-num_tiles // run)
    y = torch.empty(M.n, device=M.dev, dtype=M.dtype)
    crow = torch.empty(G, dtype=torch.int32, device=M.dev)
    cval = torch.empty(G, device=M.dev, dtype=M.dtype)
    tickets = torch.zeros(1, dtype=torch.int32, device=M.dev)
    head = (M.values.data_ptr(), M.cols.data_ptr(), M.ends.data_ptr(),
            M.x.data_ptr(), None, tr.data_ptr(), tn.data_ptr(), 1.0, 0.0,
            y.data_ptr(), crow.data_ptr(), cval.data_ptr(), M.n, num_tiles,
            run)
    shape = (T // 8, tile_shared_bytes(T, M.dtype), 1)
    args = (head + (sm_blocks,) + shape + (POLICIES.index(policy),)
            if policy else head + shape)
    entry = getattr(lib, "merge_tile_f64" if M.dtype == torch.float64
                    else "merge_tile_f32")

    def launch():
        rc = entry(*args, tickets.data_ptr(),
                   torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"launch failed: {rc}")
    return launch, y, G


_OUT = []   # the --out file, if any


def _emit(row):
    line = json.dumps(row)
    print(line, flush=True)
    for path in _OUT:
        with open(path, "a") as f:
            f.write(line + "\n")


def policies(mats, dev):
    """The committed kernel: policy x tile x SM grouping."""
    lib = K._device_lib(dev.index or 0)
    for M in mats:
        chosen = gather_policy(M.n, M.nnz, M.cols)
        for policy, tiles in POLICY_TILES.items():
            for T in tiles:
                tr, tn = M.tiles(T)
                geo = K.launch_geometry(tr.shape[0] - 1, T, torch.float32,
                                        dev, True, policy)
                k = geo.blocks_per_sm
                two = K.carry_fixup(*K.merge_tile(
                    M.values, M.cols, M.ends, M.x, tr, tn, T,
                    run_tiles=geo.run_tiles, policy=policy))
                for sm_blocks in sorted({1, k if geo.grid % k == 0 else 1}):
                    launch, y, _ = _launcher(lib, M, T, geo.run_tiles,
                                             sm_blocks, policy)
                    launch()
                    ms = event_ms(launch, iters=30)
                    _emit({"matrix": M.name, "kernel": "committed",
                           "policy": policy, "chosen": chosen, "T": T,
                           "blocks_per_sm": k, "grid": geo.grid,
                           "run": geo.run_tiles, "sm_blocks": sm_blocks,
                           "ms": ms, "cusparse_ms": M.cusparse_ms,
                           "vs_cusparse": ms / M.cusparse_ms,
                           "two_kernels_bitwise": bool(torch.equal(y, two)),
                           "rel_err": M.rel_err(y)})


def base_variants(mats, dev, src):
    """The base kernel's variants at 1-8 blocks per SM."""
    t0 = time.perf_counter()
    vs = variants(src)
    with ThreadPoolExecutor(len(vs)) as pool:
        libs = dict(pool.map(_build, vs.items()))
    _emit({"built": sorted(libs), "s": time.perf_counter() - t0})
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    plan = {name: A0_CONFIGS if name == "A0" else FEW_CONFIGS
            for name in libs}
    plan["STAMP"] = [(2048, 4), (1024, 2), (4096, 1)]
    for M in mats:
        ref = {}
        for name, configs in plan.items():
            lib = libs[name]
            for T0, nb in configs:
                T = abs(T0)
                shared = tile_shared_bytes(T, "float32")
                pct = -1 if T0 < 0 else min(100, math.ceil(
                    100 * nb * (shared + 1024) / SM_SHARED))
                rc = lib.set_carveout(pct)
                occ, regs = ctypes.c_int(0), ctypes.c_int(0)
                lib.merge_tile_occupancy_f32(1, T // 8, shared,
                                             ctypes.byref(occ),
                                             ctypes.byref(regs))
                geo = tile_geometry(M.tiles(T)[0].shape[0] - 1, T,
                                    num_sms=sms, blocks_per_sm=nb)
                launch, y, G = _launcher(lib, M, T, geo.run_tiles, 1)
                launch()
                ms = event_ms(launch, iters=30)
                row = {"matrix": M.name, "kernel": name, "T": T,
                       "blocks_per_sm": nb, "carveout_pct": pct, "rc": rc,
                       "occupancy": occ.value, "grid": G,
                       "run": geo.run_tiles, "ms": ms,
                       "vs_cusparse": ms / M.cusparse_ms}
                if name == "A0":
                    ref[T0, nb] = y.clone()
                    row["rel_err"] = M.rel_err(y)
                elif name in ("LEAD0", "EVL", "STAMP"):
                    row["a0_bitwise"] = bool(torch.equal(y, ref[T0, nb]))
                if name == "STAMP":
                    buf = (ctypes.c_longlong * (G * 4))()
                    lib.read_stamps(buf, G * 4)
                    a = np.frombuffer(buf, dtype=np.int64).reshape(G, 4)
                    row["cycles_per_tile"] = float(a.sum(1).mean()
                                                   / geo.run_tiles)
                    row["shares"] = (a.sum(0) / a.sum()).round(3).tolist()
                _emit(row)


def _tail_matrices(dev):
    """The tail study's matrices, one at a time (see the docstring)."""
    from merge_spmv_tpu_torch.tools.bench_baseline_configs import cant_csr
    from merge_spmv_tpu_torch.tools.make_corpus_stats import build_gens
    gens = build_gens()
    for name in TAIL_CORPUS:
        yield _Matrix.from_csr(name, CsrMatrix.from_coo(gens[name]()), dev)
    for label, csr in skew_trio(1 << 20, 8):
        yield _Matrix.from_csr(f"skew_{label}", csr, dev)
    yield _Matrix.from_csr("grid3d100",
                           CsrMatrix.from_coo(CooMatrix.grid3d(100)), dev)
    yield _Matrix.from_csr("cant_class_f64", cant_csr(np.float64), dev,
                           torch.float64)
    yield _Matrix("circuit5M", *_circuit(dev), dev)
    yield _Matrix("kron", *_kron(dev), dev)


def tail_study(dev, ref_src=None):
    """The tail study (``--tail``): one line per matrix."""
    t0 = time.perf_counter()
    vs = tail_variants((BUILD_DIR.parent / "csrc" / "merge_csrmv.cu")
                       .read_text())
    if ref_src is not None:
        vs["REF"] = ref_src
    with ThreadPoolExecutor(len(vs)) as pool:
        libs = dict(pool.map(lambda item: _build(item, committed=True),
                             vs.items()))
    _emit({"built": sorted(libs), "s": time.perf_counter() - t0})
    flush = _Flush(dev)
    for M in _tail_matrices(dev):
        t1 = time.perf_counter()
        dt = "float64" if M.dtype == torch.float64 else "float32"
        row = {"matrix": M.name, "rows": M.n, "nnz": M.nnz, "dtype": dt,
               "choice": gather_choice(M.n, M.nnz, M.cols, dt),
               "request_sectors_per_nnz": gather_sectors_per_nonzero(
                   M.cols, dt),
               "tile_sectors": {T: tile_sectors(M.n, M.cols, dt, T)
                                for T in (1024, 2048)},
               "cusparse_ms": M.cusparse_ms,
               "cusparse_cold_ms": flush.cold_ms(
                   lambda: torch.mv(M.sp, M.x))}
        tickets = K.ticket_counter(dev)
        for policy in POLICIES:
            for T in POLICY_TILES[policy]:
                tr, tn = M.tiles(T)
                args = (M.values, M.cols, M.ends, M.x, tr, tn, T)

                def fused(args=args, policy=policy):
                    return K.merge_csrmv(*args, tickets=tickets,
                                         policy=policy)
                geo = K.launch_geometry(tr.shape[0] - 1, T, M.dtype, dev,
                                        True, policy)
                y = fused()
                e = {"G": geo.grid, "run": geo.run_tiles,
                     "blocks_per_sm": geo.blocks_per_sm,
                     "ms": event_ms(fused, iters=20),
                     "cold_ms": flush.cold_ms(fused),
                     "rel_err": M.rel_err(y)}
                if (policy, T) in CHOICES:
                    e.update(_tail_parts(M, T, policy, geo, y, libs,
                                         flush, tickets))
                row[f"{policy}_{T}"] = e
        row["s"] = time.perf_counter() - t1
        _emit(row)
        del M


def _tail_parts(M, T, policy, geo, y, libs, flush, tickets):
    """At a (policy, tile) of CHOICES: the two kernels at the fused runs,
    the unfused kernel alone, NOTAIL, TAILSTAMP and REF."""
    tr, tn = M.tiles(T)
    args = (M.values, M.cols, M.ends, M.x, tr, tn, T)
    run = geo.run_tiles
    two = K.carry_fixup(*K.merge_tile(*args, run_tiles=run, policy=policy))
    out = {"two_kernels_bitwise": bool(torch.equal(y, two)),
           "two_kernels_ms": event_ms(lambda: K.carry_fixup(*K.merge_tile(
               *args, run_tiles=run, policy=policy)), iters=20),
           "unfused_ms": event_ms(lambda: K.merge_tile(
               *args, run_tiles=run, policy=policy), iters=20)}
    sm_blocks = geo.blocks_per_sm if geo.grid % geo.blocks_per_sm == 0 else 1
    for name, lib in libs.items():
        launch, yv, _ = _launcher(lib, M, T, run, sm_blocks, policy)
        launch()
        out[f"{name}_ms"] = event_ms(launch, iters=20)
        if name == "TAILSTAMP":
            launch()
            torch.cuda.synchronize()
            buf = (ctypes.c_longlong * 2)()
            lib.read_tail(buf)
            out["tail_cycles"], out["tail_ns"] = buf[0], buf[1]
        elif name == "NOTAIL":
            out["NOTAIL_cold_ms"] = flush.cold_ms(launch)
        else:
            out[f"{name}_cold_ms"] = flush.cold_ms(launch)
            out[f"{name}_rel_err"] = M.rel_err(yv)
    # the committed kernel again, after the variants: in turns
    out["ms_again"] = event_ms(lambda: K.merge_csrmv(
        *args, tickets=tickets, policy=policy), iters=20)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("base", nargs="?", default=None,
                    help="the tile kernel before its gather policies "
                    "(commit bf5e34b), for its variants")
    ap.add_argument("--tail", action="store_true",
                    help="the tail study (and nothing else)")
    ap.add_argument("--ref", default=None,
                    help="an earlier committed kernel, timed as REF")
    ap.add_argument("--out", default=None, help="also write the lines here")
    args = ap.parse_args(sys.argv[1:] if argv is None else argv)
    if args.out:
        _OUT.append(args.out)
    dev = torch.device("cuda")
    peak = peak_hbm_bandwidth(dev)
    _emit({"nvidia_smi": nvidia_smi_name_power(),
           "torch": torch.__version__})
    if args.tail:
        tail_study(dev, None if args.ref is None
                   else Path(args.ref).read_text())
        return 0
    rates = GR.measure()
    _emit({"gather_rate": rates})
    mats = _matrices(dev)
    for M in mats:
        sectors = GR.warp_sectors(M.cols)
        streams = M.nnz * 8 + M.n * 8
        probe = min(rates.values(),
                    key=lambda r: abs(r["x_bytes"] - M.n * 4))
        _emit({"matrix": M.name, "rows": M.n, "nnz": M.nnz,
               "sectors_per_nnz": sectors / M.nnz,
               "cusparse_ms": M.cusparse_ms,
               "bytes_bound_ms": (streams + M.n * 4) / peak / 1e6,
               "gather_bound_ms": GR.gather_bound_ms(
                   sectors, streams, probe["sector_rate_gbps"], peak)})
    policies(mats, dev)
    if args.base:
        base_variants(mats, dev, Path(args.base).read_text())
    return 0


if __name__ == "__main__":
    sys.exit(main())
