"""Ablations of the multi-RHS tile kernel (K1m) on the card: variants of
its source timed in one run beside cuSPARSE SpMM, on the cant and pdb1HYS
classes at k = 8 and 32, grid3d(60) at k = 32 and grid3d(100) at k = 4
(the smoke run's op.mm).

    python -m merge_spmv_tpu_torch.tools.mm_ablation [--base PATH]
        [--only A0,NOTAIL,...] [--cells cant:8,grid3d100:4,...] [--out PATH]

prints one JSON line per measurement.  Every time is the kernel alone,
warm, from CUDA-graph replays (``utils/timers.py::event_ms``); cuSPARSE
SpMM (``torch.sparse.mm``) runs on the same X in the same run, and each
cell's bytes bound and gather bound (``tools/gather_rate.py::
measure_rows`` at the matrix's columns) are recorded beside it.  The
variants are text substitutions of csrc/merge_csrmm.cu, written and built
under the gitignored ``merge_spmv_tpu_torch/build/mm_ablation/`` with the
package's nvcc flags and loaded by ctypes; none is kept in the tree.
Each result is checked bit for bit against ``merge_csrmm``'s at the same
launch (``equal_to_merge_csrmm``).

The committed kernel's variants:

* A0: the kernel as committed;
* NOTAIL: the fix-up tail skipped (a wrong result): what the tail costs;
* TAIL0: the previous kernel's tail (four pairs a walker a round, each
  pair's row and its neighbours' rows loaded from L2 before its Y row)
  for fix_up;
* SEARCH2: two merge-path searches a walker (its start and its end) for
  one search and the barrier that passes the ends;
* ELEM: the previous kernel's per-element cp.async staging (every
  thread, 4 or 8 bytes a copy, arriving on the stage's mbarrier) for the
  bulk copies;
* B2, B3, B4: 2, 3 or 4 X rows a register batch in every layout;
* T6, T8: 6 or 8 carry pairs a walker a round of the tail (4);
* P8: eight columns a lane (two 16-byte loads a row) where k is a
  multiple of 8, so a walker of k = 32 is four lanes: half the lanes
  repeat each nonzero's shared-memory loads and row-close test;
* LB3: four rows a batch in every layout under launch bounds of three
  blocks an SM (80 registers a thread instead of 64);
* RING4, RING8, RING16: the register batches replaced by a ring of 4, 8
  or 16 X-row slots a walker in shared memory, filled by cp.async while
  the row D nonzeros back is added (``WALK_RING``);
* COAL: the X row of a chunk's nonzero j replaced by row ``(2048 * b +
  j) % 32768`` in block b, in nonzero order: the same bytes with no
  scatter;
* WIN: the column indices masked to the first 1024 rows of X (128 KB at
  k = 32): what L1 hits are worth;
* STAMP: ``clock64()`` stamps of thread 0 summed over its run (see
  ``STAMPS``), read as shares: the stamps slow the kernel.

Each variant runs at the blocks per SM its own occupancy allows (its
runs cut for them) and is reported with the instantiations whose
``-Xptxas=-v`` report shows spills (``spilled``).

``--base PATH`` adds the previous kernel (``git show
51a0a74:merge_spmv_tpu_torch/csrc/merge_csrmm.cu``, saved to a file) in
the same run: BASE as it was, and STAMPB, its walk stamped per batch
(``STAMPS_BASE``).  ``--only`` builds and times the named variants alone.
Writes the records to ``--out`` (a JSON list) when given.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from merge_spmv_tpu_torch.bench.measure import library_csr, spmm_bytes
from merge_spmv_tpu_torch.formats.coo import CooMatrix
from merge_spmv_tpu_torch.formats.csr import CsrMatrix
from merge_spmv_tpu_torch.ops import csrmv_cuda as K
from merge_spmv_tpu_torch.ops.operator import build_operator
from merge_spmv_tpu_torch.ops.plan import MmLayout, mm_shared_bytes
from merge_spmv_tpu_torch.tools import bench_baseline_configs as BC
from merge_spmv_tpu_torch.tools import gather_rate as GR
from merge_spmv_tpu_torch.utils.cuda_build import (BUILD_DIR, CSRC_DIR,
                                                   NVCC_FLAGS, _nvcc,
                                                   raw_stream)
from merge_spmv_tpu_torch.utils.device import (nvidia_smi_name_power,
                                               peak_hbm_bandwidth)
from merge_spmv_tpu_torch.utils.timers import event_ms

CELLS = (("cant", 8), ("cant", 32), ("pdb1HYS", 8), ("pdb1HYS", 32),
         ("grid3d60", 32), ("grid3d100", 4))
MATRICES = {
    "cant": lambda: BC.cant_csr(np.float32),
    "pdb1HYS": BC.pdb1hys_csr,
    "grid3d60": lambda: CsrMatrix.from_coo(CooMatrix.grid3d(60)).astype(
        np.float32),
    "grid3d100": lambda: CsrMatrix.from_coo(CooMatrix.grid3d(100)).astype(
        np.float32),
}
STAMP_SLOTS = 8
READ_STAMPS = r'''
extern "C" int read_stamps(long long* host, int n) {
  return static_cast<int>(cudaMemcpyFromSymbol(host, g_stamps,
                                               n * sizeof(long long)));
}
'''
TICKETS = "__device__ unsigned int g_mm_tickets = 0;\n"
STAMP_DECL = (TICKETS + "__device__ long long g_stamps[4096 * 8];\n"
              "__device__ double g_sink[4096];\n"
              "__device__ __forceinline__ void touch(float& s, float v) {\n"
              "  asm volatile(\"add.f32 %0, %0, %1;\" : \"+f\"(s) : "
              "\"f\"(v));\n}\n"
              "__device__ __forceinline__ void touch(double& s, double v) {\n"
              "  asm volatile(\"add.f64 %0, %0, %1;\" : \"+d\"(s) : "
              "\"d\"(v));\n}\n")
STAMP_OUT = ("  if (tid == 0) {\n"
             "    for (int q = 0; q < 8; ++q)\n"
             "      g_stamps[blockIdx.x * 8 + q] = acc_st[q];\n"
             "    g_sink[blockIdx.x] = sink;\n"
             "  }\n")

# The previous kernel's stamps (STAMPB), by slot.  wait: the chunk's
# copies and the barrier after; search: the two merge-path searches;
# walk: the walker's whole walk, split into issue (a batch's s_col loads
# and X-row load issues), xwait (until its first X value is in a
# register), close (the row-close loops) and add (the rest: the adds and
# the later values' waits); scan: the scan and the first rows' writes.
STAMPS_BASE = ("wait", "search", "walk", "scan", "issue", "xwait", "close",
            "add")
# The committed kernel's, by slot (STAMP): wait (for the chunk's bulk
# copies), search (the walker's one search and the barrier that passes
# the ends), walk, scan; the walk split into issue (a batch's column loads
# and row-load issues), xwait (until the batch's first X value is in a
# register), close (the row-close loops) and add (the rest).
STAMPS = ("wait", "search", "walk", "scan", "issue", "xwait", "close", "add")


def _sub(text, old, new):
    if text.count(old) != 1:
        raise ValueError(f"the source does not hold exactly one {old!r}")
    return text.replace(old, new)


def base_shared_bytes(chunk_items: int, value_bytes: int, width: int) -> int:
    """The previous kernel's dynamic shared memory: the warps' scan totals
    and flags and two stages of chunk_items * (value + 4) bytes."""
    return 8 * width * value_bytes + 8 * 4 + 2 * chunk_items * (
        value_bytes + 4)


def _stamped_base(src: str) -> str:
    t = _sub(src, TICKETS, STAMP_DECL)
    t = _sub(t, "  for (int c = 0; c < num_chunks; ++c) {\n",
             "  long long acc_st[8] = {0, 0, 0, 0, 0, 0, 0, 0};\n"
             "  V sink = V(0);\n"
             "  for (int c = 0; c < num_chunks; ++c) {\n"
             "    long long c0 = clock64();\n")
    t = _sub(t, "    __syncthreads();   // every thread's copies of chunk c "
             "have landed\n", "    __syncthreads();   // every thread's "
             "copies of chunk c have landed\n    long long c1 = clock64(); "
             "acc_st[0] += c1 - c0;\n")
    t = _sub(t, "    const int j_end = d1 - i_end;\n",
             "    const int j_end = d1 - i_end;\n    long long c2 = "
             "clock64(); acc_st[1] += c2 - c1;\n")
    t = _sub(t, "      V xv[kBatch][kPer];\n",
             "      V xv[kBatch][kPer];\n      long long b0 = clock64();\n")
    t = _sub(t, "#pragma unroll\n      for (int u = 0; u < kBatch; ++u) {\n"
             "        const int j = jb + u;\n",
             "      long long b1 = clock64(); acc_st[4] += b1 - b0;\n"
             "      touch(sink, xv[0][0]);\n"
             "      long long b2 = clock64(); acc_st[5] += b2 - b1;\n"
             "      long long cl = 0;\n"
             "#pragma unroll\n      for (int u = 0; u < kBatch; ++u) {\n"
             "        const int j = jb + u;\n")
    t = _sub(t, "        for (; i < i_end && s_re[i] - n_lo <= j; ++i) {\n",
             "        long long q0 = clock64();\n"
             "        for (; i < i_end && s_re[i] - n_lo <= j; ++i) {\n")
    t = _sub(t, "        const V a = s_val[j];\n",
             "        cl += clock64() - q0;\n        const V a = s_val[j];\n")
    t = _sub(t, "    }\n    for (; i < i_end; ++i) {   // rows that end after "
             "the walker's last nonzero\n",
             "      long long b3 = clock64(); acc_st[6] += cl; "
             "acc_st[7] += b3 - b2 - cl;\n    }\n    long long t4 = "
             "clock64();\n    for (; i < i_end; ++i) {   // rows that end "
             "after the walker's last nonzero\n")
    t = _sub(t, "    __syncwarp();\n", "    long long c3 = clock64(); "
             "acc_st[6] += c3 - t4; acc_st[2] += c3 - c2;\n"
             "    __syncwarp();\n")
    t = _sub(t, "    __syncthreads();   // the stage and the warp totals are "
             "free again\n", "    __syncthreads();   // the stage and the "
             "warp totals are free again\n    acc_st[3] += clock64() - "
             "c3;\n")
    t = _sub(t, "  // The run's carry pair", STAMP_OUT +
             "  // The run's carry pair")
    return t + READ_STAMPS


def base_variants(base: str) -> dict:
    """The previous kernel as it was, and with its walk stamped per
    batch."""
    return {"BASE": lambda: base, "STAMPB": lambda: _stamped_base(base)}


# The ring the register pipeline was measured against (RING4, RING8,
# RING16): the X row of nonzero j + D copied by cp.async into a ring of D
# row slots in shared memory (slot-major: a slot holds one row of every
# walker) while nonzero j is added; rows in flight hold no registers.
WALK_RING = r"""// --- the ring: X rows copied by cp.async ---

// kBytes (4, 8 or 16) from src to shared dst through L1 (.ca: the band's
// neighbouring rows hit there); src_bytes = 0 fills zeros.
template <int kBytes>
__device__ __forceinline__ void copy_async(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;"
               :: "r"(smem_u32(dst)), "l"(src), "n"(kBytes), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void commit_group() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void wait_group() {
  asm volatile("cp.async.wait_group %0;" :: "n"(kPending) : "memory");
}

// Lane l's columns of X row `row` into its slot (the walker's row in one
// ring slot), zeros past column k.
template <typename V, int kPer, bool kVector, int kLanes>
__device__ __forceinline__ void copy_row(V* slot, const V* row, int l,
                                         int k) {
  if constexpr (kVector) {
    constexpr int kBytes = kPer * static_cast<int>(sizeof(V));
    const bool in = l * kPer < k;
    copy_async<kBytes>(slot + l * kPer, in ? row + l * kPer : row,
                       in ? kBytes : 0);
  } else {
#pragma unroll
    for (int e = 0; e < kPer; ++e) {
      const int c = l + e * kLanes;
      copy_async<static_cast<int>(sizeof(V))>(
          slot + c, c < k ? row + c : row, c < k ? static_cast<int>(sizeof(V))
                                                 : 0);
    }
  }
}

template <typename V, int kPer, bool kVector, int kLanes>
__device__ __forceinline__ void read_slot(const V* slot, int l,
                                          V (&out)[kPer]) {
  if constexpr (kVector) {
    using T = typename Vec<V, kPer>::T;
    unpack(reinterpret_cast<const T*>(slot)[l], out);
  } else {
#pragma unroll
    for (int e = 0; e < kPer; ++e) out[e] = slot[l + e * kLanes];
  }
}

// The walk of nonzeros [j, j_end) and rows [i, i_end) of a chunk, the X row
// of nonzero j + D copied into the walker's ring slot while nonzero j is
// added.  `ring` is the walker's row in slot 0; slots are kThreads * kPer
// values apart.  The next row end is kept in a register, so a nonzero that
// closes no row reads no row end.
template <typename V, int kPer, bool kVector, int kLanes>
__device__ __forceinline__ void walk_ring(
    const StageView<V>& st, int n_lo, int i, int i_end, int j, int j_end,
    const V* X, long long ldx, V* ring, const RowSink<V>& out,
    Walk<V, kPer>& w) {
  constexpr int kDepth = RING_DEPTH;
  constexpr int kSlot = kThreads * kPer;
  static_assert((kDepth & (kDepth - 1)) == 0, "ring depth: a power of two");
  const int j0 = j;
#pragma unroll
  for (int s = 0; s < kDepth; ++s) {
    if (j0 + s < j_end)
      copy_row<V, kPer, kVector, kLanes>(
          ring + s * kSlot, x_row(X, ldx, st.col, j0 + s), out.l,
          out.k);
    commit_group();
  }
  int next_end = i < i_end ? st.re[i] - n_lo : 0x7fffffff;
  for (; j < j_end; ++j) {
    while (next_end <= j) {   // rows that end before nonzero j
      close_row<V, kPer, kVector, kLanes>(w, out, i);
      ++i;
      next_end = i < i_end ? st.re[i] - n_lo : 0x7fffffff;
    }
    wait_group<kDepth - 1>();   // nonzero j's row has landed
    V* slot = ring + ((j - j0) & (kDepth - 1)) * kSlot;
    V xv[kPer];
    read_slot<V, kPer, kVector, kLanes>(slot, out.l, xv);
    const V a = st.val[j];
#pragma unroll
    for (int e = 0; e < kPer; ++e) w.acc[e] += a * xv[e];
    if (j + kDepth < j_end)
      copy_row<V, kPer, kVector, kLanes>(
          slot, x_row(X, ldx, st.col, j + kDepth), out.l, out.k);
    commit_group();
  }
  for (; i < i_end; ++i)   // rows that end after the walker's last nonzero
    close_row<V, kPer, kVector, kLanes>(w, out, i);
}

"""

# The previous kernel's tail (TAIL0): kTail pairs a walker at a time,
# each pair's row, its neighbours' rows and its carry loaded from L2, then
# the Y rows of the pairs that lead their row, a row's further carries one
# dependent load at a time.
TAIL_BASE = r"""  const int num_pairs = static_cast<int>(gridDim.x);
  for (int base = walker; base < num_pairs; base += num_walkers * kTail) {
    int r[kTail], r_next[kTail];
    bool lead[kTail];
    V s[kTail][kPer];
#pragma unroll
    for (int u = 0; u < kTail; ++u) {
      const int t = base + u * num_walkers;
      lead[u] = false;
      r[u] = r_next[u] = -1;
      if (t < num_pairs) {
        r[u] = __ldcg(carry_row + t);
        const int r_before = __ldcg(carry_row + max(t - 1, 0));
        r_next[u] = t + 1 < num_pairs ? __ldcg(carry_row + t + 1) : -1;
        lead[u] = r[u] < num_rows && (t == 0 || r_before != r[u]);
        load_row<V, kPer, kVector, kLanes, true>(
            carry_val + static_cast<long long>(t) * k, wl, k, s[u]);
      }
    }
    V yv[kTail][kPer];
#pragma unroll
    for (int u = 0; u < kTail; ++u) {
      if (!lead[u]) continue;
      if (r_next[u] == r[u]) {
        const int t = base + u * num_walkers;
        for (int w = t + 1; w < num_pairs && __ldcg(carry_row + w) == r[u];
             ++w) {
          V more[kPer];
          load_row<V, kPer, kVector, kLanes, true>(
              carry_val + static_cast<long long>(w) * k, wl, k, more);
#pragma unroll
          for (int e = 0; e < kPer; ++e) s[u][e] += more[e];
        }
      }
      load_row<V, kPer, kVector, kLanes, true>(
          Y + static_cast<long long>(r[u]) * ldy, wl, k, yv[u]);
    }
#pragma unroll
    for (int u = 0; u < kTail; ++u) {
      if (!lead[u]) continue;
#pragma unroll
      for (int e = 0; e < kPer; ++e) yv[u][e] += alpha * s[u][e];
      store_row<V, kPer, kVector, kLanes>(
          Y + static_cast<long long>(r[u]) * ldy, wl, k, yv[u]);
    }
  }
"""

# Per-element cp.async staging (ELEM), the previous kernel's: every
# thread copies its share of the chunk four or eight bytes at a time and
# arrives on the stage's barrier when its copies have landed.
STAGE_ELEM = r"""template <typename V>
__device__ __forceinline__ void stage_chunk(const V* values, const int* cols,
                                            const int* row_end, int r0,
                                            int r1, int n0, int n1,
                                            int chunk_items,
                                            unsigned char* stage,
                                            uint64_t* bar) {
  const int nnz = min(max(n1 - n0, 0), chunk_items);
  const int rows = min(max(r1 - r0, 0), chunk_items - nnz);
  const StageView<V> v = stage_view(stage, values, cols, row_end, r0, rows,
                                    n0, chunk_items);
  for (int i = threadIdx.x; i < rows; i += kThreads)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;"
                 :: "r"(smem_u32(v.re + i)), "l"(row_end + r0 + i)
                 : "memory");
  for (int j = threadIdx.x; j < nnz; j += kThreads) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;"
                 :: "r"(smem_u32(v.col + j)), "l"(cols + n0 + j)
                 : "memory");
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;"
                 :: "r"(smem_u32(v.val + j)), "l"(values + n0 + j),
                    "n"(sizeof(V)) : "memory");
  }
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];"
               :: "r"(smem_u32(bar)) : "memory");
}
"""

STAMP_DECL_NEW = ("namespace {\n\n" + STAMP_DECL[len(TICKETS):])
STAMP_OUT_NEW = ("  if (tid == 0)\n"
                 "    for (int q = 0; q < 4; ++q)\n"
                 "      g_stamps[blockIdx.x * 8 + q] = acc_st[q];\n")
SEARCH2 = ("    const int d1 = min(d0 + share, items);\n"
           "    const int i_end = merge_search(st.re, n_lo, rows, nnz, d1);\n")
BATCH = "  return lane_bytes < 16 ? 4 : lanes <= 2 ? 2 : 3;\n"
WALK_CALL = ("    walk<V, kPer, kVector, kLanes>(st, n_lo, i, i_end, d0 - i, "
             "j_end, X, ldx,\n                                   out, w);\n")
SHARED = "  return 16 + 2 * stage_bytes<V>(chunk_items) +\n"
STAGES = "  unsigned char* stages = smem + 16;\n"


def _ring(src: str, depth: int) -> str:
    """The kernel with the ring of ``depth`` slots in place of the register
    batches: its functions, its shared memory and its call."""
    ring = f"static_cast<size_t>({depth}) * kThreads"
    t = _sub(src, "// The fix-up as the tail:",
             WALK_RING.replace("RING_DEPTH", str(depth))
             + "// The fix-up as the tail:")
    t = _sub(t, SHARED, f"  return 16 + {ring} * per * sizeof(V) +\n"
             "         2 * stage_bytes<V>(chunk_items) +\n")
    t = _sub(t, STAGES, "  V* ring = reinterpret_cast<V*>(smem + 16);\n"
             f"  unsigned char* stages = smem + 16 + {ring} * kPer * "
             "sizeof(V);\n")
    return _sub(t, WALK_CALL, "    walk_ring<V, kPer, kVector, kLanes>(st, "
                "n_lo, i, i_end, d0 - i, j_end, X,\n        ldx, ring + "
                "walker "
                "* kWidth, out, w);\n")


def _block(src: str, start: str, end: str) -> str:
    """The text of ``src`` from ``start`` to the end of ``end`` (each must
    occur once)."""
    if src.count(start) != 1 or src.count(end) != 1:
        raise ValueError(f"the source does not hold exactly one {start!r} "
                         f"and {end!r}")
    a = src.index(start)
    return src[a:src.index(end, a) + len(end)]


def _function(src: str, head: str) -> str:
    """The text of the function whose definition starts with ``head``: up
    to the first line that is a lone closing brace."""
    a = src.index(head)
    if src.count(head) != 1:
        raise ValueError(f"the source does not hold exactly one {head!r}")
    b = src.index("\n}\n", a) + 3
    return src[a:b]


def _stamped(src: str) -> str:
    """STAMP: thread 0's chunk phases (wait, search, walk, scan) and, inside
    its walk, issue (a batch's column loads and row-load issues), xwait (its
    first X value), close (the row-close loops) and add."""
    t = _sub(src, "namespace {\n", STAMP_DECL_NEW)
    t = _sub(t, "  for (int c = 0; c < num_chunks; ++c) {\n",
             "  long long acc_st[4] = {0, 0, 0, 0};\n"
             "  for (int c = 0; c < num_chunks; ++c) {\n"
             "    long long c0 = clock64();\n")
    wait = ("    mbar_wait(bars + (c & 1), (c >> 1) & 1);   // chunk c has "
            "landed\n")
    t = _sub(t, wait, wait + "    long long c1 = clock64(); acc_st[0] += c1 - "
             "c0;\n")
    t = _sub(t, "    const int j_end = d1 - i_end;\n",
             "    const int j_end = d1 - i_end;\n    long long c2 = "
             "clock64(); acc_st[1] += c2 - c1;\n")
    t = _sub(t, "    __syncwarp();\n", "    long long c3 = clock64(); "
             "acc_st[2] += c3 - c2;\n    __syncwarp();\n")
    t = _sub(t, "    for (int e = 0; e < kPer; ++e) cin[e] = pv[e];\n",
             "    for (int e = 0; e < kPer; ++e) cin[e] = pv[e];\n"
             "    acc_st[3] += clock64() - c3;\n")
    # the walk: stamps around each batch's load issue, its first value's
    # wait (an add that needs it), its adds, and each nonzero's row closes
    t = _sub(t, "      batch_rows(kPer * static_cast<int>(sizeof(V)), kLanes);"
             "\n", "      batch_rows(kPer * static_cast<int>(sizeof(V)), "
             "kLanes);\n  long long ws[4] = {0, 0, 0, 0};\n  V sink = V(0);\n"
             "  long long z0 = clock64();\n")
    t = _sub(t, "  for (; j < j_end; j += 2 * kBatch) {\n",
             "  ws[0] += clock64() - z0;\n"
             "  for (; j < j_end; j += 2 * kBatch) {\n"
             "    long long z1 = clock64();\n")
    t = _sub(t, "                                                 X, ldx, "
             "out.l, out.k, xb);\n", "                                     "
             "            X, ldx, out.l, out.k, xb);\n"
             "    long long z2 = clock64(); ws[0] += z2 - z1;\n"
             "    touch(sink, xa[0][0]);\n"
             "    long long z3 = clock64(); ws[1] += z3 - z2;\n")
    t = _sub(t, "xa, out,\n" + " " * 48 + "w);\n",
             "xa, out,\n" + " " * 48 + "w, ws[2]);\n")
    t = _sub(t, "        st, n_lo, j + 2 * kBatch, j_end, X, ldx, out.l, "
             "out.k, xa);\n", "        st, n_lo, j + 2 * kBatch, j_end, X, "
             "ldx, out.l, out.k, xa);\n    long long z4 = clock64(); "
             "ws[3] += z4 - z3;\n")
    t = _sub(t, "xb, out, w);\n  }\n", "xb, out, w, ws[2]);\n"
             "    ws[3] += clock64() - z4;\n  }\n  ws[3] -= ws[2];\n"
             "  long long z5 = clock64();\n")
    t = _sub(t, "    close_row<V, kPer, kVector, kLanes>(w, out, i);\n}\n",
             "    close_row<V, kPer, kVector, kLanes>(w, out, i);\n"
             "  ws[2] += clock64() - z5;\n"
             "  if (threadIdx.x == 0) {\n"
             "    for (int q = 0; q < 4; ++q)\n"
             "      g_stamps[blockIdx.x * 8 + 4 + q] += ws[q];\n"
             "    g_sink[blockIdx.x] += sink;\n  }\n}\n")
    pad = " " * 42
    t = _sub(t, pad + "Walk<V, kPer>& w) {\n#pragma unroll\n  for (int u = 0; "
             "u < kBatch; ++u) {\n    if (j + u >= j_end) break;\n",
             pad + "Walk<V, kPer>& w, long long& wc) {\n#pragma unroll\n  "
             "for (int u = 0; u < kBatch; ++u) {\n    if (j + u >= j_end) "
             "break;\n    long long q0 = clock64();\n")
    t = _sub(t, "    const V a = st.val[j + u];\n",
             "    wc += clock64() - q0;\n    const V a = st.val[j + u];\n")
    t = _sub(t, "  // The run's carry pair", STAMP_OUT_NEW +
             "  // The run's carry pair")
    return t + READ_STAMPS


def variants(src: str) -> dict:
    """The committed kernel's variants, by name (the module docstring), as
    functions giving each one's text."""
    search = _block(src, "    int i_end = __shfl_down_sync(full, i, "
                    "kLanes);\n", "    const int d1 = min(d0 + share, "
                    "items);\n")
    tail = _block(src, "  fix_up<V, kPer, kVector, kLanes>(\n",
                  "static_cast<int>(2 * stage_len / 4) - 1);\n")
    stage = _function(src, "template <typename V>\n__device__ __forceinline__ "
                      "void stage_chunk(")
    gather = "  return X + static_cast<long long>(s_col[j]) * ldx;\n"
    out = {
        "A0": lambda: src,
        "NOTAIL": lambda: _sub(src, "  if (!s_wflag[0]) return;",
                               "  return;"),
        "COAL": lambda: _sub(src, gather, "  return X + static_cast<long "
                             "long>((blockIdx.x * 2048 + j) % 32768) * "
                             "ldx;\n"),
        "WIN": lambda: _sub(src, gather, "  return X + static_cast<long "
                            "long>(s_col[j] & 1023) * ldx;\n"),
        "TAIL0": lambda: _sub(src, tail, TAIL_BASE),
        "SEARCH2": lambda: _sub(src, search, SEARCH2),
        "ELEM": lambda: _sub(_sub(src, stage, STAGE_ELEM),
                             "    mbar_init(bars, 1);\n    mbar_init(bars + 1,"
                             " 1);\n", "    mbar_init(bars, kThreads);\n    "
                             "mbar_init(bars + 1, kThreads);\n"),
        "STAMP": lambda: _stamped(src),
    }
    for rows in (2, 3, 4):
        out[f"B{rows}"] = (lambda rows=rows: _sub(src, BATCH,
                                                  f"  return {rows};\n"))
    for pairs in (6, 8):
        out[f"T{pairs}"] = (lambda pairs=pairs: _sub(
            src, "constexpr int kTail = 4;",
            f"constexpr int kTail = {pairs};"))
    out["P8"] = lambda: _p8(src)
    out["LB3"] = lambda: _sub(_sub(src, BATCH, "  return 4;\n"),
                              "constexpr int kBlocksPerSm = 4;",
                              "constexpr int kBlocksPerSm = 3;")
    for depth in (4, 8, 16):
        out[f"RING{depth}"] = lambda depth=depth: _ring(src, depth)
    return out


# Eight columns a lane (P8): two 16-byte loads of a row a lane, so a
# walker of k = 32 is four lanes and half the lanes repeat a nonzero's
# shared-memory loads; two rows a batch, two carry pairs a tail round.
P8_TYPES = r"""struct Vec<double, 2> { using T = double2; };
struct float8 {
  float4 lo, hi;
};
template <>
struct Vec<float, 8> { using T = float8; };
__device__ __forceinline__ void unpack(float8 v, float (&o)[8]) {
  o[0] = v.lo.x; o[1] = v.lo.y; o[2] = v.lo.z; o[3] = v.lo.w;
  o[4] = v.hi.x; o[5] = v.hi.y; o[6] = v.hi.z; o[7] = v.hi.w;
}
__device__ __forceinline__ void pack(const float (&o)[8], float8& v) {
  v.lo = make_float4(o[0], o[1], o[2], o[3]);
  v.hi = make_float4(o[4], o[5], o[6], o[7]);
}
template <bool kCoherent, typename T>
__device__ __forceinline__ T load_vec(const T* p) {
  return kCoherent ? __ldcg(p) : __ldg(p);
}
template <bool kCoherent>
__device__ __forceinline__ float8 load_vec(const float8* p) {
  float8 v;
  v.lo = load_vec<kCoherent>(&p->lo);
  v.hi = load_vec<kCoherent>(&p->hi);
  return v;
}
"""
P8_DISPATCH = r"""      if (per == 4) return by_lanes<V, 4, true>(lanes);
    if constexpr (sizeof(V) == 4)
      if (per == 8 && lanes <= 8) return by_lanes<V, 8, true>(lanes);
"""


def _p8(src: str) -> str:
    t = _sub(src, "struct Vec<double, 2> { using T = double2; };\n", P8_TYPES)
    t = _sub(t, "      unpack(kCoherent ? __ldcg(p) : __ldg(p), out);\n",
             "      unpack(load_vec<kCoherent>(p), out);\n")
    t = _sub(t, "      if (per == 4) return by_lanes<V, 4, true>(lanes);\n",
             P8_DISPATCH)
    t = _sub(t, "  const int pers[] = {1, 2, 4};",
             "  const int pers[] = {1, 2, 4, 8};")
    t = _sub(t, BATCH, "  return lane_bytes >= 32 ? 2 : lane_bytes < 16 ? 4 : "
             "lanes <= 2 ? 2 : 3;\n")
    return _sub(t, "  for (int base = 0; base < num_pairs; base += cap) {\n",
                "  constexpr int kTail = kPer > 4 ? 2 : 4;\n"
                "  for (int base = 0; base < num_pairs; base += cap) {\n")


def _layout(name: str, k: int, lay):
    """The lane layout a variant launches with: P8's eight columns a lane
    where k allows, else the package's."""
    if name == "P8" and k % 8 == 0:
        return MmLayout(8, True, 1 << max(k // 8 - 1, 0).bit_length())
    return lay


def _ring_depth(name: str) -> int:
    """The ring's slots in a RING variant, else 0."""
    return int(name[4:]) if name.startswith("RING") else 0


_MANGLED = re.compile(r"merge_tile_mm_kernelI([fd])Li(\d+)ELb([01])ELi(\d+)E")


def ptxas_report(log: str) -> dict:
    """{"<float|double>,<per>,<vector>,<lanes>": (registers, spill store
    bytes)} of each K1m instantiation, from nvcc's ``-Xptxas=-v`` output."""
    out, name, spill = {}, None, 0
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            m = _MANGLED.search(ln)
            name = None if m is None else (
                f"{'float' if m[1] == 'f' else 'double'},{m[2]},{m[3]},{m[4]}")
            spill = 0
        elif "spill stores" in ln and name:
            spill = int(ln.split("bytes spill stores")[0].split(",")[-1])
        elif "Used" in ln and "registers" in ln and name:
            out[name] = (int(ln.split("Used ")[1].split(" registers")[0]),
                         spill)
            name = None
    return out


def _build(name_text):
    name, text = name_text
    out = BUILD_DIR / "mm_ablation"
    out.mkdir(parents=True, exist_ok=True)
    (out / f"{name}.cu").write_text(text)
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(out / f"{name}.so"),
                           str(out / f"{name}.cu")], stdout=subprocess.PIPE,
                          stderr=subprocess.STDOUT, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed for {name}:\n{proc.stdout}")
    report = ptxas_report(proc.stdout)
    lib = ctypes.CDLL(str(out / f"{name}.so"))
    P, I, D, L = (ctypes.c_void_p, ctypes.c_int, ctypes.c_double,
                  ctypes.c_longlong)
    lib.merge_tile_mm_f32.argtypes = [P, P, P, P, L, P, L, P, P, D, D, P, L,
                                      P, P] + [I] * 12 + [P, P]
    lib.merge_tile_mm_f32.restype = I
    lib.merge_tile_mm_occupancy_f32.argtypes = [I] * 5 + [
        ctypes.POINTER(I)] * 2
    lib.merge_tile_mm_occupancy_f32.restype = I
    if "STAMP" in name:
        lib.read_stamps.argtypes = [P, I]
    if lib.merge_csrmm_init() != 0:
        raise RuntimeError(f"merge_csrmm_init failed for {name}")
    return name, lib, {"spilled": sorted(n for n, (_, s) in report.items()
                                         if s)}


def _launcher(lib, op, X, shared_fn, layout_fn=lambda k, lay: lay):
    """A call of the variant's entry with op's tiles and the package's
    launch for X, its runs cut for the blocks per SM that the variant's
    own occupancy allows; ``shared_fn(chunk_items, layout)`` gives the
    variant's dynamic shared memory."""
    plan, dev = op.plan, op.device
    k = X.shape[1]
    geo = K.mm_launch_geometry(plan.num_tiles, plan.tile_items,
                               torch.float32, dev, k)
    lay = layout_fn(k, geo.layout)
    shared = shared_fn(geo.chunk_items, lay)
    blocks, regs = ctypes.c_int(0), ctypes.c_int(0)
    rc = lib.merge_tile_mm_occupancy_f32(lay.per, int(lay.vector), lay.lanes,
                                         geo.threads, shared,
                                         ctypes.byref(blocks),
                                         ctypes.byref(regs))
    if rc or blocks.value < 1:
        raise RuntimeError(f"occupancy query failed: {rc}, {blocks.value}")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    per_sm = min(blocks.value, 4)
    run_tiles = -(-plan.num_tiles // (per_sm * sms))
    grid = -(-plan.num_tiles // run_tiles)
    sm_blocks = per_sm if grid % per_sm == 0 else 1
    Y = torch.empty(plan.num_rows, k, device=dev)
    carry_row = torch.empty(grid, dtype=torch.int32, device=dev)
    carry_val = torch.empty(grid * k, device=dev)

    def launch():
        rc = lib.merge_tile_mm_f32(
            op.values.data_ptr(), op.col_indices.data_ptr(),
            op.row_end_offsets.data_ptr(), X.data_ptr(), k, None, 0,
            op.tile_rows.data_ptr(), op.tile_nnz.data_ptr(), 1.0, 0.0,
            Y.data_ptr(), k, carry_row.data_ptr(), carry_val.data_ptr(),
            plan.num_rows, plan.num_tiles, run_tiles, geo.chunk_tiles,
            geo.chunk_items, sm_blocks, k, lay.per, int(lay.vector),
            lay.lanes, geo.threads, shared, op.tickets.data_ptr(),
            raw_stream(dev))
        if rc:
            raise RuntimeError(f"launch failed: CUDA error {rc}")
        return Y
    launch.grid = grid
    launch.geometry = {"blocks_per_sm": per_sm, "shared_bytes": shared,
                       "run_tiles": run_tiles, "registers": regs.value,
                       "layout": [lay.per, lay.vector, lay.lanes]}
    return launch


def _shares(lib, grid, names):
    """Thread 0's stamps over the blocks: the first four as shares of
    their sum, the walk's split as shares of the walk."""
    buf = (ctypes.c_longlong * (grid * STAMP_SLOTS))()
    lib.read_stamps(buf, grid * STAMP_SLOTS)
    st = np.array(buf[:], np.float64).reshape(-1, STAMP_SLOTS).sum(0)
    out = {n: round(float(st[q] / st[:4].sum()), 4)
           for q, n in enumerate(names[:4])}
    walk = st[4:].sum() or 1.0
    out.update({f"walk.{n}": round(float(st[q] / walk), 4)
                for q, n in enumerate(names[4:], 4)})
    return out


def _cells(spec):
    if not spec:
        return CELLS
    return tuple((c.split(":")[0], int(c.split(":")[1]))
                 for c in spec.split(","))


def run(out=None, base=None, only=None, cells=None) -> list:
    dev = torch.device("cuda")
    src = (CSRC_DIR / "merge_csrmm.cu").read_text()
    def shared_fn(depth):
        def fn(chunk_items, lay):
            return (mm_shared_bytes(chunk_items, "float32", lay)
                    + depth * 256 * lay.per * 4)
        return fn
    table = {n: (fn, shared_fn(_ring_depth(n)))
             for n, fn in variants(src).items()}
    if base:
        text = open(base).read()
        table.update({n: (fn, lambda c, lay: base_shared_bytes(
            c, 4, lay.width)) for n, fn in base_variants(text).items()})
    names = [n for n in table if only is None or n in only]
    with ThreadPoolExecutor(6) as pool:
        built = {n: (lib, info) for n, lib, info in pool.map(
            _build, [(n, table[n][0]()) for n in names])}
    smi = nvidia_smi_name_power()
    peak = peak_hbm_bandwidth(dev)
    records = []
    ops = {}
    for label, k in _cells(cells):
        if label not in ops:
            csr = MATRICES[label]()
            ops[label] = (csr, build_operator(csr, dtype="float32",
                                              device=dev))
        csr, op = ops[label]
        lib_csr = library_csr(op)
        X = torch.from_numpy(np.random.RandomState(2).uniform(
            -1, 1, (csr.num_cols, k)).astype(np.float32)).to(dev)
        want = K.merge_csrmm(op.values, op.col_indices, op.row_end_offsets,
                             X, op.tile_rows, op.tile_nnz,
                             op.plan.tile_items, tickets=op.tickets)
        cus = event_ms(lambda: torch.sparse.mm(lib_csr, X), iters=20)
        nbytes = spmm_bytes(csr.num_rows, csr.num_cols, csr.num_nonzeros, k,
                            4)
        rows = GR.measure_rows(op.col_indices, csr.num_cols, (k,))[str(k)]
        cell = {"matrix": label, "k": k, "nnz": csr.num_nonzeros,
                "tiles": op.plan.num_tiles,
                "cusparse_spmm_ms": cus,
                "bytes_bound_ms": nbytes / peak / 1e6,
                "gather_bound_ms": GR.rows_gather_bound_ms(
                    csr.num_nonzeros, 4 * k, rows["matrix_rate_gbps"],
                    nbytes, peak),
                "nvidia_smi": smi}
        for name in names:
            lib, info = built[name]
            launch = _launcher(lib, op, X, table[name][1],
                               lambda k, lay, name=name: _layout(name, k, lay))
            got = launch()
            rec = {**cell, "variant": name, **info,
                   "grid": launch.grid, **launch.geometry,
                   "ms": event_ms(launch, iters=20),
                   "equal_to_merge_csrmm": bool(torch.equal(got, want))}
            if "STAMP" in name:
                launch()
                torch.cuda.synchronize()
                rec["stamp_shares"] = _shares(
                    lib, launch.grid, STAMPS_BASE if name == "STAMPB"
                    else STAMPS)
            print(json.dumps(rec), flush=True)
            records.append(rec)
    if out:
        with open(out, "w") as f:
            json.dump(records, f, indent=1)
    return records


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--base", default=None,
                    help="the previous merge_csrmm.cu, timed in the same run")
    ap.add_argument("--only", default=None,
                    help="comma-separated variant names")
    ap.add_argument("--cells", default=None,
                    help="comma-separated matrix:k, e.g. cant:32")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    run(args.out, args.base,
        None if args.only is None else set(args.only.split(",")),
        args.cells)
    return 0


if __name__ == "__main__":
    sys.exit(main())
