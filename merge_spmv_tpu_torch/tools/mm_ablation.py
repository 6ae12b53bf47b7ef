"""Ablations of the multi-RHS tile kernel (K1m) on the card, on the cant and
pdb1HYS classes at full size with k = 8 and 32.

    python -m merge_spmv_tpu_torch.tools.mm_ablation [--out PATH]

prints one JSON line per measurement.  Every time is the kernel alone,
warm, from CUDA-graph replays (``utils/timers.py::event_ms``), beside
cuSPARSE SpMM on the same X.  The variants are text substitutions of
csrc/merge_csrmm.cu, written and built under the gitignored
``merge_spmv_tpu_torch/build/mm_ablation/`` with the package's nvcc flags
and loaded by ctypes; none is kept in the tree:

* A0: the kernel as committed (its result checked bit for bit against
  ``merge_csrmm``'s at the same launch);
* COAL: each nonzero's X row replaced by row ``(n0 + j) % 32768``, in
  nonzero order: the same bytes with no scatter (what the gather's
  scatter costs);
* WIN: the column indices masked to the first 1024 rows of X (128 KB at
  k = 32, which fits one SM's L1): what L1 hits are worth;
* B2, B8: 2 or 8 X rows in flight per walker instead of 4;
* NOTAIL: the fix-up tail skipped (a wrong result): what the tail costs;
* T512: blocks of 512 threads, two an SM (the same threads an SM): what
  the barriers of larger blocks cost;
* STAMP: ``clock64()`` stamps of thread 0 summed over its run, per chunk:
  waiting for the chunk's copies (and the barrier after), the two merge
  path searches, its walker's walk, and the scan with the first rows'
  writes (which waits for the block's slowest walker).  Read as shares:
  the stamps slow the kernel.

A0 also runs at chunks of 1024, 2048 and 4096 merge items.  Writes the
records to ``--out`` (a JSON list) when given.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from merge_spmv_tpu_torch.bench.measure import library_csr
from merge_spmv_tpu_torch.ops import csrmv_cuda as K
from merge_spmv_tpu_torch.ops.operator import build_operator
from merge_spmv_tpu_torch.ops.plan import mm_shared_bytes
from merge_spmv_tpu_torch.tools import bench_baseline_configs as BC
from merge_spmv_tpu_torch.utils.cuda_build import (BUILD_DIR, CSRC_DIR,
                                                   NVCC_FLAGS, _nvcc,
                                                   raw_stream)
from merge_spmv_tpu_torch.utils.device import nvidia_smi_name_power
from merge_spmv_tpu_torch.utils.timers import event_ms

GATHER = "X + static_cast<long long>(s_col[jb + u]) * ldx"
BATCH = "constexpr int kBatch = 4;"
TAIL = "  if (!s_wflag[0]) return;"
CHUNKS = (1024, 2048, 4096)
STAMPS = ("wait", "search", "walk", "scan")
READ_STAMPS = r'''
extern "C" int read_stamps(long long* host, int n) {
  return static_cast<int>(cudaMemcpyFromSymbol(host, g_stamps,
                                               n * sizeof(long long)));
}
'''


def _sub(text, old, new):
    if text.count(old) != 1:
        raise ValueError(f"the source does not hold exactly one {old!r}")
    return text.replace(old, new)


def variants(src: str) -> dict:
    """The kernel's variants, by name (see the module docstring)."""
    return {
        "A0": src,
        "COAL": _sub(src, GATHER, "X + static_cast<long long>((n_lo + jb + "
                     "u) % 32768) * ldx"),
        "WIN": _sub(src, GATHER, "X + static_cast<long long>(s_col[jb + u] "
                    "& 1023) * ldx"),
        "B2": _sub(src, BATCH, "constexpr int kBatch = 2;"),
        "B8": _sub(src, BATCH, "constexpr int kBatch = 8;"),
        "NOTAIL": _sub(src, TAIL, "  return;"),
        "T512": _sub(_sub(src, "constexpr int kThreads = 256;",
                          "constexpr int kThreads = 512;"),
                     "constexpr int kBlocksPerSm = 4;",
                     "constexpr int kBlocksPerSm = 2;"),
        "STAMP": _stamped(src),
    }


def _stamped(src: str) -> str:
    t = _sub(src, "__device__ unsigned int g_mm_tickets = 0;\n",
             "__device__ unsigned int g_mm_tickets = 0;\n"
             "__device__ long long g_stamps[4096 * 4];\n")
    t = _sub(t, "  for (int c = 0; c < num_chunks; ++c) {\n",
             "  long long acc_st[4] = {0, 0, 0, 0};\n"
             "  for (int c = 0; c < num_chunks; ++c) {\n"
             "    long long c0 = clock64();\n")
    t = _sub(t, "    __syncthreads();   // every thread's copies of chunk c "
             "have landed\n", "    __syncthreads();   // every thread's "
             "copies of chunk c have landed\n    long long c1 = clock64(); "
             "acc_st[0] += c1 - c0;\n")
    t = _sub(t, "    const int j_end = d1 - i_end;\n",
             "    const int j_end = d1 - i_end;\n    long long c2 = "
             "clock64(); acc_st[1] += c2 - c1;\n")
    t = _sub(t, "    __syncwarp();\n", "    long long c3 = clock64(); "
             "acc_st[2] += c3 - c2;\n    __syncwarp();\n")
    t = _sub(t, "    __syncthreads();   // the stage and the warp totals are "
             "free again\n", "    __syncthreads();   // the stage and the "
             "warp totals are free again\n    acc_st[3] += clock64() - "
             "c3;\n")
    t = _sub(t, "  // The run's carry pair", "  if (tid == 0)\n"
             "    for (int q = 0; q < 4; ++q)\n"
             "      g_stamps[blockIdx.x * 4 + q] = acc_st[q];\n"
             "  // The run's carry pair")
    return t + READ_STAMPS


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
    regs = [ln.split("Used ")[1].split(" registers")[0]
            for ln in proc.stdout.splitlines() if "registers" in ln]
    lib = ctypes.CDLL(str(out / f"{name}.so"))
    P, I, D, L = (ctypes.c_void_p, ctypes.c_int, ctypes.c_double,
                  ctypes.c_longlong)
    lib.merge_tile_mm_f32.argtypes = [P, P, P, P, L, P, L, P, P, D, D, P, L,
                                      P, P] + [I] * 12 + [P, P]
    lib.merge_tile_mm_f32.restype = I
    if name == "STAMP":
        lib.read_stamps.argtypes = [P, I]
    if lib.merge_csrmm_init() != 0:
        raise RuntimeError(f"merge_csrmm_init failed for {name}")
    return name, lib, sorted(set(regs))


def _launcher(lib, op, X, chunk_items, threads=256):
    """A call of the variant's entry with op's tiles and the package's
    launch for X, at chunks of ``chunk_items`` merge items; with another
    ``threads`` (T512's), the same threads an SM in blocks of that size,
    with their warps' scan totals."""
    plan, dev = op.plan, op.device
    k = X.shape[1]
    geo = K.mm_launch_geometry(plan.num_tiles, plan.tile_items,
                               torch.float32, dev, k)
    chunk_tiles = max(1, chunk_items // plan.tile_items)
    lay = geo.layout
    shared = mm_shared_bytes(chunk_tiles * plan.tile_items, "float32",
                             lay.width)
    run_tiles, per_sm = geo.run_tiles, geo.blocks_per_sm
    if threads != geo.threads:
        shared += (threads - geo.threads) // 32 * (lay.width * 4 + 4)
        per_sm = geo.blocks_per_sm * geo.threads // threads
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
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
            plan.num_rows, plan.num_tiles, run_tiles, chunk_tiles,
            chunk_tiles * plan.tile_items, sm_blocks, k, lay.per,
            int(lay.vector), lay.lanes, threads, shared,
            op.tickets.data_ptr(), raw_stream(dev))
        if rc:
            raise RuntimeError(f"launch failed: CUDA error {rc}")
        return Y
    launch.grid = grid
    return launch


def run(out=None) -> list:
    dev = torch.device("cuda")
    src = (CSRC_DIR / "merge_csrmm.cu").read_text()
    with ThreadPoolExecutor(6) as pool:
        libs = {n: (lib, regs) for n, lib, regs in
                pool.map(_build, variants(src).items())}
    smi = nvidia_smi_name_power()
    records = []
    for label, csr in (("cant", BC.cant_csr(np.float32)),
                       ("pdb1HYS", BC.pdb1hys_csr())):
        op = build_operator(csr, dtype="float32", device=dev)
        lib_csr = library_csr(op)
        for k in (8, 32):
            X = torch.from_numpy(np.random.RandomState(2).uniform(
                -1, 1, (csr.num_cols, k)).astype(np.float32)).to(dev)
            want = K.merge_csrmm(op.values, op.col_indices,
                                 op.row_end_offsets, X, op.tile_rows,
                                 op.tile_nnz, op.plan.tile_items,
                                 tickets=op.tickets)
            cus = event_ms(lambda: torch.sparse.mm(lib_csr, X), iters=20)
            for name, (lib, regs) in libs.items():
                chunks = CHUNKS if name == "A0" else (2048,)
                for chunk in chunks:
                    launch = _launcher(lib, op, X, chunk,
                                       512 if name == "T512" else 256)
                    got = launch()
                    same = (bool(torch.equal(got, want)) if chunk == 2048
                            else None)
                    rec = {"matrix": label, "k": k, "variant": name,
                           "chunk_items": chunk, "registers": regs,
                           "ms": event_ms(launch, iters=20),
                           "cusparse_spmm_ms": cus,
                           "equal_to_merge_csrmm": same,
                           "nvidia_smi": smi}
                    if name == "T512":
                        rec["max_abs_err"] = float((got - want).abs().max())
                    if name == "STAMP":
                        launch()
                        torch.cuda.synchronize()
                        buf = (ctypes.c_longlong * (launch.grid * 4))()
                        lib.read_stamps(buf, launch.grid * 4)
                        st = np.array(buf[:], np.float64).reshape(-1, 4)
                        rec["stamp_shares"] = dict(zip(
                            STAMPS, (st.sum(0) / st.sum()).round(4)
                            .tolist()))
                    print(json.dumps(rec), flush=True)
                    records.append(rec)
    if out:
        with open(out, "w") as f:
            json.dump(records, f, indent=1)
    return records


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    run(args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
