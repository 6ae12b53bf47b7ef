"""The hot/cold popularity split's A/B on the kron class (R-MAT), float32,
beside cuSPARSE.

    python -m merge_spmv_tpu_torch.tools.bench_hotcold [scale] [nnz]
        [--cpu] [--out PATH]

Counterpart of tools/bench_hotcold.py: the matrix is bench/matrices.py::
rmat(scale, nnz, 16, float32) (scale 20 and 50,000,000 drawn nonzeros by
default), square at the largest index drawn + 1, duplicates kept
(:43-56); x is uniform(0.5, 1.5) from RandomState(1), every result
verified against gold within spmv_abs_bound (:62-65).  ``merge`` is
op(x) of build_operator, ``hotcold`` build_hotcold_operator's, or
``{"declined": true}`` when it finds no hot window (:94), and
``hotcold_speedup`` the merge time over the hot/cold time (:114; null when
declined).  The JAX tool's cache file of the matrix is not kept: the
generator takes seconds.

Added: ``cusparse``, ``torch.mv`` on an int32 ``sparse_csr_tensor`` of
the merge operator's arrays (torch.sparse with ``--cpu``; ``library`` says
which), and its time over merge's and over hot/cold's,
``merge_vs_cusparse_speedup`` and ``hotcold_vs_cusparse_speedup``; K1's
gather policy; the device.  Times and byte counts as
tools/bench_large.py's (``effective_gbps`` by the JAX count, nnz * 12 +
rows * 8).  Writes ``bench/BENCH_HOTCOLD_h100.json`` (``_cpu.json`` with
``--cpu``) or ``--out``; never a BENCH_HOTCOLD.json at the root.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

from merge_spmv_tpu_torch.bench import measure as M
from merge_spmv_tpu_torch.bench.matrices import rmat
from merge_spmv_tpu_torch.ops.operator import build_operator
from merge_spmv_tpu_torch.ops.split import build_hotcold_operator
from merge_spmv_tpu_torch.tools.bench_baseline_configs import build
from merge_spmv_tpu_torch.tools.bench_large import (library_entry,
                                                    measure_operator)
from merge_spmv_tpu_torch.utils.device import resolve_device

__all__ = ["run", "main", "kron_csr", "RECORD_KEYS", "KRON"]

KRON = (20, 50_000_000)          # tools/bench_hotcold.py:43-44

# the JAX record's keys (tools/bench_hotcold.py:69-114), for
# bench/measure.py::record_faults
RECORD_KEYS = {
    "metric": (), "rows": (), "nnz": (),
    "merge": ("avg_ms", "effective_gbps", "verified"),
    "hotcold": ("avg_ms", "effective_gbps", "verified", "hot_windows",
                "hot_nnz", "cold_nnz", "split_setup_ms"),
    "hotcold_speedup": (),
}


def kron_csr(scale: int = KRON[0], nnz: int = KRON[1]):
    """rmat(scale, nnz, 16, float32)'s matrix, square at the largest
    index drawn + 1 (tools/bench_hotcold.py:52-56)."""
    return build(lambda: rmat(scale, nnz, 16, np.float32), np.float32)


def run(scale: int = KRON[0], nnz: int = KRON[1], device=None,
        csr=None) -> dict:
    """The record for rmat(scale, nnz)'s matrix, or for ``csr`` (float32)
    when given."""
    dev = resolve_device(device)
    if csr is None:
        csr = kron_csr(scale, nnz)
    x = np.random.RandomState(1).uniform(0.5, 1.5, csr.num_cols
                                         ).astype(np.float32)
    gold, bound = csr.spmv_gold(x), csr.spmv_abs_bound(x)
    out = {"metric": "kron_class_hotcold_ab_fp32", "rows": csr.num_rows,
           "nnz": csr.num_nonzeros,
           "total_bytes": csr.num_nonzeros * 12 + csr.num_rows * 8,
           "timing": "graph" if dev.type == "cuda" else "host",
           **M.device_record(dev)}

    t0 = time.perf_counter()
    op = build_operator(csr, dtype="float32", device=dev)
    entry, setup_s = measure_operator("merge", op, t0, csr, x, gold, bound,
                                      dev)
    out["merge"] = {**entry, "policy": op.plan.policy,
                    "setup_compile_s": setup_s}
    out["cusparse"] = library_entry(op, x, gold, bound, dev)
    del op
    merge_ms, lib_ms = out["merge"]["avg_ms"], out["cusparse"]["avg_ms"]
    out["merge_vs_cusparse_speedup"] = lib_ms / merge_ms

    t0 = time.perf_counter()
    hop = build_hotcold_operator(csr, dtype="float32", device=dev)
    if hop.num_hot_windows == 0:
        print(f"hotcold: {hop.describe()}: declined", flush=True)
        out["hotcold"] = {"declined": True, "split_setup_ms": hop.setup_ms}
        out["hotcold_speedup"] = None
        return out
    entry, setup_s = measure_operator("hotcold", hop, t0, csr, x, gold,
                                      bound, dev)
    out["hotcold"] = {**entry, "hot_windows": hop.num_hot_windows,
                      "hot_nnz": hop.hot_nnz, "cold_nnz": hop.cold_nnz,
                      "split_setup_ms": hop.setup_ms,
                      "setup_compile_s": setup_s}
    hc_ms = out["hotcold"]["avg_ms"]
    out["hotcold_speedup"] = merge_ms / hc_ms
    out["hotcold_vs_cusparse_speedup"] = lib_ms / hc_ms
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("scale", type=int, nargs="?", default=KRON[0])
    ap.add_argument("nnz", type=int, nargs="?", default=KRON[1])
    ap.add_argument("--cpu", action="store_true",
                    help="the kernels' plain versions on the CPU")
    ap.add_argument("--out", default=None, help="the record's path")
    args = ap.parse_args(argv)
    from merge_spmv_tpu_torch.utils.hostmem import enable_warm_heap
    enable_warm_heap()   # warm-page reuse for the generator's arrays
    dev = resolve_device("cpu" if args.cpu else None)
    out = run(args.scale, args.nnz, dev)
    print(json.dumps(out))
    M.save_record(M.record_path("BENCH_HOTCOLD", dev, args.out), out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
