"""One rank of the multi-process distributed CsrMV.

    python -m merge_spmv_tpu_torch.parallel.mp_worker <rank> <world> <port>
        [--device cpu|cuda] [--cases DIR] [--time]

Counterpart of tools/mp_distributed_worker.py.  Every rank joins a gloo
process group on 127.0.0.1:<port>, builds the same matrix, partitions it
into ``world`` shares, runs its share through the SPMD path
(parallel/distributed.py) and verifies its own y window against the gold
SpMV; it prints one line, ``PASS rank=<r> world=<w> <json>``, and exits 0,
or raises.

Without ``--cases`` the matrix is the JAX worker's: random_powerlaw(1200,
900, 12000, seed=3) with values and x from RandomState(0), through the
prepared operator.  With ``--cases DIR`` each subdirectory of DIR is one
case, run in name order: ``row_offsets.npy``, ``col_indices.npy``,
``values.npy`` and ``x.npy`` (the CSR matrix and x, made once by the
caller) and ``case.json`` (``num_rows``, ``num_cols``, ``alpha``,
``prepared``: the prepared operator called twice, bitwise equal, else the
one-shot call; optional ``allow_halo_x``).  The rank writes its window to
``y_<rank>.npy`` there, for the caller to assemble with
``materialize_y``.  Each case's report holds the rank's K1 launches
(``k1_launches``: 0 on the CPU, where K1's plain version runs).
``--time`` (on the card) adds the rank's K1 time (CUDA-graph replay of
its local operator) and the whole call's eager time (the exchanges
included) to each case's report.

``--device`` defaults to the card; two ranks may share one card (gloo
stages the exchanges through the host, so NCCL's one-rank-per-GPU rule
does not apply).
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np


def _parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("rank", type=int)
    ap.add_argument("world", type=int)
    ap.add_argument("port", type=int)
    ap.add_argument("--device", choices=("cpu", "cuda"), default="cuda")
    ap.add_argument("--cases", default=None)
    ap.add_argument("--time", action="store_true")
    return ap.parse_args(argv)


def _default_case():
    from merge_spmv_tpu_torch.formats.coo import CooMatrix
    from merge_spmv_tpu_torch.formats.csr import CsrMatrix

    rs = np.random.RandomState(0)
    coo = CooMatrix.random_powerlaw(1200, 900, 12000, seed=3)
    csr = CsrMatrix.from_coo(coo).astype(np.float32)
    csr.values = rs.uniform(0.1, 1.0, csr.num_nonzeros).astype(np.float32)
    x = rs.uniform(0.1, 1.0, csr.num_cols).astype(np.float32)
    return csr, x, {"alpha": 1.0, "prepared": True}


def _load_case(path):
    from merge_spmv_tpu_torch.formats.csr import CsrMatrix

    with open(os.path.join(path, "case.json")) as f:
        meta = json.load(f)
    arr = {name: np.load(os.path.join(path, f"{name}.npy"))
           for name in ("row_offsets", "col_indices", "values", "x")}
    csr = CsrMatrix(meta["num_rows"], meta["num_cols"], arr["row_offsets"],
                    arr["col_indices"], arr["values"])
    return csr, arr["x"], meta


def _run_case(csr, x, meta, rank, world, device, timed):
    """Partition, run, verify this rank's window; returns (window,
    report)."""
    import torch

    from merge_spmv_tpu_torch.ops import csrmv_cuda as K
    from merge_spmv_tpu_torch.parallel.distributed import (
        PreparedDistributedCsrmv, distributed_csrmv)
    from merge_spmv_tpu_torch.parallel.partition import partition_csr
    from merge_spmv_tpu_torch.utils.compare import compare_results

    alpha = float(meta.get("alpha", 1.0))
    t0 = time.perf_counter()
    part = partition_csr(csr, world, dtype=np.float32,
                         allow_halo_x=meta.get("allow_halo_x", True))
    partition_s = time.perf_counter() - t0
    report = {"x_mode": part.x_mode, "halo": part.halo, "cpad": part.cpad,
              "rows_max": part.rows_max, "nnz_max": part.nnz_max,
              "local_nnz": int(part.meta[rank, 3]),
              "partition_s": round(partition_s, 3)}
    K.reset_launches()
    if meta.get("prepared", False):
        op = PreparedDistributedCsrmv(part, alpha=alpha, device=device)
        y = op(x)
        y2 = op(x)
        if not torch.equal(y, y2):
            raise AssertionError(f"rank {rank}: repeated calls differ")
        report["gather"] = op.op.plan.policy
    else:
        op = None
        y = distributed_csrmv(None, part, x, alpha=alpha, device=device)
    window = y.cpu().numpy()
    report["k1_launches"] = K.LAUNCHES["merge_tile_fused"]
    r0 = int(part.row_starts[rank])
    r1 = int(part.row_starts[rank + 1])
    if r1 > r0:
        c32 = csr.astype(np.float32)
        gold = c32.spmv_gold(x, alpha=alpha)[r0:r1]
        bound = c32.spmv_abs_bound(x, alpha=alpha)[r0:r1]
        err = compare_results(window[:r1 - r0], gold, verbose=True,
                              abs_bound=bound)
        if err is not None:
            raise AssertionError(f"rank {rank}: window mismatch at row "
                                 f"{r0 + err}")
    report["rows_checked"] = max(r1 - r0, 0)
    if timed:
        report.update(_timings(op or PreparedDistributedCsrmv(
            part, alpha=alpha, device=device), x))
    return window, report


def _timings(op, x, calls=20):
    """The rank's K1 time (CUDA-graph replay of its local operator), and
    by the host clock over ``calls`` calls that every rank makes together:
    the whole call eagerly, the exchanges included, its local SpMV alone,
    each waited for, and the carries' reduce-scatter alone."""
    import torch
    import torch.distributed as dist

    from merge_spmv_tpu_torch.parallel.distributed import _reduce_scatter
    from merge_spmv_tpu_torch.utils.timers import Timer, chained_rate_ms

    x_in = op.x_block(x)
    x_loc = op._halo_x(x_in) if op.part.x_mode == "halo" else x_in
    k1_ms = chained_rate_ms(op.op, x_loc)

    def per_call(fn):
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        dist.barrier()
        with Timer() as t:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        return t.elapsed_millis() / calls

    return {"k1_ms": k1_ms, "call_ms": per_call(lambda: op.apply(x_in)),
            "local_ms": per_call(lambda: op.local(x_loc)),
            "carry_ms": per_call(lambda: _reduce_scatter(
                op._received, op._routed, op.group))}


def main(argv=None) -> int:
    args = _parse(argv)
    import torch.distributed as dist

    from merge_spmv_tpu_torch.utils.device import resolve_device

    device = resolve_device(args.device)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:"
                            f"{args.port}", world_size=args.world,
                            rank=args.rank)
    try:
        reports = {}
        if args.cases is None:
            csr, x, meta = _default_case()
            _, reports["powerlaw"] = _run_case(csr, x, meta, args.rank,
                                               args.world, device, args.time)
        else:
            for name in sorted(os.listdir(args.cases)):
                path = os.path.join(args.cases, name)
                if not os.path.isdir(path):
                    continue
                csr, x, meta = _load_case(path)
                window, reports[name] = _run_case(csr, x, meta, args.rank,
                                                  args.world, device,
                                                  args.time)
                np.save(os.path.join(path, f"y_{args.rank}.npy"), window)
        dist.barrier()
    finally:
        dist.destroy_process_group()
    print(f"PASS rank={args.rank} world={args.world} device={device} "
          f"{json.dumps(reports)}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
