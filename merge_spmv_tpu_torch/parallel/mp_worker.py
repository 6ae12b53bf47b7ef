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
``--time`` adds to each case's report, by the host clock over ``calls``
calls (case.json, default 20) that every rank makes together: the whole
call eagerly from the rank's placed input (the exchanges included), its
local SpMV alone, the carries' reduce-scatter alone, and the call from the
global host x (its x block copied in per call); on the card also the
rank's K1 time (CUDA-graph replay of its local operator).  A prepared
case's report holds ``prepare_s``: partition, build and first call.

``--device`` defaults to the card; two ranks may share one card (gloo
stages the exchanges through the host, so NCCL's one-rank-per-GPU rule
does not apply).  ``save_case`` writes a case directory and ``spawn``
runs ``world`` ranks over one and returns their reports.
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

REPO_DIR = Path(__file__).resolve().parents[2]
SPAWN_TIMEOUT_S = 600


def _parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("rank", type=int)
    ap.add_argument("world", type=int)
    ap.add_argument("port", type=int)
    ap.add_argument("--device", choices=("cpu", "cuda"), default="cuda")
    ap.add_argument("--cases", default=None)
    ap.add_argument("--time", action="store_true")
    return ap.parse_args(argv)


def save_case(root, name, csr, x, meta):
    """One case for ``--cases``: the CSR arrays and x as .npy files, the
    shape and ``meta`` (``prepared``, ``allow_halo_x``, ``calls``) as
    case.json; returns its directory."""
    d = os.path.join(root, name)
    os.makedirs(d)
    for arr, a in (("row_offsets", csr.row_offsets),
                   ("col_indices", csr.col_indices),
                   ("values", csr.values), ("x", x)):
        np.save(os.path.join(d, f"{arr}.npy"), a)
    with open(os.path.join(d, "case.json"), "w") as f:
        json.dump({"num_rows": csr.num_rows, "num_cols": csr.num_cols,
                   "alpha": 1.0, **meta}, f)
    return d


def spawn(world: int, cases_dir: str, device: str, env=None) -> list:
    """``world`` ranks of this worker over one gloo group on a free local
    port, each running and timing (``--time``) the cases of
    ``cases_dir`` on ``device``: their reports, rank by rank.  Raises
    with the ranks' output if one fails; every rank is killed if it
    outlives SPAWN_TIMEOUT_S.  ``env`` adds to the ranks' environment."""
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    full_env = dict(os.environ, **(env or {}))
    full_env["PYTHONPATH"] = (str(REPO_DIR) + os.pathsep
                              + full_env.get("PYTHONPATH", ""))
    procs = [subprocess.Popen(
        [sys.executable, "-m", "merge_spmv_tpu_torch.parallel.mp_worker",
         str(r), str(world), str(port), "--device", device, "--cases",
         cases_dir, "--time"], cwd=str(REPO_DIR), env=full_env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=SPAWN_TIMEOUT_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    reports = []
    for r, (p, out) in enumerate(zip(procs, outs)):
        head = f"PASS rank={r} world={world} "
        line = [ln for ln in out.splitlines() if ln.startswith(head)]
        if p.returncode != 0 or len(line) != 1:
            raise RuntimeError(f"rank {r} of {world} failed:\n"
                               + "\n".join(o[-3000:] for o in outs))
        reports.append(json.loads(line[0].split(" ", 4)[4]))
    return reports


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
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        report["prepare_s"] = time.perf_counter() - t0
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
            part, alpha=alpha, device=device), x, int(meta.get("calls", 20))))
    return window, report


def _timings(op, x, calls=20):
    """By the host clock over ``calls`` calls that every rank makes
    together, each waited for: the whole call eagerly from the placed
    input, the exchanges included; its local SpMV alone; the carries'
    reduce-scatter alone; the call from the global host x.  On the card
    also the rank's K1 time (CUDA-graph replay of its local operator)."""
    import torch
    import torch.distributed as dist

    from merge_spmv_tpu_torch.parallel.distributed import _reduce_scatter
    from merge_spmv_tpu_torch.utils.timers import Timer, chained_rate_ms

    on_card = op.device.type == "cuda"
    x_in = op.x_block(x)
    x_loc = op._halo_x(x_in) if op.part.x_mode == "halo" else x_in

    def sync():
        if on_card:
            torch.cuda.synchronize(op.device)

    def per_call(fn):
        for _ in range(3):
            fn()
        sync()
        dist.barrier()
        with Timer() as t:
            for _ in range(calls):
                fn()
            sync()
        return t.elapsed_millis() / calls

    times = {"call_ms": per_call(lambda: op.apply(x_in)),
             "local_ms": per_call(lambda: op.local(x_loc)),
             "carry_ms": per_call(lambda: _reduce_scatter(
                 op._received, op._routed, op.group)),
             "unprepared_ms": per_call(lambda: op(x))}
    if on_card:
        times["k1_ms"] = chained_rate_ms(op.op, x_loc)
    return times


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
