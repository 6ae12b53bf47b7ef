"""SpMM on the grid3d(n) Laplacian with k columns: the merge operator's
``op.mm`` (one K1m launch) and its column loop (``method="column"``: K1
once per column), the DIA operator's ``mm`` (one K3m launch) and its
column loop (K3 once per column), beside cuSPARSE SpMM.

    python -m merge_spmv_tpu_torch.tools.bench_spmm [n] [k] [--cpu]
        [--out PATH]

Counterpart of tools/bench_spmm.py (n = 60, k = 32 by default; values and
X uniform(0.5, 1.5) from RandomState(0)).  Every path is verified against
``spmm_gold`` (the JAX tool's check: the dense |A| |X| bound up to 4,096
rows, else the ULP rule alone), then timed in the same run, each as one
CUDA graph of its launches (and eagerly).  The JAX tool times its DIA SpMM
as a jnp shifted-FMA; here it is the operator's own ``mm``, whose K3m is
that shifted multiply-add as one kernel.  ``column_loop`` and ``dia`` keep
the JAX record's keys (``column_loop`` is the column loop, as there;
``dia`` the operator's ``mm``); ``k1m`` and ``dia_column`` are added.
``actual_gbps`` keeps the JAX tool's "actual DIA bytes" (the diagonal
table, X and Y once each; K3m reads X within bounds, so without the JAX
tool's padding).  Added: cuSPARSE SpMM (``torch.sparse.mm`` of an int32 CSR
by the same row-major X), the same with X column-major, the SpMM bound (A
read once), the launches per call, K1m and K3m alone warm and with a cold
L2 against their plain versions, and the device.  Writes
``bench/BENCH_SPMM_h100.json`` (``_cpu.json`` with ``--cpu``) or
``--out``; never the root's BENCH_SPMM.json, the TPU's.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from merge_spmv_tpu_torch.bench import measure as M
from merge_spmv_tpu_torch.formats.coo import CooMatrix
from merge_spmv_tpu_torch.formats.csr import CsrMatrix
from merge_spmv_tpu_torch.ops import csrmv_cuda as K
from merge_spmv_tpu_torch.ops import dia_cuda as DK
from merge_spmv_tpu_torch.ops.dia import build_dia_operator
from merge_spmv_tpu_torch.ops.operator import build_operator
from merge_spmv_tpu_torch.utils.compare import compare_results
from merge_spmv_tpu_torch.utils.device import resolve_device

__all__ = ["run", "main"]

# the JAX tool's dense |A| |X| bound is taken up to this many rows
DENSE_BOUND_ROWS = 4096


def _launches():
    return {"merge_tile_fused": K.LAUNCHES["merge_tile_fused"],
            "merge_tile_mm": K.LAUNCHES["merge_tile_mm"],
            "dia_matvec": DK.LAUNCHES["dia_matvec"],
            "dia_matmat": DK.LAUNCHES["dia_matmat"]}


def _since(before):
    return {k: v - before[k] for k, v in _launches().items()}


def _mm_entry(op, Xd, gold, bound, csr, k, dev, method="auto") -> dict:
    """op.mm(X, method=method) verified against gold, then timed (graph
    and eager)."""
    before = _launches()
    Y = op.mm(Xd, method=method)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    launches = _since(before)
    ok = (tuple(Y.shape) == gold.shape and bool(torch.isfinite(Y).all())
          and compare_results(Y.cpu().numpy(), gold, verbose=False,
                              abs_bound=bound) is None)
    ms = M.fn_ms(lambda: op.mm(Xd, method=method), dev)
    rec = {"avg_ms": ms, "gflops": 2 * k * csr.num_nonzeros / ms / 1e6,
           "verified": ok, "launches": launches, "method": method}
    if dev.type == "cuda":
        rec["eager_ms"] = M.fn_ms(lambda: op.mm(Xd, method=method), dev,
                                  graph=False)
    return rec


def card_dia_matmat(dop, Xd) -> dict:
    """K3m alone on the DIA operator's table, warm and with a cold L2, and
    its plain version (the JAX package's shifted multiply-add) on the same
    X: the plain version's time (eager), the largest difference and
    whether the two agree within |A| |X| per column."""
    args = (dop.vtab, Xd, dop.offsets_t, dop.num_rows, dop.num_cols)
    flush = M._Flush(Xd.device)
    warm = M.event_ms(lambda: DK.dia_matmat(*args), iters=20)
    cold = flush.cold_ms(lambda: DK.dia_matmat(*args))
    Y = DK.dia_matmat(*args)
    plain = DK.dia_matmat_plain(*args)
    err = float((Y - plain).abs().max())
    scale = DK.dia_matmat_plain(dop.vtab.abs(), Xd.abs(), *args[2:])
    y, yp, sc = Y.cpu().numpy(), plain.cpu().numpy(), scale.cpu().numpy()
    ok = all(compare_results(y[:, c], yp[:, c], verbose=False,
                             abs_bound=sc[:, c]) is None
             for c in range(Xd.shape[1]))
    plain_ms = M.event_ms(lambda: DK.dia_matmat_plain(*args), iters=1,
                          reps=2, warmup=1, graph=False)
    return {"k3m_ms": warm, "k3m_cold_ms": cold, "k3m_plain_ms": plain_ms,
            "k3m_plain_max_abs_err": err, "k3m_plain_ok": ok}


def run(n: int = 60, k: int = 32, device=None) -> dict:
    """The record: the column loop and the DIA operator's SpMM on
    grid3d(n) with k columns."""
    dev = resolve_device(device)
    csr = CsrMatrix.from_coo(CooMatrix.grid3d(n)).astype(np.float32)
    rs = np.random.RandomState(0)
    csr.values = rs.uniform(0.5, 1.5, csr.num_nonzeros).astype(np.float32)
    X = rs.uniform(0.5, 1.5, (csr.num_cols, k)).astype(np.float32)
    print(f"grid3d{n}: {csr.num_rows} rows, {csr.num_nonzeros} nnz, k={k}",
          flush=True)
    gold = csr.spmm_gold(X)
    bound = (np.abs(csr.to_dense()) @ np.abs(X)
             if csr.num_rows <= DENSE_BOUND_ROWS else None)
    Xd = torch.from_numpy(X).to(dev)
    out = {"metric": "spmm_column_loop_vs_dia", "rows": csr.num_rows,
           "nnz": csr.num_nonzeros, "k": k,
           "wide_kernel": "retired round 4: ~0.3x the column loop across "
                          "two on-chip designs (round-3 BENCH_SPMM.json)",
           "x_layout": "row-major [cols, k], the same tensor for every "
                       "path", **M.device_record(dev)}
    op = build_operator(csr, dtype="float32", device=dev)
    out["column_loop"] = _mm_entry(op, Xd, gold, bound, csr, k, dev,
                                   "column")
    out["column_loop"]["policy"] = op.plan.policy
    out["k1m"] = _mm_entry(op, Xd, gold, bound, csr, k, dev)
    t0 = time.perf_counter()
    dop = build_dia_operator(csr, dtype="float32", device=dev)
    if dop.vtab is not None:
        rec = _mm_entry(dop, Xd, gold, bound, csr, k, dev)
        m, D = dop.num_rows, int(dop.offsets.size)
        # the table, X and Y once each (tools/bench_spmm.py:108-112)
        dia_bytes = (D * m + dop.num_cols * k + m * k) * 4
        rec.update({"actual_gbps": dia_bytes / rec["avg_ms"] / 1e6,
                    "diagonals": D, "rest_nnz": dop.rest_nnz,
                    "setup_ms": dop.setup_ms,
                    "wall_s": time.perf_counter() - t0})
        out["dia"] = rec
        out["dia_column"] = _mm_entry(dop, Xd, gold, bound, csr, k, dev,
                                      "column")
        if dev.type == "cuda":
            out["dia"]["bytes_bound_ms"] = M.bound_ms(dia_bytes, dev)
            out["dia"].update(card_dia_matmat(dop, Xd))
    if dev.type == "cuda":
        lib = M.library_csr(op)
        Xc = Xd.t().contiguous().t()     # the same X, column-major
        out["cusparse_spmm_colmajor_ms"] = M.fn_ms(
            lambda: torch.sparse.mm(lib, Xc), dev)
        out["column_loop"]["colmajor_ms"] = M.fn_ms(
            lambda: op.mm(Xc, method="column"), dev)
        out["k1m"]["colmajor_ms"] = M.fn_ms(lambda: op.mm(Xc), dev)
        # K1m alone warm and cold in turns with cuSPARSE SpMM, against its
        # plain version; the SpMM bound
        out["k1m"].update(M.card_spmm(op, Xd))
        out["cusparse_spmm_ms"] = out["k1m"]["cusparse_spmm_ms"]
        out["spmm_bytes"] = out["k1m"]["spmm_bytes"]
        out["spmm_bound_ms"] = out["k1m"]["spmm_bound_ms"]
    for name in ("column_loop", "k1m", "dia", "dia_column"):
        if name in out:
            r = out[name]
            print(f"{name}: {r['avg_ms']:8.4f} ms {r['gflops']:7.1f} GFLOP/s "
                  f"({'PASS' if r['verified'] else 'FAIL'}) launches "
                  f"{r['launches']}", flush=True)
    if "cusparse_spmm_ms" in out:
        print(f"cuSPARSE SpMM {out['cusparse_spmm_ms']:.4f} ms (X "
              f"column-major {out['cusparse_spmm_colmajor_ms']:.4f}); column "
              f"loop with X column-major "
              f"{out['column_loop']['colmajor_ms']:.4f} ms; K1m warm "
              f"{out['k1m']['k1m_ms']:.4f} cold {out['k1m']['k1m_cold_ms']:.4f}"
              f"; K3m warm {out['dia']['k3m_ms']:.4f} cold "
              f"{out['dia']['k3m_cold_ms']:.4f} (plain ok "
              f"{out['dia']['k3m_plain_ok']}); SpMM bound "
              f"{out['spmm_bound_ms']:.4f} ms", flush=True)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("n", type=int, nargs="?", default=60)
    ap.add_argument("k", type=int, nargs="?", default=32)
    ap.add_argument("--cpu", action="store_true",
                    help="the kernels' plain versions on the CPU")
    ap.add_argument("--out", default=None, help="the record's path")
    args = ap.parse_args(argv)
    dev = resolve_device("cpu" if args.cpu else None)
    out = run(args.n, args.k, dev)
    M.save_record(M.record_path("BENCH_SPMM", dev, args.out), out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
