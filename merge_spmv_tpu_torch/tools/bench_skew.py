"""Skew invariance: power-law against uniform row lengths at equal nnz,
and the wheel, through K1 beside cuSPARSE.

    python -m merge_spmv_tpu_torch.tools.bench_skew [n] [deg] [--cpu]
        [--out PATH]

Counterpart of tools/bench_skew.py (n = 2^20 rows, deg = 8 by default):
the matrices of bench/matrices.py::skew_trio, the JAX tool's to the bit.
Each is verified against gold at x = 1, then op(x) is timed (CUDA-graph
replays of a chain, utils/timers.py::chained_rate_ms; the host clock over
the plain version with ``--cpu``).  ``powerlaw_over_uniform_per_nnz`` is
the JAX tool's key and formula (:88-91): the GFLOP/s ratio times
uniform nnz / power-law nnz, which works out to uniform ms / power-law
ms.  Added: ``powerlaw_over_uniform_gflops``, the ratio of time per
nonzero; cuSPARSE on each matrix (``torch.mv`` on an int32 CSR of the
same arrays, the same timer) and its two ratios by the same formulas;
K1's gather policy per matrix; and the device.  Writes ``bench/SKEW_h100.json``
(``_cpu.json`` with ``--cpu``) or ``--out``; never the root's SKEW.json,
the TPU's.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from merge_spmv_tpu_torch.bench import measure as M
from merge_spmv_tpu_torch.bench.matrices import skew_trio
from merge_spmv_tpu_torch.ops.operator import build_operator
from merge_spmv_tpu_torch.utils.compare import compare_results
from merge_spmv_tpu_torch.utils.device import resolve_device
from merge_spmv_tpu_torch.utils.timers import event_ms, op_rate_ms

__all__ = ["run", "main"]


def _bench_one(label, csr, dev) -> dict:
    t0 = time.perf_counter()
    op = build_operator(csr, dtype="float32", device=dev)
    x = torch.ones(csr.num_cols, dtype=torch.float32, device=dev)
    ones = np.ones(csr.num_cols, np.float32)
    y = op(x)
    ok = (bool(torch.isfinite(y).all())
          and compare_results(y.cpu().numpy(), csr.spmv_gold(ones),
                              verbose=False,
                              abs_bound=csr.spmv_abs_bound(ones)) is None)
    ms = op_rate_ms(op, x)
    gflops = 2 * csr.num_nonzeros / ms / 1e6
    rec = {"avg_ms": ms, "gflops": gflops, "row_cov": M.row_cov(csr),
           "verified": ok, "nnz": csr.num_nonzeros,
           "policy": op.plan.policy}
    lib_note = ""
    if dev.type == "cuda":
        lib = M.library_csr(op)
        rec["cusparse_ms"] = event_ms(lambda: torch.mv(lib, x), iters=20)
        lib_note = f" cuSPARSE {rec['cusparse_ms']:.4f} ms"
    print(f"{label:>10}: {ms:8.4f} ms  {gflops:6.2f} GFLOP/s  "
          f"CoV={rec['row_cov']:.2f} verified={ok} gather={op.plan.policy}"
          f"{lib_note} (wall {time.perf_counter() - t0:.0f}s)", flush=True)
    return rec


def run(n: int = 1 << 20, deg: int = 8, device=None) -> dict:
    """The record for the trio at n rows and n * deg nonzeros."""
    dev = resolve_device(device)
    out = {"metric": "skew_invariance_powerlaw_vs_uniform", "rows": n,
           **M.device_record(dev)}
    for label, csr in skew_trio(n, deg):
        out[label] = _bench_one(label, csr, dev)
    u, p = out["uniform"], out["powerlaw"]
    # the JAX tool's key and formula: the GFLOP/s ratio times u.nnz/p.nnz,
    # which is u_ms / p_ms (the nonzero count cancels twice)
    out["powerlaw_over_uniform_per_nnz"] = (
        p["gflops"] / u["gflops"] * u["nnz"] / p["nnz"])
    # the ratio of time per nonzero, u_ms/u.nnz over p_ms/p.nnz
    out["powerlaw_over_uniform_gflops"] = p["gflops"] / u["gflops"]
    if dev.type == "cuda":
        out["cusparse_powerlaw_over_uniform_per_nnz"] = (
            u["cusparse_ms"] / p["cusparse_ms"])
        out["cusparse_powerlaw_over_uniform_gflops"] = (
            u["cusparse_ms"] / u["nnz"]) / (p["cusparse_ms"] / p["nnz"])
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("n", type=int, nargs="?", default=1 << 20)
    ap.add_argument("deg", type=int, nargs="?", default=8)
    ap.add_argument("--cpu", action="store_true",
                    help="the kernels' plain versions on the CPU")
    ap.add_argument("--out", default=None, help="the record's path")
    args = ap.parse_args(argv)
    dev = resolve_device("cpu" if args.cpu else None)
    out = run(args.n, args.deg, dev)
    print(f'{{"powerlaw_over_uniform_per_nnz": '
          f'{out["powerlaw_over_uniform_per_nnz"]}}}')
    M.save_record(M.record_path("SKEW", dev, args.out), out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
