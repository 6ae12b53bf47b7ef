"""Weak scaling of the multi-process merge-path CsrMV over S gloo ranks.

    python -m merge_spmv_tpu_torch.tools.bench_multichip [--cpu]
        [--out PATH]

Counterpart of tools/bench_multichip.py.  Weak scaling: the matrix grows
with S (S * 2^17 rows, 8 nonzeros a row within ±2000 of the diagonal), so
each rank's work is constant; the metric is nonzeros per second per rank
against S = 1.  The matrices are bench/matrices.py::weak_scaling_matrices,
the JAX tool's to the bit: every S of (1, 2, 4, 8) is drawn, then the
fixed-total-work matrix (the S = 8 size), whichever S run.

For each S, S processes of ``parallel/mp_worker.py --cases --time`` join
one gloo group; each partitions both matrices, runs its share through the
prepared SPMD operator (halo exchange, K1 on its share, carry
reduce-scatter), verifies its window, and reports by the host clock over
calls that all ranks make together:

* the whole call from its placed input (``avg_ms``: the slowest rank's);
* the local-only control (``local_only_ms``): the same K1 on the same
  share, with no halo exchange and no reduce-scatter (the JAX tool's
  ``body_local``);
* on the fixed-total-work matrix, the same call (``fixed_total_work``) and
  the call from the global host x, its block copied in per call
  (``prepared_vs_unprepared``: ``unprepared_call_ms``; the prepared
  operator's setup, partition to first call, ``prepare_setup_s``).

Here the windows are assembled and verified against gold too.  The
efficiencies are the JAX tool's formulas.  With ``--cpu`` the ranks share
this host's cores (each told cpu_count / S threads), as the JAX tool's
virtual CPU devices share a core.  On the card all S ranks share one GPU
(gloo stages the exchanges through the host; NCCL takes one rank per
GPU): their calls time-slice it, so the efficiencies measure that
sharing, not scaling across cards.  Writes ``bench/WEAKSCALING_h100.json``
(``_cpu.json`` with ``--cpu``) or ``--out``; never the root's
WEAKSCALING.json, the TPU package's.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile

import numpy as np

from merge_spmv_tpu_torch.bench import measure as M
from merge_spmv_tpu_torch.bench.matrices import (WEAK_SHARDS,
                                                 weak_scaling_matrices)
from merge_spmv_tpu_torch.parallel.distributed import materialize_y
from merge_spmv_tpu_torch.parallel.mp_worker import save_case, spawn
from merge_spmv_tpu_torch.parallel.partition import partition_csr
from merge_spmv_tpu_torch.utils.compare import compare_results
from merge_spmv_tpu_torch.utils.device import resolve_device

__all__ = ["run", "main"]

ROWS_PER_SHARD = 1 << 17
DEG = 8
NOTE_CPU = (
    "the ranks are processes sharing this host's cores; S>1 runs an "
    "S-times-larger working set than S=1, so both serialized metrics fold "
    "host effects in.  collective_overhead_efficiency is the isolating "
    "control (same shares, the exchanges removed): the fraction of a call "
    "NOT spent on the halo exchange and the carry reduce-scatter.  "
    "fixed_total_work_efficiency: one constant matrix over S shares, "
    "T_1/T_S")
NOTE_CARD = (
    "all S ranks share one GPU (device count 1) over gloo, which stages "
    "the exchanges through the host: their calls time-slice the card, so "
    "these efficiencies measure that sharing and the host-staged "
    "exchange, not scaling across GPUs (NCCL across cards is untried).  "
    "collective_overhead_efficiency: the same K1 on the same shares with "
    "the exchanges removed, over the whole call")


def _verified(case_dir, world, part, gold, bound) -> bool:
    windows = np.stack([np.load(os.path.join(case_dir, f"y_{r}.npy"))
                        for r in range(world)])
    return compare_results(materialize_y(windows, part), gold,
                           verbose=False, abs_bound=bound) is None


def run(rows_per_shard: int = ROWS_PER_SHARD, shards=WEAK_SHARDS,
        device=None, calls: int = 20) -> dict:
    """The record for ``shards`` (each a rank count), on the card or
    (``device="cpu"``) on this host's cores."""
    dev = resolve_device(device)
    shards = tuple(sorted(shards))
    weak, (csr_f, x_f) = weak_scaling_matrices(rows_per_shard, DEG, shards)
    gold_f, bound_f = csr_f.spmv_gold(x_f), csr_f.spmv_abs_bound(x_f)
    results, fixed, prepared = {}, {}, {}
    with tempfile.TemporaryDirectory() as root:
        for S in shards:
            csr, x = weak[S]
            d = os.path.join(root, f"S{S}")
            meta = {"prepared": True, "calls": calls}
            d_weak = save_case(d, "weak", csr, x, meta)
            d_fixed = save_case(d, "fixed", csr_f, x_f, meta)
            # on the CPU the ranks share the host's cores
            env = ({"OMP_NUM_THREADS": str(max(1, (os.cpu_count() or 1)
                                               // S))}
                   if dev.type == "cpu" else None)
            reps = spawn(S, d, dev.type, env)
            part = partition_csr(csr, S, dtype=np.float32)
            part_f = partition_csr(csr_f, S, dtype=np.float32)
            ok = _verified(d_weak, S, part, csr.spmv_gold(x),
                           csr.spmv_abs_bound(x))
            ok_f = _verified(d_fixed, S, part_f, gold_f, bound_f)
            w = [r["weak"] for r in reps]
            f = [r["fixed"] for r in reps]
            ms = max(r["call_ms"] for r in w)
            results[S] = {
                "rows": csr.num_rows, "nnz": csr.num_nonzeros,
                "x_mode": part.x_mode, "halo": part.halo, "verified": ok,
                "avg_ms": ms,
                "local_only_ms": max(r["local_ms"] for r in w),
                "nnz_per_s_per_shard": csr.num_nonzeros / (ms / 1e3) / S
                / 1e6,
                "ranks": w}
            fixed[S] = {"avg_ms": max(r["call_ms"] for r in f),
                        "verified": ok_f, "x_mode": part_f.x_mode,
                        "ranks": f}
            if S >= 2:
                prepared[S] = {
                    "prepared_step_ms": fixed[S]["avg_ms"],
                    "unprepared_call_ms": max(r["unprepared_ms"] for r in f),
                    "prepare_setup_s": max(r["prepare_s"] for r in f),
                    "verified": ok_f}
            print(f"S={S}: {ms:8.3f} ms (local-only "
                  f"{results[S]['local_only_ms']:8.3f})  "
                  f"{results[S]['nnz_per_s_per_shard']:7.1f} Mnnz/s/shard "
                  f"x_mode={part.x_mode} verified={ok}; fixed-total "
                  f"{fixed[S]['avg_ms']:8.3f} ms verified={ok_f}",
                  flush=True)
    eff, eff_total, eff_coll, fixed_eff = {}, {}, {}, {}
    if 1 in results:
        base = results[1]
        for S, r in results.items():
            eff[S] = r["nnz_per_s_per_shard"] / base["nnz_per_s_per_shard"]
            eff_total[S] = S * base["avg_ms"] / r["avg_ms"]
            fixed_eff[S] = fixed[1]["avg_ms"] / fixed[S]["avg_ms"]
    for S, r in results.items():
        eff_coll[S] = min(r["local_only_ms"] / r["avg_ms"], 1.0)
    return {
        "metric": "weak_scaling_nnz_per_s_per_shard",
        "rows_per_shard": rows_per_shard,
        "host_cpus": os.cpu_count(),
        "platform": dev.type,
        "backend": "gloo",
        **M.device_record(dev),
        "results": results,
        "efficiency_vs_S1": eff,
        "serialized_total_work_efficiency": eff_total,
        "collective_overhead_efficiency": eff_coll,
        "fixed_total_work": fixed,
        "prepared_vs_unprepared": prepared,
        "fixed_total_work_efficiency": fixed_eff,
        "note": NOTE_CARD if dev.type == "cuda" else NOTE_CPU,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cpu", action="store_true",
                    help="the ranks on this host's cores (plain versions)")
    ap.add_argument("--out", default=None, help="the record's path")
    args = ap.parse_args(argv)
    dev = resolve_device("cpu" if args.cpu else None)
    out = run(device=dev)
    M.save_record(M.record_path("WEAKSCALING", dev, args.out), out)
    print(json.dumps({"weak_scaling_efficiency": out["efficiency_vs_S1"]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
