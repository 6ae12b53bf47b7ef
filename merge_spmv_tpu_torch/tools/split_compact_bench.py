"""The compact-row split (stack_bands_compact) on the circuit class's
quarter against the plain stack, and where its time goes.

    python -m merge_spmv_tpu_torch.tools.split_compact_bench [n nnz]
        [B ...] [--cpu] [--out PATH]

Counterpart of tools/split_compact_bench.py: the matrix is bench/
matrices.py::make_circuit_like(n, nnz) in float32 (1,389,581 rows and
14,881,072 drawn nonzeros by default, 14,178,457 once the degrees are
truncated: the root SPLIT_COMPACT.json's), x uniform(0.1, 1) from
RandomState(1) (:32-43).  For each B (default 24, :34),
``configs["B{B}_compact"]`` is build_split_operator over B quantile bands
with ``compact_rows=True``: op(x) verified against gold (within
spmv_abs_bound), then timed, with ``stacked_rows`` and
``setup_compile_s``, the build and first call's seconds (:62-65).

``attribution`` has the keys of the root record, which the JAX tool did
not write: ``B{B}_kernel_only_ms``, the stacked K1 launch alone (the
split's ``op.op(x)``, ops/split.py:419); ``B{B}_epilogue_only_ms``, the
re-expansion alone (``_gather_rows`` on a fixed stacked y);
``plain_B{B}_total_ms``, op(x) of the plain (full-row) stack over the same
bands, verified too (``plain_B{B}_verified``).  On the card every time is
a CUDA-graph replay (op(x) of a dependent chain, utils/timers.py::
op_rate_ms; the two pieces of independent calls, ``event_ms``:
``timing`` "graph"); ``--cpu`` times the plain versions by the host clock
("host").  Writes ``bench/SPLIT_COMPACT_h100.json`` (``_cpu.json`` with
``--cpu``) or ``--out``; never the root's SPLIT_COMPACT.json, the TPU's.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from merge_spmv_tpu_torch.bench import measure as M
from merge_spmv_tpu_torch.ops.split import build_split_operator
from merge_spmv_tpu_torch.tools.bench_large import (circuit_csr,
                                                    measure_operator)
from merge_spmv_tpu_torch.utils.device import resolve_device

__all__ = ["run", "main", "record_keys", "QUARTER", "BANDS"]

QUARTER = (1_389_581, 14_881_072)     # tools/split_compact_bench.py:32-33
BANDS = (24,)                         # tools/split_compact_bench.py:34


def record_keys(bands=BANDS) -> dict:
    """The root SPLIT_COMPACT.json's keys for a run over ``bands`` (bench/
    measure.py::record_faults), its ``reading`` string aside."""
    keys = {"matrix": (), "timing": (), "configs": (),
            "attribution": tuple(k for b in bands for k in (
                f"B{b}_kernel_only_ms", f"B{b}_epilogue_only_ms",
                f"plain_B{b}_total_ms"))}
    keys.update({f"configs.B{b}_compact": (
        "avg_ms", "verified", "stacked_rows", "setup_compile_s")
        for b in bands})
    return keys


def run(n: int = QUARTER[0], nnz: int = QUARTER[1], bands=BANDS,
        device=None, csr=None) -> dict:
    """The record for make_circuit_like(n, nnz)'s matrix, or for ``csr``
    (float32) when given, over the quantile band counts ``bands``."""
    dev = resolve_device(device)
    if csr is None:
        csr = circuit_csr(n, nnz)
    x = np.random.RandomState(1).uniform(0.1, 1.0, csr.num_cols
                                         ).astype(np.float32)
    gold, bound = csr.spmv_gold(x), csr.spmv_abs_bound(x)
    xd = torch.from_numpy(x).to(dev)
    out = {"matrix": f"circuit_like n={csr.num_rows} nnz={csr.num_nonzeros}",
           "timing": "graph" if dev.type == "cuda" else "host",
           "configs": {}, "attribution": {}, **M.device_record(dev)}
    att = out["attribution"]
    for b in bands:
        t0 = time.perf_counter()
        sop = build_split_operator(csr, dtype="float32",
                                   edges_chunks="quantile", num_bands=b,
                                   compact_rows=True, device=dev)
        entry, setup_s = measure_operator(f"B={b} compact", sop, t0, csr, x,
                                          gold, bound, dev)
        out["configs"][f"B{b}_compact"] = {
            "avg_ms": entry["avg_ms"], "verified": entry["verified"],
            "stacked_rows": sop.plan.num_rows, "setup_compile_s": setup_s,
            "num_bands": sop.num_bands}
        y_stacked = sop.op(xd)
        att[f"B{b}_kernel_only_ms"] = M.fn_ms(lambda: sop.op(xd), dev)
        att[f"B{b}_epilogue_only_ms"] = M.fn_ms(
            lambda: sop._gather_rows(y_stacked), dev)
        del sop, y_stacked
        t0 = time.perf_counter()
        plain = build_split_operator(csr, dtype="float32",
                                     edges_chunks="quantile", num_bands=b,
                                     device=dev)
        entry, _ = measure_operator(f"B={b} plain", plain, t0, csr, x, gold,
                                    bound, dev)
        att[f"plain_B{b}_total_ms"] = entry["avg_ms"]
        att[f"plain_B{b}_verified"] = entry["verified"]
        att[f"plain_B{b}_stacked_rows"] = plain.plan.num_rows
        del plain
        print(f"B={b}: compact kernel alone "
              f"{att[f'B{b}_kernel_only_ms']:.4f} ms, epilogue alone "
              f"{att[f'B{b}_epilogue_only_ms']:.4f} ms; plain stack "
              f"{att[f'plain_B{b}_total_ms']:.4f} ms", flush=True)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("args", type=int, nargs="*",
                    help="n nnz, then the band counts")
    ap.add_argument("--cpu", action="store_true",
                    help="the kernels' plain versions on the CPU")
    ap.add_argument("--out", default=None, help="the record's path")
    args = ap.parse_args(argv)
    n, nnz = (args.args + list(QUARTER)[len(args.args):])[:2]
    bands = tuple(args.args[2:]) or BANDS
    from merge_spmv_tpu_torch.utils.hostmem import enable_warm_heap
    enable_warm_heap()   # warm-page reuse for the generator's arrays
    dev = resolve_device("cpu" if args.cpu else None)
    out = run(n, nnz, bands, dev)
    print(json.dumps(out))
    M.save_record(M.record_path("SPLIT_COMPACT", dev, args.out), out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
