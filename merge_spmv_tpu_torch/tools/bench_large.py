"""The circuit5M class through merge op(x), the banded splits and
hot/cold, beside cuSPARSE.

    python -m merge_spmv_tpu_torch.tools.bench_large [n] [nnz]
        [--bands=B | --edges=a,b] [--sweep=8,16,32] [--no-sweep]
        [--no-device] [--cpu] [--out PATH]

Counterpart of three JAX tools, which write one record between them,
BENCH_LARGE.json:

* tools/bench_large.py:89-131: the matrix, bench/matrices.py::
  make_circuit_like(n, nnz) in float32 (5,558,326 rows and 59,524,291
  drawn nonzeros by default, 56,717,547 once the degrees are truncated),
  x uniform(0.1, 1) from RandomState(1), and ``merge``, op(x) of
  build_operator.  ``x_win`` stays the JAX key and is null: the port's
  plan has no x window (Hopper gathers x through its caches).  Added:
  ``policy``, the gather policy K1 ran under.
* tools/bench_large.py:133-168: its split, geometric edges (8, 32) with
  5 bands (``--edges=a,b``; ``--bands=B`` takes B quantile bands), here
  ``split_geometric``: tools/band_sweep.py:111-113 writes the sweep's best
  over the JAX ``split`` key, so the default split keeps a key of its own.
* tools/band_sweep.py:78-113: ``split_sweep``, the host
  build_split_operator over B quantile bands for each B of ``--sweep``,
  and ``split``, its fastest verified entry.  Every split entry also has
  ``split_total_setup_s``, the build and first call's seconds, which the
  root record's ``split`` holds.
* tools/band_sweep.py:115-140: ``hotcold``, build_hotcold_operator on the
  same matrix, or ``{"declined": true}`` when it finds no hot window
  (tools/bench_hotcold.py:94).
* tools/split_device_bench.py:60-100: ``split_device``,
  build_split_operator_device with 16 bands, built twice:
  ``split_setup_ms`` is the second build's setup, ``stage_compile_s`` the
  first's less the second's.  On the TPU that difference was the
  conversion stages' compiles; here nothing compiles (the stages are
  torch operations, the kernel is built before), so it is the first
  build's warm-up: the allocator's and the libraries' first touches.  Its
  x is uniform(0.5, 1.5) from RandomState(1), as that tool's.

``xla`` is cuSPARSE: ``torch.mv`` on an int32 ``sparse_csr_tensor`` of
the merge operator's arrays (``library`` says which; on the CPU,
torch.sparse), timed here, where the JAX record reused a TPU time of
XLA's segment sum.  ``merge_vs_xla_speedup`` and ``split_vs_xla_speedup``
are its time over merge's and split's, the JAX formula.
``reference_k40_merge_ms`` and ``reference_cpu_merge_ms`` are the paper's
circuit5M times on a Tesla K40m and on two Xeon E5-2695v2 (BASELINE.md),
as in the JAX record: not the port's.

Every entry is verified against gold within spmv_abs_bound before it is
timed.  ``avg_ms`` is per op(x): CUDA-graph replays of a dependent chain
(utils/timers.py::op_rate_ms), the library's of independent calls
(``event_ms``), or the host clock over the kernels' plain versions with
``--cpu`` (``timing``: "graph" or "host").  ``effective_gbps`` and
``pct_peak`` take the JAX byte count, ``total_bytes`` = nnz * 12 + rows *
8 (x counted at every nonzero), against the card's published 3,350 GB/s;
``bytes`` and ``bytes_bound_ms`` are the port's count (bench/measure.py::
spmv_bytes, x read once) and its time at that rate.  Writes
``bench/BENCH_LARGE_h100.json`` (``_cpu.json`` with ``--cpu``) or
``--out``; never the root's BENCH_LARGE.json, the TPU's.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from merge_spmv_tpu_torch.bench import measure as M
from merge_spmv_tpu_torch.bench.matrices import make_circuit_like
from merge_spmv_tpu_torch.ops.operator import build_operator
from merge_spmv_tpu_torch.ops.split import (build_hotcold_operator,
                                            build_split_operator,
                                            build_split_operator_device)
from merge_spmv_tpu_torch.tools.bench_baseline_configs import build
from merge_spmv_tpu_torch.utils.device import (peak_hbm_bandwidth,
                                               resolve_device)
from merge_spmv_tpu_torch.utils.timers import op_rate_ms

__all__ = ["run", "main", "record_keys", "circuit_csr", "measure_operator",
           "library_entry", "CIRCUIT", "SWEEP"]

CIRCUIT = (5_558_326, 59_524_291)     # tools/bench_large.py:90-91
SWEEP = (8, 16, 32)                   # tools/band_sweep.py:80
DEVICE_BANDS = 16                     # tools/split_device_bench.py:41
# the paper's circuit5M merge CsrMV times (BASELINE.md), as the JAX
# record has them (tools/bench_large.py:200-201)
REFERENCE = {"reference_k40_merge_ms": 6.92, "reference_cpu_merge_ms": 12.64}

_ENTRY = ("avg_ms", "gflops", "effective_gbps", "verified")
_SPLIT = _ENTRY + ("num_bands", "edges", "split_setup_ms",
                   "split_total_setup_s")


def record_keys(sweep=SWEEP, device: bool = True) -> dict:
    """The JAX record's keys for a run over ``sweep`` (bench/measure.py::
    record_faults): the root BENCH_LARGE.json's, with ``split_sweep`` and
    ``hotcold`` from tools/band_sweep.py:97-135 and ``split_device`` from
    tools/split_device_bench.py:89-96; ``split_geometric`` is
    tools/bench_large.py:162-168's ``split``."""
    keys = {"metric": (), "rows": (), "nnz": (),
            "merge": _ENTRY + ("backend", "x_win", "pct_peak"),
            "split_geometric": _SPLIT,
            "hotcold": _ENTRY + ("setup_ms", "pct_peak"),
            "xla": ("avg_ms", "verified", "reused_prior_measurement"),
            "merge_vs_xla_speedup": (), **{k: () for k in REFERENCE}}
    if sweep:
        keys.update({"split": _SPLIT, "split_sweep": (),
                     "split_vs_xla_speedup": ()})
        keys.update({f"split_sweep.{b}": _SPLIT for b in sweep})
    if device:
        keys["split_device"] = _ENTRY + (
            "num_bands", "edges", "split_setup_ms", "upload_ms",
            "convert_ms", "stage_compile_s", "timing")
    return keys


def _log(msg):
    print(msg, flush=True)


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _timing(dev) -> str:
    return "graph" if dev.type == "cuda" else "host"


def circuit_csr(n: int, nnz: int):
    """make_circuit_like(n, nnz)'s matrix in float32 (every row has a
    nonzero, so its n rows are the largest row drawn + 1)."""
    return build(lambda: make_circuit_like(n, nnz), np.float32)


def measure_operator(label, op, t0, csr, x, gold, bound, dev):
    """(entry, seconds) for an operator built from ``t0``
    (``time.perf_counter()``) on: op(x) verified against gold within
    ``bound``, then timed; the entry has the JAX tools' keys
    (tools/bench_large.py:123-131: ``avg_ms``, ``gflops``,
    ``effective_gbps`` and ``pct_peak`` by the JAX byte count), the
    seconds are the build's and the first call's."""
    xd = torch.from_numpy(x).to(dev)
    y = op(xd)
    _sync(dev)
    setup_s = time.perf_counter() - t0
    ok = M.verify_spmv(y, gold, bound)
    del y
    ms = op_rate_ms(op, xd)
    total = csr.num_nonzeros * 12 + csr.num_rows * 8
    gbps = total / ms / 1e6
    entry = {"avg_ms": ms, "gflops": 2 * csr.num_nonzeros / ms / 1e6,
             "effective_gbps": gbps,
             "pct_peak": (100 * gbps / peak_hbm_bandwidth(dev)
                          if dev.type == "cuda" else None),
             "verified": ok}
    _log(f"{label}: {op.describe()} verified={ok}, built and called once "
         f"in {setup_s:.1f} s; op(x) {ms:.4f} ms ({_timing(dev)})")
    return entry, setup_s


def library_entry(op, x, gold, bound, dev) -> dict:
    """The library's y = A @ x on the merge operator's arrays (cuSPARSE
    on the card, torch.sparse on the CPU): verified, then timed."""
    lib = M.library_csr(op)
    xd = torch.from_numpy(x).to(dev)
    ok = M.verify_spmv(torch.mv(lib, xd), gold, bound)
    ms = M.fn_ms(lambda: torch.mv(lib, xd), dev)
    name = "cusparse" if dev.type == "cuda" else "torch.sparse (cpu)"
    _log(f"library ({name}): verified={ok}, {ms:.4f} ms")
    return {"avg_ms": ms, "verified": ok, "library": name}


def _split_entry(label, sop, t0, edges, csr, x, gold, bound, dev) -> dict:
    """A split operator's entry: measure_operator's, the JAX split keys
    (tools/bench_large.py:162-168) and the stack's rows, tile and gather
    policy."""
    entry, setup_s = measure_operator(label, sop, t0, csr, x, gold, bound,
                                      dev)
    return {**entry, "num_bands": sop.num_bands, "edges": edges,
            "split_setup_ms": sop.setup_ms, "split_total_setup_s": setup_s,
            "stacked_rows": sop.plan.num_rows,
            "tile_items": sop.plan.tile_items, "policy": sop.plan.policy}


def run(n: int = CIRCUIT[0], nnz: int = CIRCUIT[1], edges=(8, 32),
        num_bands: int = 5, sweep=SWEEP, split_device: bool = True,
        device=None, csr=None) -> dict:
    """The record for make_circuit_like(n, nnz), or for ``csr`` (float32)
    when given.  ``edges``/``num_bands`` are split_geometric's
    (build_split_operator's ``edges_chunks``, a tuple or "quantile");
    ``sweep`` the quantile band counts (empty: no sweep, no ``split``);
    ``split_device`` whether the device-built split runs."""
    dev = resolve_device(device)
    if csr is None:
        csr = circuit_csr(n, nnz)
    rows, nz = csr.num_rows, csr.num_nonzeros
    x = np.random.RandomState(1).uniform(0.1, 1.0, csr.num_cols
                                         ).astype(np.float32)
    t0 = time.perf_counter()
    gold, bound = csr.spmv_gold(x), csr.spmv_abs_bound(x)
    _log(f"circuit class {rows} rows {nz} nnz float32; gold and bound in "
         f"{time.perf_counter() - t0:.1f} s")
    nbytes = M.spmv_bytes(rows, csr.num_cols, nz, 4)
    out = {"metric": "circuit5M_class_merge_csrmv_fp32", "rows": rows,
           "nnz": nz, "total_bytes": nz * 12 + rows * 8, "bytes": nbytes,
           "bytes_bound_ms": (M.bound_ms(nbytes, dev)
                              if dev.type == "cuda" else None),
           "timing": _timing(dev), **M.device_record(dev)}

    t0 = time.perf_counter()
    op = build_operator(csr, dtype="float32", device=dev)
    entry, setup_s = measure_operator("merge", op, t0, csr, x, gold, bound,
                                      dev)
    out["merge"] = {**entry, "backend": op.plan.backend, "x_win": None,
                    "policy": op.plan.policy, "setup_compile_s": setup_s}
    out["xla"] = {**library_entry(op, x, gold, bound, dev),
                  "reused_prior_measurement": False}
    del op
    merge_ms, xla_ms = out["merge"]["avg_ms"], out["xla"]["avg_ms"]
    out["merge_vs_xla_speedup"] = xla_ms / merge_ms

    if sweep:
        out["split_sweep"] = {}
        for b in sweep:
            t0 = time.perf_counter()
            sop = build_split_operator(csr, dtype="float32",
                                       edges_chunks="quantile", num_bands=b,
                                       device=dev)
            out["split_sweep"][str(b)] = _split_entry(
                f"split B={b}", sop, t0, "quantile", csr, x, gold, bound,
                dev)
            del sop
        good = [e for e in out["split_sweep"].values() if e["verified"]]
        if good:
            out["split"] = min(good, key=lambda e: e["avg_ms"])
            out["split_vs_xla_speedup"] = xla_ms / out["split"]["avg_ms"]

    t0 = time.perf_counter()
    sop = build_split_operator(csr, dtype="float32", edges_chunks=edges,
                               num_bands=num_bands, device=dev)
    out["split_geometric"] = _split_entry(
        f"split edges={edges}", sop, t0, str(edges), csr, x, gold, bound,
        dev)
    del sop

    if split_device:
        xs = np.random.RandomState(1).uniform(0.5, 1.5, csr.num_cols
                                              ).astype(np.float32)
        gold_s, bound_s = csr.spmv_gold(xs), csr.spmv_abs_bound(xs)
        first = build_split_operator_device(csr, num_bands=DEVICE_BANDS,
                                            device=dev)
        first_ms = first.setup_ms
        del first
        t0 = time.perf_counter()
        sop = build_split_operator_device(csr, num_bands=DEVICE_BANDS,
                                          device=dev)
        out["split_device"] = {
            **_split_entry("split_device", sop, t0, "quantile(device)", csr,
                           xs, gold_s, bound_s, dev),
            "upload_ms": sop.upload_ms, "convert_ms": sop.convert_ms,
            "stage_ms": sop.stage_ms,
            "stage_compile_s": (first_ms - sop.setup_ms) / 1e3,
            "first_setup_ms": first_ms, "timing": _timing(dev)}
        _log(f"split_device: setup {sop.setup_ms:.0f} ms (first build "
             f"{first_ms:.0f} ms), stages {sop.stage_ms}")
        del sop, gold_s, bound_s

    t0 = time.perf_counter()
    hop = build_hotcold_operator(csr, dtype="float32", device=dev)
    if hop.num_hot_windows == 0:
        _log(f"hotcold: {hop.describe()}: declined")
        out["hotcold"] = {"declined": True, "setup_ms": hop.setup_ms}
    else:
        entry, setup_s = measure_operator("hotcold", hop, t0, csr, x, gold,
                                          bound, dev)
        out["hotcold"] = {
            **entry, "setup_ms": hop.setup_ms, "setup_compile_s": setup_s,
            "hot_windows": hop.num_hot_windows,
            "hot_nnz": hop.hot_nnz, "cold_nnz": hop.cold_nnz}
    del hop
    out.update(REFERENCE)
    return out


def _edges(spec: str):
    return tuple(int(e) for e in spec.split(","))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("n", type=int, nargs="?", default=CIRCUIT[0])
    ap.add_argument("nnz", type=int, nargs="?", default=CIRCUIT[1])
    split = ap.add_mutually_exclusive_group()
    split.add_argument("--bands", type=int, default=None,
                       help="split_geometric as B quantile bands")
    split.add_argument("--edges", type=_edges, default=(8, 32),
                       help="split_geometric's edges, in 1024 columns")
    ap.add_argument("--sweep", type=_edges, default=SWEEP,
                    help="the quantile band counts of split_sweep")
    ap.add_argument("--no-sweep", action="store_true")
    ap.add_argument("--no-device", action="store_true",
                    help="leave out the device-built split")
    ap.add_argument("--cpu", action="store_true",
                    help="the kernels' plain versions on the CPU")
    ap.add_argument("--out", default=None, help="the record's path")
    args = ap.parse_args(argv)
    from merge_spmv_tpu_torch.utils.hostmem import enable_warm_heap
    enable_warm_heap()   # warm-page reuse for the generator's arrays
    dev = resolve_device("cpu" if args.cpu else None)
    edges, nb = (("quantile", args.bands) if args.bands
                 else (args.edges, 5))
    out = run(args.n, args.nnz, edges, nb,
              () if args.no_sweep else args.sweep, not args.no_device, dev)
    print(json.dumps(out))
    M.save_record(M.record_path("BENCH_LARGE", dev, args.out), out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
