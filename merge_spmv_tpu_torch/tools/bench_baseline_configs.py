"""Stand-ins of the five configurations of BASELINE.json ("configs") at
their published sizes, through K1 beside cuSPARSE.

    python -m merge_spmv_tpu_torch.tools.bench_baseline_configs [names...]
        [--force] [--cpu] [--out PATH] [--scale S]

Counterpart of tools/bench_baseline_configs.py.  The SuiteSparse files are
not in the repository, so each config runs a stand-in matching the real
matrix's rows, nnz, row-length distribution and column-locality class,
made from a seed by bench/matrices.py with the JAX tool's names, sizes,
seeds and dtypes (its rows one more than the largest index drawn,
duplicates kept):

* ``cant``: cant_class, banded(62,451, 64, sigma 400), float64;
* ``webbase_pair``: webbase_1M_class (powerlaw_web(1,000,005, 3,105,536))
  and wb_edu_class (powerlaw_web(9,845,725, 57,156,537)), float32, the
  hot/cold split's A/B on wb_edu_class and ``webbase_pair_per_nnz_ratio``;
* ``spmm``: op.mm with k = 8 and 32 columns on the cant and pdb1HYS
  (banded(36,417, 119, sigma 300)) classes, float32: one K1m launch,
  beside ``method="column"`` (K1 once per column) in the same run;
* ``cage15``: cage15_class, banded(5,154,859, 19, sigma 10,000), float64;
* ``kron``: kron_g500_logn21_class, rmat(21, 182,082,942), float64.

Every matrix is verified against the gold SpMV (SpMM: JAX's relative
check) before it is timed; a float64 result also within 2 gamma_n |A| |x|
per row (bench/measure.py::fp64_bound), as is K1's plain version's.
Each entry has the JAX record's keys with their meanings (``avg_ms``: op(x), or op.mm(X), per call; ``timing``:
"graph", CUDA-graph replays of a chain, utils/timers.py::chained_rate_ms,
or "host" for the plain versions on the CPU; ``backend``: the plan's),
and adds the device (the card's name, nvidia-smi's name and power limit),
K1's gather policy and launches, K1 alone warm and with a cold L2 under
the policy make_plan picked and under the other one, cuSPARSE
(``torch.mv`` / ``torch.sparse.mm`` on an int32 CSR of the same arrays)
warm and cold, and the bytes bound (inputs read once, outputs written
once, at the published HBM rate; SpMM reads A once).  kron adds the gather
bound (tools/gather_rate.py).

The record is resumable as the JAX tool's is: entries present are kept,
``--force`` drops only the named configs' entries, and the webbase entries
carry the generator's version (``WB_GEN``).  It is written after every
entry, to ``bench/BASELINE_CONFIGS_h100.json`` (``_cpu.json`` with
``--cpu``) or ``--out``; never to the root's BASELINE_CONFIGS.json, the
TPU's.  ``--cpu`` runs the kernels' plain versions, timed by the host
clock, with the device-only keys null; ``--scale`` (tests) multiplies
every config's rows and nnz.
"""

from __future__ import annotations

import argparse
import math
import sys
import time

import numpy as np
import torch

from merge_spmv_tpu_torch.bench import measure as M
from merge_spmv_tpu_torch.bench.matrices import banded, powerlaw_web, rmat
from merge_spmv_tpu_torch.formats.coo import CooMatrix
from merge_spmv_tpu_torch.formats.csr import CsrMatrix
from merge_spmv_tpu_torch.ops import csrmv_cuda as K
from merge_spmv_tpu_torch.ops.operator import build_operator
from merge_spmv_tpu_torch.ops.split import build_hotcold_operator
from merge_spmv_tpu_torch.utils.device import (peak_hbm_bandwidth,
                                               resolve_device)
from merge_spmv_tpu_torch.utils.timers import op_rate_ms

__all__ = ["CONFIGS", "WB_GEN", "run", "run_csrmv", "run_hotcold",
           "run_spmm", "main"]

CONFIGS = ("cant", "webbase_pair", "spmm", "cage15", "kron")
# the entries each config writes, by prefix (--force drops these)
PREFIXES = {"cant": ("cant_class",), "cage15": ("cage15_class",),
            "webbase_pair": ("webbase", "wb_edu"), "spmm": ("spmm_",),
            "kron": ("kron",)}
# powerlaw_web's version: a resumed run never mixes the webbase entries
# of two versions (the hot/cold A/B and the pair ratio compare the same
# matrices)
WB_GEN = 2
WB_KEYS = ("webbase_1M_class", "wb_edu_class", "wb_edu_class_hotcold")
SPMM_K = (8, 32)
# JAX's SpMM check: max |Y - gold| within 1e-4 of max |gold|
SPMM_REL_TOL = 1e-4


def _log(msg):
    print(msg, flush=True)


def build(gen, dtype) -> CsrMatrix:
    """The CSR of ``gen()``'s COO arrays: n one more than the largest
    index drawn, duplicates kept (the JAX tool's ``build``); the host
    seconds of each step printed."""
    t0 = time.perf_counter()
    r_, c_, v_ = gen()
    n = int(max(r_.max(), c_.max())) + 1
    t1 = time.perf_counter()
    coo = CooMatrix(n, n, r_, c_, v_)
    del r_, c_, v_
    csr = CsrMatrix.from_coo(coo).astype(dtype)
    del coo
    _log(f"  built {n} rows {csr.num_nonzeros} nnz: generated in "
         f"{t1 - t0:.1f} s, CSR in {time.perf_counter() - t1:.1f} s")
    return csr


def _gather_bound(op, rec, dev):
    """The gather bound (tools/gather_rate.py): the distinct sectors of
    each warp request at the probe's L2 sector rate for an x of this
    size, plus the streams at the HBM peak."""
    from merge_spmv_tpu_torch.tools import gather_rate as GR
    vb = op.values.element_size()
    sectors = GR.warp_sectors(op.col_indices, op.dtype)
    x_bytes = op.plan.num_cols * vb
    rate = GR.measure(sizes=(x_bytes // 4,), device=dev)[str(x_bytes // 4)]
    streams = rec["bytes"] - x_bytes
    rec.update({"gather_sectors": sectors,
                "gather_sector_rate_gbps": rate["sector_rate_gbps"],
                "gather_bound_ms": GR.gather_bound_ms(
                    sectors, streams, rate["sector_rate_gbps"],
                    peak_hbm_bandwidth(dev))})


def run_csrmv(csr, dtype_name, dev, gather_bound=False) -> dict:
    """One config's entry: verify op(x) against gold, then time it."""
    on_card = dev.type == "cuda"
    x = np.random.RandomState(1).uniform(0.5, 1.5, csr.num_cols
                                         ).astype(csr.values.dtype)
    t0 = time.perf_counter()
    gold = csr.spmv_gold(x)
    bound = csr.spmv_abs_bound(x)
    _log(f"  gold ({time.perf_counter() - t0:.1f} s)")
    t0 = time.perf_counter()
    op = build_operator(csr, dtype=dtype_name, device=dev)
    xd = torch.from_numpy(x).to(dev)
    before = K.LAUNCHES["merge_tile_fused"]
    y = op(xd)
    if on_card:
        torch.cuda.synchronize()
    launches = K.LAUNCHES["merge_tile_fused"] - before
    setup_s = time.perf_counter() - t0
    ok = M.verify_spmv(y, gold, bound)
    del bound
    fp64 = {}
    if csr.values.dtype == np.float64:
        ok64, worst = M.fp64_check(y.cpu().numpy(), gold,
                                   np.diff(csr.row_offsets),
                                   csr.spmv_abs_bound(x, segmented_block=0))
        ok = ok and ok64
        fp64 = {"gold_err_over_fp64_bound": worst}
        _log(f"  |y - gold| over 2 gamma_n |A| |x|: at most {worst:.3e}")
    del y, gold
    _log(f"  {op.plan.describe()} verify={'PASS' if ok else 'FAIL'} "
         f"(setup {setup_s:.1f} s)")
    ms = op_rate_ms(op, xd)
    vb = op.values.element_size()
    # the JAX tool's byte model (:184)
    total_bytes = csr.num_nonzeros * (2 * vb + 4) + csr.num_rows * (4 + vb)
    gbps = total_bytes / ms / 1e6
    gflops = 2 * csr.num_nonzeros / ms / 1e6
    peak = peak_hbm_bandwidth(dev) if on_card else None
    rec = {"rows": csr.num_rows, "cols": csr.num_cols,
           "nnz": csr.num_nonzeros, "dtype": dtype_name, "avg_ms": ms,
           "gflops": gflops, "effective_gbps": gbps,
           "pct_peak": 100 * gbps / peak if peak else None,
           "verified": ok, "backend": op.plan.backend,
           "setup_compile_s": setup_s,
           "timing": "graph" if on_card else "host",
           "row_cov": M.row_cov(csr), "k1_launches": launches,
           "merge_items": csr.num_rows + csr.num_nonzeros, **fp64,
           **M.device_record(dev)}
    if on_card:
        rec.update(M.card_spmv(op, xd))
        if gather_bound:
            _gather_bound(op, rec, dev)
        _log(f"  op(x) {ms:.4f} ms {gflops:.2f} GFLOP/s; K1 {rec['policy']} "
             f"warm {rec['k1_ms']} cold {rec['k1_cold_ms']}; cuSPARSE "
             f"{rec['cusparse_ms']:.4f} / {rec['cusparse_cold_ms']:.4f}; "
             f"bytes bound {rec['bytes_bound_ms']:.4f}")
    else:
        _log(f"  op(x) {ms:.4f} ms on the CPU (plain version)")
    return rec


def run_hotcold(csr, dev) -> dict:
    """The hot/cold popularity split's A/B entry on the same matrix,
    float32; ``declined`` when it finds no hot window (JAX's record)."""
    t0 = time.perf_counter()
    op = build_hotcold_operator(csr, dtype="float32", device=dev)
    _log(f"  {op.describe()}")
    if op.num_hot_windows == 0:
        return {"declined": True, "setup_ms": op.setup_ms,
                **M.device_record(dev)}
    x = np.random.RandomState(1).uniform(0.5, 1.5, csr.num_cols
                                         ).astype(np.float32)
    xd = torch.from_numpy(x).to(dev)
    before = K.LAUNCHES["merge_tile_fused"]
    y = op(xd)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    launches = K.LAUNCHES["merge_tile_fused"] - before
    setup_s = time.perf_counter() - t0
    ok = M.verify_spmv(y, csr.spmv_gold(x), csr.spmv_abs_bound(x))
    ms = op_rate_ms(op, xd)
    total_bytes = csr.num_nonzeros * 12 + csr.num_rows * 8
    return {"avg_ms": ms, "gflops": 2 * csr.num_nonzeros / ms / 1e6,
            "effective_gbps": total_bytes / ms / 1e6, "verified": ok,
            "hot_windows": op.num_hot_windows, "hot_nnz": op.hot_nnz,
            "cold_nnz": op.cold_nnz, "split_setup_ms": op.setup_ms,
            "setup_compile_s": setup_s, "k1_launches": launches,
            "timing": "graph" if dev.type == "cuda" else "host",
            **M.device_record(dev)}


def _spmm_parts_ms(op, X, dev) -> dict:
    """What op.mm does around its k launches, each timed alone: the
    column slices X[:, j] of a row-major X made contiguous (the copy each
    launch is given) and the stack of the k result columns."""
    k = X.shape[1]
    cols = [X[:, j].contiguous() for j in range(k)]
    return {"column_copies_ms": M.fn_ms(
                lambda: [X[:, j].contiguous() for j in range(k)], dev),
            "stack_ms": M.fn_ms(lambda: torch.stack(cols, dim=1), dev),
            "column_is_copied": not X[:, 0].is_contiguous()}


def _spmm_check(Y, gold) -> tuple:
    """(verified, relative error): the JAX tool's check of an SpMM result,
    max |Y - gold| below SPMM_REL_TOL of max |gold|."""
    err = float(np.max(np.abs(Y.cpu().numpy() - gold), initial=0.0))
    scale = float(np.max(np.abs(gold), initial=0.0)) + 1e-9
    ok = (tuple(Y.shape) == gold.shape and bool(torch.isfinite(Y).all())
          and err / scale < SPMM_REL_TOL)
    return ok, err / scale


def _launched(fn, dev) -> tuple:
    """fn()'s result and the K1 and K1m launches it made."""
    before = dict(K.LAUNCHES)
    out = fn()
    if dev.type == "cuda":
        torch.cuda.synchronize()
    return out, {k: K.LAUNCHES[k] - before[k]
                 for k in ("merge_tile_fused", "merge_tile_mm")}


def run_spmm(label, csr, dev, gather_rows=None) -> dict:
    """{"spmm_<label>_k<k>": entry} for k in SPMM_K, X row-major [cols, k]:
    op.mm (one K1m launch) and op.mm(method="column") (K1 once per
    column), each verified against spmm_gold, then timed in the same run
    as one CUDA graph (and eagerly); cuSPARSE SpMM on the same X; both
    again with X column-major (``colmajor_ms``: op.mm makes it row-major
    once); the SpMM bound (A read once) and the column loop's (A read k
    times); K1m alone warm and cold beside cuSPARSE in turns, against its
    plain version (``card_spmm``), and its gather bound from the row-gather
    probe (``gather_rows``: {k: tools/gather_rate.py::measure_rows' record
    for rows of k floats}, measured here when None): the rows' rate at
    this matrix's columns in their order (``gather_bound_ms``) and at
    random ones over the same X (``gather_bound_random_ms``).  The first entry also holds K1's single-column
    policy record (``card_spmv``)."""
    on_card = dev.type == "cuda"
    op = build_operator(csr, dtype="float32", device=dev)
    out = {}
    from merge_spmv_tpu_torch.tools import gather_rate as GR
    if on_card and gather_rows is None:
        rows = GR.measure_rows(op.col_indices, csr.num_cols, SPMM_K)
        gather_rows = {k: rows[str(k)] for k in SPMM_K}
    for k in SPMM_K:
        _log(f"== spmm_{label}_k{k} ==")
        X = np.random.RandomState(2).uniform(-1, 1, (csr.num_cols, k)
                                             ).astype(np.float32)
        Xd = torch.from_numpy(X).to(dev)
        gold = csr.spmm_gold(X)
        Y, launches = _launched(lambda: op.mm(Xd), dev)
        ok, rel = _spmm_check(Y, gold)
        Yc, col_launches = _launched(lambda: op.mm(Xd, method="column"),
                                     dev)
        col_ok, col_rel = _spmm_check(Yc, gold)
        del Y, Yc, gold
        ms = M.fn_ms(lambda: op.mm(Xd), dev)
        col_ms = M.fn_ms(lambda: op.mm(Xd, method="column"), dev)
        gflops = 2 * csr.num_nonzeros * k / ms / 1e6
        rec = {"rows": csr.num_rows, "nnz": csr.num_nonzeros, "k": k,
               "avg_ms": ms, "gflops": gflops, "verified": ok,
               "method": "k1m",
               "timing": "graph" if on_card else "host",
               "rel_err": rel, "k1_launches": launches["merge_tile_fused"],
               "k1m_launches": launches["merge_tile_mm"],
               "column_loop_ms": col_ms, "column_loop_verified": col_ok,
               "column_loop_rel_err": col_rel,
               "column_loop_k1_launches": col_launches["merge_tile_fused"],
               "x_layout": "row-major [cols, k], the same tensor for op.mm "
                           "and cuSPARSE (colmajor_*: X column-major)",
               **M.device_record(dev)}
        if on_card:
            lib = M.library_csr(op)
            Xc = Xd.t().contiguous().t()     # the same X, column-major
            rec.update({
                "eager_ms": M.fn_ms(lambda: op.mm(Xd), dev, graph=False),
                "column_loop_eager_ms": M.fn_ms(
                    lambda: op.mm(Xd, method="column"), dev, graph=False),
                "colmajor_ms": M.fn_ms(lambda: op.mm(Xc), dev),
                "cusparse_spmm_colmajor_ms": M.fn_ms(
                    lambda: torch.sparse.mm(lib, Xc), dev),
                "column_loop_bytes": k * M.spmv_bytes(
                    csr.num_rows, csr.num_cols, csr.num_nonzeros, 4),
                **_spmm_parts_ms(op, Xd, dev), **M.card_spmm(op, Xd)})
            rec["column_loop_bound_ms"] = M.bound_ms(
                rec["column_loop_bytes"], dev)
            g = gather_rows[k]
            rec["gather_rows"] = g
            rec["gather_rate_gbps"] = g["matrix_rate_gbps"]
            for key, rate in (("gather_bound_ms", g["matrix_rate_gbps"]),
                              ("gather_bound_random_ms",
                               g["random_rate_gbps"])):
                rec[key] = GR.rows_gather_bound_ms(
                    csr.num_nonzeros, 4 * k, rate, rec["spmm_bytes"],
                    peak_hbm_bandwidth(dev))
            if k == SPMM_K[0]:
                x1 = Xd[:, 0].contiguous()
                rec["spmv_k1"] = M.card_spmv(op, x1)
            _log(f"  op.mm {ms:.4f} ms (eager {rec['eager_ms']:.4f}, X "
                 f"column-major {rec['colmajor_ms']:.4f}) {gflops:.1f} "
                 f"GFLOP/s verified={ok}; column loop {col_ms:.4f} "
                 f"verified={col_ok}; K1m warm {rec['k1m_ms']:.4f} cold "
                 f"{rec['k1m_cold_ms']:.4f}; cuSPARSE SpMM "
                 f"{rec['cusparse_spmm_ms']:.4f} (X column-major "
                 f"{rec['cusparse_spmm_colmajor_ms']:.4f}); bound "
                 f"{rec['spmm_bound_ms']:.4f}, gather bound "
                 f"{rec['gather_bound_ms']:.4f} (column loop "
                 f"{rec['column_loop_bound_ms']:.4f})")
        else:
            _log(f"  op.mm {ms:.4f} ms, column loop {col_ms:.4f} ms on the "
                 f"CPU verified={ok and col_ok}")
        out[f"spmm_{label}_k{k}"] = rec
    return out


def _sized(n, scale):
    return max(64, int(n * scale))


def cant_csr(dtype, scale=1.0):
    return build(lambda: banded(_sized(62451, scale), 64, 400.0, 11, dtype),
                 dtype)


def pdb1hys_csr(scale=1.0):
    return build(lambda: banded(_sized(36417, scale), 119, 300.0, 14,
                                np.float32), np.float32)


def webbase_1m_csr(scale=1.0):
    return build(lambda: powerlaw_web(_sized(1_000_005, scale),
                                      _sized(3_105_536, scale), 0.85, 16384,
                                      12, np.float32), np.float32)


def wb_edu_csr(scale=1.0):
    return build(lambda: powerlaw_web(_sized(9_845_725, scale),
                                      _sized(57_156_537, scale), 0.95, 32768,
                                      13, np.float32), np.float32)


def cage15_csr(scale=1.0):
    return build(lambda: banded(_sized(5_154_859, scale), 19, 10000.0, 15,
                                np.float64), np.float64)


def kron_csr(scale=1.0):
    # 2^21 rows at full size; a scaled run takes the rows down with the nnz
    levels = 21 + min(0, round(math.log2(scale)))
    return build(lambda: rmat(max(levels, 4), _sized(182_082_942, scale), 16,
                              np.float64), np.float64)


def run(want=CONFIGS, out=None, device=None, force=False,
        scale=1.0) -> dict:
    """Run the configs in ``want`` not yet in the record at ``out`` (the
    default path for the device if None), saving after each entry;
    returns the record."""
    dev = resolve_device(device)
    path = M.record_path("BASELINE_CONFIGS", dev, out)
    results = M.load_record(path)
    if force:
        for w in want:
            for k in list(results):
                if k.startswith(PREFIXES.get(w, ())):
                    del results[k]

    def save():
        M.save_record(path, results)

    if "cant" in want and "cant_class" not in results:
        # cant: 62,451 rows, 4,007,383 nnz, FEM band, fp64 (config 1)
        _log("== cant_class (fp64 FEM band) ==")
        results["cant_class"] = run_csrmv(cant_csr(np.float64, scale),
                                          "float64", dev)
        save()

    for k in WB_KEYS:
        if k in results and results[k].get("gen") != WB_GEN:
            _log(f"(dropping stale {k}: generator version changed)")
            del results[k]
    if "webbase_pair" in want and not set(WB_KEYS) <= results.keys():
        # webbase-1M: 1,000,005 rows, 3.1M nnz; wb-edu: 9,845,725 rows,
        # 57.2M nnz: the power-law skew pair (config 2)
        if "webbase_1M_class" not in results:
            _log("== webbase_1M_class (fp32 powerlaw web) ==")
            results["webbase_1M_class"] = run_csrmv(webbase_1m_csr(scale),
                                                    "float32", dev)
            results["webbase_1M_class"]["gen"] = WB_GEN
            save()
        _log("== wb_edu_class (fp32 powerlaw web, 57M nnz) ==")
        csr = wb_edu_csr(scale)
        if "wb_edu_class" not in results:
            results["wb_edu_class"] = run_csrmv(csr, "float32", dev)
            results["wb_edu_class"]["gen"] = WB_GEN
            save()
        if "wb_edu_class_hotcold" not in results:
            _log("== wb_edu_class hot/cold split ==")
            results["wb_edu_class_hotcold"] = run_hotcold(csr, dev)
            results["wb_edu_class_hotcold"]["gen"] = WB_GEN
        del csr
        a, b = results["webbase_1M_class"], results["wb_edu_class"]
        results["webbase_pair_per_nnz_ratio"] = (
            (a["avg_ms"] / a["nnz"]) / (b["avg_ms"] / b["nnz"]))
        save()

    if "spmm" in want and "spmm_cant_k32" not in results:
        # config 3: SpMM k = 8 / 32 on the cant and pdb1HYS classes, fp32
        for label, make in (("cant", lambda: cant_csr(np.float32, scale)),
                            ("pdb1HYS", lambda: pdb1hys_csr(scale))):
            results.update(run_spmm(label, make(), dev))
            save()

    if "cage15" in want and "cage15_class" not in results:
        # cage15: 5,154,859 rows, 99,199,551 nnz, banded-ish, fp64
        _log("== cage15_class (fp64, 98M nnz banded) ==")
        results["cage15_class"] = run_csrmv(cage15_csr(scale), "float64",
                                            dev)
        save()

    if "kron" in want and "kron_g500_logn21_class" not in results:
        # kron_g500-logn21: 2,097,152 rows, 182,082,942 nnz, fp64 (config 4)
        _log("== kron_g500_logn21_class (fp64 RMAT, 182M nnz) ==")
        results["kron_g500_logn21_class"] = run_csrmv(
            kron_csr(scale), "float64", dev, gather_bound=True)
        save()
    return results


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("names", nargs="*", help=f"of {', '.join(CONFIGS)} "
                    "(default: all)")
    ap.add_argument("--force", action="store_true",
                    help="measure the named configs again")
    ap.add_argument("--cpu", action="store_true",
                    help="the kernels' plain versions on the CPU")
    ap.add_argument("--out", default=None, help="the record's path")
    ap.add_argument("--scale", type=float, default=1.0,
                    help="rows and nnz times this (tests only)")
    args = ap.parse_args(argv)
    unknown = set(args.names) - set(CONFIGS)
    if unknown:
        ap.error(f"unknown configs {sorted(unknown)}; of {CONFIGS}")
    from merge_spmv_tpu_torch.utils.hostmem import enable_warm_heap
    enable_warm_heap()   # warm-page reuse for the generators' arrays
    run(args.names or CONFIGS, out=args.out,
        device="cpu" if args.cpu else None, force=args.force,
        scale=args.scale)
    return 0


if __name__ == "__main__":
    sys.exit(main())
