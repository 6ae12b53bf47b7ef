"""Headline benchmark of the port: prints ONE JSON line.

    python -m merge_spmv_tpu_torch.bench.headline            # on the card
    python -m merge_spmv_tpu_torch.bench.headline --cpu --grid 8 \\
        --skew-rows 1024 --circuit-rows 2000 --circuit-nnz 20000

Counterpart of bench.py:85-270, with the keys of its JSON line
(``HEADLINE_KEYS``), measured on the card:

* the merge headline: GFLOP/s (2 nnz / time) of op(x) on the grid3d(100)
  Laplacian (1M rows, 5.94M nonzeros, float32), its effective GB/s by the
  reference byte model (cpu_spmv.cpp:508-509) and its share of the HBM
  peak, where the peak is the larger of the data sheet's and the measured
  STREAM triad (utils/device.py::measure_stream_bandwidth);
* the DIA operator on the same matrix (``dia_*``);
* the skew pairs at 2^19 rows: uniform against power-law row lengths
  sharing one column stream (the controlled ratio), and the power-law
  half with its columns drawn around its own rows (the natural ratio);
* the circuit5M class at quarter scale (bench/matrices.py::
  make_circuit_like) and ``vs_baseline``: the K40's 6.92 ms on 56.7M
  nonzeros (README.md:138 of the reference), per nonzero, over this
  card's time per nonzero on that class.

Every matrix is verified against the gold SpMV before it is timed, and
every time is ``utils/timers.py::chained_rate_ms`` (CUDA-graph replay of
a chain of dependent op(x) calls).  Unlike bench.py no phase is caught:
any failure raises and the process exits non-zero.  ``--cpu`` (or
``run(device="cpu")``) runs the kernels' plain versions and times them by
the host clock, at whatever size is given: its numbers are the CPU's,
and the device keys (``stream_gbps``, ``pct_peak``, ``dia_pct_peak``) are
null there.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from merge_spmv_tpu_torch.bench.matrices import make_circuit_like
from merge_spmv_tpu_torch.formats.coo import CooMatrix
from merge_spmv_tpu_torch.formats.csr import CsrMatrix
from merge_spmv_tpu_torch.ops.dia import build_dia_operator
from merge_spmv_tpu_torch.ops.operator import build_operator
from merge_spmv_tpu_torch.utils.compare import compare_results
from merge_spmv_tpu_torch.utils.device import (device_info,
                                               measure_stream_bandwidth,
                                               resolve_device)
from merge_spmv_tpu_torch.utils.timers import op_rate_ms

__all__ = ["HEADLINE_KEYS", "run", "main"]

# the keys of bench.py's JSON line (BENCH_r05.json's "parsed")
HEADLINE_KEYS = (
    "metric", "value", "unit", "vs_baseline", "kernel_ms", "effective_gbps",
    "pct_peak", "stream_gbps", "device_kind", "backend",
    "dia_grid3d100_ms", "dia_grid3d100_gflops", "dia_byte_model",
    "dia_grid3d100_actual_gbps", "dia_pct_peak", "dia_verified",
    "dia_setup_ms",
    "skew_powerlaw_over_uniform_per_nnz", "skew_uniform_ms",
    "skew_powerlaw_ms", "skew_control",
    "skew_powerlaw_over_uniform_per_nnz_natural", "skew_powerlaw_natural_ms",
    "circuit_class_quarter_ms", "circuit_class_quarter_backend",
    "circuit_class_quarter_nnz")

# the reference's GPU merge CsrMV on circuit5M: 6.92 ms over 56.7M nonzeros
K40_MS_PER_MNNZ = 6.92 / 56.7
CIRCUIT_QUARTER = (1_389_581, 14_881_072)   # bench.py:245


def _verified(op, csr, dev, what):
    """op(ones) against the gold SpMV; raises on a mismatch."""
    ones = np.ones(csr.num_cols, np.float32)
    y = op(torch.from_numpy(ones).to(dev))
    idx = compare_results(y.cpu().numpy(), csr.spmv_gold(ones),
                          verbose=False, abs_bound=csr.spmv_abs_bound(ones))
    if idx is not None:
        raise RuntimeError(f"{what}: verification failed at row {idx}")
    return torch.ones(csr.num_cols, dtype=torch.float32, device=dev)


def _bench_csr(csr, dev):
    """Verify op(x) against gold, then time it: (ms, backend)."""
    op = build_operator(csr, dtype="float32", device=dev)
    x = _verified(op, csr, dev, "merge")
    return op_rate_ms(op, x), op.plan.backend


def run(device=None, grid_width: int = 100, skew_rows: int = 1 << 19,
        circuit=CIRCUIT_QUARTER) -> dict:
    """The headline measurements as one dict of ``HEADLINE_KEYS`` (plus
    ``nvidia_smi`` on the card).  ``device=None`` means the card."""
    dev = resolve_device(device)
    on_card = dev.type == "cuda"
    rs = np.random.RandomState(0)

    # 1. headline: grid3d (uniform banded best case)
    csr = CsrMatrix.from_coo(CooMatrix.grid3d(grid_width)).astype(np.float32)
    csr.values = rs.uniform(0.5, 1.5, csr.num_nonzeros).astype(np.float32)
    n, nnz = csr.num_rows, csr.num_nonzeros
    avg_ms, backend = _bench_csr(csr, dev)
    gbps = (nnz * 12 + n * 8) / avg_ms / 1e6
    stream_gbps = peak = None
    out = {}
    if on_card:
        info = device_info(dev)
        stream_gbps = measure_stream_bandwidth(device=dev)
        peak = max(info["peak_hbm_gbps"], stream_gbps)
        out["nvidia_smi"] = info["nvidia_smi"]
    out.update({
        "metric": f"grid3d{grid_width}_merge_csrmv_fp32_gflops",
        "value": 2 * nnz / avg_ms / 1e6,
        "unit": "GFLOP/s",
        "vs_baseline": None,   # from the circuit-class run below
        "kernel_ms": avg_ms,
        "effective_gbps": gbps,
        "pct_peak": None if peak is None else 100.0 * gbps / peak,
        "stream_gbps": stream_gbps,
        "device_kind": torch.cuda.get_device_name(dev) if on_card else "cpu",
        "backend": backend,
    })

    # 1b. the DIA operator on the same stencil
    dop = build_dia_operator(csr, dtype="float32", device=dev)
    if dop.vtab is None or dop.rest_op is not None:
        raise RuntimeError(f"grid3d({grid_width}) did not split into pure "
                           f"diagonals: {dop.describe()}")
    xd = _verified(dop, csr, dev, "dia")
    ms_d = op_rate_ms(dop, xd)
    # DIA reads no indices: its bytes are the (D, m) table, x and y.  A
    # rate above the peak means the table stayed in cache across the
    # chain: then the steady-state model (x and y only), as bench.py says
    dia_gbps = (dop.vtab.numel() + 2 * n) * 4 / ms_d / 1e6
    model = "hbm_all_bytes"
    if peak is not None and dia_gbps > peak:
        dia_gbps = 2 * n * 4 / ms_d / 1e6
        model = "steady_state_table_resident"
    out.update({
        "dia_grid3d100_ms": ms_d,
        "dia_grid3d100_gflops": 2 * nnz / ms_d / 1e6,
        "dia_byte_model": model,
        "dia_grid3d100_actual_gbps": dia_gbps,
        "dia_pct_peak": None if peak is None else 100.0 * dia_gbps / peak,
        "dia_verified": True,
        "dia_setup_ms": dop.setup_ms,
    })
    del dop, csr

    # 2. skew pairs (bench.py:179-236): one column stream shared by the
    # uniform and the power-law halves (controlled), then the power-law
    # half with its columns drawn around its own rows (natural)
    nk, deg = skew_rows, 8
    nnz_k = nk * deg
    centers = (np.arange(nnz_k, dtype=np.int64) * nk) // nnz_k
    cols = np.clip(centers + rs.randint(-2048, 2048, nnz_k), 0, nk - 1)
    vals = np.ones(nnz_k, np.float32)
    rows_u = np.repeat(np.arange(nk, dtype=np.int64), deg)
    csr_u = CsrMatrix.from_coo(CooMatrix(nk, nk, rows_u, cols, vals)
                               ).astype(np.float32)
    ms_u, _ = _bench_csr(csr_u, dev)
    del csr_u, rows_u
    raw = rs.pareto(1.6, nk) + 1.0
    degs = np.maximum(1, (raw * (nnz_k / raw.sum())).astype(np.int64))
    # equal nnz, so the per-nnz ratio is the plain ms ratio
    diff = int(nnz_k - degs.sum())
    if diff > 0:
        degs[np.argsort(-degs)[:diff]] += 1
    elif diff < 0:
        shrinkable = np.flatnonzero(degs > 1)
        degs[shrinkable[np.argsort(-degs[shrinkable])[:-diff]]] -= 1
    rows_p = np.repeat(np.arange(nk, dtype=np.int64), degs)
    csr_p = CsrMatrix.from_coo(CooMatrix(nk, nk, rows_p, cols, vals)
                               ).astype(np.float32)
    if csr_p.num_nonzeros != nnz_k:
        raise RuntimeError("the skew pair's halves differ in nnz")
    ms_p, _ = _bench_csr(csr_p, dev)
    del csr_p
    cols_nat = np.clip(rows_p + rs.randint(-2048, 2048, nnz_k), 0, nk - 1)
    csr_pn = CsrMatrix.from_coo(CooMatrix(nk, nk, rows_p, cols_nat, vals)
                                ).astype(np.float32)
    ms_pn, _ = _bench_csr(csr_pn, dev)
    del csr_pn, rows_p, cols, cols_nat
    out.update({
        "skew_powerlaw_over_uniform_per_nnz": ms_u / ms_p,
        "skew_uniform_ms": ms_u,
        "skew_powerlaw_ms": ms_p,
        "skew_control": "shared_column_stream",
        "skew_powerlaw_over_uniform_per_nnz_natural": ms_u / ms_pn,
        "skew_powerlaw_natural_ms": ms_pn,
    })

    # 3. the circuit5M class at quarter scale
    nq, nnzq = circuit
    r_, c_, v_ = make_circuit_like(nq, nnzq)
    csr_c = CsrMatrix.from_coo(CooMatrix(nq, nq, r_, c_, v_)
                               ).astype(np.float32)
    del r_, c_, v_
    ms_c, backend_c = _bench_csr(csr_c, dev)
    out.update({
        "circuit_class_quarter_ms": ms_c,
        "circuit_class_quarter_backend": backend_c,
        "circuit_class_quarter_nnz": csr_c.num_nonzeros,
        "vs_baseline": K40_MS_PER_MNNZ / (ms_c / (csr_c.num_nonzeros / 1e6)),
    })
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cpu", action="store_true",
                    help="the kernels' plain versions on the CPU")
    ap.add_argument("--grid", type=int, default=100)
    ap.add_argument("--skew-rows", type=int, default=1 << 19)
    ap.add_argument("--circuit-rows", type=int, default=CIRCUIT_QUARTER[0])
    ap.add_argument("--circuit-nnz", type=int, default=CIRCUIT_QUARTER[1])
    args = ap.parse_args(argv)
    out = run(device="cpu" if args.cpu else None, grid_width=args.grid,
              skew_rows=args.skew_rows,
              circuit=(args.circuit_rows, args.circuit_nnz))
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
