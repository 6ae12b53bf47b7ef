"""What the benchmark tools (tools/bench_*.py) measure beside one result,
and where they keep it.

* ``device_record``: the card's name and ``nvidia-smi``'s name and power
  limit (or "cpu" and nulls): every record carries it.
* ``record_path``, ``load_record``, ``save_record``: each tool's JSON
  record under ``merge_spmv_tpu_torch/bench/``, ``<NAME>_h100.json`` from
  the card and ``<NAME>_cpu.json`` from ``--cpu``.  The JAX tools write
  theirs at the repository's root (the TPU's numbers); nothing here
  writes there.
* ``fn_ms``: milliseconds per call of a function, from CUDA-graph
  replays on the card (``graph=False``: eager launches), by the host clock
  on the CPU.
* ``card_spmv``: on the card, K1 alone under the gather policy the plan
  picked and under the other one, warm and with a cold L2, in turns;
  cuSPARSE (``torch.mv`` on an int32 ``sparse_csr_tensor`` of the same
  arrays) warm and cold; the bytes bound; K1's plain version's time and
  its largest difference from the kernel.
* ``card_spmm``: on the card, the multi-RHS kernel K1m alone through an
  operator's launch, warm and with a cold L2, in turns with cuSPARSE SpMM
  (``torch.sparse.mm``) warm and cold; its launches per call, geometry
  and registers; its plain version's time and largest difference, held
  within |A| |X| per column; the bytes bound.
* ``spmv_bytes`` / ``spmm_bytes``: the bytes the product must move, each
  input read once and each output written once (SpMM: A read once).
* ``fp64_bound`` / ``fp64_check``: the rounding bound a float64 result is
  held to beside compare_results, whose limits are float32's.
* ``verify_spmv``: an op(x) result against gold within spmv_abs_bound.
* ``record_faults``: what a tool's record lacks of its JAX counterpart's
  keys, and which of its entries failed.
"""

from __future__ import annotations

import json
import os
from pathlib import Path

import numpy as np
import torch

from merge_spmv_tpu_torch.ops import csrmv_cuda as K
from merge_spmv_tpu_torch.ops.csrmv_torch import row_ids_from_offsets
from merge_spmv_tpu_torch.ops.plan import POLICIES
from merge_spmv_tpu_torch.utils.compare import compare_results
from merge_spmv_tpu_torch.utils.device import (nvidia_smi_name_power,
                                               peak_hbm_bandwidth)
from merge_spmv_tpu_torch.utils.timers import event_ms, host_ms

__all__ = ["BENCH_DIR", "device_record", "record_path", "load_record",
           "save_record", "row_cov", "fn_ms", "library_csr",
           "spmv_bytes", "spmm_bytes", "bound_ms", "fp64_bound",
           "fp64_check", "card_spmv", "card_spmm", "abs_product",
           "verify_spmv", "record_faults"]

BENCH_DIR = Path(__file__).resolve().parent
# bytes written before each launch of a cold-L2 time: five times the
# H100's 50 MB L2
FLUSH_BYTES = 256 << 20


def device_record(dev) -> dict:
    """The device a record's numbers come from."""
    if dev.type != "cuda":
        return {"device": "cpu", "nvidia_smi": None}
    return {"device": torch.cuda.get_device_name(dev),
            "nvidia_smi": nvidia_smi_name_power()}


def record_path(name: str, dev, out=None) -> Path:
    """``out``, else ``bench/<name>_h100.json`` (card) or ``_cpu.json``."""
    if out:
        return Path(out)
    return BENCH_DIR / f"{name}_{'h100' if dev.type == 'cuda' else 'cpu'}.json"


def load_record(path: Path) -> dict:
    if not path.exists():
        return {}
    with open(path) as f:
        return json.load(f)


def save_record(path: Path, rec: dict):
    """Write ``rec`` as indented JSON, through a temporary file, so that a
    run cut off mid-write leaves the record before it."""
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(".tmp")
    with open(tmp, "w") as f:
        json.dump(rec, f, indent=1)
        f.write("\n")
    os.replace(tmp, path)


def row_cov(csr) -> float:
    """The row lengths' coefficient of variation (population std over
    mean), ``GraphStats.row_length_variation``, without the nonzero
    scatter statistics that ``stats()`` also computes."""
    lengths = np.diff(csr.row_offsets).astype(np.float64)
    mean = csr.num_nonzeros / csr.num_rows if csr.num_rows else 0.0
    return float(lengths.std() / mean) if mean else 0.0


def fn_ms(fn, dev, iters: int = 20, graph: bool = True) -> float:
    """Milliseconds per ``fn()``: ``event_ms`` on the card, ``host_ms``
    on the CPU."""
    if dev.type == "cuda":
        return event_ms(fn, iters=iters, graph=graph)
    return host_ms(fn)


class _Flush:
    """A buffer written before each launch of a cold-L2 time, and the
    write's own time, taken off."""

    def __init__(self, dev):
        self.buf = torch.empty(FLUSH_BYTES // 4, dtype=torch.float32,
                               device=dev)
        self.ms = event_ms(lambda: self.buf.fill_(1.0), iters=20)

    def cold_ms(self, fn, iters: int = 10) -> float:
        return event_ms(lambda: (self.buf.fill_(1.0), fn()),
                        iters=iters) - self.ms


def library_csr(op):
    """The operator's arrays as a ``sparse_csr_tensor`` with int32
    indices, for cuSPARSE (``torch.mv``, ``torch.sparse.mm``)."""
    crow = torch.cat([torch.zeros(1, dtype=torch.int32, device=op.device),
                      op.row_end_offsets])
    return torch.sparse_csr_tensor(crow, op.col_indices, op.values,
                                   size=op.shape)


def spmv_bytes(rows: int, cols: int, nnz: int, value_bytes: int) -> int:
    """y = A @ x on a CSR: a value and a column index per nonzero, a row
    end and a y element per row, x once."""
    return nnz * (value_bytes + 4) + rows * (4 + value_bytes) \
        + cols * value_bytes


def spmm_bytes(rows: int, cols: int, nnz: int, k: int,
               value_bytes: int) -> int:
    """Y = A @ X with A read once: A's arrays, X [cols, k] and Y [rows,
    k] once each."""
    return nnz * (value_bytes + 4) + rows * 4 \
        + (rows + cols) * k * value_bytes


def fp64_bound(lengths, abs_bound):
    """2 gamma_n |A| |x| per row, n the row's length: two float64 sums of
    a row's n products, in any orders, each lie within gamma_n |A| |x| of
    the exact sum (gamma_n = n u / (1 - n u), u = 2^-53), so they differ
    by at most twice that.  A float64 product summed in float32 does not
    meet it."""
    nu = np.asarray(lengths, np.float64) * 2.0 ** -53
    return 2 * nu / (1 - nu) * np.asarray(abs_bound, np.float64)


def fp64_check(y, ref, lengths, abs_bound):
    """(ok, worst): whether |y - ref| is within ``fp64_bound`` in every
    row, and the largest |y - ref| over that bound."""
    err = np.abs(np.asarray(y, np.float64) - np.asarray(ref, np.float64))
    bound = fp64_bound(lengths, abs_bound)
    with np.errstate(divide="ignore", invalid="ignore"):
        ratio = np.where(bound > 0, err / bound,
                         np.where(err > 0, np.inf, 0.0))
    return bool(np.all(err <= bound)), float(np.max(ratio, initial=0.0))


def verify_spmv(y, gold, bound) -> bool:
    """Whether op(x)'s result ``y`` has gold's shape, is finite and
    passes compare_results against ``gold`` within ``bound`` (the
    matrix's spmv_abs_bound at that x)."""
    return (tuple(y.shape) == gold.shape
            and bool(torch.isfinite(y).all())
            and compare_results(y.cpu().numpy(), gold, verbose=True,
                                abs_bound=bound) is None)


def record_faults(rec: dict, keys: dict) -> list:
    """What a tool's record lacks or failed, as "path: what" strings.

    ``keys`` maps a key of the record, or a dotted path to an entry
    ("split_sweep.16"), to the keys that entry must hold (an empty tuple
    for a value).  A path absent, or a key absent from its entry, is a
    fault, except in an entry ``{"declined": true}`` (an operator that
    found nothing to split).  Anywhere in the record, an ``error`` key is
    a fault, and so is a ``verified`` or ``*_verified`` value that is not
    true."""
    faults = []

    def walk(path, entry):
        for k, v in entry.items():
            at = f"{path}.{k}" if path else k
            if k == "error":
                faults.append(f"{at}: {v}")
            elif (k == "verified" or k.endswith("_verified")) and v is not True:
                faults.append(f"{at}: {v}")
            elif isinstance(v, dict):
                walk(at, v)

    walk("", rec)
    for path, want in keys.items():
        entry = rec
        for k in path.split("."):
            if not isinstance(entry, dict) or k not in entry:
                faults.append(f"{path}: missing")
                break
            entry = entry[k]
        else:
            if isinstance(entry, dict) and not entry.get("declined"):
                faults += [f"{path}.{k}: missing" for k in want
                           if k not in entry]
    return faults


def bound_ms(nbytes: int, dev) -> float:
    """``nbytes`` at the card's published HBM rate."""
    return nbytes / peak_hbm_bandwidth(dev) / 1e6


def card_spmv(op, x) -> dict:
    """K1 alone through ``op``'s launch (its tiles and counter) under the
    chosen gather policy and the other one, warm and with a cold L2, in
    turns (chosen, other, other, chosen; best of each), beside cuSPARSE
    on the same arrays and timers and the bytes bound; and K1's plain
    version on the same inputs (at the kernel's runs): its time, eager,
    the largest difference from the kernel's result, and whether the two
    agree by compare_results within the backward-error bound |A| |x| and,
    in float64, within ``fp64_bound`` (``plain_err_over_fp64_bound``)."""
    plan, dev = op.plan, op.device
    args = (op.values, op.col_indices, op.row_end_offsets, x, op.tile_rows,
            op.tile_nnz, plan.tile_items)
    chosen = plan.policy
    other = next(p for p in POLICIES if p != chosen)
    flush = _Flush(dev)
    warm = {chosen: [], other: []}
    cold = {chosen: [], other: []}
    for p in (chosen, other, other, chosen):
        def launch(p=p):
            return K.merge_csrmv(*args, tickets=op.tickets, policy=p)
        warm[p].append(event_ms(launch, iters=20))
        cold[p].append(flush.cold_ms(launch))
    run = K.launch_geometry(plan.num_tiles, plan.tile_items,
                            op.values.dtype, dev, fused=True,
                            policy=chosen).run_tiles
    y = K.merge_csrmv(*args, tickets=op.tickets, policy=chosen)
    y_plain = K.merge_csrmv_plain(*args, run_tiles=run)
    plain_err = float((y - y_plain).abs().max()) if y.numel() else 0.0
    # |A| |x|, the scale of the two versions' rounding
    rows = row_ids_from_offsets(op.row_end_offsets, plan.num_nonzeros)
    scale = torch.zeros(plan.num_rows, dtype=torch.float64, device=dev)
    scale.index_add_(0, rows, op.values.abs().double()
                     * x.abs().double()[op.col_indices.long()])
    y, y_plain, scale = y.cpu().numpy(), y_plain.cpu().numpy(), \
        scale.cpu().numpy()
    plain_ok = compare_results(y, y_plain, verbose=False,
                               abs_bound=scale) is None
    fp64 = {}
    if op.values.dtype == torch.float64:
        lengths = np.diff(op.row_end_offsets.cpu().numpy(), prepend=0)
        ok64, worst = fp64_check(y, y_plain, lengths, scale)
        plain_ok = plain_ok and ok64
        fp64 = {"plain_err_over_fp64_bound": worst}
    del y, y_plain, rows, scale
    plain_ms = event_ms(lambda: K.merge_csrmv_plain(*args, run_tiles=run),
                        iters=1, reps=2, warmup=1, graph=False)
    lib = library_csr(op)
    xl = x.to(lib.dtype)
    nbytes = spmv_bytes(plan.num_rows, plan.num_cols, plan.num_nonzeros,
                        op.values.element_size())
    return {"policy": chosen, "tile_items": plan.tile_items,
            "k1_ms": {p: min(v) for p, v in warm.items()},
            "k1_cold_ms": {p: min(v) for p, v in cold.items()},
            "cusparse_ms": event_ms(lambda: torch.mv(lib, xl), iters=20),
            "cusparse_cold_ms": flush.cold_ms(lambda: torch.mv(lib, xl)),
            "bytes": nbytes, "bytes_bound_ms": bound_ms(nbytes, dev),
            "plain_ms": plain_ms, "plain_max_abs_err": plain_err,
            "plain_ok": plain_ok, **fp64}


def abs_product(op, X):
    """|A| |X| on the operator's device in float64: the scale of two
    summation orders' rounding, per element of A @ X."""
    plan = op.plan
    rows = row_ids_from_offsets(op.row_end_offsets, plan.num_nonzeros)
    scale = torch.zeros(plan.num_rows, X.shape[1], dtype=torch.float64,
                        device=X.device)
    return scale.index_add_(0, rows, op.values.abs().double()[:, None]
                            * X.abs().double()[op.col_indices.long()])


def card_spmm(op, X) -> dict:
    """K1m alone through ``op``'s launch (its tiles and counter) on X
    [num_cols, k], warm and with a cold L2, in turns with cuSPARSE SpMM on
    the same X (K1m, cuSPARSE, cuSPARSE, K1m; best of each); the launches
    one call makes; the launch (grid, runs, chunk, layout, registers and
    blocks per SM); K1m's plain version at the kernel's runs: its time
    (eager), its largest difference from the kernel and whether the two
    agree by compare_results within |A| |X| in every column; the bytes
    bound (A, X and Y once)."""
    plan, dev = op.plan, op.device
    k = X.shape[1]
    args = (op.values, op.col_indices, op.row_end_offsets, X, op.tile_rows,
            op.tile_nnz, plan.tile_items)

    def launch():
        return K.merge_csrmm(*args, tickets=op.tickets)
    lib = library_csr(op)
    flush = _Flush(dev)
    times = {"k1m": ([], []), "cusparse": ([], [])}
    for name in ("k1m", "cusparse", "cusparse", "k1m"):
        fn = launch if name == "k1m" else (lambda: torch.sparse.mm(lib, X))
        times[name][0].append(event_ms(fn, iters=20))
        times[name][1].append(flush.cold_ms(fn))
    before = K.LAUNCHES["merge_tile_mm"]
    Y = launch()
    torch.cuda.synchronize()
    launches = K.LAUNCHES["merge_tile_mm"] - before
    kw = min(k, K.MM_MAX_K)
    geo = K.mm_launch_geometry(plan.num_tiles, plan.tile_items,
                               op.values.dtype, dev, kw)
    blocks, regs = K.mm_kernel_occupancy(op.values.dtype, plan.tile_items,
                                         kw, dev)
    Y_plain = K.merge_csrmm_plain(*args, run_tiles=geo.run_tiles)
    err = float((Y - Y_plain).abs().max()) if Y.numel() else 0.0
    scale = abs_product(op, X).cpu().numpy()
    y, yp = Y.cpu().numpy(), Y_plain.cpu().numpy()
    ok = all(compare_results(y[:, c], yp[:, c], verbose=False,
                             abs_bound=scale[:, c]) is None
             for c in range(k))
    del Y, Y_plain, y, yp, scale
    plain_ms = event_ms(lambda: K.merge_csrmm_plain(
        *args, run_tiles=geo.run_tiles), iters=1, reps=2, warmup=1,
        graph=False)
    nbytes = spmm_bytes(plan.num_rows, plan.num_cols, plan.num_nonzeros, k,
                        op.values.element_size())
    lay = geo.layout
    return {"k1m_ms": min(times["k1m"][0]),
            "k1m_cold_ms": min(times["k1m"][1]),
            "cusparse_spmm_ms": min(times["cusparse"][0]),
            "cusparse_spmm_cold_ms": min(times["cusparse"][1]),
            "k1m_launches": launches,
            "k1m_launch": {"grid": geo.grid, "run_tiles": geo.run_tiles,
                           "chunk_items": geo.chunk_items,
                           "threads": geo.threads,
                           "shared_bytes": geo.shared_bytes,
                           "blocks_per_sm": blocks, "registers": regs,
                           "layout": [lay.per, lay.vector, lay.lanes],
                           "batch_rows": geo.batch_rows,
                           "carveout": geo.carveout},
            "k1m_plain_ms": plain_ms, "k1m_plain_max_abs_err": err,
            "k1m_plain_ok": ok, "spmm_bytes": nbytes,
            "spmm_bound_ms": bound_ms(nbytes, dev)}
