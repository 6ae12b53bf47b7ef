"""Benchmark driver on the card — counterpart of merge_spmv_tpu/bench/driver.py
(the reference drivers cpu_spmv.cpp:537-747, gpu_spmv.cu:484-741).

Per run: generate or ingest → CSR + stats + histogram → gold SpMV → for each
backend: one verification call through the public ``op(x, y_in, alpha,
beta)`` (PASS/FAIL against gold with the ``spmv_abs_bound`` backward-error
bound), then timed calls, and a perf line with GFLOP/s, effective GB/s and
% of the card's HBM peak.  ``--quiet`` switches to CSV fragments: the
statistics, one five-field group per backend, then ``merge_policy=<p>``
and ``k1_launches=<n>`` (the merge backend's) and, where a backend failed
verification, ``FAIL=<backends>``.

Backends:
  merge   — the merge-path CUDA kernels (ops/operator.py); ``--autotune``
            takes the autotuner's tile size (ops/autotune.py)
  dia     — the DIA kernel plus the merge kernels for the leftover
            (ops/dia.py)
  split   — the banded split, one stacked merge-kernel launch plus a
            reshape-sum (ops/split.py): ``--split=<n>`` gives n quantile
            bands, else the geometric (8, 32) edges
  hotcold — the hot/cold column split, two merge-kernel launches
            (ops/split.py)
  xla     — the device library baseline: cuSPARSE through ``torch.mv`` on a
            ``sparse_csr_tensor`` with int32 indices (the JAX package's
            XLA segment sum has the same role)
  scipy   — SciPy csr_matrix @ x on the host (MKL-analog baseline)
  torch   — torch.sparse.csr on the host (second vendor baseline)

Device times are CUDA-graph replays of a chain of dependent calls
(utils/timers.py::chained_rate_ms); with alpha/beta set every timed call
carries the full epilogue.  ``args["device"] == "cpu"`` runs the kernels'
plain versions and times them with the host clock.
"""

from __future__ import annotations

import os
import sys
import warnings

import numpy as np
import torch

from merge_spmv_tpu_torch.formats.coo import CooMatrix
from merge_spmv_tpu_torch.formats.csr import CsrMatrix
from merge_spmv_tpu_torch.ops import csrmv_cuda
from merge_spmv_tpu_torch.ops.dia import build_dia_operator
from merge_spmv_tpu_torch.ops.operator import build_operator
from merge_spmv_tpu_torch.ops.split import (build_hotcold_operator,
                                            build_split_operator)
from merge_spmv_tpu_torch.utils.compare import compare_results
from merge_spmv_tpu_torch.utils.device import (device_info,
                                               resolve_device, torch_dtype)
from merge_spmv_tpu_torch.utils.timers import (Timer,
                                               adaptive_timing_iterations,
                                               chained_rate_ms, event_ms)

__all__ = ["build_matrix", "run_benchmark", "display_perf", "BackendResult"]

DEVICE_BACKENDS = ("merge", "xla", "split", "hotcold", "dia")


class BackendResult:
    def __init__(self, name, avg_ms, setup_ms, verified, error_index=None,
                 policy=None):
        self.name = name
        self.avg_ms = avg_ms
        self.setup_ms = setup_ms
        self.verified = verified
        self.error_index = error_index
        self.policy = policy   # the merge plan's gather policy


def build_matrix(args) -> CsrMatrix:
    """Matrix selection mirroring RunTests (cpu_spmv.cpp:550-593)."""
    if args.get("mtx"):
        coo = CooMatrix.from_market(args["mtx"], default_value=1.0)
        if coo.num_rows == 1 or coo.num_cols == 1 or coo.num_nonzeros == 1:
            if not args.get("quiet"):
                print("Trivial dataset")
            sys.exit(0)
        label = os.path.splitext(os.path.basename(args["mtx"]))[0]
    elif args.get("grid2d"):
        coo = CooMatrix.grid2d(args["grid2d"], self_loop=False)
        label = f"grid2d_{args['grid2d']}"
    elif args.get("grid3d"):
        coo = CooMatrix.grid3d(args["grid3d"], self_loop=False)
        label = f"grid3d_{args['grid3d']}"
    elif args.get("wheel"):
        coo = CooMatrix.wheel(args["wheel"])
        label = f"wheel_{args['wheel']}"
    elif args.get("dense"):
        cols = args["dense"]
        rows = (1 << 24) // cols          # 16M nnz (cpu_spmv.cpp:584)
        coo = CooMatrix.dense(rows, cols)
        label = f"dense_{rows}_x_{cols}"
    elif args.get("powerlaw"):
        n = args["powerlaw"]
        coo = CooMatrix.random_powerlaw(n, n, 16 * n, seed=args.get("seed", 0))
        label = f"powerlaw_{n}"
    elif args.get("uniform"):
        n = args["uniform"]
        coo = CooMatrix.random_uniform(n, n, 16, seed=args.get("seed", 0))
        label = f"uniform_{n}"
    else:
        print("No graph type specified (--mtx/--grid2d/--grid3d/--wheel/"
              "--dense/--powerlaw/--uniform).", file=sys.stderr)
        sys.exit(1)
    print(f"{label}, ", end="", flush=True)
    return CsrMatrix.from_coo(coo)


def display_perf(name, setup_ms, avg_ms, csr, value_bytes, quiet=False,
                 peak_gbps=None, num_rhs=1):
    """Perf line (cpu_spmv.cpp:502-528 byte/flop model, RHS-scaled)."""
    total_bytes = (csr.num_nonzeros * (value_bytes * (1 + num_rhs) + 4)
                   + csr.num_rows * (4 + value_bytes * num_rhs))
    gflops = 2 * num_rhs * csr.num_nonzeros / avg_ms / 1e6
    gbps = total_bytes / avg_ms / 1e6
    if quiet:
        print(f"{setup_ms:.5f}, {avg_ms:.5f}, {gflops:.6f}, {gbps:.3f}, ",
              end="", flush=True)
    else:
        pct = f", {100.0 * gbps / peak_gbps:.2f}% peak" if peak_gbps else ""
        print(f"fp{value_bytes * 8}: {setup_ms:.4f} setup ms, "
              f"{avg_ms:.4f} avg ms, {gflops:.5f} gflops, "
              f"{gbps:.3f} effective GB/s{pct}", flush=True)
    return {"gflops": gflops, "gbps": gbps, "avg_ms": avg_ms}


def _verify(name, y, gold, quiet, abs_bound=None):
    if torch.is_tensor(y):
        y = y.cpu().numpy()
    idx = compare_results(np.asarray(y), gold, verbose=not quiet,
                          abs_bound=abs_bound)
    if not quiet:
        print(f"\t{'FAIL' if idx is not None else 'PASS'}", flush=True)
    return idx


class _LibrarySpmv:
    """The device library baseline: ``torch.mv`` on a sparse CSR tensor
    with the matrix's int32 indices (cuSPARSE on the card), with the
    epilogue as separate tensor operations.  A yardstick: the port's
    operators never call it."""

    def __init__(self, csr: CsrMatrix, dtype, device):
        with warnings.catch_warnings():   # "beta state", invariant checks
            warnings.simplefilter("ignore", UserWarning)
            self.matrix = torch.sparse_csr_tensor(
                torch.from_numpy(np.ascontiguousarray(csr.row_offsets,
                                                      dtype=np.int32)),
                torch.from_numpy(np.ascontiguousarray(csr.col_indices,
                                                      dtype=np.int32)),
                torch.from_numpy(np.ascontiguousarray(csr.values)).to(dtype),
                size=(csr.num_rows, csr.num_cols)).to(device)

    def __call__(self, x, y_in=None, alpha=1.0, beta=0.0):
        y = torch.mv(self.matrix, x)
        if alpha != 1.0:
            y = alpha * y
        if y_in is not None:
            y = y + beta * y_in
        return y


def _bench_device_backend(backend, csr, x, gold, args, abs_bound=None):
    """Verify + time a device backend through its public call."""
    dev = resolve_device(args.get("device"))
    quiet = args.get("quiet", False)
    dtype = torch_dtype(csr.values.dtype)
    xd = torch.from_numpy(x).to(dev)
    alpha = args.get("alpha", 1.0)
    beta = args.get("beta", 0.0)
    y_in = torch.ones(csr.num_rows, dtype=dtype, device=dev) if beta else None

    # setup is the analog of the reference's "setup" column (HYB
    # conversion, gpu_spmv.cu:129): the build (plan, copy to the device,
    # tile search or diagonal table), then the first call, which loads
    # the kernel library (built by nvcc once per source and process)
    prep_t = Timer().start()
    if backend == "split":
        nb = args.get("split")
        quantile = isinstance(nb, int) and nb > 1
        op = build_split_operator(
            csr, dtype=csr.values.dtype,
            edges_chunks="quantile" if quantile else (8, 32),
            num_bands=nb if quantile else 5,
            tile_items=args.get("tile_items"), device=dev)
        if not quiet:
            print(f"({op.describe()}) ", end="", flush=True)
    elif backend == "hotcold":
        op = build_hotcold_operator(csr, dtype=csr.values.dtype,
                                    tile_items=args.get("tile_items"),
                                    device=dev)
        if not quiet:
            print(f"({op.describe()}) ", end="", flush=True)
    elif backend == "dia":
        op = build_dia_operator(csr, dtype=csr.values.dtype,
                                tile_items=args.get("tile_items"),
                                device=dev)
        if not quiet:
            print(f"({op.describe()}) ", end="", flush=True)
    elif backend == "merge":
        op = build_operator(csr, dtype=csr.values.dtype,
                            tile_items=args.get("tile_items"),
                            autotune=bool(args.get("autotune")),
                            gather_group=args.get("gather_group", 1),
                            gather_cluster=bool(
                                args.get("gather_cluster", False)),
                            device=dev)
    else:
        op = _LibrarySpmv(csr, dtype, dev)
    prep_t.stop()
    first_t = Timer().start()
    y = op(xd, y_in=y_in, alpha=alpha, beta=beta)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    first_t.stop()
    if not quiet:
        br = getattr(op, "setup_s", None)
        br_s = ("" if not br else
                " (plan {plan:.2f}s prepare {prepare:.2f}s)".format(**br))
        print(f"[prep {prep_t.elapsed_millis():.0f} ms{br_s}, first-call "
              f"{first_t.elapsed_millis():.0f} ms] ", end="", flush=True)
    setup_ms = prep_t.elapsed_millis() + first_t.elapsed_millis()

    idx = _verify(backend, y, gold, quiet, abs_bound)

    iters = args.get("i") or adaptive_timing_iterations(
        csr.num_nonzeros, max_iterations=args.get("max_iters", 2000))
    if dev.type != "cuda":
        t = Timer().start()
        for _ in range(iters):
            op(xd, y_in=y_in, alpha=alpha, beta=beta)
        t.stop()
        avg_ms = t.elapsed_millis() / iters
    elif backend == "xla":
        avg_ms = event_ms(lambda: op(xd, y_in=y_in, alpha=alpha, beta=beta),
                          iters=max(16, min(iters, 256)))
    else:
        avg_ms = chained_rate_ms(op, xd, n=max(16, min(iters, 256)),
                                 y_in=y_in, beta=beta)
    policy = op.plan.policy if backend == "merge" else None
    return BackendResult(backend, avg_ms, setup_ms, idx is None, idx, policy)


def _bench_scipy(csr, x, gold, args, abs_bound=None):
    try:
        import scipy.sparse as sp
    except ImportError:
        return None
    quiet = args.get("quiet", False)
    t = Timer().start()
    m = sp.csr_matrix((csr.values, csr.col_indices, csr.row_offsets),
                      shape=(csr.num_rows, csr.num_cols))
    t.stop()
    alpha, beta = args.get("alpha", 1.0), args.get("beta", 0.0)
    y_in = np.ones(csr.num_rows, csr.values.dtype) if beta else None

    def spmv():
        # full epilogue timed, as the device backends time it
        y = m @ x
        if alpha != 1.0:
            y = alpha * y
        if beta:
            y = y + beta * y_in
        return y

    y = spmv()
    idx = _verify("scipy", y, gold, quiet, abs_bound)
    iters = min(args.get("i") or adaptive_timing_iterations(
        csr.num_nonzeros, max_iterations=200), 200)
    tm = Timer().start()
    for _ in range(iters):
        y = spmv()
    tm.stop()
    return BackendResult("scipy", tm.elapsed_millis() / iters,
                         t.elapsed_millis(), idx is None, idx)


def _bench_torch(csr, x, gold, args, abs_bound=None):
    quiet = args.get("quiet", False)
    t = Timer().start()
    m = torch.sparse_csr_tensor(
        torch.from_numpy(np.ascontiguousarray(csr.row_offsets, dtype=np.int64)),
        torch.from_numpy(np.ascontiguousarray(csr.col_indices, dtype=np.int64)),
        torch.from_numpy(np.ascontiguousarray(csr.values)),
        size=(csr.num_rows, csr.num_cols))
    xt = torch.from_numpy(np.ascontiguousarray(x))
    t.stop()
    alpha, beta = args.get("alpha", 1.0), args.get("beta", 0.0)
    y_in_t = (torch.ones(csr.num_rows, dtype=xt.dtype) if beta else None)

    def spmv():
        # full epilogue timed, matching the device backends
        y = m @ xt
        if alpha != 1.0:
            y = alpha * y
        if beta:
            y = y + beta * y_in_t
        return y

    y = spmv().numpy()
    idx = _verify("torch", y, gold, quiet, abs_bound)
    iters = min(args.get("i") or adaptive_timing_iterations(
        csr.num_nonzeros, max_iterations=200), 200)
    tm = Timer().start()
    for _ in range(iters):
        y = spmv()
    tm.stop()
    return BackendResult("torch", tm.elapsed_millis() / iters,
                         t.elapsed_millis(), idx is None, idx)


def run_benchmark(args) -> dict:
    """Full benchmark flow; returns {backend: perf dict}.  Runs on the card
    unless ``args["device"] == "cpu"``; raises without a card otherwise."""
    quiet = args.get("quiet", False)
    dev = resolve_device(args.get("device"))
    fp64 = not args.get("fp32", True)
    dtype = np.float64 if fp64 else np.float32
    vb = 8 if fp64 else 4

    csr = build_matrix(args).astype(dtype)
    stats = csr.stats()
    stats.display(show_labels=not quiet,
                  out=(lambda s: print(s, end="" if quiet else "\n", flush=True)))
    peak = None
    if dev.type == "cuda":
        info = device_info(dev)
        peak = info["peak_hbm_gbps"]
    if not quiet:
        print()
        csr.display_histogram()
        print()
        if args.get("v2"):
            csr.display()
        if dev.type == "cuda":
            print(f"device: {info['device_kind']} ({info['nvidia_smi']}; "
                  f"peak {peak} GB/s)\n")
        else:
            print("device: cpu (the kernels' plain versions)\n")

    # vectors (ones, matching RunTests cpu_spmv.cpp:637-641); --beta
    # exercises the full y = alpha*A*x + beta*y_in epilogue
    x = np.ones(csr.num_cols, dtype=dtype)
    beta = args.get("beta", 0.0)
    y_in = np.ones(csr.num_rows, dtype=dtype) if beta else None
    gold = csr.spmv_gold(x, y_in, alpha=args.get("alpha", 1.0), beta=beta)
    abs_bound = csr.spmv_abs_bound(x, y_in, alpha=args.get("alpha", 1.0),
                                   beta=beta)

    results = {}
    backends = args.get("backends") or ["scipy", "xla", "merge"]
    on_card = dev.type == "cuda"
    for backend in backends:
        if not quiet:
            print(f"\n{_display_name(backend, on_card)}, ", end="", flush=True)
        else:
            print(f"{_display_name(backend, on_card)}, ", end="", flush=True)
        k1_before = csrmv_cuda.LAUNCHES["merge_tile_fused"]
        if backend in DEVICE_BACKENDS:
            r = _bench_device_backend(backend, csr, x, gold, args, abs_bound)
        elif backend == "scipy":
            r = _bench_scipy(csr, x, gold, args, abs_bound)
        elif backend == "torch":
            r = _bench_torch(csr, x, gold, args, abs_bound)
        else:
            print(f"unknown backend {backend}", file=sys.stderr)
            continue
        if r is None:
            continue
        results[backend] = display_perf(
            backend, r.setup_ms, r.avg_ms, csr, vb, quiet=quiet,
            peak_gbps=peak if backend in DEVICE_BACKENDS else None)
        results[backend]["verified"] = r.verified
        if r.policy is not None:
            results[backend]["policy"] = r.policy
        if backend == "merge":
            # the fused tile kernel's launches by its wrapper: each call,
            # those captured into a CUDA graph included; replays launch
            # without the wrapper
            results[backend]["k1_launches"] = (
                csrmv_cuda.LAUNCHES["merge_tile_fused"] - k1_before)
    if quiet:
        # trailing fields, fewer than a backend group's five, so a reader
        # of the groups passes over them: the merge plan's gather policy,
        # its K1 launches and the backends whose result failed
        # verification
        if "merge" in results:
            m = results["merge"]
            print(f"merge_policy={m['policy']}, "
                  f"k1_launches={m['k1_launches']}, ", end="")
        failed = [b for b, r in results.items() if not r["verified"]]
        if failed:
            print(f"FAIL={'+'.join(failed)}, ", end="")
    print()
    return results


def _display_name(backend, on_card: bool = True):
    names = {"merge": "Merge CsrMV (CUDA)", "xla": "cuSPARSE CsrMV",
             "scipy": "SciPy CsrMV", "torch": "Torch CsrMV",
             "split": "Banded-split CsrMV (stacked)",
             "hotcold": "Hot/cold-split CsrMV",
             "dia": "DIA-split CsrMV (CUDA)"}
    if not on_card:
        # no commas: the names are fields of --quiet's CSV rows
        names.update({"merge": "Merge CsrMV (plain on CPU)",
                      "xla": "torch.sparse CsrMV (CPU)",
                      "split": "Banded-split CsrMV (stacked; plain on CPU)",
                      "hotcold": "Hot/cold-split CsrMV (plain on CPU)",
                      "dia": "DIA-split CsrMV (plain on CPU)"})
    return names.get(backend, backend)
