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
``prepared``: the prepared operator, on the split path, called twice,
bitwise equal, and held against the unsplit order within the backward
error bound; else the one-shot call; optional ``allow_halo_x``,
``evidence``).  The rank writes its window to ``y_<rank>.npy`` there, for
the caller to assemble with ``materialize_y``.  Each case's report holds
the rank's K1 launches (``k1_launches``: 0 on the CPU, where K1's plain
version runs); a prepared case's also its launches and collectives in one
call (``k1_per_call``, ``collectives_per_call``), its boundary items and
its operators' gather policies, and ``prepare_s``: partition, build and
first call.  ``--time`` adds to each case's report, by the host clock over
``calls`` calls (case.json, default 20) that every rank makes together:
the split call, the unsplit call, the local SpMV alone (both K1 launches),
the halo exchange alone, the carries alone, and the call from the global
host x (its x block copied in per call); on the card also each K1's device
time (CUDA-graph replays) and the boundary add's compact form
(``_timings``).  ``evidence`` adds the split call's timeline
(``_evidence``): CUDA events on the card, the host clock on the CPU, and
on the card a ``torch.profiler`` trace of the same calls.

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
        PreparedDistributedCsrmv, distributed_csrmv, distributed_csrmv_fn)
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
    r0 = int(part.row_starts[rank])
    r1 = int(part.row_starts[rank + 1])
    c32 = csr.astype(np.float32)
    gold = c32.spmv_gold(x, alpha=alpha)[r0:r1]
    bound = c32.spmv_abs_bound(x, alpha=alpha)[r0:r1]

    def check(window, against, what):
        err = compare_results(window[:r1 - r0], against, verbose=True,
                              abs_bound=bound)
        if err is not None:
            raise AssertionError(f"rank {rank}: window mismatch against "
                                 f"{what} at row {r0 + err}")

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    K.reset_launches()
    unsplit = None
    if meta.get("prepared", False):
        op = PreparedDistributedCsrmv(part, alpha=alpha, device=device)
        y = op(x)
        sync()
        report["prepare_s"] = time.perf_counter() - t0
        k0, c0 = K.LAUNCHES["merge_tile_fused"], op.collectives
        y2 = op(x)
        sync()
        report["k1_per_call"] = K.LAUNCHES["merge_tile_fused"] - k0
        report["collectives_per_call"] = op.collectives - c0
        if not torch.equal(y, y2):
            raise AssertionError(f"rank {rank}: repeated calls differ")
        report.update(_split_report(op))
        # the A/B control: the unsplit order, built once
        unsplit = distributed_csrmv_fn(None, part, alpha, device=device)
        y_unsplit = unsplit(x).cpu().numpy()   # a collective: every rank
        if r1 > r0:
            check(y_unsplit, y.cpu().numpy()[:r1 - r0], "the unsplit call")
    else:
        op = None
        y = distributed_csrmv(None, part, x, alpha=alpha, device=device)
    window = y.cpu().numpy()
    report["k1_launches"] = K.LAUNCHES["merge_tile_fused"]
    if r1 > r0:
        check(window, gold, "gold")
    report["rows_checked"] = max(r1 - r0, 0)
    if timed or meta.get("evidence", False):
        op = op or PreparedDistributedCsrmv(part, alpha=alpha, device=device)
        unsplit = unsplit or distributed_csrmv_fn(None, part, alpha,
                                                  device=device)
    if timed:
        t0 = time.perf_counter()
        report.update(_timings(op, unsplit, x, int(meta.get("calls", 20))))
        report["timings_s"] = time.perf_counter() - t0
    if meta.get("evidence", False):
        t0 = time.perf_counter()
        report["evidence"] = _evidence(op, unsplit, op.x_block(x))
        report["evidence_s"] = time.perf_counter() - t0
    return window, report


def _split_report(op) -> dict:
    """The rank's split: its item counts and its K1 operators' plans."""
    out = {"boundary_items": op.num_boundary,
           "interior_nnz": op.interior.plan.num_nonzeros,
           "gather": op.interior.plan.policy,
           "tile_items": op.interior.plan.tile_items}
    if op.boundary is not None:
        b = op.boundary
        out["boundary_rows"] = int(np.count_nonzero(np.diff(
            op.split.boundary_csr(op.rank).row_offsets)))
        out["boundary_gather"] = b.plan.policy
        out["boundary_tile_items"] = b.plan.tile_items
    return out


def _compact_boundary(op):
    """The boundary add in its compact form, for the A/B: K1 over the
    boundary rows only (``y_in`` their interior sums, ``beta = 1``),
    written back by ``index_copy_`` at those (unique) rows.  Returns
    ``fn(y, halo)``, which updates y in place."""
    import torch

    from merge_spmv_tpu_torch.formats.csr import CsrMatrix
    from merge_spmv_tpu_torch.ops.operator import build_operator

    b = op.split.boundary_csr(op.rank, op.alpha)
    counts = np.diff(b.row_offsets)
    rows = np.nonzero(counts)[0]
    compact = CsrMatrix(len(rows), b.num_cols,
                        np.concatenate([[0], np.cumsum(counts[rows])]
                                       ).astype(np.int32),
                        b.col_indices, b.values)
    opc = build_operator(compact, dtype=op.split.dtype,
                         tile_items=op.split.tile_items, device=op.device)
    idx = torch.from_numpy(rows).to(op.device)

    def fn(y, halo):
        return y.index_copy_(0, idx, opc(halo, y_in=y[idx], beta=1.0))
    return fn


def _timings(op, unsplit, x, calls=20):
    """By the host clock over ``calls`` calls that every rank makes
    together, each waited for: the split call eagerly from the placed
    input (``call_ms``) and the unsplit call (``unsplit_ms``), each the
    median of four runs taken in turns (split, unsplit, unsplit, split,
    twice; ``ab_runs_ms``), the local SpMV alone (``local_ms``: both K1
    launches over a halo already exchanged), the halo exchange alone
    (``exchange_ms``), the carries alone (``carry_ms``), the split call
    from the global host x (``unprepared_ms``).  On the card also each
    K1's device time (``_k1_times``)."""
    import torch
    import torch.distributed as dist

    from merge_spmv_tpu_torch.utils.timers import Timer

    on_card = op.device.type == "cuda"
    x_in = op.x_block(x)
    halo = op.exchange(x_in)
    y_loc = op.local(x_in, halo)

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

    # the A/B in turns: split, unsplit, unsplit, split, twice
    runs = {"call_ms": [], "unsplit_ms": []}
    for key in ("call_ms", "unsplit_ms", "unsplit_ms", "call_ms") * 2:
        fn = op if key == "call_ms" else unsplit
        runs[key].append(per_call(lambda: fn.apply(x_in)))
    times = {k: float(np.median(v)) for k, v in runs.items()}
    times.update({"ab_runs_ms": runs,
                  "local_ms": per_call(lambda: op.local(x_in, halo)),
                  "carry_ms": per_call(lambda: op._carry(y_loc)),
                  "unprepared_ms": per_call(lambda: op(x))})
    if halo is not None:
        times["exchange_ms"] = per_call(lambda: op.exchange(x_in))
    if on_card:
        times.update(_k1_times(op, unsplit, x_in, halo))
    return times


def _k1_times(op, unsplit, x_in, halo) -> dict:
    """Each K1 launch of the rank on the card, by CUDA-graph replay: the
    unsplit window's (``k1_ms``), the interior's (``interior_k1_ms``)
    beside its bytes bound, its plain version and cuSPARSE's ``torch.mv``
    on the same inputs, and the boundary add's (``boundary_k1_ms``)
    beside its bound, cuSPARSE's ``torch.addmv`` (y_in + B @ halo) and its
    compact form (``boundary_compact_ms``; ``boundary_compact_equal``:
    bit for bit the full form's y)."""
    import torch

    from merge_spmv_tpu_torch.bench import measure as M
    from merge_spmv_tpu_torch.ops import csrmv_cuda as K
    from merge_spmv_tpu_torch.utils.timers import chained_rate_ms, event_ms

    H = unsplit._halo_w
    window = (torch.cat([halo[:H], x_in, halo[H:]]) if halo is not None
              else x_in)
    inner = op.interior
    vs = inner.values.element_size()
    rows, cols = inner.shape
    out = {"k1_ms": chained_rate_ms(unsplit.op, window),
           "interior_k1_ms": chained_rate_ms(inner, x_in),
           "interior_bound_ms": M.bound_ms(M.spmv_bytes(
               rows, cols, inner.plan.num_nonzeros, vs), op.device),
           "interior_cusparse_ms": event_ms(
               lambda: torch.mv(M.library_csr(inner), x_in)),
           "interior_plain_ms": event_ms(lambda: K.merge_csrmv_plain(
               inner.values, inner.col_indices, inner.row_end_offsets, x_in,
               inner.tile_rows, inner.tile_nnz, inner.plan.tile_items),
               iters=5, graph=False)}
    if op.boundary is None:
        return out
    b = op.boundary
    y_int = inner(x_in)
    # y_in read besides a CSR SpMV's bytes
    out["boundary_k1_ms"] = chained_rate_ms(b, halo, y_in=y_int, beta=1.0)
    out["boundary_bound_ms"] = M.bound_ms(M.spmv_bytes(
        rows, 2 * H, b.plan.num_nonzeros, vs) + rows * vs, op.device)
    b_csr = M.library_csr(b)
    out["boundary_cusparse_ms"] = event_ms(
        lambda: torch.addmv(y_int, b_csr, halo))
    compact = _compact_boundary(op)
    y_c = y_int.clone()
    out["boundary_compact_ms"] = event_ms(lambda: compact(y_c, halo))
    out["boundary_compact_equal"] = bool(torch.equal(
        compact(y_int.clone(), halo), b(halo, y_in=y_int, beta=1.0)))
    return out


class Timeline:
    """``mark(name, where)`` at a call's steps (parallel/distributed.py
    calls it where a rank's ``timeline`` is set), read on one clock: on
    the card CUDA events, recorded on the compute stream ("compute": the
    point in the stream's work), on the exchange's side stream ("side"),
    or on an idle stream of their own ("host": the host's moment, as
    that stream records at once); on the CPU the host clock."""

    def __init__(self, op):
        import torch

        self.device = op.device
        self._side = getattr(op, "_side", None)
        self._idle = (torch.cuda.Stream(op.device)
                      if op.device.type == "cuda" else None)
        self.marks = []

    def mark(self, name, where):
        import torch

        if self._idle is None:
            self.marks.append((name, time.perf_counter()))
            return
        stream = {"compute": torch.cuda.current_stream(self.device),
                  "side": self._side, "host": self._idle}[where]
        ev = torch.cuda.Event(enable_timing=True)
        ev.record(stream)
        self.marks.append((name, ev))

    def read(self) -> dict:
        """{name: ms after the first mark} (call after a synchronize)."""
        first = self.marks[0][1]
        if self._idle is None:
            return {n: (t - first) * 1e3 for n, t in self.marks}
        return {n: first.elapsed_time(ev) for n, ev in self.marks}


def _overlap(t, k1="interior") -> dict:
    """A call's timeline read: the K1 launch ``k1`` ("interior"; the
    unsplit call's "window") started before the exchange completed
    (``overlap_scheduled``), and how far its interval reached into the
    exchange's window."""
    start, end = t[f"{k1}_start"], t[f"{k1}_end"]
    out = {"overlap_scheduled": start < t["exchange_done"],
           "interior_under_exchange_ms": max(
               0.0, min(end, t["exchange_done"])
               - max(start, t["exchange_post"]))}
    if "boundary_start" in t:
        landed = t.get("halo_landed", t["exchange_done"])
        out["boundary_after_halo"] = t["boundary_start"] >= landed
    return out


def _timeline(op, x_in, calls):
    """``calls`` timelines of ``op.apply(x_in)``, each read after the
    call."""
    import torch

    reads = []
    for _ in range(calls):
        op.timeline = Timeline(op)
        op.apply(x_in)
        if op.device.type == "cuda":
            torch.cuda.synchronize(op.device)
        reads.append(op.timeline.read())
        op.timeline = None
    return reads


def _evidence(op, unsplit, x_in, calls=5) -> dict:
    """The split call's timeline, ``calls`` times after a warm-up: each
    mark's ms from the call's first (the interior K1's GPU interval, the
    exchange from its post to its completion, the halo's landing, the
    boundary K1's interval, the carries' end); ``overlap_scheduled`` when
    the interior K1 starts before the exchange completes on every call.
    ``unsplit``: the same for the unsplit call, whose one K1 waits for the
    exchange (the control).  On the card, a ``torch.profiler`` trace of
    the split calls gives the kernels' CUPTI intervals beside the host's
    marks (``cupti``)."""
    import torch
    import torch.distributed as dist

    on_card = op.device.type == "cuda"
    for fn in (op, unsplit):
        for _ in range(3):
            fn.apply(x_in)
    if on_card:
        torch.cuda.synchronize(op.device)
    dist.barrier()
    reads = _timeline(op, x_in, calls)
    out = {"clock": "cuda events" if on_card else "host", "calls": reads}
    if op._halo_w:
        per = [_overlap(t) for t in reads]
        out["per_call"] = per
        out["overlap_scheduled"] = all(p["overlap_scheduled"] for p in per)
        dist.barrier()
        u_reads = _timeline(unsplit, x_in, calls)
        u_per = [_overlap(t, "window") for t in u_reads]
        out["unsplit"] = {"calls": u_reads, "per_call": u_per,
                          "overlap_scheduled": all(
                              p["overlap_scheduled"] for p in u_per)}
    if on_card:
        dist.barrier()
        out["cupti"] = _cupti_evidence(op, x_in, calls)
    return out


class _Annotations:
    """Marks as zero-length ``record_function`` ranges: host moments in a
    ``torch.profiler`` trace."""

    def mark(self, name, where):
        import torch

        with torch.profiler.record_function(f"mark:{name}"):
            pass


def _cupti_evidence(op, x_in, calls) -> dict:
    """The same calls under ``torch.profiler`` (CPU and CUDA activities):
    whether the K1 kernels, launched through ctypes, appear in the CUPTI
    trace, and per call their device intervals beside the host marks, in
    ms from the call's first mark (the interior's launch)."""
    import tempfile

    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            op.timeline = _Annotations()
            op.apply(x_in)
            op.timeline = None
            torch.cuda.synchronize(op.device)
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    kernels = sorted((e for e in events if e.get("cat") == "kernel"
                      and "merge_tile" in e.get("name", "")),
                     key=lambda e: e["ts"])
    # the host's ranges (a GPU projection of each has its own category)
    marks = sorted((e for e in events if e.get("name", "").startswith(
        "mark:") and e.get("cat") != "gpu_user_annotation"),
        key=lambda e: e["ts"])
    out = {"kernels_seen": len(kernels),
           "kernel_names": sorted({e["name"][:80] for e in kernels}),
           "marks_seen": len(marks)}
    per_call = 1 + (op.boundary is not None)
    if len(kernels) != per_call * calls or not op._halo_w:
        return out
    starts = [i for i, e in enumerate(marks)
              if e["name"] == "mark:interior_start"]
    reads = []
    for c, i in enumerate(starts):
        nxt = starts[c + 1] if c + 1 < len(starts) else len(marks)
        t0 = marks[i]["ts"]
        r = {e["name"][5:]: (e["ts"] - t0) / 1e3 for e in marks[i:nxt]}
        k = kernels[c * per_call:(c + 1) * per_call]
        r["interior_kernel"] = [(k[0]["ts"] - t0) / 1e3,
                                (k[0]["ts"] + k[0]["dur"] - t0) / 1e3]
        if per_call == 2:
            r["boundary_kernel"] = [(k[1]["ts"] - t0) / 1e3,
                                    (k[1]["ts"] + k[1]["dur"] - t0) / 1e3]
        k0, k1 = r["interior_kernel"]
        r["overlap_scheduled"] = k0 < r["exchange_done"]
        r["interior_under_exchange_ms"] = max(
            0.0, min(k1, r["exchange_done"]) - max(k0, r["exchange_post"]))
        reads.append(r)
    out["calls"] = reads
    out["overlap_scheduled"] = all(r["overlap_scheduled"] for r in reads)
    return out


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
