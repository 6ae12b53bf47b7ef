"""Halo-overlap evidence on the card: each rank's split call on one
timeline, the interior K1 against the halo exchange.

    python -m merge_spmv_tpu_torch.tools.halo_overlap_evidence [--cpu]
        [--out PATH] [--calls N]

Counterpart of tools/halo_overlap_evidence.py.  That tool AOT-compiles
the JAX package's prepared SPMD CsrMV for a v5e:2x4 topology and reads in
the optimized HLO schedule that ``collective-permute-start`` precedes the
merge kernel and ``-done`` follows it (HALO_OVERLAP.json).  Here the
program runs: S processes of ``parallel/mp_worker.py`` (``--cases
--time``, each case ``prepared`` and ``evidence``) share the card over
gloo, each runs its share through ``PreparedDistributedCsrmv``'s split
path, verifies its window, and records per call, in ms from the call's
first mark:

* the interior K1's GPU interval (CUDA events on the compute stream);
* the exchange's window, from the post of its ``batch_isend_irecv`` to
  its completion (events recorded on an idle stream at those host
  moments: that stream stamps them as soon as the card serves this
  rank's context, so under another rank's time slice they lag the host),
  and the halo's landing (the side stream's event after its copy back);
* the boundary K1's interval; the carries' end;
* ``overlap_scheduled``: the interior K1 started before the exchange
  completed; the same read of the unsplit call, whose K1 waits for the
  exchange, is the control (``unsplit_overlap_scheduled``, false).  A
  ``torch.profiler`` trace of the same calls (CUPTI) gives
  the K1 kernels' device intervals beside the host's marks, and says
  whether the ctypes-launched kernels appear in it (``cupti``).

Beside it, the A/B of the same run (host clock, every rank together,
slowest rank): the split call against the unsplit one (exchange, one K1
over the window, carries), and on the card each K1's device time
(CUDA-graph replays): the unsplit window's, the interior's, the boundary
add's and its compact form's (K1 over the boundary rows only, then
``index_copy_``).

Matrices: the JAX tool's banded matrix (n = 65536, deg 6, bw 3000, seed
7; tools/halo_overlap_evidence.py:55-60) at S = 2 and 4, and grid3d(100)
(bench.py:93-97) at S = 2; x uniform on [0.1, 1) from RandomState(0).
The ranks share one card, so each timeline is about its own rank's
exchange and kernels.  Writes ``bench/HALO_OVERLAP_h100.json`` (with
``--cpu``: ``_cpu.json``, the host clock, the plain K1) or ``--out``;
never the root's HALO_OVERLAP.json, the TPU package's.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile

import numpy as np

from merge_spmv_tpu_torch.bench import measure as M
from merge_spmv_tpu_torch.formats.coo import CooMatrix
from merge_spmv_tpu_torch.formats.csr import CsrMatrix
from merge_spmv_tpu_torch.parallel.distributed import materialize_y
from merge_spmv_tpu_torch.parallel.mp_worker import save_case, spawn
from merge_spmv_tpu_torch.parallel.partition import partition_csr
from merge_spmv_tpu_torch.utils.compare import compare_results
from merge_spmv_tpu_torch.utils.device import resolve_device

__all__ = ["banded", "grid3d", "default_entries", "run", "main"]

# (n, deg, bw, seed) of tools/halo_overlap_evidence.py:55-60
JAX_BANDED = (1 << 16, 6, 3000, 7)


def banded(n, deg, bw, seed) -> CsrMatrix:
    """The JAX tool's banded matrix: ``deg`` items a row within ``bw`` of
    the diagonal, values on [0.1, 1), all from RandomState(seed)."""
    r = np.random.RandomState(seed)
    rows = np.repeat(np.arange(n, dtype=np.int64), deg)
    cols = np.clip(rows + r.randint(-bw, bw + 1, rows.size), 0, n - 1)
    return CsrMatrix.from_coo(CooMatrix(n, n, rows, cols,
                                        r.uniform(0.1, 1, rows.size)))


def grid3d(width) -> CsrMatrix:
    """bench.py's grid3d, values on [0.5, 1.5) from RandomState(50)."""
    csr = CsrMatrix.from_coo(CooMatrix.grid3d(width)).astype(np.float32)
    csr.values = np.random.RandomState(50).uniform(
        0.5, 1.5, csr.num_nonzeros).astype(np.float32)
    return csr


def default_entries():
    """(name, S, matrix) of the record."""
    n, deg, bw, seed = JAX_BANDED
    jax_m = banded(n, deg, bw, seed)
    name = f"banded_n{n}_deg{deg}_bw{bw}"
    return [(name, 2, jax_m), (name, 4, jax_m),
            ("grid3d100", 2, grid3d(100))]


def _entry(name, S, csr, dev, calls, root) -> dict:
    x = np.random.RandomState(0).uniform(0.1, 1, csr.num_cols).astype(
        np.float32)
    d = os.path.join(root, f"{name}_S{S}")
    case = save_case(d, "case", csr, x, {"prepared": True, "evidence": True,
                                         "calls": calls})
    reps = [r["case"] for r in spawn(S, d, dev.type)]
    part = partition_csr(csr, S, dtype=np.float32)
    c32 = csr.astype(np.float32)
    y = materialize_y(np.stack([np.load(os.path.join(case, f"y_{r}.npy"))
                                for r in range(S)]), part)
    ok = compare_results(y, c32.spmv_gold(x), verbose=False,
                         abs_bound=c32.spmv_abs_bound(x)) is None
    call = max(r["call_ms"] for r in reps)
    unsplit = max(r["unsplit_ms"] for r in reps)
    out = {"matrix": name, "S": S, "rows": csr.num_rows,
           "nnz": csr.num_nonzeros, "x_mode": part.x_mode,
           "halo": part.halo, "cpad": part.cpad, "verified": ok,
           "overlap_scheduled": all(r["evidence"].get("overlap_scheduled")
                                    for r in reps),
           "unsplit_overlap_scheduled": any(
               r["evidence"]["unsplit"]["overlap_scheduled"] for r in reps),
           "call_ms": call, "unsplit_ms": unsplit,
           "split_over_unsplit": call / unsplit, "ranks": reps}
    if dev.type == "cuda":
        cupti = [r["evidence"]["cupti"] for r in reps]
        out["cupti_kernels_seen"] = all(c["kernels_seen"] for c in cupti)
        out["cupti_overlap_scheduled"] = all(c.get("overlap_scheduled")
                                             for c in cupti)
    print(f"{name} S={S}: {part.x_mode} halo {part.halo}, verified {ok}, "
          f"overlap_scheduled {out['overlap_scheduled']}; split call "
          f"{call:.4f} ms, unsplit {unsplit:.4f} ms; boundary items "
          f"{[r.get('boundary_items') for r in reps]}", flush=True)
    return out


def run(entries=None, device=None, calls: int = 20) -> dict:
    """The record for ``entries`` ((name, S, CsrMatrix) triples; None:
    ``default_entries()``), on the card or (``device="cpu"``) on this
    host's cores."""
    dev = resolve_device(device)
    entries = default_entries() if entries is None else entries
    with tempfile.TemporaryDirectory() as root:
        results = [_entry(name, S, csr, dev, calls, root)
                   for name, S, csr in entries]
    rec = {"tool": "halo_overlap_evidence", "platform": dev.type,
           "backend": "gloo", **M.device_record(dev), "calls": calls,
           "entries": results,
           "overlap_scheduled": all(e["overlap_scheduled"]
                                    for e in results),
           "verified": all(e["verified"] for e in results),
           "note": ("the ranks share one device over gloo, which stages "
                    "the halo edges and the carries through the host; "
                    "each rank's timeline is its own exchange and "
                    "kernels.  Times in a timeline are ms from the call's "
                    "first mark (the interior K1's start); on the CPU they "
                    "are host-clock times of the plain K1")}
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cpu", action="store_true",
                    help="the ranks on this host's cores (plain versions)")
    ap.add_argument("--out", default=None, help="the record's path")
    ap.add_argument("--calls", type=int, default=20,
                    help="calls per timing (the timelines take 5)")
    args = ap.parse_args(argv)
    dev = resolve_device("cpu" if args.cpu else None)
    rec = run(device=dev, calls=args.calls)
    M.save_record(M.record_path("HALO_OVERLAP", dev, args.out), rec)
    print(json.dumps({"overlap_scheduled": rec["overlap_scheduled"],
                      "verified": rec["verified"]}))
    return 0 if rec["overlap_scheduled"] and rec["verified"] else 1


if __name__ == "__main__":
    sys.exit(main())
