"""Corpus sweep: run the port's benchmark CLI over every .mtx in a directory
— the port's counterpart of the TPU package's tools/eval_corpus.py.

Analog of eval_csrmv.sh (eval_csrmv.sh:8-17): CSV header, then one
``python -m merge_spmv_tpu_torch.cli --quiet --mtx=<f>`` subprocess per
dataset — one process per matrix gives crash isolation by construction,
exactly like the reference sweep.  The default backends are ``merge,xla``:
the merge-path CUDA kernel (K1) and cuSPARSE, the paper's comparison.

    python -m merge_spmv_tpu_torch.tools.eval_corpus <mtx-dir>
        [--out results.csv] [--backends merge,xla] [--fp64] [--cpu]
        [--timeout S]

Files run in an md5-shuffled order, so an interrupted sweep covers a
cross-section of the corpus; ``--out`` resumes, keeping every finished
row (rows that ended in TIMEOUT or ERROR run again).  Each row gets one
retry after a non-zero exit, none after a timeout.  On the card, each run
writes a ``# device: <name>, <power limit>`` line (nvidia-smi's) into the
CSV, which readers of the rows skip.  At the end, tools/corpus_stats.py
runs over ``--out``.
"""

from __future__ import annotations

import argparse
import glob
import hashlib
import os
import subprocess
import sys
import time

from merge_spmv_tpu_torch.tools import corpus_stats
from merge_spmv_tpu_torch.utils.hostmem import enable_warm_heap

__all__ = ["HEADER", "device_ready", "device_note", "main"]

HEADER = ("dataset, num_rows, num_cols, num_nonzeros, row_length_mean, "
          "row_length_std_dev, row_length_variation, row_length_skewness, "
          "backend, setup_ms, avg_ms, gflops, effective_GBs")

REPO_DIR = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def _env():
    """The environment of a row's subprocess: this checkout first on the
    import path, so ``-m merge_spmv_tpu_torch.cli`` finds this package."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [REPO_DIR] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                      if p])
    return env


def device_ready(timeout: int = 120) -> bool:
    """Preflight: does a fresh process see a CUDA device?

    Asked in a subprocess, so that a hung driver cannot poison the sweep's
    own process.  A sweep row started while the device is lost burns its
    whole timeout and records a spurious TIMEOUT."""
    code = ("import sys, torch; "
            "sys.exit(0 if torch.cuda.is_available() else 1)")
    try:
        r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                           timeout=timeout, env=_env())
        return r.returncode == 0
    except subprocess.TimeoutExpired:
        return False


def device_note():
    """nvidia-smi's name and power limit of the card, or None."""
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True,
                           text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired):
        return None
    lines = r.stdout.strip().splitlines()
    return lines[0].strip() if r.returncode == 0 and lines else None


def _wait_device(limit_s: int) -> None:
    waited = 0
    while not device_ready() and waited < limit_s:
        print(f"# device unreachable; waiting ({waited}s)", file=sys.stderr,
              flush=True)
        time.sleep(60)
        waited += 60


def main(argv=None):
    enable_warm_heap()   # warm-page reuse for the host's numpy
    ap = argparse.ArgumentParser()
    ap.add_argument("mtx_dir")
    ap.add_argument("--fp64", action="store_true")
    ap.add_argument("--out", default=None)
    ap.add_argument("--backends", default="merge,xla")
    ap.add_argument("--timeout", type=int, default=900)
    ap.add_argument("--tile-items", type=int, default=0, dest="tile_items")
    ap.add_argument("--cpu", action="store_true",
                    help="run the kernels' plain versions on the CPU (no "
                         "device preflight)")
    ap.add_argument("--wait-device", type=int, default=3600,
                    help="max seconds to wait for the device before a row "
                         "(0 disables the preflight)")
    args = ap.parse_args(argv)

    files = sorted(glob.glob(os.path.join(args.mtx_dir, "*.mtx")))
    if not files:
        print(f"no .mtx files under {args.mtx_dir}", file=sys.stderr)
        return 1
    # stable shuffle (hash of the name): alphabetical order front-loads
    # whole generator families, so an interrupted sweep would cover one
    # corner of the CoV/size/locality space instead of a cross-section
    files.sort(key=lambda p: hashlib.md5(
        os.path.basename(p).encode()).hexdigest())

    done = set()
    if args.out and os.path.exists(args.out):
        # resume: keep completed rows (a sweep may span several runs on
        # fresh machines; a crash mid-sweep must not discard finished work)
        for line in open(args.out):
            name = line.split(",")[0].strip()
            if name and name != "dataset" and not name.startswith("#") \
                    and "TIMEOUT" not in line and "ERROR" not in line:
                done.add(name)
    out = open(args.out, "a" if done else "w") if args.out else sys.stdout
    if not done:
        print(HEADER, file=out, flush=True)
    preflight = not args.cpu and args.wait_device > 0
    if not args.cpu:
        note = device_note()
        if note:
            print(f"# device: {note}", file=out, flush=True)
    # the preflight runs before the first row and after a row that failed
    # (when the device may have been lost), not before every row: a
    # subprocess that imports torch costs seconds
    check_device = preflight
    t_sweep = time.perf_counter()
    for path in files:
        name = os.path.splitext(os.path.basename(path))[0]
        if name in done:
            continue
        cmd = [sys.executable, "-m", "merge_spmv_tpu_torch.cli",
               f"--mtx={os.path.abspath(path)}", "--quiet",
               f"--backends={args.backends}"]
        if args.fp64:
            cmd.append("--fp64")
        if args.tile_items:
            cmd.append(f"--tile-items={args.tile_items}")
        if args.cpu:
            cmd.append("--cpu")
        if check_device:
            _wait_device(args.wait_device)
        t_row = time.perf_counter()
        status = None
        for attempt in range(2):
            # one retry after a non-zero exit (a lost context, a killed
            # process), independent of the matrix
            try:
                r = subprocess.run(cmd, capture_output=True, text=True,
                                   timeout=args.timeout, env=_env())
                line = (r.stdout.strip().splitlines()[-1]
                        if r.stdout.strip() else "")
                status = (line if r.returncode == 0
                          else f"ERROR rc={r.returncode}")
                if r.returncode == 0:
                    break
                tail = r.stderr.strip().splitlines()[-3:]
                print(f"# {name}: rc={r.returncode}: {' | '.join(tail)}",
                      file=sys.stderr, flush=True)
            except subprocess.TimeoutExpired:
                status = "TIMEOUT"
                break   # a timeout is the matrix, not a flake: retrying
                        # doubles the burn
        check_device = preflight and (status == "TIMEOUT"
                                      or status.startswith("ERROR"))
        print(f"{name}, {status}", file=out, flush=True)
        print(f"# {name}: {time.perf_counter() - t_row:.1f} s "
              f"(sweep {time.perf_counter() - t_sweep:.0f} s)",
              file=sys.stderr, flush=True)
    if args.out:
        out.close()
        # corpus-scale acceptance statistics (paper Fig. 9 analogs)
        corpus_stats.main([args.out])
    return 0


if __name__ == "__main__":
    sys.exit(main())
