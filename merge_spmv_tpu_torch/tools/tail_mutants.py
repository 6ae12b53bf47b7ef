"""Mutation check of the fused tile kernel's tail, on the card.

    python -m merge_spmv_tpu_torch.tools.tail_mutants

For each mutant, copies the package and tests/test_torch_cuda.py into a
temporary directory, breaks the tail in that copy's csrc/merge_csrmv.cu
(its ordering: ``relaxed_ticket``, the ticket taken by a relaxed instead
of an acquire-release atomic; ``no_barrier``, no block barrier before it;
its sums: ``no_group_barrier``, the groups' totals read with no barrier
after their writes; ``no_prefix``, a pair's group not joined to the
groups before it), and runs the card tests that exercise the tail from
the copy.
Prints one JSON line: per mutant, pytest's summary and whether any test
failed.  Nothing broken is written into the tree.
"""

from __future__ import annotations

import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

PKG = Path(__file__).resolve().parents[1]
TESTS = PKG.parent / "tests" / "test_torch_cuda.py"
SELECT = "fused_tail or tail_ or two_streams or graph_replays"
MUTANTS = {
    "relaxed_ticket": ("atom.acq_rel.gpu.inc.u32", "atom.relaxed.gpu.inc.u32"),
    "no_barrier": ("    __syncthreads();\n    if (tid == 0) {\n"
                   "      unsigned int* counter",
                   "    if (tid == 0) {\n      unsigned int* counter"),
    "no_group_barrier": ("    __syncthreads();\n    // the groups folded",
                         "    // the groups folded"),
    "no_prefix": ("        if (w == warp) combine(open_f, open, f, v);\n",
                  ""),
}


def run_mutant(name: str) -> dict:
    old, new = MUTANTS[name]
    with tempfile.TemporaryDirectory() as tmp:
        copy = Path(tmp) / PKG.name
        shutil.copytree(PKG, copy, ignore=shutil.ignore_patterns(
            "build", "__pycache__"))
        (Path(tmp) / "tests").mkdir()
        shutil.copy(TESTS, Path(tmp) / "tests")
        src = copy / "csrc" / "merge_csrmv.cu"
        text = src.read_text()
        if text.count(old) != 1:
            raise ValueError(f"{name}: the source does not hold the tail "
                             "it breaks")
        src.write_text(text.replace(old, new))
        proc = subprocess.run(
            [sys.executable, "-m", "pytest", "--noconftest", "-q",
             "-p", "no:cacheprovider", "tests/test_torch_cuda.py",
             "-k", SELECT],
            cwd=tmp, env={**os.environ, "PYTHONPATH": tmp},
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            timeout=900)
    summary = proc.stdout.strip().splitlines()[-1] if proc.stdout else ""
    return {"summary": summary, "returncode": proc.returncode,
            "caught": bool(re.search(r"\d+ failed", summary))}


def main() -> int:
    print(json.dumps({name: run_mutant(name) for name in MUTANTS}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
