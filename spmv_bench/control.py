"""The control: the plain reference put in the program's place and
computed in the next precision below the configuration's ``dtype``
(``LOWER``: float32 under float64, bfloat16 under float32).  A sound
comparison has to call it not correct.

    python3 spmv_bench/control.py --workload <cell> --seeds 1,2,... \\
        --control-seeds 7,8,9 --seconds 2

runs the cell's whole run (set-up, a short window, the comparison) in one
process for each seed, the program on ``--seeds`` and the control on
``--control-seeds``, and prints each run's compared numbers, one JSON
line a run, then a summary: the largest reading of the program and the
smallest of the control, per number.  These are the two readings each
limit in ``limits/`` is set between.  The benchmark's own runs never run
the control.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import torch

if __package__ in (None, ""):
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from spmv_bench import reference  # noqa: E402

# the configuration's dtype -> the control's
LOWER = {"float64": torch.float32, "float32": torch.bfloat16}


class ControlOperator:
    """alpha A x + beta y_in by the reference, in ``LOWER`` of the
    configuration's dtype."""

    def __init__(self, host_csr: dict, config: dict, device):
        dev = torch.device(device)
        self.csr = {
            "num_rows": host_csr["num_rows"],
            "num_cols": host_csr["num_cols"],
            "row_offsets": torch.as_tensor(host_csr["row_offsets"]).to(
                dev, torch.int64),
            "col_indices": torch.as_tensor(host_csr["col_indices"]).to(dev),
            "values": torch.as_tensor(host_csr["values"]).to(dev)}
        self.shape = (host_csr["num_rows"], host_csr["num_cols"])
        self.dtype = config["dtype"]
        self.lower = LOWER[self.dtype]
        self.device = dev
        self.setup_s = {}

    def __call__(self, x, y_in=None, alpha=1.0, beta=0.0):
        return reference.affine(self.csr, x, y_in, alpha, beta, self.lower)

    def mm(self, X, Y_in=None, alpha=1.0, beta=0.0):
        return reference.affine(self.csr, X, Y_in, alpha, beta, self.lower)


class Control:
    name = "control"

    def build(self, host_csr: dict, config: dict, device):
        return ControlOperator(host_csr, config, device)

    def solve(self, solver: str, op, b, tol=0.0, maxiter=50, **_):
        x, _ = getattr(reference, solver)(op.csr, b, maxiter, op.lower)
        return x, int(maxiter), 0, None

    @staticmethod
    def setup_spans(op) -> dict:
        return {}


def main(argv=None) -> int:
    from spmv_bench import run, system

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--seconds", type=float, default=2.0)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 3
    readings = {"program": {}, "control": {}}
    for side, seeds, sut in (("program", args.seeds, system.Program()),
                             ("control", args.control_seeds, Control())):
        for seed in [int(s) for s in seeds.split(",") if s]:
            t0 = time.perf_counter()
            result = run.run_cell(args.workload, seed, args.seconds, False,
                                  "cuda", sut, t_start=t0)
            print(json.dumps({"side": side, "seed": seed,
                              "correct": result["correct"],
                              "attempted": result["attempted"],
                              "metrics": result["metrics"],
                              "checks": result["checks"]}), flush=True)
            for name, entry in result["checks"].items():
                readings[side].setdefault(name, []).append(entry["value"])
            torch.cuda.empty_cache()
    summary = {name: {"program_max": max(vals),
                      "control_min": min(readings["control"].get(
                          name, [float("nan")]))}
               for name, vals in readings["program"].items()}
    print(json.dumps({"summary": summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
