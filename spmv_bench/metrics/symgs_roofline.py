"""The colour step's share of its roofline in the V-cycle (HPCG's
symmetric Gauss-Seidel sweep, `models/multigrid.py`): the least time of
the traced window's V-cycles' colour steps (`roofline_mg.symgs_bytes`: a
colour's rows of A, the x they gather, r at the rows, x written there,
at HBM's rate) over the device seconds of every `symgs_update_kernel`
and of the K1 product that runs right before each (`roofline_mg.
colour_step_seconds`).  One reader for every cell's entry
(`symgs_roofline.<mix>`)."""

from spmv_bench.roofline_mg import (colour_step_seconds, share_pct,
                                    symgs_bytes)

LAYER = "multigrid"
UNIT = "%"
SOURCE = "device_trace"


def read(run):
    if run.trace is None:
        return None
    return share_pct(run, colour_step_seconds(run.trace),
                     symgs_bytes(run.cell.config,
                                 run.cell.problem["dtype"]))
