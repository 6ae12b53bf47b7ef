"""The prolongation kernel's share of its roofline (`csrc/multigrid.cu::
mg_prolong_kernel`: x[f2c] += x_c): the least time of the traced
window's V-cycles' prolongations (`roofline_mg.prolong_bytes`) over the
kernel's device seconds.  One reader for every cell's entry
(`mg_prolong_roofline.<mix>`)."""

from spmv_bench.roofline_mg import PROLONG, prolong_bytes, share_pct

LAYER = "multigrid"
UNIT = "%"
SOURCE = "device_trace"


def read(run):
    if run.trace is None:
        return None
    return share_pct(run, run.trace.kernel(PROLONG)[1],
                     prolong_bytes(run.cell.config,
                                   run.cell.problem["dtype"]))
