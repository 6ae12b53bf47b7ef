"""The restriction kernel's share of its roofline (`csrc/multigrid.cu::
mg_restrict_kernel`: r_c = r[f2c] - Axf[f2c], x_c = 0): the least time of
the traced window's V-cycles' restrictions (`roofline_mg.
restrict_bytes`) over the kernel's device seconds.  One reader for every
cell's entry (`mg_restrict_roofline.<mix>`)."""

from spmv_bench.roofline_mg import RESTRICT, restrict_bytes, share_pct

LAYER = "multigrid"
UNIT = "%"
SOURCE = "device_trace"


def read(run):
    if run.trace is None:
        return None
    return share_pct(run, run.trace.kernel(RESTRICT)[1],
                     restrict_bytes(run.cell.config,
                                    run.cell.problem["dtype"]))
