"""The share of the V-cycles' device time spent on levels 1-3, in
percent, over the traced window (`roofline_mg.vcycle_split`: a kernel
is placed on its level by its order on the card, between the
restriction that opens a coarser level and the prolongation that closes
it; the card's activities run behind the host's spans, so the
`merge_spmv.mg.level<l>` spans cannot place them).  One reader for
every cell's entry (`mg_coarse_pct.<mix>`)."""

from spmv_bench.roofline_mg import vcycle_split

LAYER = "multigrid"
UNIT = "%"
SOURCE = "device_trace"


def read(run):
    if run.trace is None:
        return None
    fine, coarse = vcycle_split(run.trace)
    if fine + coarse <= 0 or coarse <= 0:
        return None
    return 100.0 * coarse / (fine + coarse)
