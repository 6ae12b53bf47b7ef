"""The host's cost to enqueue one V-cycle, in us: the mean length of the
program's `merge_spmv.solve.precondition` spans (`models/multigrid.py::
MultigridOperator.precondition`, in a solve's prologue, eager blocks and
recording) in the traced window.  One reader for every cell's entry
(`mg_vcycle_host_us.<mix>`)."""

from spmv_bench.roofline_mg import span_mean_us

LAYER = "multigrid"
UNIT = "us"
SOURCE = "program_span"
PRECONDITION = "merge_spmv.solve.precondition"


def read(run):
    return span_mean_us(run.trace, PRECONDITION)
