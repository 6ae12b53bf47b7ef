"""The host time of FastRP's dense work after a product, in us: the mean
length of the program's `merge_spmv.solve.normalize` spans
(`models/solvers.py::fastrp`: N_i's rows L2-normalised in place and
added, weighted, into E) in the traced window."""

from spmv_bench.spans import named

LAYER = "solvers"
UNIT = "us"
SOURCE = "program_span"
NORMALIZE = "merge_spmv.solve.normalize"


def read(run):
    spans = named(run.trace, NORMALIZE)
    if not spans:
        return None
    return 1e6 * sum(e - s for s, e in spans) / len(spans)
