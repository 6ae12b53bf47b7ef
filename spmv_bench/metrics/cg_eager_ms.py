"""The program's eager blocks, in ms a set: the time in its
`merge_spmv.solve.eager_block` spans (`models/solvers.py::_iterate`) a
`merge_spmv.solve` span, the mean over the traced sets."""

from spmv_bench.spans import EAGER_BLOCK, phase_ms_per_solve

LAYER = "solvers"
UNIT = "ms"
SOURCE = "program_span"


def read(run):
    return phase_ms_per_solve(run.trace, EAGER_BLOCK)
