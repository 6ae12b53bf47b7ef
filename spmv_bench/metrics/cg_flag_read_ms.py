"""The host blocked on the card, in ms a set: the time in the program's
`merge_spmv.solve.flag_read` spans (each host read of the solver's
active flag, `models/solvers.py::_iterate`) a `merge_spmv.solve` span,
the mean over the traced sets."""

from spmv_bench.spans import FLAG_READ, phase_ms_per_solve

LAYER = "solvers"
UNIT = "ms"
SOURCE = "program_span"


def read(run):
    return phase_ms_per_solve(run.trace, FLAG_READ)
