"""The program's per-call CUDA graph capture, in ms a set: the time in
its `merge_spmv.solve.capture` span (torch.cuda.graph's entry, the host
recording one block, capture_end and instantiation;
`models/solvers.py::_capture`) a `merge_spmv.solve` span, the mean over
the traced sets."""

from spmv_bench.spans import CAPTURE, phase_ms_per_solve

LAYER = "solvers"
UNIT = "ms"
SOURCE = "program_span"


def read(run):
    return phase_ms_per_solve(run.trace, CAPTURE)
