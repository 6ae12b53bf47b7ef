"""The solver's own device time a masked iteration (`SolveInfo.step_ms`:
CUDA events around each replay of the captured block in
`models/solvers.py::_iterate`), the mean over the window's sets outside
the traced sub-window."""

LAYER = "solvers"
UNIT = "ms"
SOURCE = "program_span"


def read(run):
    steps = [s["step_ms"] for s in run.loop.sets
             if s["step_ms"] is not None and not s["traced"]]
    return sum(steps) / len(steps) if steps else None
