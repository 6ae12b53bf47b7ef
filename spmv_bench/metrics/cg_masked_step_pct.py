"""The share of the steps a set launched that did nothing, in percent:
100 (1 - the sum of `SolveInfo.iterations` / the sum of `host_reads` x
`check_every`) over the window's sets outside the traced sub-window.
The solver launches `check_every` masked steps a host read
(`models/solvers.py::_iterate`); those past the stopping iteration leave
the state unchanged."""

LAYER = "solvers"
UNIT = "%"
SOURCE = "program_counter"


def read(run):
    every = int(run.cell.traffic["solver_args"]["check_every"])
    sets = [s for s in run.loop.sets if not s["traced"]]
    launched = sum(s["reads"] * every for s in sets)
    if not launched:
        return None
    return 100.0 * (1.0 - sum(s["iterations"] for s in sets) / launched)
