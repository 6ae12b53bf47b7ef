"""A set's host-clock time outside its replayed blocks: the set's time
minus its replayed iterations ((host reads - 1) x check_every) times its
`step_ms`; the eager first block, the graph capture and the host's flag
reads.  The mean over the window's sets outside the traced sub-window."""

LAYER = "solvers"
UNIT = "ms"
SOURCE = "host_clock"


def read(run):
    every = int(run.cell.traffic["solver_args"]["check_every"])
    outside = [s["host_ms"] - (s["reads"] - 1) * every * s["step_ms"]
               for s in run.loop.sets
               if s["step_ms"] is not None and not s["traced"]]
    return sum(outside) / len(outside) if outside else None
