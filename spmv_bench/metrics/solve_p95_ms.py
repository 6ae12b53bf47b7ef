"""The 95th percentile (nearest rank) of the host-clock time of every set
in the window outside the traced sub-window, each ended by the solver's
own read of its flag: the tail of all sets."""

from spmv_bench.loops import nearest_rank

LAYER = "solvers"
UNIT = "ms"
SOURCE = "host_clock"


def read(run):
    times = [s["host_ms"] for s in run.loop.sets if not s["traced"]]
    return nearest_rank(times, 0.95) if times else None
