"""The mean host-clock time of the window's sets outside the traced
sub-window, each ended by the solver's own read of its flag: what a set
costs on average, the allocator's long stalls included (the window's wall
time over its sets, less the loop's few microseconds between sets)."""

LAYER = "solvers"
UNIT = "ms"
SOURCE = "host_clock"


def read(run):
    times = [s["host_ms"] for s in run.loop.sets if not s["traced"]]
    return sum(times) / len(times) if times else None
