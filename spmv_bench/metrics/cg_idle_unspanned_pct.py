"""The share of the traced window's device idle time that lies under no
phase span of a solve (`merge_spmv.solve.*`: prologue, eager block,
capture, replay, flag read), in percent: what of the idle the program's
spans leave unexplained."""

from spmv_bench.spans import PHASE, idle, overlap, union

LAYER = "solvers"
UNIT = "%"
SOURCE = "device_trace"


def read(run):
    trace = run.trace
    if trace is None:
        return None
    phases = union((max(s, trace.start), min(e, trace.end))
                   for name, s, e in trace.host if name.startswith(PHASE))
    if not phases:
        return None
    gaps = idle(trace)
    idle_s = sum(e - s for s, e in gaps)
    if idle_s <= 0:
        return None
    return 100.0 * (1.0 - overlap(gaps, phases) / idle_s)
