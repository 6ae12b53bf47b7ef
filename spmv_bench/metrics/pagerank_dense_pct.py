"""The dense share of a PageRank job's device time, in percent: the device
seconds of every activity other than K1 (`merge_tile_kernel`: the step's
sums, scalings, masks and copies over the rank vector) over the device
seconds of all activities in the traced window.  None without a trace or
without a K1 launch."""

LAYER = "solvers"
UNIT = "%"
SOURCE = "device_trace"
KERNEL = "merge_tile_kernel"


def read(run):
    if run.trace is None:
        return None
    launches, k1_s = run.trace.kernel(KERNEL)
    total = sum(e - s for _, s, e in run.trace.clipped())
    if not launches or total <= 0:
        return None
    return 100.0 * (total - k1_s) / total
