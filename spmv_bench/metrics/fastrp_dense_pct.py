"""The dense share of a FastRP call's device time, in percent: the device
seconds of every activity other than K1m (`merge_tile_mm_kernel`: the
row norms, the division, E's weighted sums) over the device seconds of
all activities in the traced window.  None without a trace or without a
K1m launch."""

LAYER = "solvers"
UNIT = "%"
SOURCE = "device_trace"
KERNEL = "merge_tile_mm_kernel"


def read(run):
    if run.trace is None:
        return None
    launches, k1m_s = run.trace.kernel(KERNEL)
    total = sum(e - s for _, s, e in run.trace.clipped())
    if not launches or total <= 0:
        return None
    return 100.0 * (total - k1m_s) / total
