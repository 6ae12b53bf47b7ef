"""The device activities (kernels, copies, sets) of the traced window a
product CG asked for: over the traced sets, 1 + `host_reads` x
`check_every` products a set, the prologue's r = b - op(x) and one a
step, masked steps included (`loops/cg_sets.py::traced_products`).  On
the card a step is K1 and the three fused vector kernels of
`csrc/cg_step.cu`."""

LAYER = "solvers"
UNIT = "count"
SOURCE = "device_trace"


def read(run):
    if run.trace is None:
        return None
    activities = sum(1 for _ in run.trace.clipped())
    products = run.loop.traced_products
    if not activities or not products:
        return None
    return activities / products
