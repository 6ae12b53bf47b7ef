"""The share of the traced window in which no kernel, copy or set ran
on the card, in percent.  One reader for every cell's entry
(`device_idle_pct.<mix>`)."""

LAYER = "device"
UNIT = "%"
SOURCE = "device_trace"


def read(run):
    if run.trace is None or run.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - run.trace.busy_s() / run.trace.window_s)
