"""The traced sub-window and its reduction to numbers.

``profiled(body, device)`` runs ``body`` under ``torch.profiler`` (CUPTI
on the card) inside a span named ``WINDOW``, with the device synchronised
at both of its ends, and keeps the events in memory: the span's start and
end, every device activity (kernels, copies, sets) and every host event,
as (name, start, end) in seconds on the profiler's clock.  Nothing is
written to disk.  The readers in ``metrics/`` take their numbers from the
``Trace`` it returns.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import torch

WINDOW = "spmv_bench.window"
# host events of the profiler's own work, never what the program did
PROFILER_OWN = ("Activity Buffer Request",)


@dataclass
class Trace:
    start: float = 0.0
    end: float = 0.0
    device: list = field(default_factory=list)   # (name, start, end)
    host: list = field(default_factory=list)     # (name, start, end)

    @property
    def window_s(self) -> float:
        return self.end - self.start

    def clipped(self):
        """Device activities inside the window, cut to it."""
        for name, s, e in self.device:
            s, e = max(s, self.start), min(e, self.end)
            if e > s:
                yield name, s, e

    def busy_intervals(self):
        """The union of the device activities in the window, merged."""
        merged = []
        for _, s, e in sorted(self.clipped(), key=lambda t: t[1]):
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return merged

    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals())

    def kernel(self, name_part: str):
        """(launches, seconds) of the device activities whose name holds
        ``name_part``, inside the window."""
        times = [e - s for name, s, e in self.clipped() if name_part in name]
        return len(times), sum(times)

    def device_ops(self, n: int = 10):
        """The ``n`` device operations that took most time: [name, s]."""
        total: dict = {}
        for name, s, e in self.clipped():
            total[name] = total.get(name, 0.0) + (e - s)
        return sorted(([k, v] for k, v in total.items()),
                      key=lambda t: -t[1])[:n]

    def idle_gaps(self, n: int = 10):
        """The ``n`` longest stretches of the window with no device
        activity, each named by the innermost host event open at its
        middle: [name, s]."""
        edges = [self.start]
        for s, e in self.busy_intervals():
            edges += [s, e]
        edges.append(self.end)
        gaps = sorted(((edges[i], edges[i + 1])
                       for i in range(0, len(edges), 2)
                       if edges[i + 1] > edges[i]),
                      key=lambda g: g[0] - g[1])[:n]
        out = []
        for s, e in gaps:
            mid = 0.5 * (s + e)
            inner = [(hs, name) for name, hs, he in self.host
                     if hs <= mid <= he and name not in PROFILER_OWN]
            out.append([max(inner)[1] if inner else "host", e - s])
        return out


def _span(event):
    if hasattr(event, "start_ns"):
        start = event.start_ns() * 1e-9
        return start, start + event.duration_ns() * 1e-9
    start = event.start_us() * 1e-6
    return start, start + event.duration_us() * 1e-6


def profiled(body, device) -> Trace:
    """Run ``body()`` traced; return its Trace."""
    from torch.profiler import ProfilerActivity, profile, record_function

    cuda = torch.device(device).type == "cuda"
    activities = [ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if cuda else [])
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    sync()
    with profile(activities=activities) as prof:
        with record_function(WINDOW):
            sync()
            body()
            sync()
    trace = Trace()
    for event in prof.profiler.kineto_results.events():
        start, end = _span(event)
        name = event.name()
        if event.device_type() == torch.autograd.DeviceType.CPU:
            if name == WINDOW:
                trace.start, trace.end = start, end
            else:
                trace.host.append((name, start, end))
        elif not (name == WINDOW or (hasattr(event, "is_user_annotation")
                                     and event.is_user_annotation())):
            # a span's projection on the device timeline is no activity
            trace.device.append((name, start, end))
    return trace
