"""The program's own spans in a traced window.

merge_spmv_tpu_torch marks its phases with ``torch.profiler``'s
``record_function`` (its ``utils/tracing.py``), so they are host events of
the ``Trace`` (``trace.host``), on the clock of the device's activities.
A solve's phases are the ``merge_spmv.solve.*`` spans its
``merge_spmv.solve`` span holds in time (the loop runs on one thread).
Every function here gives None, or nothing, when the window holds no such
span, as under a program that marks none.
"""

from __future__ import annotations

SOLVE = "merge_spmv.solve"
PHASE = SOLVE + "."
CAPTURE = PHASE + "capture"
EAGER_BLOCK = PHASE + "eager_block"
FLAG_READ = PHASE + "flag_read"
OP_CALL = "merge_spmv.op.call"


def named(trace, name: str):
    """[(start, end)] of the host spans called ``name``, in time order."""
    if trace is None:
        return []
    return sorted((s, e) for n, s, e in trace.host if n == name)


def solves(trace):
    """[{phase name: [(start, end)]}] for each solve span of the window,
    with the solve's own span under ``SOLVE``."""
    out = [{SOLVE: [span]} for span in named(trace, SOLVE)]
    if not out:
        return out
    for name, s, e in trace.host:
        if not name.startswith(PHASE):
            continue
        for phases in out:
            start, end = phases[SOLVE][0]
            if start <= s and e <= end:
                phases.setdefault(name, []).append((s, e))
                break
    return out


def phase_ms_per_solve(trace, name: str):
    """The mean over the window's solves of the time in phase ``name`` a
    solve, in ms; None without solve spans."""
    sets = solves(trace)
    if not sets:
        return None
    total = sum(e - s for phases in sets for s, e in phases.get(name, ()))
    return 1e3 * total / len(sets)


def idle(trace):
    """The stretches of the window with no device activity, in order."""
    edges = [trace.start]
    for s, e in trace.busy_intervals():
        edges += [s, e]
    edges.append(trace.end)
    return union((edges[i], edges[i + 1]) for i in range(0, len(edges), 2))


def union(intervals):
    """The union of [(start, end)], merged, in time order."""
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        elif e > s:
            merged.append([s, e])
    return merged


def overlap(a, b) -> float:
    """The length both unions of intervals ``a`` and ``b`` cover."""
    total, j = 0.0, 0
    for s, e in a:
        while j < len(b) and b[j][1] <= s:
            j += 1
        k = j
        while k < len(b) and b[k][0] < e:
            total += min(e, b[k][1]) - max(s, b[k][0])
            k += 1
    return total
