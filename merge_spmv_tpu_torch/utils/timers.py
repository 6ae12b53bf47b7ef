"""Timing on the card.

Counterpart of ``ingraph_rate_ms`` / ``operator_step_fn``
(merge_spmv_tpu/utils/timers.py:136-225): a chain of N dependent ``op(x)``
calls between two CUDA events, minus a 1-call chain, minimum over repeats.
The subtraction removes the fixed cost of starting a chain; the minimum
drops repeats that a neighbour on the host slowed down.

``graph=True`` (the default) captures each chain in a CUDA graph and times
its replay: the device's time for the calls, as ``ingraph_rate_ms`` runs
its chain inside one compiled program.  ``graph=False`` launches the calls
from Python: what an eager caller gets, which is the host's launch cost
whenever that exceeds the device's time.  Every time here needs a CUDA
device: there is no CPU fallback.
"""

from __future__ import annotations

import torch

from merge_spmv_tpu_torch.ops.csrmv_torch import row_ids_from_offsets

__all__ = ["chained_rate_ms", "event_ms"]


def _require_cuda(t):
    if t.device.type != "cuda":
        raise RuntimeError("timing needs a tensor on the card, got "
                           f"{t.device}")


def _row_abs_sum_max(op) -> float:
    rows = row_ids_from_offsets(op.row_end_offsets, op.plan.num_nonzeros)
    sums = torch.zeros(op.plan.num_rows, dtype=torch.float64,
                       device=op.device)
    sums.index_add_(0, rows, op.values.abs().double())
    return float(sums.max()) if sums.numel() else 0.0


def _timed(run) -> float:
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    run()
    end.record()
    end.synchronize()
    return start.elapsed_time(end)


def _runner(body, graph: bool):
    """A no-argument callable that runs ``body()`` once: eagerly, or as the
    replay of a CUDA graph captured from it."""
    if not graph:
        return body
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        body()
    return g.replay


def chained_rate_ms(op, x0, n: int = 64, reps: int = 5,
                    graph: bool = True) -> float:
    """Milliseconds per ``op(x)`` call on the card.

    For a square matrix call k+1 takes call k's output as its x, with
    ``alpha = 1 / max_r sum_j |A[r, j]|`` so the chain neither overflows
    nor underflows within ``n`` calls; alpha costs nothing in the kernel's
    epilogue.  A non-square matrix repeats ``op(x0)``: the stream runs the
    calls in order either way.
    """
    _require_cuda(x0)
    square = op.plan.num_rows == op.plan.num_cols
    norm = _row_abs_sum_max(op) if square else 0.0
    alpha = 1.0 / norm if norm > 0 else 1.0

    def chain(k):
        def body():
            x = x0
            for _ in range(k):
                y = op(x, alpha=alpha)
                x = y if square else x
        return body

    for _ in range(2):   # warm: library load, allocator
        chain(2)()
    torch.cuda.synchronize()
    run_n, run_1 = _runner(chain(n), graph), _runner(chain(1), graph)
    big = small = float("inf")
    for _ in range(reps):
        big = min(big, _timed(run_n))
        small = min(small, _timed(run_1))
    return (big - small) / (n - 1)


def event_ms(fn, iters: int = 50, reps: int = 3, warmup: int = 3,
             graph: bool = True) -> float:
    """Milliseconds per ``fn()`` call: ``iters`` back-to-back calls between
    two CUDA events, minimum over ``reps``.  ``fn`` launches work on the
    current stream; with ``graph=True`` it must not synchronise."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()

    def body():
        for _ in range(iters):
            fn()

    run = _runner(body, graph)
    return min(_timed(run) for _ in range(reps)) / iters
