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
whenever that exceeds the device's time.  Every device time here needs a
CUDA device: there is no CPU fallback.  ``Timer`` is the host clock, for
the host baselines and the plain versions.
"""

from __future__ import annotations

import time

import torch

__all__ = ["chained_rate_ms", "chain_alpha", "event_ms", "Timer",
           "adaptive_timing_iterations"]


class Timer:
    """Wall-clock timer with the CpuTimer Start/Stop/ElapsedMillis surface
    (merge_spmv_tpu/utils/timers.py:18-40), for the host baselines and
    the plain versions."""

    def __init__(self):
        self._start = None
        self._elapsed = 0.0

    def start(self):
        self._start = time.perf_counter()
        return self

    def stop(self):
        self._elapsed = time.perf_counter() - self._start
        return self

    def elapsed_millis(self) -> float:
        return self._elapsed * 1e3

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()


def adaptive_timing_iterations(num_nonzeros: int, max_iterations: int = 50000,
                               min_iterations: int = 100,
                               target_nnz: int = 16 << 30) -> int:
    """Iteration count targeting `target_nnz` total nonzeros processed
    (cpu_spmv.cpp:611-616 with the GPU driver's 50k cap)."""
    if num_nonzeros <= 0:
        return min_iterations
    return int(min(max_iterations, max(min_iterations, target_nnz // num_nonzeros)))


def _require_cuda(t):
    if t.device.type != "cuda":
        raise RuntimeError("timing needs a tensor on the card, got "
                           f"{t.device}")


def chain_alpha(op) -> float:
    """``1 / max_r sum_j |A[r, j]|`` from the operator's
    ``abs_row_sum_max`` (taken once at build), or 1 for a zero matrix:
    the alpha under which a chain of calls neither overflows nor
    underflows."""
    norm = op.abs_row_sum_max
    return 1.0 / norm if norm > 0 else 1.0


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
                    graph: bool = True, y_in=None,
                    beta: float = 0.0) -> float:
    """Milliseconds per ``op(x, y_in, alpha, beta)`` call on the card.

    ``op`` is any operator with a logical ``shape`` (rows, cols) and
    ``abs_row_sum_max``; ``op(x)`` must not synchronise.  The shape, not
    ``op.plan``, decides: a split operator's plan is its stack's.
    For a square matrix call k+1 takes call k's output as its x, with
    ``alpha = chain_alpha(op)``, so the chain neither overflows nor
    underflows within ``n`` calls; alpha costs nothing in the kernels'
    epilogue.  ``y_in``/``beta`` make every timed call carry the full
    epilogue.  A non-square matrix repeats ``op(x0)``: the stream runs
    the calls in order either way.
    """
    _require_cuda(x0)
    rows, cols = op.shape
    square = rows == cols
    alpha = chain_alpha(op) if square else 1.0

    def chain(k):
        def body():
            x = x0
            for _ in range(k):
                y = op(x, y_in=y_in, alpha=alpha, beta=beta)
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
