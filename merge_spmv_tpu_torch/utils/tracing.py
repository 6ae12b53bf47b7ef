"""Named spans around the port's phases, for a profiler to place.

``span(name)`` marks a phase.  While a profiler records (``torch.profiler``,
or ``torch.autograd.profiler.emit_nvtx`` under Nsight Systems) it is
``torch.profiler.record_function(name)``, so the phase is a host event on
the profiler's clock, beside the device's kernels.  Otherwise it is one
shared no-op context, after a single check of the profiler's flag: no
dispatcher call and no allocation.  ``span(name, into=d, key=k)`` also
adds the phase's host seconds to ``d[k]``, profiler or not.

    with span(SOLVE):
        ...

The names, each with what it covers (``SPANS``).  A solve's phases are
found inside its ``SOLVE`` span by time containment on its thread.
"""

from __future__ import annotations

import time

import torch

__all__ = ["span", "SPANS", "SOLVE", "PROLOGUE", "EAGER_BLOCK", "CAPTURE",
           "CAPTURE_ENTER", "CAPTURE_RECORD", "CAPTURE_EXIT", "REPLAY",
           "FLAG_READ", "RELEASE", "NORMALIZE", "PRECONDITION", "MG_LEVELS",
           "OP_CALL", "OP_MM", "BUILD_PLAN", "BUILD_PREPARE",
           "BUILD_TRANSITION", "BUILD_STOCHASTIC", "BUILD_MULTIGRID"]

SOLVE = "merge_spmv.solve"
PROLOGUE = "merge_spmv.solve.prologue"
EAGER_BLOCK = "merge_spmv.solve.eager_block"
CAPTURE = "merge_spmv.solve.capture"
CAPTURE_ENTER = "merge_spmv.solve.capture.enter"
CAPTURE_RECORD = "merge_spmv.solve.capture.record"
CAPTURE_EXIT = "merge_spmv.solve.capture.exit"
REPLAY = "merge_spmv.solve.replay"
FLAG_READ = "merge_spmv.solve.flag_read"
RELEASE = "merge_spmv.solve.release"
NORMALIZE = "merge_spmv.solve.normalize"
PRECONDITION = "merge_spmv.solve.precondition"
MG_LEVEL0 = "merge_spmv.mg.level0"
MG_LEVEL1 = "merge_spmv.mg.level1"
MG_LEVEL2 = "merge_spmv.mg.level2"
MG_LEVEL3 = "merge_spmv.mg.level3"
MG_LEVELS = (MG_LEVEL0, MG_LEVEL1, MG_LEVEL2, MG_LEVEL3)
OP_CALL = "merge_spmv.op.call"
OP_MM = "merge_spmv.op.mm"
BUILD_PLAN = "merge_spmv.build.plan"
BUILD_PREPARE = "merge_spmv.build.prepare"
BUILD_TRANSITION = "merge_spmv.build.transition"
BUILD_STOCHASTIC = "merge_spmv.build.stochastic"
BUILD_MULTIGRID = "merge_spmv.build.multigrid"

SPANS = {
    SOLVE: "a solver call (models/solvers.py), entry to return",
    PROLOGUE: "the solver's set-up before its loop: the first residual, "
              "the tolerance, the state",
    EAGER_BLOCK: "one block of check_every masked steps run eagerly",
    CAPTURE: "the one CUDA graph capture of a block, after the first "
             "block's enqueue and before its flag read; its three parts "
             "below",
    CAPTURE_ENTER: "an event after the first block, the side stream and "
                   "capture_begin into the device's kept pool (when another "
                   "solve holds it, torch.cuda.graph's entry: synchronise, "
                   "empty the device and host caches, capture_begin)",
    CAPTURE_RECORD: "the host enqueueing one block under capture",
    CAPTURE_EXIT: "capture_end and the graph's instantiation",
    REPLAY: "one replay of the captured block, with its two timing events",
    FLAG_READ: "one host read of the solver's active flag: the host waits "
               "for the card",
    RELEASE: "after the last flag read: the replays' timing events read and "
             "the captured graph destroyed, its blocks left in the pool",
    NORMALIZE: "FastRP's dense work after a product: the rows of N_i "
               "L2-normalised in place and added, weighted, into the "
               "embedding",
    PRECONDITION: "one multigrid V-cycle z = M r enqueued by the host "
                  "(models/multigrid.py), in a solve's prologue, eager "
                  "blocks or recording",
    **{name: f"level {level}'s work inside a V-cycle: its zero start (level "
             "0), smoothing, residual product, restriction and "
             "prolongation; it holds the coarser levels' spans"
       for level, name in enumerate(MG_LEVELS)},
    OP_CALL: "SpmvOperator.__call__: y = alpha A x + beta y_in, one launch",
    OP_MM: "SpmvOperator.mm: Y = alpha A X + beta Y_in",
    BUILD_PLAN: "build_operator's make_plan (op.setup_s['plan'])",
    BUILD_PREPARE: "build_operator's copy to the device, tile search and "
                   "row norm (op.setup_s['prepare']); pagerank_operator's "
                   "two halves, before and after the plan, summed",
    BUILD_TRANSITION: "transition_operator's row sums and scaling of the "
                      "values to D^-1 A, inside BUILD_PREPARE "
                      "(op.setup_s['transition'])",
    BUILD_STOCHASTIC: "pagerank_operator's row sums, scaling and transpose "
                      "of the values to A^T D^-1 on the device, inside "
                      "BUILD_PREPARE's first half (op.setup_s['stochastic'])",
    BUILD_MULTIGRID: "build_multigrid's own set-up, two spans around the "
                     "fine operator's build: the grid check before it; the "
                     "coarse levels, the colours' operators and the scratch "
                     "after it (op.setup_s['multigrid'], the two summed)",
}

_profiler_enabled = torch.autograd._profiler_enabled


class _Off:
    """The context of a span while no profiler records."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _Timed:
    """A span that also adds its host seconds to ``into[key]``."""

    __slots__ = ("name", "into", "key", "mark", "t0")

    def __init__(self, name: str, into: dict, key):
        self.name, self.into, self.key = name, into, key

    def __enter__(self):
        self.mark = span(self.name)
        self.mark.__enter__()
        self.t0 = time.perf_counter()

    def __exit__(self, *exc):
        seconds = time.perf_counter() - self.t0
        self.into[self.key] = self.into.get(self.key, 0.0) + seconds
        return self.mark.__exit__(*exc)


def span(name: str, into: dict | None = None, key=None):
    """A context manager marking the phase ``name`` (one of ``SPANS``);
    with ``into``, it adds the phase's host seconds to ``into[key]``."""
    if into is not None:
        return _Timed(name, into, key)
    if _profiler_enabled():
        return torch.profiler.record_function(name)
    return _OFF
