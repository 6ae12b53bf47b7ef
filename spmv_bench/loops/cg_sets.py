"""Sets of a solver run back to back by one closed-loop caller: each set
is ``solver(op, b, **solver_args)`` from x0 = 0 (HPCG's fixed sets of
``maxiter`` CG iterations with ``tol`` = 0), ending in the solver's own
read of its flag on the host.  Set s solves for b = pool[s mod
``rhs_pool``], the pool uniform(-1, 1) from the seed, so every seed does
the same work.

Each set's host-clock time, the solver's host reads and its ``step_ms``
are kept.  A traced set asks for 1 + reads x ``check_every`` products:
the prologue's r = b - op(x) and one a step, masked steps included, as
CG makes them (``traced_products``).  Sets at positions drawn from the
seed (``samples`` of them below ``sample_below``), set 0 and the
window's last set keep their solution; the reference's function of the
same name runs the same iterations from the same b.

traffic keys: ``solver``, ``solver_args``, ``rhs_pool``, ``warm_sets``,
``samples``, ``sample_below``, ``trace_after_s``, ``trace_sets``.
"""

from __future__ import annotations

import statistics
import time

from spmv_bench import reference
from spmv_bench.generators import generator, uniform
from spmv_bench.loops import TracedOnce, sample_positions, synchronize


def rhs_pool(cell, device):
    gen = generator(cell.seed, "cg.rhs", device)
    n = cell.problem["num_rows"]
    return [uniform(n, -1.0, 1.0, gen, device)
            for _ in range(int(cell.traffic["rhs_pool"]))]


class Loop:
    def __init__(self, system, op, cell):
        t = cell.traffic
        self.system, self.op, self.cell = system, op, cell
        self.device = cell.device
        self.pool = rhs_pool(cell, cell.device)
        self.sample_at = sample_positions(cell.seed, "cg.samples",
                                          int(t["samples"]),
                                          int(t["sample_below"]))
        # a dict a set: host_ms, iterations, reads, step_ms, traced
        self.sets = []
        self.samples = []   # (position, x)
        self.wall_s = 0.0
        self.trace = None

    def solve(self, s: int, traced: bool = False):
        t = self.cell.traffic
        t0 = time.perf_counter()
        x, iters, reads, step_ms = self.system.solve(
            t["solver"], self.op, self.pool[s % len(self.pool)],
            **t["solver_args"])
        host_ms = (time.perf_counter() - t0) * 1e3
        self.sets.append({"host_ms": host_ms, "iterations": iters,
                          "reads": reads, "step_ms": step_ms,
                          "traced": traced})
        if s in self.sample_at:
            self.samples.append((s, x))
        self.last = (s, x)

    def warm(self):
        for s in range(int(self.cell.traffic["warm_sets"])):
            self.system.solve(self.cell.traffic["solver"], self.op,
                              self.pool[s % len(self.pool)],
                              **self.cell.traffic["solver_args"])
        synchronize(self.device)

    def run(self, seconds: float, trace: bool):
        t = self.cell.traffic
        t0 = time.perf_counter()
        traced = TracedOnce(trace, float(t["trace_after_s"]), t0)
        while time.perf_counter() - t0 < seconds:
            if traced.due():
                def body():
                    for _ in range(int(t["trace_sets"])):
                        self.solve(len(self.sets), traced=True)
                traced.take(body, self.device)
                continue
            self.solve(len(self.sets))
        synchronize(self.device)
        self.wall_s = time.perf_counter() - t0
        self.trace = traced.trace
        if self.sets and self.last[0] not in self.sample_at:
            self.samples.append(self.last)

    @property
    def attempted(self) -> int:
        return len(self.sets)

    @property
    def traced_products(self) -> int:
        every = int(self.cell.traffic["solver_args"]["check_every"])
        return sum(1 + s["reads"] * every for s in self.sets if s["traced"])

    def end_to_end(self) -> dict:
        """The median host-clock time of every set in the window."""
        return {"solve_p50_ms":
                statistics.median(s["host_ms"] for s in self.sets)}

    def release(self):
        self.op = None
        self.last = None
        self.pool = None

    def check(self, csr: dict):
        """({"solution_err": the worst over the samples, "iteration_gap":
        the largest |iterations - maxiter| over all sets}, samples or
        sets past a limit).  The reference draws the pool again."""
        maxiter = int(self.cell.traffic["solver_args"]["maxiter"])
        pool = rhs_pool(self.cell, self.device)
        limit = self.cell.limits
        errs = []
        for s, x in self.samples:
            x_ref, _ = getattr(reference, self.cell.traffic["solver"])(
                csr, pool[s % len(pool)], maxiter)
            errs.append(reference.relative_error(x, x_ref))
        gaps = [abs(st["iterations"] - maxiter) for st in self.sets]
        numbers = {"solution_err": max(errs, default=float("inf")),
                   "iteration_gap": max(gaps, default=float("inf"))}
        failed = sum(not e <= limit["solution_err"] for e in errs) + \
            sum(not g <= limit["iteration_gap"] for g in gaps)
        return numbers, failed
