"""PageRank jobs back to back, as LDBC Graphalytics runs its PR algorithm:
one closed-loop caller, each job ``solver(op, damping, **solver_args)``
(``models/solvers.py::pagerank`` with ``tol`` 0 and ``maxiter`` the fixed
iteration count) from PR_0 = 1 / |V|, ending in the solver's own read of
its flag on the host.  ``op`` applies P = A^T D^-1
(``pagerank_operator``).  Every job does the same work; its host-clock
time, the solver's host reads and its ``step_ms`` are kept as
``cg_sets`` keeps a set's, and the window's median job is
``solve_p50_ms``.

A traced job asks for reads x ``check_every`` products (one a step,
masked steps included; PageRank has no prologue product), each y = P pr
with beta = 0 (``traced_products``).  Jobs at positions drawn from the
seed (``samples`` of them below ``sample_below``), job 0 and the window's
last job keep their ranks; the reference (``reference_pagerank.py``,
float64, from the link graph the generator makes again) computes the
ranks once, after the window.

traffic keys: ``solver``, ``damping``, ``solver_args``, ``warm_sets``,
``samples``, ``sample_below``, ``trace_after_s``, ``trace_sets``.
"""

from __future__ import annotations

import time

from spmv_bench import reference_pagerank
from spmv_bench.loops import cg_sets, sample_positions, synchronize


class Loop(cg_sets.Loop):
    def __init__(self, system, op, cell):
        t = cell.traffic
        self.system, self.op, self.cell = system, op, cell
        self.device = cell.device
        self.sample_at = sample_positions(cell.seed, "pagerank.samples",
                                          int(t["samples"]),
                                          int(t["sample_below"]))
        # a dict a job: host_ms, iterations, reads, step_ms, traced
        self.sets = []
        self.samples = []   # (position, ranks)
        self.wall_s = 0.0
        self.trace = None

    def job(self):
        t = self.cell.traffic
        return self.system.solve(t["solver"], self.op, float(t["damping"]),
                                 **t["solver_args"])

    def solve(self, s: int, traced: bool = False):
        t0 = time.perf_counter()
        ranks, iters, reads, step_ms = self.job()
        host_ms = (time.perf_counter() - t0) * 1e3
        self.sets.append({"host_ms": host_ms, "iterations": iters,
                          "reads": reads, "step_ms": step_ms,
                          "traced": traced})
        if s in self.sample_at:
            self.samples.append((s, ranks))
        self.last = (s, ranks)

    def warm(self):
        for _ in range(int(self.cell.traffic["warm_sets"])):
            self.job()
        synchronize(self.device)

    @property
    def traced_products(self) -> int:
        every = int(self.cell.traffic["solver_args"]["check_every"])
        return sum(s["reads"] * every for s in self.sets if s["traced"])

    def check(self, csr: dict):
        """({"rank_err": the largest L1 distance sum_v |pr_v - pr_ref,v|
        over the samples, "iteration_gap": the largest |iterations -
        maxiter| over all jobs}, samples or jobs past a limit)."""
        t, limit = self.cell.traffic, self.cell.limits
        maxiter = int(t["solver_args"]["maxiter"])
        want = reference_pagerank.pagerank(csr, float(t["damping"]), maxiter)
        errs = [float((ranks.double() - want).abs().sum())
                for _, ranks in self.samples]
        errs = [e if e == e else float("inf") for e in errs]   # NaN: worst
        gaps = [abs(st["iterations"] - maxiter) for st in self.sets]
        numbers = {"rank_err": max(errs, default=float("inf")),
                   "iteration_gap": max(gaps, default=float("inf"))}
        failed = sum(not e <= limit["rank_err"] for e in errs) + \
            sum(not g <= limit["iteration_gap"] for g in gaps)
        return numbers, failed
