"""HPCG's timed sets: preconditioned CG run back to back by one
closed-loop caller, as ``cg_sets`` runs CG: each set is ``solver(op, b,
**solver_args)`` from x0 = 0 with ``preconditioner`` in ``solver_args``,
b = pool[s mod ``rhs_pool``], the set's host-clock time its own.  A
traced set asks for 1 + reads x ``check_every`` products and as many
V-cycles (the prologue's and one a step, masked steps included:
``traced_vcycles``).

After the window, untimed and before ``release``, the loop runs one short
set of 1, 2 and 3 iterations (``precond_iters``) from b = pool[0] and
keeps each x.  The check holds every kept x to ``reference_hpcg.py`` (its
own hierarchy, float64): the window's samples after the set's
``maxiter`` iterations (``solution_err``), the short sets after theirs
(``precond_err``: a 50-iteration PCG converges to rounding whatever
V-cycle it runs, an iterate after 1 to 3 does not), and every set's
iteration count (``iteration_gap``).  The reference runs once for each
pool index it needs.

traffic keys: those of ``cg_sets``, and ``precond_iters``.
"""

from __future__ import annotations

from spmv_bench import reference, reference_hpcg
from spmv_bench.loops import cg_sets, synchronize


class Loop(cg_sets.Loop):
    def __init__(self, system, op, cell):
        super().__init__(system, op, cell)
        self.short = []     # (iterations asked, iterations done, x)

    @property
    def traced_vcycles(self) -> int:
        return self.traced_products

    def release(self):
        """The short sets, then the program's state dropped."""
        t = self.cell.traffic
        for m in t["precond_iters"]:
            x, iters, _, _ = self.system.solve(
                t["solver"], self.op, self.pool[0],
                **dict(t["solver_args"], maxiter=int(m)))
            self.short.append((int(m), iters, x))
        synchronize(self.device)
        super().release()

    def check(self, csr: dict):
        """({"solution_err", "precond_err", "iteration_gap"}, samples,
        short sets or sets past a limit).  The reference draws the pool
        again."""
        t, limit = self.cell.traffic, self.cell.limits
        maxiter = int(t["solver_args"]["maxiter"])
        pool = cg_sets.rhs_pool(self.cell, self.device)
        levels = reference_hpcg.hierarchy(csr, self.cell.config)
        runs: dict = {}

        def iterates(i: int, upto: int):
            if i not in runs or len(runs[i]) < upto:
                runs[i] = reference_hpcg.pcg(levels, pool[i], upto)
            return runs[i]

        errs = [reference.relative_error(
            x, iterates(s % len(pool), maxiter)[-1])
            for s, x in self.samples]
        short = max((m for m, _, _ in self.short), default=0)
        pre = [reference.relative_error(x, iterates(0, short)[m - 1])
               for m, _, x in self.short]
        gaps = [abs(st["iterations"] - maxiter) for st in self.sets] + \
            [abs(done - m) for m, done, _ in self.short]
        numbers = {"solution_err": max(errs, default=float("inf")),
                   "precond_err": max(pre, default=float("inf")),
                   "iteration_gap": max(gaps, default=float("inf"))}
        failed = sum(not e <= limit["solution_err"] for e in errs) + \
            sum(not e <= limit["precond_err"] for e in pre) + \
            sum(not g <= limit["iteration_gap"] for g in gaps)
        return numbers, failed
