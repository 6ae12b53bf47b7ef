"""FastRP embeddings back to back: call i is ``solver(op, R, **solver_args)``
with R = pool[i mod ``projection_pool``], by one closed-loop caller that
records an event a call and waits for the oldest only when more than
``lag_calls`` calls are in flight.  ``op`` applies P = D^-1 A, and a call
makes one product P X of ``k`` columns a weight of
``solver_args["iteration_weights"]``, as the program counts them
(``info.iterations``).

The pool holds FastRP's very sparse projections, drawn from the seed in
the configuration's dtype: each entry +sqrt(s) or -sqrt(s) with
probability 1 / (2 s), else 0, s = ``SPARSITY``.  The window ends in a
synchronise; the rate is 2 nnz ``k`` operations a product over the whole
window.  The traced sub-window runs ``trace_calls`` calls and asks for
their products (``traced_products``); ``beta`` (0: a product adds no
Y_in) tells the roofline so.

Calls at positions drawn from the seed (``samples`` of them below
``sample_below``), call 0 and the window's last call keep E and their
pool index; the reference (``reference_fastrp.py``, float64) computes E
again from the same projection, once for each pool index sampled.

traffic keys: ``solver``, ``solver_args``, ``k``, ``beta``,
``projection_pool``, ``lag_calls``, ``warm_calls``, ``samples``,
``sample_below``, ``trace_after_s``, ``trace_calls``, ``rate_metric``.
"""

from __future__ import annotations

import collections
import sys
import time

import torch

from spmv_bench import reference, reference_fastrp
from spmv_bench.generators import generator
from spmv_bench.loops import TracedOnce, sample_positions, synchronize

SPARSITY = 3


def projections(cell, device):
    """The pool of projections [num_cols, k], from the seed."""
    gen = generator(cell.seed, "fastrp.projections", device)
    shape = (cell.problem["num_cols"], int(cell.traffic["k"]))
    dtype = getattr(torch, cell.problem["dtype"])
    root, p = SPARSITY ** 0.5, 1.0 / (2 * SPARSITY)
    pool = []
    for _ in range(int(cell.traffic["projection_pool"])):
        u = torch.rand(shape, generator=gen, device=device)
        pool.append(torch.where(u < p, root, torch.where(
            u >= 1.0 - p, -root, 0.0)).to(dtype))
        del u
    return pool


class Loop:
    def __init__(self, system, op, cell):
        t = cell.traffic
        self.system, self.op, self.cell = system, op, cell
        self.device = cell.device
        self.pool = projections(cell, cell.device)
        self.sample_at = sample_positions(cell.seed, "fastrp.samples",
                                          int(t["samples"]),
                                          int(t["sample_below"]))
        self.samples = []       # (position, pool index, E)
        self.calls = 0
        self.products = 0
        self.traced_products = 0
        self.wall_s = 0.0
        self.trace = None

    def call(self, traced: bool = False):
        t = self.cell.traffic
        i = self.calls % len(self.pool)
        emb, products, _, _ = self.system.solve(
            t["solver"], self.op, self.pool[i], **t["solver_args"])
        if self.calls in self.sample_at:
            self.samples.append((self.calls, i, emb))
        self.last = (self.calls, i, emb)
        self.calls += 1
        self.products += products
        if traced:
            self.traced_products += products

    def warm(self):
        t = self.cell.traffic
        for i in range(int(t["warm_calls"])):
            self.system.solve(t["solver"], self.op,
                              self.pool[i % len(self.pool)],
                              **t["solver_args"])
        synchronize(self.device)

    def run(self, seconds: float, trace: bool):
        t = self.cell.traffic
        cuda = torch.device(self.device).type == "cuda"
        lag = int(t["lag_calls"])
        t0 = time.perf_counter()
        traced = TracedOnce(trace, float(t["trace_after_s"]), t0)
        pending = collections.deque()
        while time.perf_counter() - t0 < seconds:
            if traced.due():
                def body():
                    for _ in range(int(t["trace_calls"])):
                        self.call(traced=True)
                traced.take(body, self.device)
                continue
            self.call()
            if cuda:
                event = torch.cuda.Event()
                event.record()
                pending.append(event)
                if len(pending) > lag:
                    pending.popleft().synchronize()
        synchronize(self.device)
        self.wall_s = time.perf_counter() - t0
        self.trace = traced.trace
        if self.calls and self.last[0] not in self.sample_at:
            self.samples.append(self.last)

    def end_to_end(self) -> dict:
        nnz = self.cell.problem["nnz"]
        k = int(self.cell.traffic["k"])
        rate = 2.0 * nnz * k * self.products / self.wall_s / 1e9
        return {self.cell.traffic["rate_metric"]: rate}

    @property
    def attempted(self) -> int:
        return self.calls

    def release(self):
        self.op = None
        self.last = None
        self.pool = None

    def check(self, csr: dict):
        """({"embedding_err": the worst |E - E_ref| over every entry of the
        samples}, samples past the limit).  The pool is drawn again from
        the seed; the worst entry's row and its degree go to standard
        error."""
        weights = self.cell.traffic["solver_args"]["iteration_weights"]
        limit = self.cell.limits["embedding_err"]
        pool = projections(self.cell, self.device)
        degrees = reference.row_lengths(csr)
        worst, where, failed = -1.0, None, 0
        for i in sorted({i for _, i, _ in self.samples}):
            want = reference_fastrp.fastrp(csr, pool[i], weights)
            for position, j, emb in self.samples:
                if j != i:
                    continue
                diff = (emb.double() - want).abs()
                if bool(torch.isfinite(emb).all()):
                    err = float(diff.max())
                    row = int(diff.max(dim=1).values.argmax())
                else:
                    err, row = float("inf"), -1
                failed += not err <= limit
                if err > worst:
                    worst, where = err, (position, row)
            del want
        if where is None:
            return {"embedding_err": float("inf")}, failed
        position, row = where
        degree = int(degrees[row]) if row >= 0 else -1
        print(f"embedding_err {worst!r}: call {position}, row {row}, "
              f"degree {degree}", file=sys.stderr)
        return {"embedding_err": worst}, failed
