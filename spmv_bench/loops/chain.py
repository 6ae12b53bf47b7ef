"""The dependent chain x <- op(x, b, alpha, beta) (``k`` = 1), or
X <- op.mm(X, B, alpha, beta) for k right-hand sides, sent back to back
by one closed-loop caller that never waits for a call.

alpha = ``alpha_scale`` / max_r sum_j |a_rj|, worked out by the benchmark
from its own arrays, so that with beta = 1 the chain is PageRank's affine
iteration and x stays O(1).  x0 and b are uniform(-1, 1) from the seed,
in the configuration's dtype.
The host runs at most ``lag_batches`` batches of ``batch_calls`` calls
ahead of the device (an event a batch), so the window's end finds a short
queue.  The window ends in a synchronise; the rate is every call's
operations over the whole window.  The traced sub-window asks for
``trace_calls`` products (``traced_products``).

Calls at positions drawn from the seed (``samples`` of them below
``sample_below``), call 0 and the window's last call keep their input and
output (references: a call makes a new output and changes neither), and
the reference recomputes each from its input.

traffic keys: ``k``, ``alpha_scale``, ``beta``, ``batch_calls``,
``lag_batches``, ``warm_calls``, ``samples``, ``sample_below``,
``trace_after_s``, ``trace_calls``, ``rate_metric``.
"""

from __future__ import annotations

import collections
import time

import torch

from spmv_bench import reference
from spmv_bench.generators import generator, uniform
from spmv_bench.loops import TracedOnce, sample_positions, synchronize


def vectors(cell, shape):
    """(b, x0), drawn from the seed in float64 and handed over in the
    configuration's dtype."""
    gen = generator(cell.seed, "chain.vectors", cell.device)
    dtype = getattr(torch, cell.problem["dtype"])
    return [uniform(shape, -1.0, 1.0, gen, cell.device).to(dtype)
            for _ in range(2)]


class Loop:
    def __init__(self, system, op, cell):
        t = cell.traffic
        self.op, self.cell, self.device = op, cell, cell.device
        self.k = int(t["k"])
        shape = (cell.problem["num_rows"],) if self.k == 1 else \
            (cell.problem["num_rows"], self.k)
        self.b, self.x0 = vectors(cell, shape)
        self.alpha = float(t["alpha_scale"]) / cell.problem["max_row_abs_sum"]
        self.beta = float(t["beta"])
        self.sample_at = sample_positions(cell.seed, "chain.samples",
                                          int(t["samples"]),
                                          int(t["sample_below"]))
        self.samples = []           # (position, x_in, y)
        self.calls = 0
        self.traced_products = 0
        self.wall_s = 0.0
        self.trace = None

    def call(self, x):
        if self.k == 1:
            return self.op(x, self.b, self.alpha, self.beta)
        return self.op.mm(x, self.b, self.alpha, self.beta)

    def warm(self):
        x = self.x0
        for _ in range(int(self.cell.traffic["warm_calls"])):
            x = self.call(x)
        synchronize(self.device)

    def _launch(self, x, n: int):
        for _ in range(n):
            y = self.call(x)
            if self.calls in self.sample_at:
                self.samples.append((self.calls, x, y))
            self.last = (self.calls, x, y)
            x = y
            self.calls += 1
        return x

    def run(self, seconds: float, trace: bool):
        t = self.cell.traffic
        cuda = torch.device(self.device).type == "cuda"
        batch, lag = int(t["batch_calls"]), int(t["lag_batches"])
        t0 = time.perf_counter()
        traced = TracedOnce(trace, float(t["trace_after_s"]), t0)
        pending = collections.deque()
        x = self.x0
        while time.perf_counter() - t0 < seconds:
            if traced.due():
                box = [x]

                def body():
                    box[0] = self._launch(box[0], int(t["trace_calls"]))
                traced.take(body, self.device)
                self.traced_products = int(t["trace_calls"])
                x = box[0]
                continue
            x = self._launch(x, batch)
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
        rate = 2.0 * nnz * self.k * self.calls / self.wall_s / 1e9
        return {self.cell.traffic["rate_metric"]: rate}

    @property
    def attempted(self) -> int:
        return self.calls

    def release(self):
        self.op = None
        self.last = None
        self.b = self.x0 = None

    def check(self, csr: dict):
        """({"product_err": the worst over the samples}, samples past the
        limit).  The reference works out alpha and b again from the
        seed."""
        t = self.cell.traffic
        shape = (csr["num_rows"],) if self.k == 1 else \
            (csr["num_rows"], self.k)
        b, _ = vectors(self.cell, shape)
        alpha = float(t["alpha_scale"]) / reference.max_row_abs_sum(csr)
        limit = self.cell.limits["product_err"]
        unit = reference.unit_roundoff(self.cell.problem["dtype"])
        errs = [reference.product_error(
                    csr, y, x_in, b, alpha, self.beta,
                    reference.affine(csr, x_in, b, alpha, self.beta), unit)
                for _, x_in, y in self.samples]
        worst = max(errs, default=float("inf"))
        return {"product_err": worst}, sum(not e <= limit for e in errs)
