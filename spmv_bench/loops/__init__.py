"""The timed loops, one module a loop, found by the name a traffic mix's
``loop`` gives.  Each module has a ``Loop(system, op, cell)`` with
``warm()``, ``run(seconds, trace)``, ``attempted``, ``end_to_end()``
(the values its window gives, by metric name), ``release()``
(drops the program's state, keeping the samples) and ``check(csr)``
(the numbers compared, by name, and how many answers failed a limit).
``cell`` is the run's ``Cell`` (run.py).
"""

from __future__ import annotations

import math
import time

import torch

from spmv_bench.generators import derive_seed
from spmv_bench.trace import profiled


def synchronize(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def sample_positions(seed: int, stream: str, count: int, below: int):
    """``count`` positions drawn from the seed in [1, below), and 0."""
    gen = torch.Generator().manual_seed(derive_seed(seed, stream))
    drawn = torch.randint(1, max(below, 2), (count,), generator=gen)
    return {0} | set(drawn.tolist())


def nearest_rank(values, q: float) -> float:
    """The q-quantile of ``values`` by the nearest-rank rule."""
    ordered = sorted(values)
    return ordered[max(math.ceil(q * len(ordered)) - 1, 0)]


class TracedOnce:
    """Starts the traced sub-window once ``after_s`` of the window has
    passed: ``due()`` says when, ``take(body, device)`` traces it."""

    def __init__(self, enabled: bool, after_s: float, t0: float):
        self.pending = enabled
        self.after_s = after_s
        self.trace = None
        self.t0 = t0

    def due(self) -> bool:
        return self.pending and time.perf_counter() - self.t0 >= self.after_s

    def take(self, body, device):
        self.pending = False
        self.trace = profiled(body, device)
