"""Matrix generators, one module a generator, found by the name a
configuration's ``generator`` gives.  Each has ``generate(params, seed,
device)`` returning a ``dict`` of the CSR on ``device``: ``num_rows``,
``num_cols``, ``row_offsets`` (int64, [num_rows + 1]), ``col_indices``
(int32) and ``values`` (float64), drawn with ``torch`` from the seed.
"""

from __future__ import annotations

import hashlib

import torch


def derive_seed(seed: int, stream: str) -> int:
    """A seed for one named stream of draws of run seed ``seed``: any
    whole number gives a seed a ``torch.Generator`` takes."""
    digest = hashlib.sha256(f"{int(seed)}:{stream}".encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 1


def generator(seed: int, stream: str, device) -> torch.Generator:
    """A ``torch.Generator`` on ``device`` seeded for ``stream``."""
    gen = torch.Generator(device=torch.device(device))
    gen.manual_seed(derive_seed(seed, stream))
    return gen


def uniform(n, low: float, high: float, gen: torch.Generator, device,
            dtype=torch.float64):
    """n values uniform in [low, high) from ``gen``; ``n`` an int or a
    shape."""
    shape = (n,) if isinstance(n, int) else tuple(n)
    u = torch.rand(shape, generator=gen, device=device, dtype=dtype)
    return u.mul_(high - low).add_(low)


def offsets_from_rows(rows: torch.Tensor, num_rows: int) -> torch.Tensor:
    """Row offsets [num_rows + 1] (int64) of sorted row ids."""
    counts = torch.bincount(rows, minlength=num_rows)
    offsets = torch.zeros(num_rows + 1, dtype=torch.int64,
                          device=rows.device)
    torch.cumsum(counts, 0, out=offsets[1:])
    return offsets
