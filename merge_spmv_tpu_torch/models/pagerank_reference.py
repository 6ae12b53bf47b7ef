"""PageRank in plain PyTorch: the reference that ``models/solvers.py::pagerank``
over ``ops/operator.py::pagerank_operator`` is held to.

It imports only ``torch``: no kernel, operator or plan of the port.  It
works over the link graph's CSR itself (``row_offsets`` [num_rows + 1],
``col_indices``; row u holds u's out-links), never densely and never
through the program's P, and follows LDBC Graphalytics' definition of
PageRank (the Graphalytics specification, "PageRank"):

    PR_0(v) = 1 / |V|
    PR_i(v) = (1 - d) / |V| + d sum_{u in N_in(v)} PR_{i-1}(u) / |N_out(u)|
              + (d / |V|) sum_{w dangling} PR_{i-1}(w)

for a fixed number of iterations, with no tolerance.  The product is
``index_add_`` of PR(u) / |N_out(u)| into each out-link's head, over
blocks of nonzeros; the dangling term is the explicit sum over the
vertices with no out-link, not the program's ``(1 - sum(P pr)) / n``.

Departures from the specification:

* each stored nonzero is one link, so a duplicate edge counts as many
  times as it is stored and a self-loop as a link to itself (Graphalytics'
  datasets have neither; the program scales by the sum of a row's values,
  which equals this count for a 0/1 graph); the values are not read;
* every step computes in ``dtype``: float64 for the reference, float32 for
  a control that a sound comparison must reject.
"""

from __future__ import annotations

import torch

# the most nonzeros one block of a product gathers
BLOCK = 1 << 24


def pagerank(row_offsets, col_indices, damping: float = 0.85,
             iterations: int = 10, dtype=torch.float64):
    """PR after ``iterations`` steps from 1 / |V|, every step in
    ``dtype``; returns PR in ``dtype``."""
    offsets = torch.as_tensor(row_offsets).long()
    cols = torch.as_tensor(col_indices, device=offsets.device).long()
    n = offsets.numel() - 1
    nnz = int(offsets[-1])
    out_degree = (offsets[1:] - offsets[:-1]).to(dtype)
    dangling = out_degree == 0
    share = torch.where(dangling, torch.zeros_like(out_degree),
                        1.0 / torch.where(dangling, 1.0, out_degree))
    pr = torch.full((n,), 1.0 / n, dtype=dtype, device=offsets.device)
    for _ in range(int(iterations)):
        spread = pr * share
        new = torch.zeros_like(pr)
        for start in range(0, nnz, BLOCK):
            stop = min(start + BLOCK, nnz)
            pos = torch.arange(start, stop, device=offsets.device)
            rows = torch.searchsorted(offsets, pos, right=True) - 1
            new.index_add_(0, cols[start:stop], spread[rows])
        lost = torch.sum(pr[dangling])
        pr = (1.0 - damping) / n + damping * new + (damping / n) * lost
    return pr
