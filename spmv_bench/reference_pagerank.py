"""PageRank's plain reference for the benchmark: plain PyTorch over the
link graph's CSR that the generator makes (row u holds u's out-links),
nothing of the package under test and never the program's P.

LDBC Graphalytics' PageRank (the Graphalytics specification, "PageRank"):
PR_0(v) = 1 / |V|, then for a fixed number of iterations

    PR_i(v) = (1 - d) / |V| + d sum_{u in N_in(v)} PR_{i-1}(u) / |N_out(u)|
              + (d / |V|) sum_{w dangling} PR_{i-1}(w)

The product is ``index_add_`` of PR(u) / |N_out(u)| into each out-link's
head, ``reference.BLOCK`` nonzeros at a time; the dangling term is the
explicit sum over the vertices with no out-link.  Each stored nonzero is
one link (the generated graphs have no duplicate); the values are not
read.

``dtype`` is the precision every step computes in: float64 for the
reference, float32 for the control under the float64 configuration.
"""

from __future__ import annotations

import torch

from spmv_bench import reference


def pagerank(csr: dict, damping: float, iterations: int,
             dtype=torch.float64) -> torch.Tensor:
    """PR after ``iterations`` steps from 1 / |V| in ``dtype``, returned
    in float64."""
    offsets = csr["row_offsets"]
    cols = csr["col_indices"]
    n = csr["num_rows"]
    nnz = int(offsets[-1])
    out_degree = reference.row_lengths(csr).to(dtype)
    dangling = out_degree == 0
    share = torch.where(dangling, torch.zeros_like(out_degree),
                        1.0 / torch.where(dangling, 1.0, out_degree))
    pr = torch.full((n,), 1.0 / n, dtype=dtype, device=offsets.device)
    block = reference.block_nonzeros(1)
    for _ in range(int(iterations)):
        spread = pr * share
        new = torch.zeros_like(pr)
        for start in range(0, nnz, block):
            stop = min(start + block, nnz)
            pos = torch.arange(start, stop, device=offsets.device)
            rows = torch.searchsorted(offsets, pos, right=True) - 1
            new.index_add_(0, cols[start:stop].long(), spread[rows])
        lost = torch.sum(pr[dangling])
        pr = (1.0 - damping) / n + damping * new + (damping / n) * lost
    return pr.double()
