"""FastRP's plain reference for the benchmark: plain PyTorch over the
adjacency CSR that the generator makes, nothing of the package under
test.

P = D^-1 A from the row sums of the values (an empty row stays empty);
N_1 = P R, N_i = P n(N_{i-1}) and E = sum_i w_i n(N_i), n the L2
normalisation of each row (a row of norm 0 stays 0), as Neo4j Graph Data
Science's ``gds.fastRP`` computes FastRP (Chen et al., CIKM 2019,
Algorithm 1, with each N_i normalised before it is weighted and
propagated, and normalisation strength 0).  The products are
``reference.product``'s blocks of at most 2^24 gathered elements.

``dtype`` is the precision every step computes in: float64 for the
reference, bfloat16 for the control under a float32 configuration.
"""

from __future__ import annotations

import torch

from spmv_bench import reference


def transition(csr: dict, dtype=torch.float64) -> dict:
    """The CSR of P = D^-1 A, its values in ``dtype``."""
    offsets = csr["row_offsets"]
    rows = torch.repeat_interleave(
        torch.arange(csr["num_rows"], device=offsets.device),
        offsets[1:] - offsets[:-1])
    values = csr["values"].to(dtype)
    sums = torch.zeros(csr["num_rows"], dtype=dtype, device=values.device)
    sums.index_add_(0, rows, values)
    return dict(csr, values=values / sums[rows])


def normalize_rows_(n):
    """Each row of ``n`` over its L2 norm, in place; a zero row stays 0."""
    norms = torch.linalg.vector_norm(n, dim=1, keepdim=True)
    return n.div_(torch.where(norms > 0, norms, torch.ones_like(norms)))


def fastrp(csr: dict, r, iteration_weights, dtype=torch.float64):
    """E for the adjacency CSR and projection ``r`` [num_cols, d], every
    step in ``dtype``; returns E in ``dtype``."""
    p = transition(csr, dtype)
    x = r.to(dtype)
    emb = None
    for w in iteration_weights:
        x = normalize_rows_(reference.product(p, x, dtype))
        if emb is None:
            emb = x * float(w)
        else:
            emb.add_(x, alpha=float(w))
    return emb
