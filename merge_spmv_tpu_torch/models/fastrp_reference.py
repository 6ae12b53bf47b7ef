"""FastRP in plain PyTorch: the reference that ``models/solvers.py::fastrp``
is held to.

It imports only ``torch``: no kernel, operator or plan of the port.  It
works over the adjacency CSR itself (``row_offsets`` [num_rows + 1],
``col_indices``, ``values``), never densely:

* P = D^-1 A from the row sums of the values, an empty row left empty;
* each product P X by ``index_add_`` over blocks of nonzeros;
* n, the L2 normalisation of each row (a row of norm 0 stays 0), and the
  weighted sum E = sum_i w_i n(N_i), with N_1 = P R and
  N_i = P n(N_{i-1}).

Departures from Chen et al., "Fast and Accurate Network Embeddings via
Very Sparse Random Projection" (CIKM 2019), Algorithm 1, as Neo4j Graph
Data Science's ``gds.fastRP`` runs it:

* normalisation: each N_i is L2-normalised by rows, and the normalised
  one is both weighted into E and propagated further; Algorithm 1
  propagates and sums the N_i as they come;
* beta = 0 (GDS's ``normalizationStrength``): R is not scaled by
  degree, where Algorithm 1 takes P L R with L = D^beta.

Every step computes in ``dtype``: float64 for the reference, a lower
precision (bfloat16) for a control that a sound comparison must reject.
"""

from __future__ import annotations

import torch

# the most gathered elements (nonzeros x columns) one block of a product
# holds
BLOCK = 1 << 24


def transition_values(row_offsets, values, dtype=torch.float64):
    """The values of P = D^-1 A in ``dtype``: each value over its row's
    sum of values."""
    offsets = torch.as_tensor(row_offsets).long()
    lengths = offsets[1:] - offsets[:-1]
    rows = torch.repeat_interleave(
        torch.arange(lengths.numel(), device=offsets.device), lengths)
    vals = torch.as_tensor(values, device=offsets.device).to(dtype)
    sums = torch.zeros(lengths.numel(), dtype=dtype, device=offsets.device)
    sums.index_add_(0, rows, vals)
    return vals / sums[rows]


def product(row_offsets, col_indices, p_values, x):
    """P x for x [num_cols, d], summed by rows in x's dtype, a block of at
    most ``BLOCK`` gathered elements at a time."""
    offsets = torch.as_tensor(row_offsets).long()
    cols = torch.as_tensor(col_indices, device=offsets.device).long()
    nnz = int(offsets[-1])
    out = torch.zeros((offsets.numel() - 1, x.shape[1]), dtype=x.dtype,
                      device=x.device)
    block = max(BLOCK // max(x.shape[1], 1), 1)
    for start in range(0, nnz, block):
        stop = min(start + block, nnz)
        pos = torch.arange(start, stop, device=offsets.device)
        rows = torch.searchsorted(offsets, pos, right=True) - 1
        out.index_add_(0, rows,
                       p_values[start:stop, None] * x[cols[start:stop]])
    return out


def normalize_rows(n):
    """n with each row divided by its L2 norm; a row of norm 0 stays 0."""
    norms = torch.sqrt(torch.sum(n * n, dim=1, keepdim=True))
    return n / torch.where(norms > 0, norms, torch.ones_like(norms))


def fastrp(row_offsets, col_indices, values, r,
           iteration_weights=(0.0, 1.0, 1.0), dtype=torch.float64):
    """E = sum_i w_i n(N_i) for the adjacency CSR and projection ``r``
    [num_cols, d], every step in ``dtype``; returns E in ``dtype``."""
    p_values = transition_values(row_offsets, values, dtype)
    x = torch.as_tensor(r).to(dtype)
    emb = None
    for w in iteration_weights:
        x = normalize_rows(product(row_offsets, col_indices, p_values, x))
        emb = w * x if emb is None else emb + w * x
    return emb
