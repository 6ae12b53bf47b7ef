"""R-MAT (Graph500 Kronecker) matrix on the card, from the seed.

Each nonzero picks one of the four quadrants at each of ``scale`` levels,
with probabilities a, b, c and 1 - a - b - c (rows from quadrants c and
d take the level's bit, columns from b and d); duplicates are kept as
distinct nonzeros.  As the Graph500 generator does, the vertex ids are
then relabelled by a permutation drawn from the seed, the same for rows
and columns, so that the hottest vertices (ids with few bits set) do not
sit side by side in x.  The entries are sorted by (row, column) and their
values drawn uniform in ``values`` after the sort, so the CSR depends on
the seed alone.

params: ``scale`` (rows = columns = 2**scale), ``nnz``, ``a``, ``b``,
``c``, ``values`` ([low, high]).
"""

from __future__ import annotations

import torch

from spmv_bench.generators import generator, offsets_from_rows, uniform


def generate(params: dict, seed: int, device) -> dict:
    scale, nnz = int(params["scale"]), int(params["nnz"])
    a, b, c = float(params["a"]), float(params["b"]), float(params["c"])
    n = 1 << scale
    gen = generator(seed, "rmat.structure", device)
    keys = torch.zeros(nnz, dtype=torch.int64, device=device)
    for level in range(scale):
        r = torch.rand(nnz, generator=gen, device=device)
        row_bit = r >= a + b
        col_bit = ((r >= a) & (r < a + b)) | (r >= a + b + c)
        keys |= row_bit.to(torch.int64) << (scale + level)
        keys |= col_bit.to(torch.int64) << level
        del r, row_bit, col_bit
    perm = torch.randperm(n, generator=generator(seed, "rmat.labels",
                                                 device), device=device)
    keys = (perm[keys >> scale] << scale) | perm[keys & (n - 1)]
    del perm
    keys = torch.sort(keys).values
    rows = keys >> scale
    cols = (keys & (n - 1)).to(torch.int32)
    del keys
    offsets = offsets_from_rows(rows, n)
    del rows
    low, high = params["values"]
    values = uniform(nnz, low, high, generator(seed, "rmat.values", device),
                     device)
    return {"num_rows": n, "num_cols": n, "row_offsets": offsets,
            "col_indices": cols, "values": values}
