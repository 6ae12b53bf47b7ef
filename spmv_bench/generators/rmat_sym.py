"""The symmetric R-MAT (Graph500 Kronecker) graph on the card, from the
seed: ``edges`` edges drawn as ``rmat.py`` draws its nonzeros (the same
streams, the same Graph500 relabelling), each edge (u, v) mirrored to
(v, u), sorted by (row, column), every value 1.0.  Duplicates and
self-loops are kept, so a self-loop is stored twice and the matrix has
2 x ``edges`` nonzeros.

params: ``scale`` (rows = columns = 2**scale), ``edges``, ``a``, ``b``,
``c``.
"""

from __future__ import annotations

import torch

from spmv_bench.generators import offsets_from_rows, rmat


def generate(params: dict, seed: int, device) -> dict:
    scale = int(params["scale"])
    n = 1 << scale
    half = rmat.generate({"scale": scale, "nnz": int(params["edges"]),
                          "a": params["a"], "b": params["b"],
                          "c": params["c"], "values": [1.0, 1.0]},
                         seed, device)
    offsets = half["row_offsets"]
    u = torch.repeat_interleave(torch.arange(n, device=device),
                                offsets[1:] - offsets[:-1])
    v = half["col_indices"].to(torch.int64)
    del half
    keys = torch.cat([(u << scale) | v, (v << scale) | u])
    del u, v
    keys = torch.sort(keys).values
    rows = keys >> scale
    cols = (keys & (n - 1)).to(torch.int32)
    del keys
    offsets = offsets_from_rows(rows, n)
    del rows
    return {"num_rows": n, "num_cols": n, "row_offsets": offsets,
            "col_indices": cols,
            "values": torch.ones(cols.numel(), dtype=torch.float64,
                                 device=device)}
