"""A Graph500 Kronecker graph as LDBC Graphalytics' graph500 datasets make
it, on the card, from the seed: edgefactor x 2^scale edges drawn as
``rmat.py`` draws its nonzeros (the same streams, the same Graph500
relabelling of the vertex ids), then, as Graphalytics' conversion does,
self-loops dropped, each edge mirrored (the graph is undirected), duplicate
edges dropped, and the vertices left with no edge dropped, the others
numbered again in their order.  Sorted by (row, column), every value 1.0:
row u holds u's neighbours, so every row has at least one and the
matrix is symmetric.

params: ``scale``, ``edgefactor``, ``a``, ``b``, ``c``.
"""

from __future__ import annotations

import torch

from spmv_bench.generators import offsets_from_rows, rmat


def generate(params: dict, seed: int, device) -> dict:
    scale = int(params["scale"])
    n = 1 << scale
    drawn = rmat.generate({"scale": scale,
                           "nnz": int(params["edgefactor"]) << scale,
                           "a": params["a"], "b": params["b"],
                           "c": params["c"], "values": [1.0, 1.0]},
                          seed, device)
    offsets = drawn["row_offsets"]
    u = torch.repeat_interleave(torch.arange(n, device=device),
                                offsets[1:] - offsets[:-1])
    v = drawn["col_indices"].to(torch.int64)
    del drawn, offsets
    loop = u == v
    u, v = u[~loop], v[~loop]
    del loop
    keys = torch.cat([(u << scale) | v, (v << scale) | u])
    del u, v
    keys = torch.sort(keys).values
    keep = torch.ones_like(keys, dtype=torch.bool)
    keep[1:] = keys[1:] != keys[:-1]
    keys = keys[keep]
    del keep
    rows = keys >> scale
    cols = keys & (n - 1)
    del keys
    present = torch.bincount(rows, minlength=n) > 0
    label = torch.cumsum(present, 0) - 1
    num = int(present.sum())
    del present
    rows = label[rows]
    cols = label[cols].to(torch.int32)
    del label
    row_offsets = offsets_from_rows(rows, num)
    del rows
    return {"num_rows": num, "num_cols": num, "row_offsets": row_offsets,
            "col_indices": cols,
            "values": torch.ones(cols.numel(), dtype=torch.float64,
                                 device=device)}
