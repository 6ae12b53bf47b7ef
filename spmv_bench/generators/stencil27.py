"""HPCG's matrix: the 27-point stencil on an nx x ny x nz grid.

Row (iz, iy, ix) = iz*ny*nx + iy*nx + ix holds a nonzero for every
neighbour (the point itself included) inside the grid: ``diagonal`` on
the diagonal and ``off_diagonal`` elsewhere, in increasing column order,
as HPCG's GenerateProblem builds it.  It does not depend on the seed.

params: ``nx``, ``ny``, ``nz``, ``diagonal``, ``off_diagonal``.
"""

from __future__ import annotations

import itertools

import torch


def generate(params: dict, seed: int, device) -> dict:
    nx, ny, nz = (int(params[k]) for k in ("nx", "ny", "nz"))
    n = nx * ny * nz
    idx = torch.arange(n, dtype=torch.int64, device=device)
    ix, iy, iz = idx % nx, (idx // nx) % ny, idx // (nx * ny)
    offsets = list(itertools.product((-1, 0, 1), repeat=3))   # (dz, dy, dx)
    cols = torch.empty((n, len(offsets)), dtype=torch.int64, device=device)
    valid = torch.empty((n, len(offsets)), dtype=torch.bool, device=device)
    vals = torch.empty((n, len(offsets)), dtype=torch.float64,
                       device=device)
    for j, (dz, dy, dx) in enumerate(offsets):
        cols[:, j] = idx + dz * nx * ny + dy * nx + dx
        valid[:, j] = ((ix + dx >= 0) & (ix + dx < nx) & (iy + dy >= 0)
                       & (iy + dy < ny) & (iz + dz >= 0) & (iz + dz < nz))
        vals[:, j] = float(params["diagonal"] if (dz, dy, dx) == (0, 0, 0)
                           else params["off_diagonal"])
    counts = valid.sum(1)
    row_offsets = torch.zeros(n + 1, dtype=torch.int64, device=device)
    torch.cumsum(counts, 0, out=row_offsets[1:])
    return {"num_rows": n, "num_cols": n, "row_offsets": row_offsets,
            "col_indices": cols[valid].to(torch.int32),
            "values": vals[valid]}
