"""The plain reference of HPCG's preconditioned CG: plain torch, with its
own hierarchy built from the grid, for the tests that hold
models/multigrid.py and ``conjugate_gradient(..., preconditioner=
"multigrid")`` to it.

Written from HPCG's reference code (https://github.com/hpcg-benchmark/hpcg):
src/GenerateProblem_ref.cpp (the 27-point stencil, 26 on the diagonal and
-1 off it), src/GenerateCoarseProblem.cpp (level l the stencil on the
(n / 2^l)^3 grid, f2c coarse (i, j, k) -> fine (2i, 2j, 2k), 4 levels),
src/ComputeSYMGS_ref.cpp, src/ComputeMG_ref.cpp and src/CG.cpp.  Its
departures, each also the program's:

* the sweep runs in colour order (colour (ix mod 2) + 2 (iy mod 2) +
  4 (iz mod 2), forward 7 to 0, backward 0 to 7: colour 0, the points
  f2c injects from, is not the last a sweep updates, which would leave
  the injected residual 0), not row order, with each row's update
  x_i + (r_i - (A x)_i) / a_ii;
* CG applies M in its prologue and after each step's update (51 V-cycles
  for 50 iterations, where HPCG's loop applies it at the top of each of
  its 50), with alpha = r.z / p.Ap and p = z + beta p as there;
* b is the caller's (HPCG sets b = A 1).

It imports nothing of the port: no kernel, no operator, no generator.
Products are index_add_ over each row's nonzeros in the vectors' dtype
(float64, or the input's for a lower-precision run).  No matrix product
runs, so TF32 never applies; ``pcg`` still turns it off while it runs.
"""

from __future__ import annotations

import contextlib
import itertools

import torch

__all__ = ["Level", "hierarchy", "colour_step", "symgs", "vcycle", "pcg",
           "FORWARD", "BACKWARD"]

FORWARD = tuple(range(7, -1, -1))
BACKWARD = FORWARD[::-1]


class Level:
    """One level: the stencil on ``dims`` as COO (row, col, val) in row
    order, its diagonal, each colour's rows and nonzeros, and ``f2c`` to
    the next coarser level (None on the coarsest)."""

    def __init__(self, dims, dtype, device):
        nx, ny, nz = dims
        self.dims, self.n = tuple(dims), nx * ny * nz
        idx = torch.arange(self.n, device=device)
        ix, iy, iz = idx % nx, (idx // nx) % ny, idx // (nx * ny)
        rows, cols, vals = [], [], []
        for dz, dy, dx in itertools.product((-1, 0, 1), repeat=3):
            ok = ((ix + dx >= 0) & (ix + dx < nx) & (iy + dy >= 0)
                  & (iy + dy < ny) & (iz + dz >= 0) & (iz + dz < nz))
            rows.append(idx[ok])
            cols.append(idx[ok] + dz * nx * ny + dy * nx + dx)
            vals.append(torch.full((int(ok.sum()),),
                                   26.0 if (dz, dy, dx) == (0, 0, 0)
                                   else -1.0, dtype=dtype, device=device))
        rows, cols, vals = torch.cat(rows), torch.cat(cols), torch.cat(vals)
        order = torch.argsort(rows * self.n + cols)
        self.rows, self.cols, self.vals = rows[order], cols[order], \
            vals[order]
        self.diag = torch.full((self.n,), 26.0, dtype=dtype, device=device)
        colour = ix % 2 + 2 * (iy % 2) + 4 * (iz % 2)
        self.colour_rows = [torch.nonzero(colour == c).flatten()
                            for c in range(8)]
        nz_colour = colour[self.rows]
        self.colour_nnz = [torch.nonzero(nz_colour == c).flatten()
                           for c in range(8)]
        self.f2c = None

    def product(self, x, nnz=None):
        """A x, or (A x) at the rows of nonzeros ``nnz`` only (others 0)."""
        rows, cols, vals = ((self.rows, self.cols, self.vals) if nnz is None
                            else (self.rows[nnz], self.cols[nnz],
                                  self.vals[nnz]))
        return torch.zeros(self.n, dtype=x.dtype, device=x.device) \
            .index_add_(0, rows, vals * x[cols])


def hierarchy(dims, dtype=torch.float64, device="cpu", levels: int = 4):
    """The ``levels`` levels of HPCG's multigrid on the grid ``dims``."""
    out = [Level(dims, dtype, device)]
    for _ in range(levels - 1):
        nx, ny, nz = out[-1].dims
        coarse = Level((nx // 2, ny // 2, nz // 2), dtype, device)
        cx, cy, _ = coarse.dims
        idx = torch.arange(coarse.n, device=device)
        i, j, k = idx % cx, (idx // cx) % cy, idx // (cx * cy)
        out[-1].f2c = 2 * k * ny * nx + 2 * j * nx + 2 * i
        out.append(coarse)
    return out


def colour_step(level: Level, c: int, r, x):
    """One colour's Gauss-Seidel update of x, in place."""
    rows = level.colour_rows[c]
    y = level.product(x, level.colour_nnz[c])[rows]
    x[rows] += (r[rows] - y) / level.diag[rows]
    return x


def symgs(level: Level, r, x, forward=FORWARD, backward=BACKWARD):
    """One symmetric sweep: the colours in ``forward``, then ``backward``."""
    for c in tuple(forward) + tuple(backward):
        colour_step(level, c, r, x)
    return x


def vcycle(levels, r, lv: int = 0):
    """z = M r on level ``lv`` (src/ComputeMG_ref.cpp), from z = 0."""
    level = levels[lv]
    x = torch.zeros_like(r)
    symgs(level, r, x)
    if lv + 1 < len(levels):
        axf = level.product(x)
        rc = r[level.f2c] - axf[level.f2c]
        x[level.f2c] += vcycle(levels, rc, lv + 1)
        symgs(level, r, x)
    return x


@contextlib.contextmanager
def _no_tf32():
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def pcg(dims, b, maxiter: int, dtype=torch.float64, levels=None,
        tol: float = 0.0):
    """Preconditioned CG from x0 = 0 on the grid ``dims``, in ``dtype``,
    for ``maxiter`` iterations or until ||r|| <= tol ||b|| (HPCG's
    normr / normr0 <= tolerance, with r0 = b).  Returns (x, the iterates
    after each iteration, ||r||), x and the iterates in float64."""
    with _no_tf32():
        levels = levels or hierarchy(dims, dtype, b.device)
        fine = levels[0]
        r = b.to(dtype).clone()
        tol2 = tol ** 2 * torch.dot(r, r)
        x = torch.zeros_like(r)
        z = vcycle(levels, r)
        p = z.clone()
        rz = torch.dot(r, z)
        iterates = []
        for _ in range(maxiter):
            if not bool(torch.dot(r, r) > tol2):
                break
            ap = fine.product(p)
            alpha = rz / torch.dot(p, ap)
            x = x + alpha * p
            r = r - alpha * ap
            z = vcycle(levels, r)
            rz_n = torch.dot(r, z)
            p = z + (rz_n / rz) * p
            rz = rz_n
            iterates.append(x.double())
        return x.double(), iterates, float(torch.linalg.vector_norm(r))
