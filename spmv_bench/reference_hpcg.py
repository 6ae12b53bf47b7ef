"""HPCG's preconditioned CG as the benchmark's plain reference: plain
PyTorch over the stencil the generator makes, nothing of the package
under test.

Written from HPCG's reference code (https://github.com/hpcg-benchmark/hpcg:
src/GenerateCoarseProblem.cpp, ComputeMG_ref.cpp, ComputeSYMGS_ref.cpp,
CG.cpp).  Level l is the generator's stencil on the configuration's
``levels`` grid l, each half the one before (HPCG's 4: the (n / 2^l)^3
grids, l = 0..3; level 0 is the CSR the check is given); f2c takes coarse
(i, j, k) to fine (2i, 2j, 2k).  The V-cycle z = M(r): x = 0, one
symmetric sweep, Axf = A x, r_c = r[f2c] - Axf[f2c], x_c = M_c(r_c),
x[f2c] += x_c, one more sweep; on the coarsest level one sweep from
x = 0.  A sweep's row update
is x_i + (r_i - (A x)_i) / a_ii.  Departures, each also the program's:
the sweep takes the rows colour by colour (colour (ix mod 2) + 2 (iy mod
2) + 4 (iz mod 2), forward 7 to 0, backward 0 to 7, so that colour 0, the
points f2c injects from, is not the last updated), each colour's rows at
once; CG applies M in its prologue and after each step's update (51
V-cycles for 50 iterations; the program also runs one in each masked
step, which changes nothing); b is the loop's, from the seed.

Products are ``reference.product``'s blocks of at most 2^24 gathered
elements, over each level's CSR and over each colour's rows.  ``dtype``
is the precision every step computes in: float64 for the reference,
float32 for the control.
"""

from __future__ import annotations

import torch

from spmv_bench import reference
from spmv_bench.generators import stencil27

FORWARD = tuple(range(7, -1, -1))
BACKWARD = FORWARD[::-1]


def grid(params: dict) -> tuple:
    return tuple(int(params[k]) for k in ("nx", "ny", "nz"))


def grids(config: dict) -> list:
    """The configuration's ``levels``, fine first, each (nx, ny, nz): the
    first its ``params``' grid, each next one half the one before;
    ValueError otherwise."""
    dims = [tuple(int(d) for d in lv) for lv in config["levels"]]
    halves = all(c == tuple(d // 2 for d in f) and not any(d % 2 for d in f)
                 for f, c in zip(dims, dims[1:]))
    if not dims or dims[0] != grid(config["params"]) or not halves:
        raise ValueError(f"levels {dims} are not the grid "
                         f"{grid(config['params'])} halved level by level")
    return dims


class Level:
    """One level: its CSR (values in ``dtype``), diagonal, colours (rows
    and the CSR of those rows), and f2c to the next coarser level."""

    def __init__(self, csr: dict, dims, dtype):
        nx, ny, nz = dims
        self.dims, self.n = tuple(dims), csr["num_rows"]
        offsets = csr["row_offsets"]
        dev = offsets.device
        self.csr = dict(csr, values=csr["values"].to(dtype))
        lengths = offsets[1:] - offsets[:-1]
        idx = torch.arange(self.n, device=dev)
        row_of = torch.repeat_interleave(idx, lengths)
        on_diag = csr["col_indices"].long() == row_of
        self.diag = torch.zeros(self.n, dtype=dtype, device=dev)
        self.diag[row_of[on_diag]] = self.csr["values"][on_diag]
        colour = idx % nx % 2 + 2 * (idx // nx % ny % 2) + \
            4 * (idx // (nx * ny) % 2)
        colour_of = colour[row_of]
        self.colours = []
        for c in range(8):
            rows = torch.nonzero(colour == c).flatten()
            keep = colour_of == c
            sub_offsets = torch.zeros(rows.numel() + 1, dtype=torch.int64,
                                      device=dev)
            torch.cumsum(lengths[rows], 0, out=sub_offsets[1:])
            self.colours.append((rows, {
                "num_rows": rows.numel(), "num_cols": self.n,
                "row_offsets": sub_offsets,
                "col_indices": csr["col_indices"][keep],
                "values": self.csr["values"][keep]}))
        self.f2c = None


def hierarchy(csr: dict, config: dict, dtype=torch.float64):
    """The configuration's levels (``grids``) over the fine CSR ``csr`` of
    its stencil, the coarse ones generated again on their grids."""
    dims = grids(config)
    levels = [Level(csr, dims[0], dtype)]
    for cdims in dims[1:]:
        nx, ny, nz = levels[-1].dims
        coarse = stencil27.generate(
            dict(config["params"], nx=cdims[0], ny=cdims[1], nz=cdims[2]),
            0, csr["row_offsets"].device)
        levels.append(Level(coarse, cdims, dtype))
        idx = torch.arange(levels[-1].n, device=csr["row_offsets"].device)
        i, j, k = idx % cdims[0], idx // cdims[0] % cdims[1], \
            idx // (cdims[0] * cdims[1])
        levels[-2].f2c = 2 * k * ny * nx + 2 * j * nx + 2 * i
    return levels


def symgs(level: Level, r, x, dtype, forward=FORWARD, backward=BACKWARD):
    """One symmetric sweep in colour order, in place."""
    for c in tuple(forward) + tuple(backward):
        rows, sub = level.colours[c]
        if rows.numel() == 0:
            continue
        y = reference.product(sub, x, dtype)
        x[rows] += (r[rows] - y) / level.diag[rows]
    return x


def vcycle(levels, r, dtype, lv: int = 0):
    """z = M r on level ``lv``, from z = 0."""
    level = levels[lv]
    x = torch.zeros_like(r)
    symgs(level, r, x, dtype)
    if lv + 1 < len(levels):
        axf = reference.product(level.csr, x, dtype)
        rc = r[level.f2c] - axf[level.f2c]
        x[level.f2c] += vcycle(levels, rc, dtype, lv + 1)
        symgs(level, r, x, dtype)
    return x


def pcg(levels, b, maxiter: int, dtype=torch.float64):
    """``maxiter`` iterations of PCG from x0 = 0 (fewer only where ||r||
    reaches 0, HPCG's loop at tolerance 0), every step in ``dtype``;
    returns the iterates after each iteration, in float64."""
    r = b.to(dtype).clone()
    x = torch.zeros_like(r)
    z = vcycle(levels, r, dtype)
    p = z.clone()
    rz = torch.dot(r, z)
    iterates = []
    for _ in range(maxiter):
        if not bool(torch.dot(r, r) > 0):
            break
        ap = reference.product(levels[0].csr, p, dtype)
        alpha = rz / torch.dot(p, ap)
        x = x + alpha * p
        r = r - alpha * ap
        z = vcycle(levels, r, dtype)
        rz_n = torch.dot(r, z)
        p = z + (rz_n / rz) * p
        rz = rz_n
        iterates.append(x.double())
    return iterates
