"""HPCG's multigrid preconditioner: the hierarchy, the colouring and the
V-cycle over the port's operators.

HPCG (https://github.com/hpcg-benchmark/hpcg) times CG preconditioned by
one multigrid V-cycle a step, on its 27-point stencil (diagonal 26, -1 off
it) over an nx x ny x nz grid.  As in its reference code:

* levels (src/GenerateCoarseProblem.cpp, main.cpp's 4 levels): level l is
  the same stencil generated again on the (n / 2^l)^3 grid, l = 0..3, not
  a Galerkin product; ``f2c`` maps coarse point (i, j, k) to fine point
  (2i, 2j, 2k);
* the V-cycle z = M(r) (src/ComputeMG_ref.cpp): x = 0 and one symmetric
  Gauss-Seidel sweep; Axf = A x; r_c = r[f2c] - Axf[f2c]; x_c = M_c(r_c);
  x[f2c] += x_c; one more sweep.  On the coarsest level, one sweep from
  x = 0;
* the sweep (src/ComputeSYMGS_ref.cpp): forward, then backward, each row
  x_i <- x_i + (r_i - (A x)_i) / a_ii.

One departure, which HPCG allows in optimised runs: the sweep runs in
colour order, not row order.  Colour = (ix mod 2) + 2 (iy mod 2) +
4 (iz mod 2); the forward sweep takes colours 7 to 0, the backward 0 to
7.  Colour 0 holds exactly the points f2c injects from, (2i, 2j, 2k): a
sweep that ended on it (forward 0 to 7, backward 7 to 0) would leave the
residual there 0 to rounding, and with it r_c and every coarse level's
correction.  Rows of one colour share no nonzero but their own diagonal,
so a colour's step is one product over its rows and one update of them,
and on the card one launch computes both: ``bind_colour_step``
(models/multigrid_cuda.py; csrc/multigrid.cu's symgs_update_kernel) over
the colour's gathered copy of its rows (through ``build_operator``, whose
CSR arrays it reads; on the CPU the copy's product, then
``symgs_update_plain``).  The restriction and prolongation are that
module's other two kernels; each level's residual product is its own
operator's (K1).  models/hpcg_reference.py is the plain version, with its
own hierarchy.

    op = build_multigrid(hpcg_csr, dtype="float64")   # on the card
    x, info = conjugate_gradient(op, b, preconditioner="multigrid")

``build_multigrid`` reads nx, ny and nz from row 0 of the matrix and
refuses anything but HPCG's stencil on a grid whose sides divide by 2^3.
Its operator's ``op(x)`` and ``op.mm`` are the fine level's; it holds
every level's residual and iterate (level 0's: copies of the r it is
given and of the z it returns), so a V-cycle's calls must be
stream-ordered, as an operator's ticket counter asks of its calls.

The V-cycle is bound once, at build: each level's work before the
coarser level (the first sweep, the residual product, the restriction)
and after it (the prolongation, the second sweep) is a ``Segment``, on
the card one CUDA graph of ~17-36 launches (models/multigrid_cuda.py::
Graph), so that a V-cycle costs the host 7 graph launches, and a solver
recording its block 7 child-graph nodes, instead of ~123 kernel
launches: the card, not the host's speed, sets the pace of PCG.
``LAUNCHES`` counts what the card ran, by (level, kind): the colour steps
("colour", 112 a V-cycle), the residual products, the restrictions and
prolongations, each time a segment runs or is recorded (a launch recorded
into a CUDA graph counts once, at capture); each kernel's own counter
gains the same.  The CPU runs the same segments on the plain versions,
launcher by launcher, and counts nothing.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from merge_spmv_tpu_torch.formats.csr import CsrMatrix
from merge_spmv_tpu_torch.models import multigrid_cuda
from merge_spmv_tpu_torch.ops.operator import build_operator
from merge_spmv_tpu_torch.utils.cuda_build import device_context, raw_stream
from merge_spmv_tpu_torch.utils.device import dtype_name, resolve_device
from merge_spmv_tpu_torch.utils.tracing import (BUILD_MULTIGRID, MG_LEVELS,
                                                PRECONDITION, span)

__all__ = ["build_multigrid", "MultigridOperator", "Level", "Colour", "Bound",
           "Segment", "stencil27", "grid_of", "colours", "fine_of_coarse",
           "LAUNCHES", "reset_launches", "NUM_LEVELS", "FORWARD", "BACKWARD",
           "DIAGONAL", "OFF_DIAGONAL"]

NUM_LEVELS = 4              # HPCG's main.cpp: numberOfMgLevels
DIAGONAL, OFF_DIAGONAL = 26.0, -1.0
FORWARD = tuple(range(7, -1, -1))   # the forward sweep's colour order
BACKWARD = FORWARD[::-1]
# (level, kind) -> launches on the card: kind "colour" (a colour step, one
# symgs_update_kernel), "residual" (K1), "restrict", "prolong"
LAUNCHES: dict = {}


def reset_launches():
    LAUNCHES.clear()


def stencil27(nx: int, ny: int, nz: int, dtype=np.float64) -> CsrMatrix:
    """HPCG's matrix on the nx x ny x nz grid (src/GenerateProblem_ref.cpp):
    row iz ny nx + iy nx + ix holds every neighbour inside the grid, the
    point itself included, in increasing column order, DIAGONAL on the
    diagonal and OFF_DIAGONAL elsewhere."""
    n = nx * ny * nz
    idx = np.arange(n, dtype=np.int64)
    ix, iy, iz = idx % nx, (idx // nx) % ny, idx // (nx * ny)
    cols = np.empty((n, 27), dtype=np.int64)
    valid = np.empty((n, 27), dtype=bool)
    vals = np.full((n, 27), OFF_DIAGONAL, dtype=dtype)
    j = 0
    for dz in (-1, 0, 1):
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                cols[:, j] = idx + dz * nx * ny + dy * nx + dx
                valid[:, j] = ((ix + dx >= 0) & (ix + dx < nx)
                               & (iy + dy >= 0) & (iy + dy < ny)
                               & (iz + dz >= 0) & (iz + dz < nz))
                if (dz, dy, dx) == (0, 0, 0):
                    vals[:, j] = DIAGONAL
                j += 1
    offsets = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(valid.sum(1), out=offsets[1:])
    return CsrMatrix(n, n, offsets, cols[valid], vals[valid])


def grid_of(csr) -> tuple:
    """(nx, ny, nz) of HPCG's stencil ``csr``, read from row 0's columns
    {0, 1, nx, nx + 1, nx ny, ...}; raises ValueError unless the matrix is
    that stencil, exactly, on a grid whose sides divide by 2^(NUM_LEVELS -
    1)."""
    n = csr.num_rows
    offsets = np.asarray(csr.row_offsets)
    row0 = np.asarray(csr.col_indices[offsets[0]:offsets[1]])
    if csr.num_cols != n or row0.shape[0] != 8:
        raise ValueError("not HPCG's 27-point stencil: row 0 must hold 8 "
                         "nonzeros of a square matrix")
    nx = int(row0[2])
    ny = int(row0[4]) // max(nx, 1)
    nz = n // max(nx * ny, 1)
    step = 2 ** (NUM_LEVELS - 1)
    if nx * ny * nz != n or min(nx, ny, nz) < 1 or \
            nx % step or ny % step or nz % step:
        raise ValueError(f"HPCG's stencil on a grid whose sides divide by "
                         f"{step}: row 0 reads nx={nx}, ny={ny}, nz={nz} "
                         f"for {n} rows")
    want = stencil27(nx, ny, nz)
    if not (np.array_equal(offsets, want.row_offsets)
            and np.array_equal(csr.col_indices, want.col_indices)
            and np.array_equal(np.asarray(csr.values, dtype=np.float64),
                               want.values)):
        raise ValueError(f"not HPCG's 27-point stencil on the {nx} x {ny} "
                         f"x {nz} grid")
    return nx, ny, nz


def colours(nx: int, ny: int, nz: int) -> np.ndarray:
    """Each point's colour, (ix mod 2) + 2 (iy mod 2) + 4 (iz mod 2)."""
    idx = np.arange(nx * ny * nz, dtype=np.int64)
    return ((idx % nx) % 2 + 2 * ((idx // nx) % ny % 2)
            + 4 * (idx // (nx * ny) % 2)).astype(np.int8)


def fine_of_coarse(nx: int, ny: int, nz: int) -> np.ndarray:
    """f2c of the fine nx x ny x nz grid: coarse point (i, j, k) of the
    (nx/2) x (ny/2) x (nz/2) grid to fine point (2i, 2j, 2k)."""
    cx, cy, cz = nx // 2, ny // 2, nz // 2
    idx = np.arange(cx * cy * cz, dtype=np.int64)
    i, j, k = idx % cx, (idx // cx) % cy, idx // (cx * cy)
    return (2 * k * ny * nx + 2 * j * nx + 2 * i).astype(np.int32)


class Colour(NamedTuple):
    rows: torch.Tensor      # int32, the colour's rows in the level
    diag: torch.Tensor      # a_ii of those rows
    op: object              # SpmvOperator over those rows, all columns


class Level(NamedTuple):
    dims: tuple             # (nx, ny, nz)
    op: object              # SpmvOperator of the level's matrix
    colours: tuple          # Colour by colour number; None where empty
    f2c: torch.Tensor       # int32, the next level's points here; or None
    r: torch.Tensor         # the level's residual
    x: torch.Tensor         # the level's iterate


def _colour_split(csr: CsrMatrix, dims, dtype, dev):
    """The colours of ``csr``: each a gathered copy of its rows (all
    columns) through build_operator, with their row numbers and
    diagonals."""
    n = csr.num_rows
    offsets = np.asarray(csr.row_offsets, dtype=np.int64)
    lengths = np.diff(offsets)
    row_of = np.repeat(np.arange(n, dtype=np.int64), lengths)
    on_diag = csr.col_indices == row_of
    diag = np.zeros(n, dtype=np.float64)
    diag[row_of[on_diag]] = csr.values[on_diag]
    colour = colours(*dims)
    colour_of = np.repeat(colour, lengths)
    out = []
    for c in range(8):
        rows = np.flatnonzero(colour == c)
        if rows.size == 0:
            out.append(None)
            continue
        keep = colour_of == c
        sub_offsets = np.zeros(rows.size + 1, dtype=np.int64)
        np.cumsum(lengths[rows], out=sub_offsets[1:])
        sub = CsrMatrix(rows.size, n, sub_offsets, csr.col_indices[keep],
                        csr.values[keep])
        op = build_operator(sub, dtype=dtype, device=dev)
        out.append(Colour(
            torch.from_numpy(rows.astype(np.int32)).to(dev),
            torch.from_numpy(diag[rows]).to(dev, op.values.dtype), op))
    return tuple(out)


class Segment:
    """A run of one level's bound launchers, ``steps`` of (launcher, kind
    or None), in order.  On the card one multigrid_cuda.Graph of them:
    ``run(stream)`` launches it and adds to ``LAUNCHES`` each step's
    (level, kind) and to each kernel's counter its launch.  On the CPU,
    the plain launchers one by one, counting nothing."""

    def __init__(self, lv: int, steps, device):
        self.steps = tuple(steps)
        self.graph = None
        counts: dict = {}       # (id(counter), key) -> [counter, key, n]
        if device.type == "cuda":
            self.graph = multigrid_cuda.Graph([s for s, _ in self.steps],
                                              device)
            for launch, kind in self.steps:
                for counter in ((LAUNCHES, (lv, kind)) if kind else None,
                                launch.counter):
                    if counter is not None:
                        counts.setdefault((id(counter[0]), counter[1]),
                                          [*counter, 0])[2] += 1
        self.counts = tuple(map(tuple, counts.values()))

    def run(self, stream=None):
        if self.graph is None:
            for launch, _ in self.steps:
                launch(stream)
            return
        self.graph.launch(stream)
        for counter, key, n in self.counts:
            counter[key] = counter.get(key, 0) + n


class Bound(NamedTuple):
    """A level's V-cycle work with its operands bound (``bind`` below):
    launchers that take no argument, and the segments made of them."""
    colours: tuple          # the colour step's launcher by colour; None
    #                         where empty
    sweep: tuple            # (launcher, kind) of one symmetric sweep
    pre: Segment            # level 0: x = 0; the sweep; on a level with a
    #                         coarser one, the residual and the restriction
    post: Segment           # the prolongation, the sweep; None (coarsest)


class MultigridOperator:
    """The fine level's operator with HPCG's hierarchy beneath it:
    ``op(x)`` and ``op.mm`` are the fine SpmvOperator's, ``precondition(r,
    z)`` writes one V-cycle z = M r into z.  ``levels`` are the Level
    tuples, fine first; ``setup_s`` holds the fine operator's "plan" and
    "prepare" and the rest of the build's "multigrid".

    Every launch of a V-cycle is bound once, at build, onto each level's
    own r and x (``SpmvOperator.bind`` and models/multigrid_cuda.py's
    ``bind_*``: the checks and arguments worked out, one launcher a colour
    step), and each level's runs of them are ``Segment``s: CUDA graphs on
    the card."""

    def __init__(self, levels, setup_s: dict):
        self.levels = tuple(levels)
        self.fine = self.levels[0].op
        self.plan = self.fine.plan
        self.device = self.fine.device
        self.abs_row_sum_max = self.fine.abs_row_sum_max
        self.setup_s = setup_s
        self._card = self.device.type == "cuda"
        self._bound = [self.bind(lv, level.r, level.x)
                       for lv, level in enumerate(self.levels)]

    @property
    def shape(self):
        return self.fine.shape

    @property
    def dtype(self) -> str:
        return self.fine.dtype

    def __call__(self, x, y_in=None, alpha=1.0, beta=0.0,
                 interpret: bool = False):
        return self.fine(x, y_in, alpha, beta)

    def mm(self, X, Y_in=None, alpha=1.0, beta=0.0, interpret: bool = False,
           method: str = "auto"):
        return self.fine.mm(X, Y_in, alpha, beta, method=method)

    def bind(self, lv: int, r, x) -> Bound:
        """Level ``lv``'s V-cycle work bound to its residual r and iterate
        x (the coarser levels' own r and x below it)."""
        level = self.levels[lv]
        colours = tuple(
            None if colour is None else multigrid_cuda.bind_colour_step(
                x, r, colour.op, colour.rows, colour.diag)
            for colour in level.colours)
        # one symmetric Gauss-Seidel sweep in colour order, each colour's
        # step x[rows] += (r[rows] - A[rows] x) / diag
        sweep = [(colours[c], "colour") for c in FORWARD + BACKWARD
                 if colours[c] is not None]
        pre = list(sweep)
        if lv == 0:     # coarser levels start at 0 in the restriction
            pre.insert(0, (multigrid_cuda.bind_zero(x), None))
        post = None
        if lv + 1 < len(self.levels):
            coarse = self.levels[lv + 1]
            residual, axf = level.op.bind(x)
            pre += [(residual, "residual"),
                    (multigrid_cuda.bind_restrict(coarse.r, coarse.x, r, axf,
                                                  level.f2c), "restrict")]
            post = Segment(lv, [(multigrid_cuda.bind_prolong(
                x, coarse.x, level.f2c), "prolong")] + sweep, self.device)
        return Bound(colours, tuple(sweep),
                     Segment(lv, pre, self.device), post)

    def precondition(self, r, z):
        """z = M r, one V-cycle from z = 0; returns z.  r and z are
        [num_rows] vectors of the operator's dtype on its device: r is
        copied into level 0's residual, the V-cycle runs there, and its
        iterate is copied into z.  The V-cycle goes to the current
        stream, read once."""
        fine = self.levels[0]
        for name, t in (("r", r), ("z", z)):
            if t.dtype != fine.r.dtype or t.shape != fine.r.shape \
                    or t.device != fine.r.device:
                raise ValueError(
                    f"{name} must be a {tuple(fine.r.shape)} vector of "
                    f"{fine.r.dtype} on {fine.r.device}, got "
                    f"{tuple(t.shape)} {t.dtype} on {t.device}")
        with span(PRECONDITION), device_context(self.device):
            fine.r.copy_(r)
            self._vcycle(0, raw_stream(self.device) if self._card else None)
            z.copy_(fine.x)
        return z

    def _vcycle(self, lv: int, stream):
        work = self._bound[lv]
        with span(MG_LEVELS[lv]):
            work.pre.run(stream)
            if work.post is None:
                return
            self._vcycle(lv + 1, stream)
            work.post.run(stream)


def build_multigrid(csr, dtype="float64", device=None) -> MultigridOperator:
    """HPCG's 4-level multigrid over the host CsrMatrix ``csr``, which must
    be HPCG's stencil (``grid_of``; ValueError otherwise), in float32 or
    float64.  The fine level is ``build_operator(csr, dtype,
    device=device)``, timed into ``setup_s["plan"]`` and ``["prepare"]``;
    the grid check before it and, after it, the coarse levels (each
    generated on its grid), the colours' operators, the scratch vectors
    and every level's bound launches and segments (their CUDA graphs
    captured on the card) are timed into
    ``setup_s["multigrid"]``.  ``device`` as for
    build_operator: None is the card."""
    if dtype_name(dtype) not in ("float32", "float64"):
        raise ValueError(f"build_multigrid takes float32 or float64, got "
                         f"{dtype!r}")
    dev = resolve_device(device)
    timed: dict = {}
    with span(BUILD_MULTIGRID, into=timed, key="check"):
        dims = grid_of(csr)
    fine = build_operator(csr, dtype=dtype, device=dev)
    with span(BUILD_MULTIGRID, into=timed, key="hierarchy"):
        levels, level_csr, op = [], csr, fine
        for lv in range(NUM_LEVELS):
            if lv:
                level_csr = stencil27(*dims)
                op = build_operator(level_csr, dtype=dtype, device=dev)
            f2c = (torch.from_numpy(fine_of_coarse(*dims)).to(dev)
                   if lv + 1 < NUM_LEVELS else None)
            r, x = (torch.zeros(level_csr.num_rows, dtype=op.values.dtype,
                                device=dev) for _ in range(2))
            levels.append(Level(dims, op, _colour_split(
                level_csr, dims, dtype, dev), f2c, r, x))
            dims = tuple(d // 2 for d in dims)
        mg = MultigridOperator(levels, dict(fine.setup_s))
    mg.setup_s["multigrid"] = round(timed["check"] + timed["hierarchy"], 3)
    return mg
