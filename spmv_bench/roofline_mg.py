"""Frozen byte models of HPCG's V-cycle kernels, and their roofline
shares in a traced window.

Each counts what the work must move, each input read once and each
output written once, on HPCG's stencil at the configuration's
``levels`` grids (HPCG's 4: level l on the (n / 2^l)^3 grid, l = 0..3):

* a colour step (a colour's product y = A_c x and its update x[rows] +=
  (r[rows] - y) / a_ii): the colour's rows of A (a value and a column
  index a nonzero, a row end a row), x at every column those rows touch
  (their own rows included), r at the rows, and x written at the rows.
  Per V-cycle each colour of a level above the coarsest runs 4 times (two
  sweeps of a forward and a backward pass), of the coarsest twice;
* a restriction (r_c = r[f2c] - Axf[f2c], x_c = 0), once a V-cycle from
  each level above the coarsest: f2c, r and Axf at the coarse points,
  r_c and x_c written;
* a prolongation (x[f2c] += x_c), as often: f2c, x_c, x at the coarse
  points read and written.

The counts are separable: the stencil is a product of 1-D three-point
stencils, and a colour's rows are those of one parity along each axis.
The card's bandwidth is ``roofline.peaks``'s.
"""

from __future__ import annotations

from spmv_bench.roofline import INDEX_BYTES, VALUE_BYTES, peaks
from spmv_bench.spans import named

# device activity names (substrings) of the V-cycle's kernels
PRODUCT = "merge_tile_kernel"
UPDATE = "symgs_update_kernel"
RESTRICT = "mg_restrict_kernel"
PROLONG = "mg_prolong_kernel"


def level_dims(config: dict):
    """The configuration's ``levels``, fine first, each (nx, ny, nz)."""
    return [tuple(int(d) for d in lv) for lv in config["levels"]]


def _axis(size: int, parity: int):
    """(points, neighbour pairs, distinct neighbours) along one axis for
    the coordinates of ``parity``."""
    coords = range(parity, size, 2)
    pairs = sum(min(i + 1, size - 1) - max(i - 1, 0) + 1 for i in coords)
    near = {j for i in coords for j in (i - 1, i, i + 1) if 0 <= j < size}
    return len(coords), pairs, len(near)


def colour_counts(dims, colour: int):
    """(rows, nonzeros, distinct columns) of ``colour`` on the grid."""
    rows = nnz = cols = 1
    for axis, size in enumerate(dims):
        a, b, c = _axis(size, colour >> axis & 1)
        rows, nnz, cols = rows * a, nnz * b, cols * c
    return rows, nnz, cols


def symgs_bytes(config: dict, dtype: str) -> int:
    """Bytes of one V-cycle's colour steps."""
    v = VALUE_BYTES[dtype]
    grids = level_dims(config)
    total = 0
    for lv, dims in enumerate(grids):
        visits = 2 if lv == len(grids) - 1 else 4
        for c in range(8):
            rows, nnz, cols = colour_counts(dims, c)
            total += visits * (nnz * (v + INDEX_BYTES) + rows * INDEX_BYTES
                               + cols * v + 2 * rows * v)
    return total


def _coarse_points(config: dict):
    return [nx * ny * nz for nx, ny, nz in level_dims(config)[1:]]


def restrict_bytes(config: dict, dtype: str) -> int:
    """Bytes of one V-cycle's restrictions."""
    v = VALUE_BYTES[dtype]
    return sum(n * (INDEX_BYTES + 4 * v) for n in _coarse_points(config))


def prolong_bytes(config: dict, dtype: str) -> int:
    """Bytes of one V-cycle's prolongations."""
    v = VALUE_BYTES[dtype]
    return sum(n * (INDEX_BYTES + 3 * v) for n in _coarse_points(config))


def ordered(trace):
    """The window's device activities (name, start, end), in time order."""
    return sorted(trace.clipped(), key=lambda a: a[1])


def colour_step_seconds(trace) -> float:
    """Device seconds of every symgs_update and of the product that runs
    right before it on the card (its colour's K1)."""
    acts = ordered(trace)
    total = 0.0
    for i, (name, s, e) in enumerate(acts):
        if UPDATE in name:
            total += e - s
            if i and PRODUCT in acts[i - 1][0]:
                total += acts[i - 1][2] - acts[i - 1][1]
    return total


def share_pct(run, seconds: float, bytes_per_vcycle: int):
    """100 x (the least time of the traced window's V-cycles' bytes) over
    ``seconds``; None without a trace, the kernel, a V-cycle or the
    card's peaks."""
    table = peaks(run.device_name)
    vcycles = getattr(run.loop, "traced_vcycles", 0)
    if run.trace is None or seconds <= 0 or not vcycles or table is None:
        return None
    least = bytes_per_vcycle * vcycles / table["hbm_bytes_per_s"]
    return 100.0 * least / seconds


def vcycle_split(trace):
    """(device seconds of the V-cycles' kernels on level 0, on levels 1-3),
    by their order on the card: a restriction opens a coarser level and a
    prolongation closes it, so a kernel between them runs on a coarser
    level.  A V-cycle's kernels are the colour steps, the residual
    products (the K1 right before a restriction), the restrictions and
    the prolongations; level 0's zero start is not counted."""
    acts = ordered(trace)
    fine = coarse = 0.0
    depth = 0
    for i, (name, s, e) in enumerate(acts):
        nxt = acts[i + 1][0] if i + 1 < len(acts) else ""
        if PROLONG in name:
            depth = max(depth - 1, 0)
        part = (UPDATE in name or RESTRICT in name or PROLONG in name or
                (PRODUCT in name and (UPDATE in nxt or RESTRICT in nxt)))
        if part:
            if depth:
                coarse += e - s
            else:
                fine += e - s
        if RESTRICT in name:
            depth += 1
    return fine, coarse


def span_mean_us(trace, span: str):
    """The mean length of the host spans ``span`` in us, or None."""
    spans = named(trace, span)
    if not spans:
        return None
    return 1e6 * sum(e - s for s, e in spans) / len(spans)
