"""Prepare-time matrix splitting for scattered-column matrices (opt-in).

Counterpart of merge_spmv_tpu/ops/split.py.  The nonzeros are split by
signed diagonal distance into bands, and the bands are STACKED vertically
into one (num_bands * m_pad, n) CSR over a virtual row space: row r of band
b becomes stacked row b * m_pad + r.  The stack is one CSR, so the whole
split is one launch of the fused merge kernel (ops/csrmv_cuda.py::
merge_csrmv) under one plan, finished by the reshape-sum epilogue
``y_v.reshape(B, m_pad)[:, :m].sum(0)``.

Band edges come in two flavours: geometric ``edges_chunks=(8, 32)`` (fixed
signed edges in 1024-column units) and ``edges_chunks="quantile"`` with
``num_bands=B`` (equal-nnz bands from signed-distance quantiles).
``compact_rows=True`` keeps only the rows each band holds; its epilogue is
an ``index_select`` through a row-sorted permutation and the compensated
sorted-segment sum.  ``HotColdSpmvOperator`` splits by column popularity
instead: the popular 128-column windows are compacted into a dense prefix
and run as a second merge operator.

The host helpers (band_assignment, stack_bands, stack_bands_compact,
split_by_distance, popularity_assignment) are NumPy copies of the JAX
package's and give the same arrays.  ``build_split_operator_device`` runs
the quantile split's heavy passes as torch operations on the operator's
device.  Both epilogues are plain torch operations, as they are XLA code
in the JAX package; the stacked multiply is the merge kernel.

Every band of a stack is padded so that no merge tile straddles two bands
(``stack_bands``), which needs a tile size that is a multiple of 1024: the
split resolves its tile size as the port's plan choice rounded up to a
multiple of 1024 and capped at MAX_TILE_ITEMS.  Like the reference's
cuSPARSE HybMV comparison point (gpu_spmv.cu:106-251), the splits trade
one-time setup, reported as ``setup_ms``, for per-call speed.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional, Sequence, Union

import numpy as np
import torch

from merge_spmv_tpu_torch.formats.csr import CsrMatrix
from merge_spmv_tpu_torch.ops.csrmv import (check_matrix_operands,
                                            check_vector_operands)
from merge_spmv_tpu_torch.ops.csrmv_torch import _sorted_segment_sum
from merge_spmv_tpu_torch.ops.operator import (assemble_operator,
                                               build_operator, row_abs_sums)
from merge_spmv_tpu_torch.ops.plan import (MAX_TILE_ITEMS, gather_policy,
                                           make_plan)
from merge_spmv_tpu_torch.utils.device import dtype_name, resolve_device

__all__ = ["split_by_distance", "SplitSpmvOperator", "build_split_operator",
           "build_split_operator_device", "band_assignment", "stack_bands",
           "stack_bands_compact", "split_tile_items",
           "popularity_assignment", "HotColdSpmvOperator",
           "build_hotcold_operator", "_row_ids", "_subset_csr"]

# Band boundaries of a stack fall on multiples of this many nonzeros.
_BAND_ALIGN = 1024


def _row_ids(csr: CsrMatrix) -> np.ndarray:
    lens = np.diff(csr.row_offsets)
    return np.repeat(np.arange(csr.num_rows, dtype=np.int32),
                     lens).astype(np.int32, copy=False)


def _check_tile_items(tile_items: int):
    if tile_items % _BAND_ALIGN or not 0 < tile_items <= MAX_TILE_ITEMS:
        raise ValueError(f"a stack needs tile_items a multiple of "
                         f"{_BAND_ALIGN} up to {MAX_TILE_ITEMS}, got "
                         f"{tile_items}")


def split_tile_items(num_rows: int, num_nonzeros: int) -> int:
    """Tile size of a stack of ``num_rows`` rows and ``num_nonzeros``
    nonzeros: the port's plan choice rounded up to a multiple of 1024,
    capped at MAX_TILE_ITEMS.  Raises, as make_plan does, when the stack
    outgrows the kernel's int32 merge coordinates."""
    t = make_plan(num_rows, 1, num_nonzeros, device="cpu").tile_items
    return min(-(-t // _BAND_ALIGN) * _BAND_ALIGN, MAX_TILE_ITEMS)


def band_assignment(csr: CsrMatrix,
                    edges_chunks: Union[Sequence[int], str] = (8, 32),
                    num_bands: int = 5,
                    min_frac: float = 0.02,
                    row_ids: Optional[np.ndarray] = None):
    """Per-nonzero band ids from signed diagonal distance.

    Geometric mode (``edges_chunks`` a sequence): positive edges in
    1024-column units; the signed edge list becomes
    [-inf, -e_n..., -e_1, e_1, ..., e_n, inf].  Quantile mode
    (``edges_chunks == "quantile"``): ``num_bands`` equal-nnz bands from
    signed-distance quantiles, 1024-aligned.  Bands holding less than
    ``min_frac`` of the nonzeros are merged into their inner neighbour.

    Returns (band, nbands): int8 ids in [0, nbands), densely renumbered
    in ascending-distance order.
    """
    if row_ids is None:
        row_ids = _row_ids(csr)
    # |col - row| < 2**31 for int32 column indices: the distance fits int32
    d = csr.col_indices.astype(np.int32, copy=False) - row_ids
    if isinstance(edges_chunks, str):
        if edges_chunks != "quantile":
            raise ValueError(f"unknown edges mode {edges_chunks!r}")
        if num_bands < 2:
            return np.zeros(d.shape[0], np.int8), 1
        qs = np.quantile(d, np.arange(1, num_bands) / num_bands)
        signed_edges = np.unique((np.round(qs / 1024.0) * 1024
                                  ).astype(np.int64))
    else:
        edges = np.array(sorted({int(e) * 1024 for e in edges_chunks
                                 if e > 0}), dtype=np.int64)
        signed_edges = np.concatenate([-edges[::-1], edges])
    if signed_edges.size == 0:
        return np.zeros(d.shape[0], np.int8), 1
    # edges in d's dtype: int64 edges would promote the whole distance
    # array inside searchsorted
    band = np.searchsorted(signed_edges.astype(d.dtype), d,
                           side="left").astype(np.int8)
    nbands = len(signed_edges) + 1
    counts = np.bincount(band, minlength=nbands)
    # merge sub-threshold bands inward, towards the most populated band
    mid = int(np.argmax(counts))
    remap = np.arange(nbands, dtype=np.int8)
    thresh = min_frac * max(1, csr.num_nonzeros)
    for b in range(nbands):
        if counts[b] and counts[b] < thresh:
            step = 1 if b < mid else -1
            t = b
            while t != mid and (counts[t] < thresh or t == b):
                t += step
            remap[b] = t
    band = remap[band]
    # dense renumbering preserving distance order
    used = np.flatnonzero(np.bincount(band, minlength=nbands))
    renum = np.zeros(nbands, np.int8)
    renum[used] = np.arange(len(used), dtype=np.int8)
    return renum[band], len(used)


def stack_bands(csr: CsrMatrix, band: np.ndarray, nbands: int,
                row_ids: Optional[np.ndarray] = None,
                tile_items: int = 0):
    """Stack the bands vertically into one (nbands * m_pad, n) CSR.

    A stable sort by band id keeps row-major order inside each band, so
    the permuted columns and values ARE the stack's arrays; the stacked
    row lengths are per-band bincounts.  With ``tile_items`` (a multiple
    of 1024) each band's rows are padded to m_pad = ceil(m/1024)*1024 and
    its nonzeros to nnz'_b ≡ -m_pad (mod tile_items) with zero-valued
    dummies on the band's last row, whose column repeats the band's last
    column: every band then starts on a merge-tile boundary, and no tile
    mixes two bands.  Returns (stacked, m_pad).
    """
    if row_ids is None:
        row_ids = _row_ids(csr)
    m = csr.num_rows
    if nbands == 1:
        return csr, m
    m_pad = m
    if tile_items:
        _check_tile_items(tile_items)
        m_pad = -(-m // _BAND_ALIGN) * _BAND_ALIGN
    order = np.argsort(band, kind="stable")
    bcounts = np.bincount(band, minlength=nbands)
    seg = np.concatenate([[0], np.cumsum(bcounts)])
    pad = np.zeros(nbands, np.int64)
    if tile_items:
        pad = (-(m_pad + bcounts)) % tile_items
    dst = np.concatenate([[0], np.cumsum(bcounts + pad)])
    total = int(dst[-1])
    rows_sorted = row_ids[order]
    cols_sorted = csr.col_indices[order]
    vals_sorted = csr.values[order]
    cols_s = np.empty(total, cols_sorted.dtype)
    vals_s = np.zeros(total, vals_sorted.dtype)
    row_offsets = np.zeros(nbands * m_pad + 1, dtype=np.int64)
    for b in range(nbands):
        s0, s1 = int(seg[b]), int(seg[b + 1])
        d0 = int(dst[b])
        cols_s[d0:d0 + s1 - s0] = cols_sorted[s0:s1]
        vals_s[d0:d0 + s1 - s0] = vals_sorted[s0:s1]
        if pad[b]:
            cols_s[d0 + s1 - s0:int(dst[b + 1])] = (
                cols_sorted[s1 - 1] if s1 > s0 else 0)
        lens_b = np.bincount(rows_sorted[s0:s1], minlength=m_pad)
        lens_b[m_pad - 1] += pad[b]
        row_offsets[1 + b * m_pad:1 + (b + 1) * m_pad] = lens_b
    np.cumsum(row_offsets[1:], out=row_offsets[1:])
    return CsrMatrix(nbands * m_pad, csr.num_cols, row_offsets,
                     cols_s, vals_s), m_pad


def stack_bands_compact(csr: CsrMatrix, band: np.ndarray, nbands: int,
                        row_ids: Optional[np.ndarray] = None,
                        tile_items: int = 0):
    """Stack bands with COMPACT per-band rows: stacked row rdst[b] + i is
    the i-th row of band b that holds a band-b nonzero.  The epilogue is
    then a gather of the stacked y through ``gather_idx`` (the (band,
    row) slots sorted by global row) and a sorted-segment sum over
    ``seg_ends``.

    Returns (stacked, gather_idx, seg_ends, present_counts):
    ``gather_idx`` int32 (R_total,), ``seg_ends`` int32 (m,).  Band
    alignment as in stack_bands (p_pad_b a multiple of 1024; p_pad_b +
    nnz'_b ≡ 0 mod tile_items).
    """
    if row_ids is None:
        row_ids = _row_ids(csr)
    m = csr.num_rows
    if not tile_items:
        raise ValueError("a compact stack needs tile_items")
    _check_tile_items(tile_items)
    order = np.argsort(band, kind="stable")
    bcounts = np.bincount(band, minlength=nbands)
    seg = np.concatenate([[0], np.cumsum(bcounts)])
    rows_sorted = row_ids[order]
    cols_sorted = csr.col_indices[order]
    vals_sorted = csr.values[order]
    rows_list = []
    lens_list = []
    p_pads = []
    for b in range(nbands):
        s0, s1 = int(seg[b]), int(seg[b + 1])
        # rows within a band stay in ascending order (stable sort)
        ur, cnts = np.unique(rows_sorted[s0:s1], return_counts=True)
        rows_list.append(ur.astype(np.int64))
        lens_list.append(cnts.astype(np.int64))
        p_pads.append(max(_BAND_ALIGN,
                          -(-max(len(ur), 1) // _BAND_ALIGN) * _BAND_ALIGN))
    nnz_pad = [int((-(p_pads[b] + bcounts[b])) % tile_items)
               for b in range(nbands)]
    rdst = np.concatenate([[0], np.cumsum(p_pads)]).astype(np.int64)
    dst = np.concatenate([[0], np.cumsum(bcounts + np.asarray(nnz_pad))
                          ]).astype(np.int64)
    total = int(dst[-1])
    rows_total = int(rdst[-1])
    cols_s = np.empty(total, cols_sorted.dtype)
    vals_s = np.zeros(total, vals_sorted.dtype)
    row_offsets = np.zeros(rows_total + 1, dtype=np.int64)
    for b in range(nbands):
        s0, s1 = int(seg[b]), int(seg[b + 1])
        d0 = int(dst[b])
        cols_s[d0:d0 + s1 - s0] = cols_sorted[s0:s1]
        vals_s[d0:d0 + s1 - s0] = vals_sorted[s0:s1]
        if nnz_pad[b]:
            cols_s[d0 + s1 - s0:int(dst[b + 1])] = (
                cols_sorted[s1 - 1] if s1 > s0 else 0)
        lens_b = np.zeros(p_pads[b], np.int64)
        lens_b[:len(lens_list[b])] = lens_list[b]
        lens_b[p_pads[b] - 1] += nnz_pad[b]
        row_offsets[1 + rdst[b]:1 + rdst[b + 1]] = lens_b
    np.cumsum(row_offsets[1:], out=row_offsets[1:])
    stacked = CsrMatrix(rows_total, csr.num_cols, row_offsets,
                        cols_s, vals_s)
    rows_all = (np.concatenate(rows_list) if rows_list
                else np.zeros(0, np.int64))
    pos_all = np.concatenate(
        [rdst[b] + np.arange(len(rows_list[b]), dtype=np.int64)
         for b in range(nbands)]) if rows_list else np.zeros(0, np.int64)
    perm = np.argsort(rows_all, kind="stable")
    gather_idx = pos_all[perm].astype(np.int32)
    seg_ends = np.cumsum(np.bincount(rows_all, minlength=m)
                         ).astype(np.int32)
    return stacked, gather_idx, seg_ends, [len(r) for r in rows_list]


def _subset_csr(csr: CsrMatrix, mask: np.ndarray,
                row_ids: np.ndarray,
                cols: Optional[np.ndarray] = None,
                num_cols: Optional[int] = None) -> CsrMatrix:
    """CSR holding only the masked nonzeros; same rows.  ``cols`` replaces
    the selected column indices (already masked), ``num_cols`` the column
    count — used by the hot/cold split's compact remap."""
    sel_rows = row_ids[mask]
    counts = np.bincount(sel_rows, minlength=csr.num_rows)
    row_offsets = np.zeros(csr.num_rows + 1, dtype=csr.row_offsets.dtype)
    np.cumsum(counts, out=row_offsets[1:])
    if cols is None:
        cols = csr.col_indices[mask]
    return CsrMatrix(csr.num_rows,
                     csr.num_cols if num_cols is None else num_cols,
                     row_offsets, np.ascontiguousarray(cols),
                     np.ascontiguousarray(csr.values[mask]))


def split_by_distance(csr: CsrMatrix,
                      edges_chunks: Union[Sequence[int], str] = (8, 32),
                      min_frac: float = 0.02, num_bands: int = 5):
    """Split into per-band CsrMatrix views (each a valid CSR over the SAME
    rows).  Returns (bands, band_ids).  The operator uses the stacked
    form; this materialised form serves analysis and the tests."""
    row_ids = _row_ids(csr)
    band, nbands = band_assignment(csr, edges_chunks, num_bands=num_bands,
                                   min_frac=min_frac, row_ids=row_ids)
    bands = [_subset_csr(csr, band == b, row_ids) for b in range(nbands)]
    return bands, band


def _abs_row_sum_max(csr: CsrMatrix) -> float:
    """``max_r sum_j |A[r, j]|`` of a host CSR, in float64."""
    if not csr.num_rows or not csr.num_nonzeros:
        return 0.0
    return float(np.bincount(_row_ids(csr),
                             weights=np.abs(csr.values.astype(np.float64)),
                             minlength=csr.num_rows).max())


class SplitSpmvOperator:
    """Banded SpMV through one stacked-band launch of the merge kernel.

    ``y = alpha * A @ x + beta * y_in`` runs as ``y_v = op(x, alpha)``
    over the stack (``self.op``, an SpmvOperator whose ``plan`` is the
    stacked plan with B * m_pad rows), then the epilogue
    ``y_v.reshape(B, m_pad)[:, :m].sum(0) + beta * y_in`` (or, with
    compact rows, the gather and sorted-segment sum).  ``shape`` is the
    logical (m, n) and ``abs_row_sum_max`` the original matrix's; the
    timers read both.  ``setup_ms`` records the split + prepare cost.
    ``interpret`` (the TPU package's) is accepted and ignored.
    """

    def __init__(self, csr: CsrMatrix, dtype="float32",
                 edges_chunks: Union[Sequence[int], str] = (8, 32),
                 num_bands: int = 5,
                 tile_items: Optional[int] = None,
                 compact_rows: Optional[bool] = None,
                 device=None):
        dev = resolve_device(device)
        t0 = time.perf_counter()
        row_ids = _row_ids(csr)
        band, nb = band_assignment(csr, edges_chunks, num_bands=num_bands,
                                   row_ids=row_ids)
        self.num_bands = nb
        self.num_rows = csr.num_rows
        self.num_cols = csr.num_cols
        self.device = dev
        self.band_nnz = np.bincount(band, minlength=nb).tolist()
        # the tile size comes first: the bands are padded to its boundaries
        if tile_items is None:
            tile_items = split_tile_items(nb * csr.num_rows,
                                          csr.num_nonzeros)
        self._gather_idx = None
        self._seg_ends = None
        # compact rows shrink the stack's row count but replace the
        # reshape-sum by a gather of ~R_total slots; opt-in only, never
        # chosen automatically (split.py:337-343)
        if compact_rows and nb > 1:
            (self.stacked, gidx, sends, self.band_rows
             ) = stack_bands_compact(csr, band, nb, row_ids=row_ids,
                                     tile_items=tile_items)
            self._m_pad = 0
            self._gather_idx = torch.from_numpy(gidx).to(dev)
            self._seg_ends = torch.from_numpy(sends).to(dev)
        else:
            self.stacked, self._m_pad = stack_bands(csr, band, nb,
                                                    row_ids=row_ids,
                                                    tile_items=tile_items)
        self.op = build_operator(self.stacked, dtype=dtype,
                                 tile_items=tile_items, device=dev)
        self.plan = self.op.plan
        self.abs_row_sum_max = _abs_row_sum_max(csr)
        self.setup_ms = (time.perf_counter() - t0) * 1e3

    @classmethod
    def from_stacked(cls, op, num_bands: int, m_pad: int, num_rows: int,
                     band_nnz, setup_ms: float) -> "SplitSpmvOperator":
        """Wrap an already-built full-row stacked operator (the device
        builder's path).  ``abs_row_sum_max`` is taken from the stack: its
        row sums, summed over the bands, are the original rows' sums."""
        self = object.__new__(cls)
        self.op = op
        self.plan = op.plan
        self.num_bands = int(num_bands)
        self._m_pad = int(m_pad)
        self.num_rows = int(num_rows)
        self.num_cols = op.plan.num_cols
        self.device = op.device
        self.band_nnz = list(band_nnz)
        self.stacked = None   # device-built: no host CsrMatrix exists
        self._gather_idx = None
        self._seg_ends = None
        sums = row_abs_sums(op.values, op.row_end_offsets, op.plan.num_rows)
        sums = sums.reshape(self.num_bands, self._m_pad)[:, :self.num_rows]
        self.abs_row_sum_max = (float(sums.sum(0).max())
                                if self.num_rows else 0.0)
        self.setup_ms = float(setup_ms)
        return self

    @property
    def shape(self):
        return (self.num_rows, self.num_cols)

    @property
    def dtype(self) -> str:
        """The name of the dtype op(x) returns (the plan's)."""
        return self.plan.dtype

    def _vec(self, v):
        return None if v is None else torch.as_tensor(v, device=self.device)

    def _gather_rows(self, y_v):
        """The stacked result folded back to the m logical rows."""
        if self._gather_idx is not None:
            return _sorted_segment_sum(y_v.index_select(0, self._gather_idx),
                                       self._seg_ends)
        rest = tuple(y_v.shape[1:])
        return y_v.reshape((self.num_bands, self._m_pad) + rest
                           )[:, :self.num_rows].sum(0)

    def __call__(self, x, y_in=None, alpha=1.0, beta=0.0,
                 interpret: bool = False):
        x, y_in = self._vec(x), self._vec(y_in)
        check_vector_operands(self, x, y_in)
        y = self._gather_rows(self.op(x, alpha=alpha))
        if y_in is not None:
            y = y + beta * y_in.to(y.dtype)
        return y

    def mm(self, X, Y_in=None, alpha=1.0, beta=0.0, interpret: bool = False,
           method: str = "auto"):
        """SpMM: the stacked operator's ``mm`` (one launch per column of
        X), then the same epilogue over k columns."""
        X, Y_in = self._vec(X), self._vec(Y_in)
        check_matrix_operands(self, X, Y_in)
        Y = self._gather_rows(self.op.mm(X, alpha=alpha, method=method))
        if Y_in is not None:
            Y = Y + beta * Y_in.to(Y.dtype)
        return Y

    def describe(self) -> str:
        parts = ", ".join(str(n) for n in self.band_nnz)
        return (f"SplitSpmvOperator({self.num_bands} bands stacked, "
                f"nnz=[{parts}], setup={self.setup_ms:.0f} ms)")


def popularity_assignment(csr: CsrMatrix,
                          coverage: float = 0.5,
                          max_hot_windows: int = 4096,
                          min_gain: float = 2.0):
    """Select hot 128-column windows by nonzero popularity.

    Windows are taken in descending nnz count while (a) a window still
    holds ≥ ``min_gain`` × the mean per-window count (a flat profile
    selects nothing), (b) cumulative coverage < ``coverage``, (c) at most
    ``max_hot_windows``.  Returns ``(hot_mask, hot_windows)``: the
    per-nonzero bool mask and the ASCENDING window ids.  An empty hot set
    means the split is not worth a second launch.
    """
    if csr.num_nonzeros == 0:
        return np.zeros(0, bool), np.empty(0, np.int64)
    nwin = max(1, -(-csr.num_cols // 128))
    win = (csr.col_indices >> 7).astype(np.int32, copy=False)
    wcount = np.bincount(win, minlength=nwin)
    order = np.argsort(wcount)[::-1]
    csum = np.cumsum(wcount[order])
    mean = csr.num_nonzeros / max(1, int((wcount > 0).sum()))
    take = int(np.searchsorted(csum, coverage * csr.num_nonzeros,
                               side="left") + 1)
    take = min(take, max_hot_windows, nwin)
    # drop trailing windows below the gain threshold
    counts_desc = wcount[order[:take]]
    good = counts_desc >= min_gain * mean
    take = int(np.argmin(good)) if not good.all() else take
    if take == 0 or csum[take - 1] < 0.10 * csr.num_nonzeros:
        return np.zeros(csr.num_nonzeros, bool), np.empty(0, np.int64)
    hot_windows = np.sort(order[:take])
    rank = np.full(nwin, -1, np.int32)
    rank[hot_windows] = np.arange(take, dtype=np.int32)
    return rank[win] >= 0, hot_windows


class HotColdSpmvOperator:
    """Hot/cold column split: popular columns compacted, the rest as is.

    The HOT part's columns are remapped to the compact prefix
    ``rank(window) * 128 + (col % 128)``, so its x is ``x[xidx]``, one
    ``index_select`` per call; the COLD part keeps the original columns.
    ``y = hot_op(x_hot, alpha)``, then ``cold_op(x, y_in=y, alpha,
    beta=1)``, then ``+ beta * y_in``: two launches of the fused merge
    kernel, each on its operator's own ticket counter.  ``plan`` is the
    cold operator's (the hot one's when there is no cold part);
    ``shape`` is the logical (m, n), ``abs_row_sum_max`` the original
    matrix's.  ``interpret`` (the TPU package's) is accepted and ignored.
    """

    def __init__(self, csr: CsrMatrix, dtype="float32",
                 coverage: float = 0.5, max_hot_windows: int = 4096,
                 min_gain: float = 2.0,
                 tile_items: Optional[int] = None,
                 backend: str = "auto", device=None):
        dev = resolve_device(device)
        t0 = time.perf_counter()
        hot_mask, hot_windows = popularity_assignment(
            csr, coverage=coverage, max_hot_windows=max_hot_windows,
            min_gain=min_gain)
        self.num_rows = csr.num_rows
        self.num_cols = csr.num_cols
        self.device = dev
        self.num_hot_windows = int(hot_windows.size)
        self.hot_nnz = int(hot_mask.sum())
        self.cold_nnz = csr.num_nonzeros - self.hot_nnz
        self.hot_op = None
        self.cold_op = None
        self._xidx = None
        row_ids = _row_ids(csr)
        if self.num_hot_windows:
            rank = np.full(max(1, -(-csr.num_cols // 128)), -1, np.int32)
            rank[hot_windows] = np.arange(self.num_hot_windows,
                                          dtype=np.int32)
            sel_cols = csr.col_indices[hot_mask]
            new_cols = (rank[sel_cols >> 7] * 128
                        + (sel_cols & 127)).astype(np.int32)
            hot_csr = _subset_csr(csr, hot_mask, row_ids, cols=new_cols,
                                  num_cols=self.num_hot_windows * 128)
            self.hot_op = build_operator(hot_csr, dtype=dtype,
                                         tile_items=tile_items,
                                         backend=backend, device=dev)
            # original column of each compact slot (clamped: slots past
            # num_cols in the last window are never referenced)
            flat = (hot_windows[:, None] * 128
                    + np.arange(128)[None, :]).ravel()
            self._xidx = torch.from_numpy(
                np.minimum(flat, csr.num_cols - 1).astype(np.int32)).to(dev)
        if self.cold_nnz or not self.num_hot_windows:
            cold_csr = _subset_csr(csr, ~hot_mask, row_ids)
            self.cold_op = build_operator(cold_csr, dtype=dtype,
                                          tile_items=tile_items,
                                          backend=backend, device=dev)
        self.plan = (self.cold_op or self.hot_op).plan
        self.abs_row_sum_max = _abs_row_sum_max(csr)
        self.setup_ms = (time.perf_counter() - t0) * 1e3

    @property
    def shape(self):
        return (self.num_rows, self.num_cols)

    @property
    def dtype(self) -> str:
        """The name of the dtype op(x) returns (the plan's)."""
        return self.plan.dtype

    def _vec(self, v):
        return None if v is None else torch.as_tensor(v, device=self.device)

    def __call__(self, x, y_in=None, alpha=1.0, beta=0.0,
                 interpret: bool = False):
        x, y_in = self._vec(x), self._vec(y_in)
        check_vector_operands(self, x, y_in)
        y = None
        if self.hot_op is not None:
            y = self.hot_op(x.index_select(0, self._xidx), alpha=alpha)
        if self.cold_op is not None:
            y = self.cold_op(x, y_in=y, alpha=alpha,
                             beta=0.0 if y is None else 1.0)
        if y_in is not None:
            y = y + beta * y_in.to(y.dtype)
        return y

    def mm(self, X, Y_in=None, alpha=1.0, beta=0.0, interpret: bool = False,
           method: str = "auto"):
        X, Y_in = self._vec(X), self._vec(Y_in)
        check_matrix_operands(self, X, Y_in)
        Y = None
        if self.hot_op is not None:
            Y = self.hot_op.mm(X.index_select(0, self._xidx), alpha=alpha,
                               method=method)
        if self.cold_op is not None:
            Y = self.cold_op.mm(X, Y_in=Y, alpha=alpha,
                                beta=0.0 if Y is None else 1.0,
                                method=method)
        if Y_in is not None:
            Y = Y + beta * Y_in.to(Y.dtype)
        return Y

    def describe(self) -> str:
        hot = (f"{self.num_hot_windows} hot windows, nnz {self.hot_nnz}"
               if self.num_hot_windows else "no hot set")
        return (f"HotColdSpmvOperator({hot} / cold nnz {self.cold_nnz}, "
                f"setup={self.setup_ms:.0f} ms)")


def build_hotcold_operator(csr: CsrMatrix, dtype="float32",
                           coverage: float = 0.5,
                           max_hot_windows: int = 4096,
                           min_gain: float = 2.0,
                           tile_items: Optional[int] = None,
                           backend: str = "auto",
                           device=None) -> HotColdSpmvOperator:
    """Build the hot/cold popularity-split operator (see the class docs).
    ``device=None`` means the card and raises without one; ``"cpu"`` runs
    the merge kernel's plain version."""
    return HotColdSpmvOperator(csr, dtype=dtype, coverage=coverage,
                               max_hot_windows=max_hot_windows,
                               min_gain=min_gain, tile_items=tile_items,
                               backend=backend, device=device)


def build_split_operator(csr: CsrMatrix, dtype="float32",
                         edges_chunks: Union[Sequence[int], str] = (8, 32),
                         num_bands: int = 5,
                         tile_items: Optional[int] = None,
                         compact_rows: Optional[bool] = None,
                         device=None) -> SplitSpmvOperator:
    """Build the banded operator on the host's split (see the module
    docstring for when).  ``device`` as for build_hotcold_operator."""
    return SplitSpmvOperator(csr, dtype=dtype, edges_chunks=edges_chunks,
                             num_bands=num_bands, tile_items=tile_items,
                             compact_rows=compact_rows, device=device)


# ---------------------------------------------------------------------- #
# The device builder: the quantile split's passes as torch operations
# ---------------------------------------------------------------------- #

def _counts_below(d, probes):
    """Number of elements of ``d`` below each of the sorted, unique
    ``probes``: one searchsorted of ``d`` into the probes (how many probes
    each element reaches), a bincount and a cumsum.  Exact, so the counts
    of the JAX builder's chunked compare-reduce (split.py:625-649)
    without its (chunk, P) intermediate."""
    reach = torch.searchsorted(probes, d, right=True)
    return torch.cumsum(torch.bincount(reach, minlength=probes.numel() + 1),
                        0)[:probes.numel()]


def _quantile_edges(d, nnz: int, num_bands: int) -> np.ndarray:
    """Equal-nnz band edges of the signed distances ``d``, 1024-aligned,
    by iterative probe refinement (split.py:788-822): each round counts
    the elements below ~64 aligned probes per unresolved quantile and
    narrows its bracket; the quantile ranks are host integers."""
    dmin, dmax = int(d.min()), int(d.max())
    targets = [int(b * nnz) // num_bands for b in range(1, num_bands)]
    lo = np.full(len(targets), dmin - 1, np.int64)   # count_below(lo) <= t
    hi = np.full(len(targets), dmax + 1, np.int64)   # count_below(hi) > t
    while True:
        probe_sets = []
        for k in range(len(targets)):
            width = hi[k] - lo[k]
            if width <= 1024:
                continue
            step = max(1024, (-(-width // 64) + 1023) // 1024 * 1024)
            probe_sets.append(np.arange(lo[k] + step, hi[k], step,
                                        dtype=np.int64))
        if not probe_sets:
            break
        probes = np.unique(np.concatenate(probe_sets)).astype(np.int32)
        cnts = _counts_below(d, torch.from_numpy(probes).to(d.device)
                             ).cpu().numpy().astype(np.int64)
        for k, t_ in enumerate(targets):
            # tightest probe bracket around rank t_
            below = probes[cnts <= t_]
            above = probes[cnts > t_]
            if below.size:
                lo[k] = max(lo[k], int(below[-1]))
            if above.size:
                hi[k] = min(hi[k], int(above[0]))
    return np.unique((np.round(hi / 1024.0) * 1024).astype(np.int32))


def _stack_on_device(cols, vals, band, ends, order, seg, counts, dst,
                     nb: int, total: int, m_pad: int):
    """The stack's (cols, vals, row ends) from the band order and the
    per-band segment starts ``seg``, sizes ``counts`` and stacked starts
    ``dst`` (int32 tensors; dst[nb] == total), as split.py:660-709 builds
    them: output j belongs to band b = bucket(dst, j), and an offset past
    the band's real nonzeros repeats the band's last column with value
    zero (an empty band's pad takes the column at its start in the sorted
    order, as the JAX builder's, clamped into the array).
    The row ends of band b count its elements up to each row's end with a
    running sum over the original order, plus dst[b]; its last row also
    holds the pad."""
    m = ends.shape[0]
    dev = cols.device
    nnz = cols.shape[0]
    cols_s = cols[order]
    vals_s = vals[order]
    j = torch.arange(total, dtype=torch.int32, device=dev)
    b_of = torch.searchsorted(dst, j, right=True).sub_(1)
    o = j - dst[b_of]
    cnt_b = counts[b_of]
    src = (seg[b_of] + torch.minimum(o, (cnt_b - 1).clamp(min=0))
           ).clamp(max=nnz - 1).long()
    cols_f = cols_s[src].to(torch.int32)
    vals_f = torch.where(o < cnt_b, vals_s[src],
                         torch.zeros((), dtype=vals.dtype, device=dev))
    del cols_s, vals_s, j, b_of, o, cnt_b, src
    last = (ends.long() - 1).clamp(min=0)
    ends_f = torch.empty(nb * m_pad, dtype=torch.int32, device=dev)
    for b in range(nb):
        cs = torch.cumsum(band == b, 0, dtype=torch.int32)
        part = ends_f[b * m_pad:(b + 1) * m_pad]
        part[:m] = torch.where(ends > 0, cs[last], 0) + dst[b]
        part[m:] = dst[b] + counts[b]
        part[m_pad - 1] = dst[b + 1]
    return cols_f, vals_f, ends_f


def build_split_operator_device(csr: CsrMatrix, dtype="float32",
                                num_bands: int = 16,
                                tile_items: Optional[int] = None,
                                backend: str = "auto",
                                device=None) -> SplitSpmvOperator:
    """Quantile-band stacked split built on the operator's device.

    The host builder's NumPy passes over the nonzeros take tens of
    seconds at circuit5M scale; here the original CSR is copied once and
    the heavy passes run as torch operations on the device
    (split.py:730-918):

      1. ``edges``: the signed diagonal distances (a searchsorted over
         the row ends) and their equal-nnz quantile edges by probe
         refinement; only the probe counts come back to the host;
      2. ``order``: a stable sort by band id and the band starts;
      3. ``stack``: the stacked columns, values and row ends in one
         vectorised source-index pass plus one running count per band.

    ``stage_ms`` times each stage (synchronised), ``upload_ms`` the copy,
    ``convert_ms`` the rest of ``setup_ms``.  The JAX builder's
    per-1024-block column extents and its ``r_win`` / ``x_win`` /
    ``row_span`` reductions feed only the TPU's gather plan, which the
    port does not have (Hopper gathers x through its caches): they are
    left out.  fp32 only, as the JAX builder.  ``device=None`` means the
    card; ``device="cpu"`` runs every stage and the merge kernel's plain
    version on the CPU, with the same arrays.
    """
    if dtype_name(dtype) != "float32":
        raise ValueError("the device split builder is fp32-only")
    dev = resolve_device(device)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    t_start = time.perf_counter()
    m, n, nnz = csr.num_rows, csr.num_cols, csr.num_nonzeros
    if nnz == 0:
        raise ValueError("the device split builder needs nonzeros")
    vals_d, ends_d, cols_d = csr.to_device(dtype=torch.float32, device=dev)
    sync()
    upload_ms = (time.perf_counter() - t_start) * 1e3
    stage_ms = {"upload": upload_ms}
    t_m = time.perf_counter()

    def mark(name):
        nonlocal t_m
        sync()
        stage_ms[name] = (time.perf_counter() - t_m) * 1e3
        t_m = time.perf_counter()

    rows = torch.searchsorted(ends_d, torch.arange(nnz, dtype=torch.int32,
                                                   device=dev),
                              right=True, out_int32=True)
    d = cols_d - rows
    del rows
    edges = _quantile_edges(d, nnz, int(num_bands))
    mark("edges")
    nb = len(edges) + 1
    if nb == 1:
        base = build_operator(csr, dtype=dtype, tile_items=tile_items,
                              backend=backend, device=dev)
        return SplitSpmvOperator.from_stacked(
            base, 1, m, m, [nnz], (time.perf_counter() - t_start) * 1e3)

    band = torch.searchsorted(torch.from_numpy(edges).to(dev), d,
                              right=True, out_int32=True)
    del d
    band_sorted, order = torch.sort(band, stable=True)
    seg_t = torch.searchsorted(band_sorted, torch.arange(
        nb, dtype=torch.int32, device=dev), out_int32=True)
    seg = np.concatenate([seg_t.cpu().numpy().astype(np.int64), [nnz]])
    del band_sorted
    mark("order")
    counts = np.diff(seg)

    m_pad = -(-m // _BAND_ALIGN) * _BAND_ALIGN
    if tile_items is None:
        tile_items = split_tile_items(nb * m_pad, nnz)
    _check_tile_items(tile_items)
    pads = (-(m_pad + counts)) % tile_items
    dst = np.concatenate([[0], np.cumsum(counts + pads)]).astype(np.int64)
    # the JAX builder's static total (split.py:846-856): a function of
    # (nnz, nb, m_pad, tile_items) alone; the last band's pad takes up
    # the difference
    t0 = nnz + (nb + 1) * tile_items
    total = t0 - (t0 + nb * m_pad) % tile_items
    assert total >= int(dst[-1]) and (total - int(dst[-1])) % tile_items == 0
    pads[-1] += total - int(dst[-1])
    dst = np.concatenate([[0], np.cumsum(counts + pads)]).astype(np.int64)
    # raises when the stack's rows + merge items outgrow int32
    plan = make_plan(nb * m_pad, n, total, dtype=dtype,
                     tile_items=tile_items, backend=backend, device=dev)

    as_i32 = lambda a: torch.from_numpy(  # noqa: E731
        np.ascontiguousarray(a, dtype=np.int32)).to(dev)
    cols_f, vals_f, ends_f = _stack_on_device(
        cols_d, vals_d, band, ends_d, order, as_i32(seg[:-1]),
        as_i32(counts), as_i32(dst), nb, total, m_pad)
    del cols_d, vals_d, band, order
    mark("stack")
    plan = dataclasses.replace(plan, policy=gather_policy(
        plan.num_rows, plan.num_nonzeros, cols_f, plan.dtype))
    op = assemble_operator(plan, vals_f, ends_f, cols_f)
    mark("plan_prepare")
    sop = SplitSpmvOperator.from_stacked(
        op, nb, m_pad, m, counts.tolist(),
        (time.perf_counter() - t_start) * 1e3)
    sop.upload_ms = upload_ms
    sop.convert_ms = sop.setup_ms - upload_ms
    sop.stage_ms = {k: round(v, 1) for k, v in stage_ms.items()}
    return sop
