"""Diagonal (DIA) split operator — the structured-matrix fast path.

Counterpart of merge_spmv_tpu/ops/dia.py.  Stencil matrices (grid2d/grid3d
Laplacians, banded FEM with exact offsets) hold their nonzeros on a few
diagonals.  For each stored diagonal d, ``y += v_d * x[r + d]`` needs no
column index and no merge bookkeeping: the table streams, and x is read at
a fixed shift.

Prepare time histograms the column-row offsets; if the densest
``max_diags`` diagonals cover at least ``min_coverage`` of the nonzeros,
they are densified into a (D, m) table and the leftover nonzeros (if any)
chain through the merge-path operator (ops/operator.py).  Otherwise the
split declines and the whole matrix goes through the merge operator.  Like
the reference's cuSPARSE HybMV comparison point (gpu_spmv.cu:106-251) it
is an opt-in that trades setup, reported as ``setup_ms``, for per-call
speed.

On the card the diagonal part is the CUDA kernel of ops/dia_cuda.py (K3)
for every dtype and every D: the TPU package's gate (``_pallas_ok``,
dia.py:150-160) guarded VMEM and a Mosaic limit of 16 diagonals, neither
of which the card has.  ``device="cpu"`` runs the kernels' plain versions.
bfloat16 rounds the table and x to bfloat16, computes in float32 and rounds
the result once.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from merge_spmv_tpu_torch.formats.csr import CsrMatrix
from merge_spmv_tpu_torch.ops.csrmv import (check_matrix_operands,
                                            check_vector_operands,
                                            compute_dtype)
from merge_spmv_tpu_torch.ops.dia_cuda import dia_matvec
from merge_spmv_tpu_torch.ops.operator import build_operator, row_abs_sums
from merge_spmv_tpu_torch.ops.split import _row_ids, _subset_csr
from merge_spmv_tpu_torch.utils.device import (dtype_name, itemsize,
                                               resolve_device, torch_dtype)

__all__ = ["diagonal_assignment", "DiaPlan", "DiaSpmvOperator",
           "build_dia_operator"]

# offset histogram cap: a true-DIA matrix has a tiny offset range; a
# range beyond this is scatter, not structure (the bincount below would
# also allocate range*8 bytes)
_RANGE_CAP = 1 << 24


def diagonal_assignment(csr: CsrMatrix, max_diags: int = 32,
                        min_coverage: float = 0.5,
                        dense_frac: float = 0.2,
                        row_ids: Optional[np.ndarray] = None):
    """Pick the dense diagonals.

    A diagonal is worth densifying when it holds at least ``dense_frac``
    of its full length in nonzeros (a (D, m) band costs m values to
    store and stream regardless of fill; below ~1/3 fill the CSR bytes
    are cheaper, and sparse bands waste the multiply).  The densest
    ``max_diags`` such diagonals are taken; if together they cover less
    than ``min_coverage`` of the nonzeros the split DECLINES — this is
    scatter, not structure.

    Returns ``(offsets, diag_mask)``: chosen signed offsets (ascending,
    int64) and the per-nonzero bool mask of entries on them.
    """
    if csr.num_nonzeros == 0:
        return np.empty(0, np.int64), np.zeros(0, bool)
    if row_ids is None:
        row_ids = _row_ids(csr)
    d = csr.col_indices.astype(np.int64, copy=False) - row_ids
    dmin, dmax = int(d.min()), int(d.max())
    if dmax - dmin >= _RANGE_CAP:
        return np.empty(0, np.int64), np.zeros(csr.num_nonzeros, bool)
    cnt = np.bincount((d - dmin).astype(np.int64),
                      minlength=dmax - dmin + 1)
    # full length of diagonal at offset o within the m x n rectangle
    offs_all = np.arange(dmin, dmax + 1)
    dlen = (np.minimum(csr.num_rows, csr.num_cols - offs_all)
            - np.maximum(0, -offs_all)).clip(1)
    dense = np.flatnonzero(cnt >= dense_frac * dlen)
    if dense.size > max_diags:
        dense = dense[np.argsort(cnt[dense])[::-1][:max_diags]]
    covered = int(cnt[dense].sum())
    if dense.size == 0 or covered < min_coverage * csr.num_nonzeros:
        return np.empty(0, np.int64), np.zeros(csr.num_nonzeros, bool)
    offsets = np.sort(dense) + dmin
    keep = np.zeros(dmax - dmin + 1, bool)
    keep[offsets - dmin] = True
    return offsets.astype(np.int64), keep[(d - dmin).astype(np.int64)]


@dataclasses.dataclass(frozen=True)
class DiaPlan:
    """Shapes of a DIA operator: the whole matrix, its D diagonals and the
    leftover nonzeros that chain through the merge operator."""
    num_rows: int
    num_cols: int
    num_nonzeros: int
    dtype: str
    num_diags: int
    rest_nnz: int

    def table_bytes_accessed(self) -> int:
        """Least HBM bytes of the diagonal kernel: the (D, m) table, x and
        y, each once, in the compute type."""
        vs = itemsize(compute_dtype(self.dtype))
        if not self.num_diags:
            return 0
        return vs * (self.num_diags * self.num_rows + self.num_cols
                     + self.num_rows)


class DiaSpmvOperator:
    """Dominant diagonals densified, leftover through the merge path.

    ``y = alpha*A@x + beta*y_in`` runs in the JAX operator's order: the
    diagonal kernel gives ``acc = alpha * (table part)``, the leftover
    operator adds its part as ``rest_op(x, y_in=acc, alpha, beta=1)``, and
    ``beta * y_in`` is added last.  ``vtab`` is held on the device in the
    compute dtype; ``abs_row_sum_max`` is ``max_r sum_j |A[r, j]|``, taken
    once at build (duplicates summed, as the table sums them).
    """

    def __init__(self, csr: CsrMatrix, dtype="float32",
                 max_diags: int = 32, min_coverage: float = 0.5,
                 tile_items: Optional[int] = None, backend: str = "auto",
                 device=None):
        dev = resolve_device(device)
        t0 = time.perf_counter()
        row_ids = _row_ids(csr)
        offsets, mask = diagonal_assignment(csr, max_diags=max_diags,
                                            min_coverage=min_coverage,
                                            row_ids=row_ids)
        self.num_rows = m = csr.num_rows
        self.num_cols = csr.num_cols
        self.offsets = offsets
        self.dia_nnz = int(mask.sum())
        self.rest_nnz = csr.num_nonzeros - self.dia_nnz
        self.device = dev
        self.dtype = dtype_name(dtype)
        self._store_dt = torch_dtype(self.dtype)
        self._cdt = compute_dtype(self.dtype)
        self.vtab = None
        self.offsets_t = None
        self.rest_op = None
        sums = torch.zeros(m, dtype=torch.float64, device=dev)
        if offsets.size:
            d = csr.col_indices.astype(np.int64, copy=False) - row_ids
            # one bucketing pass: flat (diag_rank, row) bincount sums
            # duplicates with the same semantics as the CSR gold
            rank = np.searchsorted(offsets, d[mask])
            flat = rank * m + row_ids[mask]
            vtab = np.bincount(
                flat, weights=csr.values[mask].astype(np.float64),
                minlength=offsets.size * m).reshape(offsets.size, m)
            self.vtab = self._rounded(torch.from_numpy(vtab)).to(dev)
            self.offsets_t = torch.from_numpy(offsets).to(dev)
            sums += self.vtab.abs().double().sum(0)
        if self.rest_nnz or not offsets.size:
            # declined => the original CSR is the rest; no copy
            rest = (_subset_csr(csr, ~mask, row_ids) if offsets.size
                    else csr)
            rest_dtype = self.dtype
            if self._store_dt != self._cdt:
                # round once to bfloat16, then keep float32: the leftover
                # part returns float32 and the result is rounded once
                rest = CsrMatrix(rest.num_rows, rest.num_cols,
                                 rest.row_offsets, rest.col_indices,
                                 self._rounded(torch.from_numpy(
                                     np.asarray(rest.values))).numpy())
                rest_dtype = dtype_name(self._cdt)
            self.rest_op = build_operator(rest, dtype=rest_dtype,
                                          tile_items=tile_items,
                                          backend=backend, device=dev)
            sums += row_abs_sums(self.rest_op.values,
                                 self.rest_op.row_end_offsets, m)
        self.abs_row_sum_max = float(sums.max()) if m else 0.0
        self.plan = DiaPlan(m, csr.num_cols, csr.num_nonzeros, self.dtype,
                            int(offsets.size), self.rest_nnz)
        self.setup_ms = (time.perf_counter() - t0) * 1e3

    @property
    def shape(self):
        return (self.num_rows, self.num_cols)

    def _rounded(self, t):
        """Values rounded to the operator's dtype, held in its compute
        dtype."""
        return t.to(self._store_dt).to(self._cdt)

    def _vec(self, v):
        return None if v is None else torch.as_tensor(v, device=self.device)

    def __call__(self, x, y_in=None, alpha=1.0, beta=0.0,
                 interpret: bool = False):
        """``interpret`` is the TPU package's; accepted and ignored."""
        x, y_in = self._vec(x), self._vec(y_in)
        check_vector_operands(self.plan, x, y_in)
        xv = self._rounded(x).contiguous()
        y = None
        if self.vtab is not None:
            y = dia_matvec(self.vtab, xv, self.offsets_t, self.num_rows,
                           self.num_cols, alpha)
        if self.rest_op is not None:
            y = self.rest_op(xv, y_in=y, alpha=alpha,
                             beta=0.0 if y is None else 1.0)
        if y_in is not None:
            y = y + beta * y_in.to(self._cdt)
        return y.to(self._store_dt)

    def mm(self, X, Y_in=None, alpha=1.0, beta=0.0, interpret: bool = False,
           method: str = "auto"):
        """SpMM: the diagonal kernel once per column of X, then the
        leftover operator's ``mm`` (one merge pass per column).
        ``method="wide"`` raises, as SpmvOperator.mm does; ``interpret``
        is accepted and ignored."""
        if method == "wide":
            raise ValueError(
                "method='wide' is retired: the multi-RHS kernel measured "
                "~0.3x the per-column loop on the TPU (BENCH_SPMM.json).  "
                "Use method='auto' (column loop).")
        if method not in ("auto", "column"):
            raise ValueError(f"unknown method {method!r}")
        X, Y_in = self._vec(X), self._vec(Y_in)
        check_matrix_operands(self.plan, X, Y_in)
        Xv = self._rounded(X)
        Y = None
        if self.vtab is not None:
            Y = torch.stack([
                dia_matvec(self.vtab, Xv[:, k].contiguous(), self.offsets_t,
                           self.num_rows, self.num_cols, alpha)
                for k in range(X.shape[1])], dim=1)
        if self.rest_op is not None:
            Y = self.rest_op.mm(Xv, Y_in=Y, alpha=alpha,
                                beta=0.0 if Y is None else 1.0)
        if Y_in is not None:
            Y = Y + beta * Y_in.to(self._cdt)
        return Y.to(self._store_dt)

    def describe(self) -> str:
        dia = (f"{self.offsets.size} diagonals, nnz {self.dia_nnz}"
               if self.offsets.size else "no diagonal structure")
        return (f"DiaSpmvOperator({dia} / rest nnz {self.rest_nnz}, "
                f"setup={self.setup_ms:.0f} ms, {self.dtype} on "
                f"{self.device})")


def build_dia_operator(csr: CsrMatrix, dtype="float32",
                       max_diags: int = 32, min_coverage: float = 0.5,
                       tile_items: Optional[int] = None,
                       backend: str = "auto", device=None) -> DiaSpmvOperator:
    """Build the DIA split operator (see the class docs for when).
    ``device=None`` means the card and raises without one; ``"cpu"`` runs
    the kernels' plain versions.  ``tile_items`` and ``backend`` go to the
    leftover merge operator."""
    return DiaSpmvOperator(csr, dtype=dtype, max_diags=max_diags,
                           min_coverage=min_coverage,
                           tile_items=tile_items, backend=backend,
                           device=device)
