"""Prepare-time matrix splitting on the host (NumPy).

Counterpart of merge_spmv_tpu/ops/split.py.  For now it holds the two
helpers the DIA operator needs (split.py:52-55, 270-286): the per-nonzero
row ids and the CSR of a subset of the nonzeros.  The banded, stacked and
hot/cold split operators are the next slice of the port.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from merge_spmv_tpu_torch.formats.csr import CsrMatrix

__all__ = ["_row_ids", "_subset_csr"]


def _row_ids(csr: CsrMatrix) -> np.ndarray:
    lens = np.diff(csr.row_offsets)
    return np.repeat(np.arange(csr.num_rows, dtype=np.int32),
                     lens).astype(np.int32, copy=False)


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
