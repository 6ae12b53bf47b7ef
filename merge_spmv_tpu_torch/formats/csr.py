"""CSR sparse-matrix container: COO→CSR conversion, gold SpMV, statistics.

Capability parity with the reference CsrMatrix (sparse_matrix.h:633-978):

* stable sort of COO tuples by (row, col) — duplicate coordinates retained
  as distinct nonzeros in their original relative order,
* `row_offsets` with empty-row backfill (rows with no entries get
  offsets[r] == offsets[r+1]); trailing empty rows point at nnz,
* graph statistics (row-length mean / std-dev / CoV / skewness, Pearson r,
  diag-distance) and the log10 row-length histogram,
* a sequential gold SpMV ``y = alpha*A*x + beta*y_in`` (cpu_spmv.cpp:257-277)
  used as the differential-test oracle for every device backend.

The analog of the reference's NUMA-aware placement (sparse_matrix.h:679-699)
is an explicit copy of the arrays to a torch device; see
CsrMatrix.to_device().
"""

from __future__ import annotations

import numpy as np

from merge_spmv_tpu_torch.formats.coo import CooMatrix
from merge_spmv_tpu_torch.formats.stats import GraphStats

__all__ = ["CsrMatrix"]


class CsrMatrix:
    """Compressed-sparse-row matrix on the host.

    Attributes
    ----------
    num_rows, num_cols : int
    row_offsets : int32 ndarray [num_rows + 1]
    col_indices : int32 ndarray [nnz]
    values : float ndarray [nnz]
    """

    def __init__(self, num_rows, num_cols, row_offsets, col_indices, values):
        self.num_rows = int(num_rows)
        self.num_cols = int(num_cols)
        self.row_offsets = np.asarray(row_offsets, dtype=np.int32)
        self.col_indices = np.asarray(col_indices, dtype=np.int32)
        self.values = np.asarray(values)
        if len(self.row_offsets) != self.num_rows + 1:
            raise ValueError("row_offsets must have num_rows+1 entries")
        if len(self.col_indices) != len(self.values):
            raise ValueError("col_indices/values length mismatch")

    @property
    def num_nonzeros(self) -> int:
        return len(self.values)

    @property
    def row_end_offsets(self):
        """Merge list A — row *end* offsets (device_spmv.cuh:148 passes
        ``d_row_offsets + 1``)."""
        return self.row_offsets[1:]

    # ------------------------------------------------------------------ #
    # Construction
    # ------------------------------------------------------------------ #

    @classmethod
    def from_coo(cls, coo: CooMatrix, use_native: bool = True):
        """Build CSR from COO via stable (row, col) sort + searchsorted
        offsets — the vectorized equivalent of sparse_matrix.h:666-728.

        With ``use_native`` and at least 2^16 nonzeros, the C++ parallel
        stable sort (csrc/market_io.cpp) builds the same arrays; NumPy
        runs where the library is unavailable, for non-float values and
        for row ids outside [0, num_rows).
        """
        if (use_native and coo.num_nonzeros >= (1 << 16)
                and coo.vals.dtype.kind == "f" and coo.vals.itemsize <= 8
                and int(coo.rows.min()) >= 0
                and int(coo.rows.max()) < coo.num_rows):
            from merge_spmv_tpu_torch.formats import native_io
            if native_io.available():
                ro, ci, vals = native_io.coo_to_csr(
                    coo.num_rows, coo.rows, coo.cols, coo.vals)
                return cls(coo.num_rows, coo.num_cols, ro, ci, vals)
        order = np.lexsort((coo.cols, coo.rows))  # stable: row major, col minor
        rows_sorted = coo.rows[order]
        col_indices = coo.cols[order]
        values = coo.vals[order]
        # searchsorted on the sorted row ids produces offsets with empty-row
        # backfill for free (empty rows collapse to equal offsets).
        row_offsets = np.searchsorted(
            rows_sorted, np.arange(coo.num_rows + 1), side="left"
        ).astype(np.int32)
        return cls(coo.num_rows, coo.num_cols, row_offsets, col_indices, values)

    @classmethod
    def from_market(cls, path: str, default_value: float = 1.0,
                    value_dtype=np.float64):
        return cls.from_coo(CooMatrix.from_market(path, default_value,
                                                  value_dtype=value_dtype))

    @classmethod
    def from_arrays(cls, num_rows, num_cols, row_offsets, col_indices,
                    values):
        """Wrap existing CSR arrays (numpy) without conversion: the hand-off
        point for a matrix built elsewhere, so two implementations can
        compute on identical data."""
        return cls(num_rows, num_cols, np.asarray(row_offsets),
                   np.asarray(col_indices), np.asarray(values))

    def astype(self, dtype):
        return CsrMatrix(self.num_rows, self.num_cols, self.row_offsets,
                         self.col_indices, self.values.astype(dtype))

    def relabel_rows(self, relabel_indices):
        """Row permutation (capability parity with InitCsrRelabel,
        sparse_matrix.h:189-211): returns a COO whose row ids are remapped
        through `relabel_indices`."""
        relabel = np.asarray(relabel_indices, dtype=np.int32)
        row_ids = self.row_ids()
        return CooMatrix(self.num_rows, self.num_cols,
                         relabel[row_ids], self.col_indices, self.values)

    def row_ids(self):
        """Per-nonzero row id (expansion of row_offsets)."""
        lengths = np.diff(self.row_offsets)
        return np.repeat(np.arange(self.num_rows, dtype=np.int32), lengths)

    # ------------------------------------------------------------------ #
    # Gold model
    # ------------------------------------------------------------------ #

    def spmv_gold(self, x, y_in=None, alpha=1.0, beta=0.0):
        """Sequential-semantics gold SpMV (cpu_spmv.cpp:257-277):
        ``y[r] = beta*y_in[r] + alpha * sum_j values[j] * x[col[j]]``."""
        x = np.asarray(x)
        products = self.values * x[self.col_indices]
        sums = np.bincount(
            self.row_ids(), weights=products, minlength=self.num_rows
        ).astype(self.values.dtype)
        y = alpha * sums
        if beta != 0.0:
            if y_in is None:
                raise ValueError("beta != 0 requires y_in")
            y = y + beta * np.asarray(y_in)
        return y

    def spmv_abs_bound(self, x, y_in=None, alpha=1.0, beta=0.0,
                       segmented_block: int = 1024):
        """Per-row backward-error condition scale for SpMV verification:
        ``|alpha| * |A| @ |x| + |beta * y_in|`` plus a cumsum-difference
        prefix term.

        The first term is the classic bound: rows whose true sum nearly
        cancels can only be computed to ~eps times this scale by ANY
        summation order.  The second term is specific to segmented
        reduction via prefix-sum DIFFERENCES (the merge kernel's form,
        like the reference's scan-based fixup): a row's value is
        ``S(end) - S(start)`` where S is a running fp32 prefix over the
        row's ``segmented_block``-item block, so each endpoint carries
        ~eps * |prefix| rounding REGARDLESS of the row's own magnitude.
        A one-nonzero row of value 1.4e-5 sitting at a signed prefix of
        -27 legitimately comes back with ~ULP(27) = 1.9e-6 error — the
        webbase-class matrices (signed values, heavy cancellation) fail
        any per-row-only bound this way.  The prefix scale is the max
        |running signed prefix| of the row's endpoint blocks, pre-scaled
        so the comparator's BWD_TOL (4096 eps) applies ~32 eps to it
        (cumsum tree depth 10 + carry chain, with margin).  Pass
        ``segmented_block=0`` for the pure classic bound."""
        x = np.asarray(x)
        signed = self.values * x[self.col_indices]
        products = np.abs(signed)
        sums = np.bincount(
            self.row_ids(), weights=products, minlength=self.num_rows
        ).astype(np.float64)
        bound = abs(alpha) * sums
        if segmented_block and self.num_nonzeros:
            B = segmented_block
            nb = -(-self.num_nonzeros // B)
            ps = np.zeros(nb * B, np.float32)   # f32: it is a bound scale
            ps[:self.num_nonzeros] = signed
            # block-local running prefixes, max |.| per block
            cs = np.cumsum(ps.reshape(nb, B), axis=1, dtype=np.float32)
            mb = np.abs(cs).max(axis=1).astype(np.float64)
            # the start endpoint actually read is S(start - 1), which
            # lives in block (start-1)//B when a row begins exactly on a
            # block boundary (ADVICE r4: the unshifted form could miss
            # the previous block's larger prefix scale for that row class)
            starts = np.minimum(
                np.maximum(self.row_offsets[:-1] - 1, 0) // B, nb - 1)
            ends = np.maximum(self.row_offsets[1:] - 1, 0) // B
            prefix_scale = mb[starts] + mb[np.minimum(ends, nb - 1)]
            bound = bound + abs(alpha) * prefix_scale * (32.0 / 4096.0)
        if beta != 0.0 and y_in is not None:
            bound = bound + np.abs(beta * np.asarray(y_in))
        return bound

    def spmm_gold(self, X, Y_in=None, alpha=1.0, beta=0.0):
        """Gold SpMM: X is [num_cols, k]."""
        X = np.asarray(X)
        gathered = X[self.col_indices] * self.values[:, None]
        row_ids = self.row_ids()
        out = np.zeros((self.num_rows, X.shape[1]), dtype=self.values.dtype)
        np.add.at(out, row_ids, gathered)
        out = alpha * out
        if beta != 0.0:
            if Y_in is None:
                raise ValueError("beta != 0 requires Y_in")
            out = out + beta * np.asarray(Y_in)
        return out

    def to_dense(self):
        dense = np.zeros((self.num_rows, self.num_cols), dtype=self.values.dtype)
        np.add.at(dense, (self.row_ids(), self.col_indices), self.values)
        return dense

    # ------------------------------------------------------------------ #
    # Device placement
    # ------------------------------------------------------------------ #

    def to_device(self, dtype=None, device=None):
        """Copy the CSR arrays to a torch device.

        Returns (values, row_end_offsets, col_indices) as torch tensors: the
        values in ``dtype`` (a torch dtype or a numpy/str name; default the
        host dtype) and int32 indices.  The merge list A is the row *end*
        offsets, matching device_spmv.cuh:148.  ``device=None`` means CUDA.
        """
        import torch

        from merge_spmv_tpu_torch.utils.device import resolve_device, torch_dtype

        device = resolve_device(device)
        dt = torch_dtype(self.values.dtype if dtype is None else dtype)
        host = self.values
        if host.dtype.name == "bfloat16":   # numpy holds it only via ml_dtypes
            host = host.astype(np.float32)
        vals = torch.from_numpy(np.ascontiguousarray(host))
        return (vals.to(device=device, dtype=dt),
                torch.from_numpy(np.ascontiguousarray(
                    self.row_end_offsets, dtype=np.int32)).to(device),
                torch.from_numpy(np.ascontiguousarray(
                    self.col_indices, dtype=np.int32)).to(device))

    # ------------------------------------------------------------------ #
    # Statistics / display
    # ------------------------------------------------------------------ #

    def stats(self) -> GraphStats:
        return GraphStats.from_csr(self)

    def row_length_histogram(self):
        """Log10 row-length bucket counts (sparse_matrix.h:919-956).

        Returns (log_counts, max_length): log_counts[0] counts empty rows
        (bucket 1e-1), log_counts[b] counts rows with 10^(b-1) <= len < 10^b.
        """
        lengths = np.diff(self.row_offsets)
        max_length = int(lengths.max()) if len(lengths) else 0
        log_len = np.full(lengths.shape, -1, dtype=np.int64)
        nz = lengths > 0
        log_len[nz] = np.floor(np.log10(lengths[nz])).astype(np.int64)
        counts = np.bincount(log_len + 1, minlength=10)
        return counts, max_length

    def display_histogram(self, out=print):
        counts, max_length = self.row_length_histogram()
        out(f"CSR matrix ({self.num_rows} rows, {self.num_cols} columns, "
            f"{self.num_nonzeros} non-zeros, max-length {max_length}):")
        top = int(np.max(np.nonzero(counts)[0])) if counts.any() else 0
        for b in range(top + 1):
            pct = 100.0 * counts[b] / self.num_cols if self.num_cols else 0.0
            out(f"\tDegree 1e{b - 1}: \t{counts[b]} ({pct:.2f}%)")

    def display(self, out=print):
        """Debug dump (sparse_matrix.h:962-975)."""
        out(f"Input Matrix ({self.num_rows} vertices, {self.num_nonzeros} nonzeros):")
        for r in range(self.num_rows):
            lo, hi = self.row_offsets[r], self.row_offsets[r + 1]
            entries = ", ".join(
                f"{self.col_indices[j]} ({self.values[j]:f})"
                for j in range(lo, hi))
            out(f"{r} [@{lo}, #{hi - lo}]: {entries}")

    def __repr__(self):
        return (f"CsrMatrix({self.num_rows}x{self.num_cols}, "
                f"nnz={self.num_nonzeros}, dtype={self.values.dtype})")
