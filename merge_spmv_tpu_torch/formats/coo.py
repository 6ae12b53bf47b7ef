"""COO sparse-matrix container and synthetic generators.

Capability parity with the reference CooMatrix (sparse_matrix.h:119-618):
Matrix Market ingest plus dense / wheel / grid2d / grid3d generators, with the
same shapes and nonzero counts.  Adds uniform-random and power-law (skewed)
generators used by the skew-invariance benchmarks — the adversarial row-length
distributions the merge-path algorithm is designed for.

Generators are vectorized NumPy (no per-edge scalar loops).
"""

from __future__ import annotations

import numpy as np

from merge_spmv_tpu_torch.formats import market as _market

__all__ = ["CooMatrix"]


class CooMatrix:
    """Coordinate-format sparse matrix on the host.

    Attributes
    ----------
    num_rows, num_cols : int
    rows, cols : int32 ndarray [nnz]
    vals : float ndarray [nnz]
    """

    def __init__(self, num_rows, num_cols, rows, cols, vals):
        self.num_rows = int(num_rows)
        self.num_cols = int(num_cols)
        self.rows = np.asarray(rows, dtype=np.int32)
        self.cols = np.asarray(cols, dtype=np.int32)
        self.vals = np.asarray(vals)
        if not (len(self.rows) == len(self.cols) == len(self.vals)):
            raise ValueError("rows/cols/vals length mismatch")

    @property
    def num_nonzeros(self) -> int:
        return len(self.vals)

    # ------------------------------------------------------------------ #
    # Ingest
    # ------------------------------------------------------------------ #

    @classmethod
    def from_market(cls, path: str, default_value: float = 1.0,
                    value_dtype=np.float64, use_native: bool = True):
        """Parse a Matrix Market file (sparse_matrix.h:217-380 semantics).

        With ``use_native``, tries the C++ parser (csrc/market_io.cpp)
        first: the same arrays as the NumPy parser, except that a
        symmetric file's mirrored entries follow each original instead of
        coming after all of them.  The vectorized NumPy parser runs where
        the library is unavailable, and on a file the C++ parser rejects,
        so a malformed file gets the NumPy parser's diagnosis.
        """
        if use_native:
            from merge_spmv_tpu_torch.formats import native_io
            if native_io.available():
                try:
                    nr, nc, rows, cols, vals = native_io.read_market(
                        path, default_value, value_dtype)
                    return cls(nr, nc, rows, cols, vals)
                except ValueError:
                    pass
        nr, nc, rows, cols, vals = _market.read_market(
            path, default_value, value_dtype=value_dtype)
        return cls(nr, nc, rows, cols, vals)

    def to_market(self, path: str):
        _market.write_market(path, self.num_rows, self.num_cols,
                             self.rows, self.cols, self.vals)

    # ------------------------------------------------------------------ #
    # Generators (parity: sparse_matrix.h InitDense/InitWheel/InitGrid2d/3d)
    # ------------------------------------------------------------------ #

    @classmethod
    def dense(cls, num_rows: int, num_cols: int, default_value: float = 1.0,
              dtype=np.float64):
        """Dense matrix stored as COO (sparse_matrix.h:386-413)."""
        idx = np.arange(num_rows * num_cols, dtype=np.int64)
        rows = (idx // num_cols).astype(np.int32)
        cols = (idx % num_cols).astype(np.int32)
        vals = np.full(idx.size, default_value, dtype=dtype)
        return cls(num_rows, num_cols, rows, cols, vals)

    @classmethod
    def wheel(cls, spokes: int, default_value: float = 1.0, dtype=np.float64):
        """Wheel graph: one hub row with `spokes` nonzeros + a 1-nnz rim row
        per spoke (sparse_matrix.h:419-452).  The canonical row-length-skew
        adversary: row 0 has `spokes` entries, every other row exactly one.
        """
        s = int(spokes)
        hub_rows = np.zeros(s, dtype=np.int32)
        hub_cols = np.arange(1, s + 1, dtype=np.int32)
        rim_rows = np.arange(1, s + 1, dtype=np.int32)
        rim_cols = ((np.arange(s, dtype=np.int64) + 1) % s + 1).astype(np.int32)
        rows = np.concatenate([hub_rows, rim_rows])
        cols = np.concatenate([hub_cols, rim_cols])
        vals = np.full(2 * s, default_value, dtype=dtype)
        return cls(s + 1, s + 1, rows, cols, vals)

    @classmethod
    def grid2d(cls, width: int, self_loop: bool = False,
               default_value: float = 1.0, dtype=np.float64):
        """width×width 4-point lattice (sparse_matrix.h:461-526)."""
        w = int(width)
        n = w * w
        j, k = np.divmod(np.arange(n, dtype=np.int64), w)
        stencil = []
        # West / East / North / South, clipped at the boundary.
        stencil.append((k - 1 >= 0, j * w + (k - 1)))
        stencil.append((k + 1 < w, j * w + (k + 1)))
        stencil.append((j - 1 >= 0, (j - 1) * w + k))
        stencil.append((j + 1 < w, (j + 1) * w + k))
        if self_loop:
            stencil.append((np.ones(n, dtype=bool), j * w + k))
        me = j * w + k
        rows = np.concatenate([me[m] for m, nb in stencil]).astype(np.int32)
        cols = np.concatenate([nb[m] for m, nb in stencil]).astype(np.int32)
        vals = np.full(rows.size, default_value, dtype=dtype)
        return cls(n, n, rows, cols, vals)

    @classmethod
    def grid3d(cls, width: int, self_loop: bool = False,
               default_value: float = 1.0, dtype=np.float64):
        """width³ 6-point lattice (sparse_matrix.h:533-617)."""
        w = int(width)
        n = w * w * w
        idx = np.arange(n, dtype=np.int64)
        i, rem = np.divmod(idx, w * w)
        j, k = np.divmod(rem, w)
        stencil = [
            (k - 1 >= 0, i * w * w + j * w + (k - 1)),
            (k + 1 < w, i * w * w + j * w + (k + 1)),
            (j - 1 >= 0, i * w * w + (j - 1) * w + k),
            (j + 1 < w, i * w * w + (j + 1) * w + k),
            (i - 1 >= 0, (i - 1) * w * w + j * w + k),
            (i + 1 < w, (i + 1) * w * w + j * w + k),
        ]
        if self_loop:
            stencil.append((np.ones(n, dtype=bool), idx))
        rows = np.concatenate([idx[m] for m, nb in stencil]).astype(np.int32)
        cols = np.concatenate([nb[m] for m, nb in stencil]).astype(np.int32)
        vals = np.full(rows.size, default_value, dtype=dtype)
        return cls(n, n, rows, cols, vals)

    # ------------------------------------------------------------------ #
    # Random generators (new capability; used by skew-invariance benches)
    # ------------------------------------------------------------------ #

    @classmethod
    def random_uniform(cls, num_rows: int, num_cols: int, nnz_per_row: int,
                       seed: int = 0, dtype=np.float64):
        """Uniform row lengths: every row has exactly `nnz_per_row` entries at
        random column positions (duplicates possible, as in real corpora)."""
        rng = np.random.RandomState(seed)  # MT19937, analog of utils.h:74-188
        rows = np.repeat(np.arange(num_rows, dtype=np.int32), nnz_per_row)
        cols = rng.randint(0, num_cols, size=rows.size).astype(np.int32)
        vals = rng.uniform(-1.0, 1.0, size=rows.size).astype(dtype)
        return cls(num_rows, num_cols, rows, cols, vals)

    @classmethod
    def random_powerlaw(cls, num_rows: int, num_cols: int, nnz: int,
                        alpha: float = 1.3, seed: int = 0, dtype=np.float64):
        """Power-law (Zipf-like) row-length distribution: a few huge rows and
        a long tail of tiny/empty rows.  The skew case the merge-path
        decomposition must stay flat on (paper Fig. 9a)."""
        rng = np.random.RandomState(seed)
        # Zipf weights over a random row permutation so big rows land anywhere.
        w = 1.0 / np.power(np.arange(1, num_rows + 1, dtype=np.float64), alpha)
        rng.shuffle(w)
        p = w / w.sum()
        counts = rng.multinomial(int(nnz), p)
        rows = np.repeat(np.arange(num_rows, dtype=np.int32), counts)
        cols = rng.randint(0, num_cols, size=rows.size).astype(np.int32)
        vals = rng.uniform(-1.0, 1.0, size=rows.size).astype(dtype)
        return cls(num_rows, num_cols, rows, cols, vals)

    # ------------------------------------------------------------------ #

    def __repr__(self):
        return (f"CooMatrix({self.num_rows}x{self.num_cols}, "
                f"nnz={self.num_nonzeros}, dtype={self.vals.dtype})")
