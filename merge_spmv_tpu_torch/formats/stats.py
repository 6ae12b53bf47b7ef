"""Graph statistics (parity: GraphStats + CsrMatrix::Stats,
sparse_matrix.h:59-107 and :786-913).

All quantities use the reference's population conventions:
row-length variance divides by num_rows, skewness is the standardized third
central moment, Pearson r and the Deming regression slope are computed over
the (col, row) scatter of all nonzeros.  Vectorized NumPy instead of the
reference's Welford-style streaming loops (identical results up to fp
round-off).
"""

from __future__ import annotations

import numpy as np

__all__ = ["GraphStats"]


class GraphStats:
    FIELDS = ("num_rows", "num_cols", "num_nonzeros",
              "row_length_mean", "row_length_std_dev",
              "row_length_variation", "row_length_skewness",
              "pearson_r", "deming_slope", "diag_dist_mean", "diag_dist_std_dev")

    def __init__(self, **kw):
        for f in self.FIELDS:
            setattr(self, f, kw.get(f, 0.0))

    @classmethod
    def from_csr(cls, csr) -> "GraphStats":
        n_rows = csr.num_rows
        nnz = csr.num_nonzeros
        lengths = np.diff(csr.row_offsets).astype(np.float64)

        mean = nnz / n_rows if n_rows else 0.0
        delta = lengths - mean
        variance = float(np.mean(delta * delta)) if n_rows else 0.0
        std_dev = float(np.sqrt(variance))
        skew = (float(np.mean(delta ** 3)) / std_dev ** 3) if std_dev > 0 else 0.0
        cov = std_dev / mean if mean else 0.0

        # Nonzero scatter statistics: x = col index, y = row index.
        pearson = deming = 0.0
        dmean = dstd = 0.0
        if nnz:
            cols = csr.col_indices.astype(np.float64)
            rows = csr.row_ids().astype(np.float64)
            # diag-distance |col - row| (sparse_matrix.h:793-811)
            dd = np.abs(cols - rows)
            dmean = float(dd.mean())
            dstd = float(dd.std())
            mx, my = cols.mean(), rows.mean()
            dx, dy = cols - mx, rows - my
            ss_x = float(np.dot(dx, dx))
            ss_y = float(np.dot(dy, dy))
            s_xy = float(np.mean(dx * dy))
            s_xx = ss_x / nnz
            s_yy = ss_y / nnz
            if ss_x > 0 and ss_y > 0:
                pearson = nnz * s_xy / (np.sqrt(ss_x) * np.sqrt(ss_y))
            if s_xy != 0.0:
                # Deming slope (sparse_matrix.h:878-884)
                deming = ((s_yy - s_xx
                           + np.sqrt((s_yy - s_xx) ** 2 + 4.0 * s_xy ** 2))
                          / (2.0 * s_xy))

        return cls(num_rows=n_rows, num_cols=csr.num_cols, num_nonzeros=nnz,
                   row_length_mean=mean, row_length_std_dev=std_dev,
                   row_length_variation=cov, row_length_skewness=skew,
                   pearson_r=pearson, deming_slope=deming,
                   diag_dist_mean=dmean, diag_dist_std_dev=dstd)

    def display(self, show_labels: bool = True, out=print):
        """Human-readable or CSV-fragment display (sparse_matrix.h:72-106)."""
        if show_labels:
            out("\n\t num_rows: %d\n\t num_cols: %d\n\t num_nonzeros: %d\n"
                "\t row_length_mean: %.5f\n\t row_length_std_dev: %.5f\n"
                "\t row_length_variation: %.5f\n\t row_length_skewness: %.5f"
                % (self.num_rows, self.num_cols, self.num_nonzeros,
                   self.row_length_mean, self.row_length_std_dev,
                   self.row_length_variation, self.row_length_skewness))
        else:
            out("%d, %d, %d, %.5f, %.5f, %.5f, %.5f, "
                % (self.num_rows, self.num_cols, self.num_nonzeros,
                   self.row_length_mean, self.row_length_std_dev,
                   self.row_length_variation, self.row_length_skewness))

    def as_dict(self):
        return {f: getattr(self, f) for f in self.FIELDS}

    def __repr__(self):
        return "GraphStats(%s)" % ", ".join(
            f"{f}={getattr(self, f)!r}" for f in self.FIELDS)
