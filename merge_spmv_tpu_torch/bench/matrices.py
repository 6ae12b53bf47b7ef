"""Generators of the large scattered-column matrices the split operators
are for, as (rows, cols, vals) COO arrays from a seed.

Copies of the JAX side's benchmark generators, so that the port needs
nothing of it:

* ``make_circuit_like`` — circuit5M class (tools/bench_large.py:52-71):
  power-law row degrees and Laplace column offsets off the diagonal;
  ``make_circuit_like(5_558_326, 59_524_291)`` is the full size.
* ``rmat`` — the Kronecker / R-MAT kron_g500 class
  (tools/bench_baseline_configs.py:133-147): power-law both ways,
  globally scattered columns; ``rmat(20, 50_000_000, 16, np.float32)`` is
  the hot/cold benchmark's matrix (tools/bench_hotcold.py:43-56).
"""

from __future__ import annotations

import numpy as np

__all__ = ["make_circuit_like", "rmat"]


def make_circuit_like(n, nnz, seed=0):
    """Power-law row degrees + Laplace column offsets off the diagonal."""
    rs = np.random.RandomState(seed)
    # power-law-ish degrees: most rows small, a few huge (hubs)
    raw = rs.pareto(1.8, n) + 1.0
    deg = np.maximum(1, (raw * (nnz / raw.sum())).astype(np.int64))
    rows = np.repeat(np.arange(n, dtype=np.int64), deg)
    m = rows.size
    # Laplace offsets around the diagonal, the tail clipped at ±64K
    scale = 25000.0
    off = np.clip(rs.laplace(0.0, scale, m), -65536, 65535).astype(np.int64)
    cols = np.clip(rows + off, 0, n - 1)
    vals = rs.uniform(0.1, 1.0, m)
    return rows, cols, vals


def rmat(scale, nnz, seed, dtype, a=0.57, b=0.19, c=0.19):
    """Kronecker/R-MAT stand-in (kron_g500 class): power-law both ways,
    globally scattered columns."""
    rs = np.random.RandomState(seed)
    rows = np.zeros(nnz, np.int64)
    cols = np.zeros(nnz, np.int64)
    for level in range(scale):
        r = rs.random(nnz)
        row_bit = r >= a + b                      # quadrants c, d
        col_bit = ((r >= a) & (r < a + b)) | (r >= a + b + c)   # b, d
        rows |= row_bit.astype(np.int64) << level
        cols |= col_bit.astype(np.int64) << level
    vals = rs.uniform(-1.0, 1.0, nnz).astype(dtype)
    return rows, cols, vals
